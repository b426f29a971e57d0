#!/usr/bin/env python3
"""Drive the PyTorch port's offset-keypoint server and trainer on one NVIDIA
GPU and hold its hand-written kernels against their plain versions.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure:
  1. device: the card's name and power limit;
  2. build: nvcc builds every kernel of the paths from ``csrc/``;
  3. kernels: B1 (patch attention) and B3 (sparse conv) against their plain
     versions at the full-width PTv3 serving shapes, in f32 and bf16;
  4. serve: the server of ``configs/my_dataset/offset_keypoint_ptv3.py``
     (seeded weights) answers 3 POSTs of ~20k-point body-like clouds; each
     kernel must launch once per Block per request;
  5. card against CPU: one request's outputs with the same weights on the CPU
     (plain versions);
  6. training kernels: B1, B2 (attention backward), B3 and B4 (conv dW)
     against their plain versions at every training shape (batch 8) in f32
     and bf16, the conv kernels on the kernel maps of a batch of the
     trainer's data pipeline, B2 at patch 1024, and both autograd Functions
     against autograd of the plain forwards;
  7. train: the config's trainer at full width, batch 8, on synthetic scenes,
     2 epochs of 2 steps with the evaluator and the checkpoint saver; each
     step must launch B1 22, B2 22, B3 44 and B4 22 times;
  8. card against CPU: one training step (batch 1, no drop path, no order
     shuffling) with the same weights and batch on the CPU;
  9. times: request latency and step time (host clock), one step under
     torch.profiler, and each kernel, its plain version and a library
     yardstick at every serving and training shape, beside the bound (CUDA
     events around a CUDA-graph replay, inputs read from HBM);
 10. summary: the kernels line (per training step: launches, errors and
     times of the training levels), then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import expit

from pointcept_keypointdetection_tpu_torch import serve
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.datasets.dataloader import Dataloader
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import SyntheticKeypointDataset, body_cloud
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device
from pointcept_keypointdetection_tpu_torch.engines.train import Trainer
from pointcept_keypointdetection_tpu_torch.inference.keypoint import (
    OffsetKeypointPredictor,
    aggregate_keypoints,
    estimate_normals_curvature,
)
from pointcept_keypointdetection_tpu_torch.kernels import _build
from pointcept_keypointdetection_tpu_torch.kernels import patch_attention as pa
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc
from pointcept_keypointdetection_tpu_torch.models import build_model, init_weights
from pointcept_keypointdetection_tpu_torch.ops import sparse as sp
from pointcept_keypointdetection_tpu_torch.ops.serialization import z_order_encode_np
from pointcept_keypointdetection_tpu_torch.utils.config import Config

CONFIG = "configs/my_dataset/offset_keypoint_ptv3.py"
REQUESTS = 3
CLOUD_POINTS = 20000
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FFMA and bf16 tensor-core flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
L2_BYTES = 50 * 2**20
# (atol, rtol); both sides compute in f32 and round the output once, so bf16 may differ by one ulp (2^-7 |x|)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 8e-3)}
# card vs CPU, relative to max(1, |cpu|): f32 through 22 blocks in two summation orders read 3.2e-6
CPU_TOL = 1e-4
# B4 sums up to 65,536 f32 products per entry in another order than the plain einsum: relative to
# max|dW|; the readings reach 2.8e-6 (f32) and 1.5e-6 (bf16)
DW_TOL = 1e-5
# one training step, card against CPU, relative to max(1, |cpu|) per tensor: the readings were 0 (loss),
# 3.2e-5 (gradients, f32 sums in other orders through 22 Blocks and back) and 1.2e-7 (running statistics)
TRAIN_CPU_TOL = 1e-3
TRAIN_EPOCHS = 2  # of 2 steps each
CARD = ""


def stamp() -> str:
    return f"[{CARD}]"


def request_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """A body-like cloud as the server receives it: [n, 7] = xyz (mm), normal, curvature."""
    coord = body_cloud(rng, n)
    return np.concatenate([coord, estimate_normals_curvature(coord)], axis=1)


def copies_for(nbytes: int) -> int:
    """Input sets whose bytes together are at least twice the L2."""
    return max(4, -(-2 * L2_BYTES // nbytes))


def cuda_ms(fn, cases, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: one call per input set of ``cases``, captured in a
    CUDA graph, one replay between two events.  Each call reads its own set, and the sets
    together exceed the L2 twice over, so the calls read their inputs from HBM.  Launched
    one by one, a call's host time (Python, ctypes) exceeds the device time of the smaller
    kernels, and the events would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in cases[:warmup]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in cases:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(cases)


# ---- the slice's kernel shapes ------------------------------------------------------------------


def stage_shapes(cfg):
    """(N, channels, heads, patch, launches per request) of every Block level of the config."""
    bb = cfg.model.backbone_conf
    slot = cfg.slot_size
    caps = []
    for s, p in enumerate(bb.enc_patch_size):
        cap = max(slot // bb.slot_divisors[s], p)
        caps.append(-(-cap // p) * p)
    shapes = [(caps[s], bb.enc_channels[s], bb.enc_num_head[s], bb.enc_patch_size[s], bb.enc_depths[s])
              for s in range(len(caps))]
    shapes += [(caps[s], bb.dec_channels[s], bb.dec_num_head[s], bb.dec_patch_size[s], bb.dec_depths[s])
               for s in range(len(bb.dec_depths))]
    return shapes


def surface_kernel_map(rng: np.random.Generator, n: int, z_sorted: bool, valid_frac: float = 0.88):
    """A real k=3 map from ``build_kernel_map`` over n voxel rows of a surface cloud, pads last.

    Rows are in the cloud's input order, as at stage 0 of a request, or with
    ``z_sorted`` in z order, as ``slotted_unique`` leaves the pooled stages."""
    pts = body_cloud(rng, 4 * n) / 1000.0
    grid_size = 0.1
    while True:
        grid = np.floor((pts - pts.min(0)) / grid_size).astype(np.int64)
        _, first = np.unique(z_order_encode_np(grid), return_index=True)
        if len(first) >= int(n * valid_frac):
            break
        grid_size *= 0.85
    nv = int(n * valid_frac)
    g = np.zeros((n, 3), np.int32)
    g[:nv] = grid[np.sort(rng.choice(first, nv, replace=False))]
    if z_sorted:
        g[:nv] = g[np.argsort(z_order_encode_np(g[:nv]), kind="stable")]
    valid = torch.zeros(n, dtype=torch.bool)
    valid[:nv] = True
    grid_t, batch = torch.from_numpy(g).cuda(), torch.zeros(n, dtype=torch.int64, device="cuda")
    valid = valid.cuda()
    index = sp.build_voxel_index(grid_t, batch, valid)
    return sp.build_kernel_map(index, grid_t, batch, valid, sp.SparseConvSpec.cube(3)).neighbor_idx


def attention_case(rng, n, heads, patch, dtype):
    qkv = torch.from_numpy(rng.normal(size=(n, 3, heads, 16)).astype(np.float32)).to("cuda", dtype)
    valid = torch.from_numpy(rng.random(n) > 0.12).cuda()
    valid[patch : 2 * patch] = False  # one patch without a valid key
    return qkv, valid


def conv_case(rng, idx, c, dtype):
    n = idx.shape[0]
    feat = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to("cuda", dtype)
    w = torch.from_numpy((rng.normal(size=(27, c, c)) / np.sqrt(27 * c)).astype(np.float32)).to("cuda", dtype)
    return feat, w


# ---- phases ---------------------------------------------------------------------------------------


def phase_device() -> str:
    global CARD
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    CARD = smi.splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {torch.cuda.get_device_name(0)}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    return CARD


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        print(f"built {_build.library_path(name).name}")
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source, in parallel)")


def check(label: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(got).all())
    print(f"{label}: max_abs_err={err:.3e} max|ref|={ref.float().abs().max().item():.3e} "
          f"tol=atol {atol:.3g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def check_attention(rng, n, heads, patch, dtype) -> float:
    qkv, valid = attention_case(rng, n, heads, patch, dtype)
    return check(f"B1 patch_attention N={n} H={heads} D=16 patch={patch} {str(dtype)[6:]}",
                 pa.patch_attention(qkv, valid, patch, 16**-0.5), pa.patch_attention_plain(qkv, valid, patch, 16**-0.5),
                 *TOL[dtype])


def check_conv(rng, idx, c, dtype) -> float:
    n = idx.shape[0]
    feat, w = conv_case(rng, idx, c, dtype)
    return check(f"B3 subm_conv N={n} Cin=Cout={c} K=27 hits={int((idx < n).sum())} {str(dtype)[6:]}",
                 sc.subm_conv(feat, idx, w), sc.subm_conv_plain(feat, idx, w), *TOL[dtype])


def phase_kernels(cfg):
    """B1 and B3 against their plain versions at every serving shape; returns the surface maps."""
    rng = np.random.default_rng(0)
    maps = {}
    for dtype in (torch.float32, torch.bfloat16):  # the key tiles of a patch of 1024 (bench.py's)
        check_attention(rng, cfg.slot_size, 4, 1024, dtype)
    for n, c, heads, patch, _ in stage_shapes(cfg):
        if n not in maps:
            maps[n] = surface_kernel_map(rng, n, z_sorted=n < cfg.slot_size)
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(rng, n, heads, patch, dtype)
            check_conv(rng, maps[n], c, dtype)
    return maps


def phase_serve(cfg, predictor, clouds):
    """3 POSTs through the server; returns the latencies and the launch counts of the run."""
    per_request = sum(cfg.model.backbone_conf.enc_depths) + sum(cfg.model.backbone_conf.dec_depths)
    server = serve.make_server(predictor, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies = []
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict?cols=7"
        pa.launches = 0
        sc.launches = 0
        for i, cloud in enumerate(clouds):
            before = (pa.launches, sc.launches)
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=cloud.astype(np.float32).tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                reply = np.frombuffer(r.read(), np.float32)
            latencies.append((time.perf_counter() - t0) * 1e3)
            delta = (pa.launches - before[0], sc.launches - before[1])
            print(f"request {i}: {cloud.shape[0]} points -> reply {reply.size} floats, "
                  f"{latencies[-1]:.1f} ms, launches B1 +{delta[0]} B3 +{delta[1]}")
            if reply.shape != (18,) or not np.isfinite(reply).all():
                raise AssertionError(f"request {i}: expected 6 x 3 finite floats, got {reply}")
            if delta != (per_request, per_request):
                raise AssertionError(f"request {i}: expected {per_request} launches of each kernel, got {delta}")
        counts = {"patch_attention_fwd": pa.launches, "subm_conv_fwd": sc.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("the server thread did not stop")
    print(f"serve: {REQUESTS} requests answered; launches {counts}")
    return latencies, counts


def phase_cpu(cfg, predictor, cloud) -> None:
    """The card's and the CPU's outputs on one request; an argmax keypoint may differ only where
    the CPU's two best logits are closer than twice the measured logit error (a tie it can flip)."""
    state = {k: v.detach().cpu() for k, v in predictor.model.state_dict().items()}
    cpu = OffsetKeypointPredictor(dict(cfg.model), state, cfg.slot_size, device="cpu")
    coord, feat = cloud[:, :3], cloud[:, 3:]
    gpu_res, cpu_res = predictor.infer(coord, feat), cpu.infer(coord, feat)
    np.testing.assert_array_equal(gpu_res["coord"], cpu_res["coord"])
    errs = {}
    for key in ("offset_pred", "mask_logits"):
        a, b = gpu_res[key], cpu_res[key]
        err = errs[key] = float(np.abs(a - b).max())
        scale = float(np.abs(b).max())
        print(f"card vs cpu {key} {a.shape}: max_abs_err={err:.3e} (|cpu| max {scale:.3f}) "
              f"tol={CPU_TOL:g} x max(1, |cpu| max)")
        if not (np.isfinite(a).all() and err <= CPU_TOL * max(1.0, scale)):
            raise AssertionError(f"card and CPU disagree on {key}")
    for method in ("argmax", "weighted"):
        kps = []
        for res in (gpu_res, cpu_res):
            prob = expit(res["mask_logits"])
            kps.append(aggregate_keypoints(res["coord"], res["offset_pred"], prob, method) * res["scale"]
                       + res["centroid"])
        err = float(np.abs(kps[0] - kps[1]).max())
        tol = CPU_TOL * gpu_res["scale"]
        print(f"card vs cpu keypoints ({method}): max_abs_err={err:.3e} mm tol={tol:.3e} mm")
        if err > tol:
            cpu_prob = cpu_res["mask_logits"]
            gpu_arg = gpu_res["mask_logits"].argmax(0)
            gap = float(np.abs(cpu_prob.max(0) - cpu_prob[gpu_arg, np.arange(cpu_prob.shape[1])]).max())
            tie = 2 * errs["mask_logits"]
            if method == "weighted" or gap > tie:
                raise AssertionError(f"card and CPU keypoints disagree ({method}), logit gap {gap:.3e}")
            print(f"  argmax picks differ on a near tie (logit gap {gap:.3e} <= {tie:.3e})")


# ---- the training slice -----------------------------------------------------------------------------


def train_shapes(cfg):
    """(N, channels, heads, patch, Blocks) of every training Block level: serving slots x batch."""
    return [(n * cfg.batch_size, c, h, p, d) for n, c, h, p, d in stage_shapes(cfg)]


def training_maps(cfg) -> dict:
    """{N: kernel map} of every training level, from the first batch of the trainer's data pipeline
    (``train_config``, seed 0) through a forward of the full-width model: the maps depend on the
    points only, not on the weights or on the order shuffles."""
    tcfg = train_config()
    np.random.seed(0)
    loader = Dataloader(build_dataset(dict(tcfg.data.train)), batch_size=tcfg.batch_size,
                        slot_size=tcfg.slot_size, seed=0, prefetch=0)
    batch_np = next(iter(loader))
    model = build_model(dict(tcfg.model)).cuda().eval()
    make, maps = model.backbone._kernel_map, {}

    def record(point, shuffled):
        kmap = make(point, shuffled)
        maps[kmap.neighbor_idx.shape[0]] = kmap.neighbor_idx
        return kmap

    model.backbone._kernel_map = record
    with torch.no_grad():
        model(build_point_batch(sample_to_device(batch_np, "cuda"), batch_np["num_samples"]))
    want = sorted({n for n, *_ in train_shapes(cfg)})
    if sorted(maps) != want:
        raise AssertionError(f"the training forward built maps of {sorted(maps)} rows, expected {want}")
    for n, idx in sorted(maps.items(), reverse=True):
        print(f"training map N={n}: {int((idx < n).sum())} hits, {int((idx[:, 13] < n).sum())} valid rows")
    return maps


def attention_bwd_case(rng, n, heads, patch, dtype):
    qkv, valid = attention_case(rng, n, heads, patch, dtype)
    g = torch.from_numpy(rng.normal(size=(n, heads * 16)).astype(np.float32)).to("cuda", dtype)
    _, lse, out32 = pa.patch_attention_with_lse(qkv, valid, patch, 0.25)
    return qkv, valid, out32, lse, g


def check_attention_bwd(rng, n, heads, patch, dtype) -> float:
    qkv, valid, out32, lse, g = attention_bwd_case(rng, n, heads, patch, dtype)
    got = pa.patch_attention_backward(qkv, valid, out32, lse, g, patch, 0.25)
    ref = pa.patch_attention_backward_plain(qkv, valid, g, patch, 0.25)
    return check(f"B2 patch_attention_bwd N={n} H={heads} D=16 patch={patch} {str(dtype)[6:]}", got, ref,
                 *TOL[dtype])


def phase_train_kernels(cfg, maps):
    """All four kernels against their plain versions at every training shape, the conv kernels on
    the trainer's maps, and the autograd Functions; returns each kernel's largest f32 error."""
    rng = np.random.default_rng(3)
    errors = dict.fromkeys(("patch_attention_fwd", "patch_attention_bwd", "subm_conv_fwd", "subm_conv_dw"), 0.0)
    for dtype in (torch.float32, torch.bfloat16):  # the key tiles of a patch of 1024 (bench.py's)
        err = check_attention_bwd(rng, cfg.slot_size, 4, 1024, dtype)
        if dtype == torch.float32:
            errors["patch_attention_bwd"] = max(errors["patch_attention_bwd"], err)
    for n, c, heads, patch, _ in train_shapes(cfg):
        idx = maps[n]
        hits = int((idx < n).sum())
        for dtype in (torch.float32, torch.bfloat16):
            found = {"patch_attention_fwd": check_attention(rng, n, heads, patch, dtype),
                     "patch_attention_bwd": check_attention_bwd(rng, n, heads, patch, dtype),
                     "subm_conv_fwd": check_conv(rng, idx, c, dtype)}
            feat, _ = conv_case(rng, idx, c, dtype)
            g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to("cuda", dtype)
            ref = sc.subm_conv_dw_plain(feat, idx, g)
            found["subm_conv_dw"] = check(f"B4 subm_conv_dw N={n} Cin=Cout={c} K=27 hits={hits} {str(dtype)[6:]}",
                                          sc.subm_conv_dw(feat, idx, g), ref, DW_TOL * ref.abs().max().item(), 0.0)
            if dtype == torch.float32:
                for name, err in found.items():
                    errors[name] = max(errors[name], err)

    # the Functions against autograd of the plain forwards, at the first training level
    n, c, heads, patch, _ = train_shapes(cfg)[0]
    idx = maps[n]
    feat0, w0 = conv_case(rng, idx, c, torch.float32)
    g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).cuda()
    grads = []
    for fn in (sc.SubmConvFunction.apply, sc.subm_conv_plain):
        feat, w = feat0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(feat, idx, w) * g).sum().backward()
        grads.append((feat.grad, w.grad))
    for name, got, ref in zip(("dfeat (B3, mirrored W)", "dW (B4)"), *grads):
        check(f"SubmConvFunction {name} vs autograd of the plain forward N={n} C={c}", got, ref,
              TOL[torch.float32][0] * max(1.0, ref.abs().max().item()), TOL[torch.float32][1])
    qkv0, valid = attention_case(rng, n, heads, patch, torch.float32)
    g = torch.from_numpy(rng.normal(size=(n, heads * 16)).astype(np.float32)).cuda()
    grads = []
    for fn in (pa.PatchAttentionFunction.apply, pa.patch_attention_plain):
        qkv = qkv0.clone().requires_grad_()
        (fn(qkv, valid, patch, 0.25) * g).sum().backward()
        grads.append(qkv.grad[valid])  # valid rows: autograd of the plain forward gates dS by the mask
    check(f"PatchAttentionFunction dqkv vs autograd of the plain forward N={n} H={heads} (valid rows)",
          grads[0], grads[1], *TOL[torch.float32])
    return errors


def launch_counts():
    return {"patch_attention_fwd": pa.launches, "patch_attention_bwd": pa.bwd_launches,
            "subm_conv_fwd": sc.launches, "subm_conv_dw": sc.dw_launches}


def set_launch_counts_to_zero():
    pa.launches = pa.bwd_launches = sc.launches = sc.dw_launches = 0


def train_config(save_path: str = ""):
    """The full-width config on synthetic scenes: 2 steps of batch 8 per epoch, 1 val batch."""
    cfg = Config.fromfile(CONFIG)
    data = {}
    for split, scenes in (("train", 2 * cfg.batch_size), ("val", cfg.batch_size)):
        data[f"data.{split}"] = dict(_delete_=True, type="SyntheticKeypointDataset", split=split, num_scenes=scenes,
                                     num_points=CLOUD_POINTS, num_keypoints=cfg.num_keypoints,
                                     offset_radius=cfg.data[split].offset_radius,
                                     transform=cfg.data[split].transform)
    cfg.merge_from_dict(dict(save_path=save_path, eval_epoch=TRAIN_EPOCHS, seed=0, **data))
    return cfg


def profile_step(trainer, run_step) -> dict:
    """One training step under torch.profiler: device busy ms (the kernels' sum), idle share, kernels."""
    from torch.profiler import ProfilerActivity, profile

    trainer.comm_info["input_dict"] = next(iter(trainer.train_loader))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.events():
        # a user annotation (the optimizer's step) spans kernels of its own on the device timeline
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            ms, cnt = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, cnt + 1)
    busy = sum(ms for ms, _ in by_kernel.values())
    out = dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms if busy else None,
               kernels=sum(cnt for _, cnt in by_kernel.values()))
    print(f"one training step under torch.profiler: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {out['idle_share']}, {out['kernels']} kernels {stamp()}")
    for name, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:9.3f} ms x{cnt:5d}  {name[:110]}")
    if not busy:
        raise AssertionError("the profiler saw no device time in the training step")
    return out


def phase_train(cfg):
    """The trainer at full width for TRAIN_EPOCHS epochs; returns its step times, launch counts and profile."""
    # every Block: B1 and B3 forward, B2 and B4 backward, and B3 again for the conv's input gradient
    blocks = sum(cfg.model.backbone_conf.enc_depths) + sum(cfg.model.backbone_conf.dec_depths)  # 22
    per_step = {"patch_attention_fwd": blocks, "patch_attention_bwd": blocks, "subm_conv_fwd": 2 * blocks,
                "subm_conv_dw": blocks}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(train_config(tmp), device="cuda")
        steps, step_ms = [], []
        run_step = trainer.run_step

        def counted_step():
            before = launch_counts()
            t0 = time.perf_counter()
            run_step()  # ends in the host reading the losses
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            steps.append(delta)
            m = trainer.comm_info["metrics"]
            print(f"train step {len(steps)}: loss {m['loss']:.4f} (cls {m['cls_loss']:.4f}, reg {m['reg_loss']:.4f}), "
                  f"{step_ms[-1]:.1f} ms, launches {delta} {stamp()}")
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"step {len(steps)}: a loss is not finite: {m}")
            if delta != per_step:
                raise AssertionError(f"step {len(steps)}: expected launches {per_step}, got {delta}")

        trainer.run_step = counted_step
        before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        set_launch_counts_to_zero()
        trainer.train()
        counts = launch_counts()
        if len(steps) != 2 * TRAIN_EPOCHS:
            raise AssertionError(f"expected {2 * TRAIN_EPOCHS} steps, ran {len(steps)}")
        unchanged = [k for k, v in trainer.model.state_dict().items() if torch.equal(v, before[k])]
        print(f"train: {len(steps)} steps; {len(before) - len(unchanged)} of {len(before)} parameter and "
              f"statistics tensors changed; launches {counts}")
        if unchanged:
            raise AssertionError(f"tensors the training did not change: {unchanged[:8]}")
        metric = trainer.comm_info.get("current_metric_value")
        if metric is None or not np.isfinite(metric):
            raise AssertionError(f"the evaluator gave no finite mm error: {metric}")
        print(f"evaluator: mean keypoint distance {-metric:.2f} mm (argmax) after {TRAIN_EPOCHS} epochs {stamp()}")
        profile = profile_step(trainer, run_step)
    return dict(step_ms=step_ms, counts=counts, steps=steps, profile=profile)


def phase_train_cpu(cfg) -> None:
    """One training step, card against CPU: batch 1, no drop path, no order shuffling, same weights
    and batch; the loss, every gradient and the running statistics, relative to max(1, |cpu|)."""
    model_cfg = dict(cfg.model)
    model_cfg["backbone_conf"] = dict(cfg.model.backbone_conf, drop_path=0.0, shuffle_orders=False)
    cpu_model = init_weights(build_model(model_cfg), torch.Generator().manual_seed(3))
    card_model = build_model(model_cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.cuda()
    np.random.seed(5)
    dataset = SyntheticKeypointDataset(split="train", num_scenes=1, num_points=CLOUD_POINTS,
                                       offset_radius=cfg.data.train.offset_radius, transform=cfg.data.train.transform)
    batch_np = collate([dataset[0]], cfg.slot_size, np.random)
    outs = []
    for model, device in ((card_model, "cuda"), (cpu_model, "cpu")):
        model.train()
        batch = sample_to_device(batch_np, device)
        t0 = time.perf_counter()
        out = model(build_point_batch(batch, 1), batch)
        out["loss"].backward()
        outs.append(out)
        print(f"one training step on {device}: {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock) {stamp()}")
    worst = {}
    for kind, card_t, cpu_t in [("loss", {"loss": outs[0]["loss"].detach()}, {"loss": outs[1]["loss"].detach()}),
                                ("grad", {k: p.grad for k, p in card_model.named_parameters()},
                                 {k: p.grad for k, p in cpu_model.named_parameters()}),
                                ("stat", dict(card_model.named_buffers()), dict(cpu_model.named_buffers()))]:
        for name, ref in cpu_t.items():
            got = card_t[name].cpu()
            rel = (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            if not (rel <= TRAIN_CPU_TOL and bool(torch.isfinite(got).all())):
                raise AssertionError(f"card and CPU disagree on {kind} {name}: {rel:.3e}")
            if rel >= worst.get(kind, (-1.0, ""))[0]:
                worst[kind] = (rel, name)
    for kind, (rel, name) in worst.items():
        print(f"card vs cpu training step, {kind}: max abs err / max(1, |cpu|) = {rel:.3e} ({name}); "
              f"tol {TRAIN_CPU_TOL:g} {stamp()}")


SOURCES = {  # name: (source, the Pallas kernel body it replaces)
    "patch_attention_fwd": ("pointcept_keypointdetection_tpu_torch/csrc/patch_attention.cu",
                            "pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py:32"),
    "patch_attention_bwd": ("pointcept_keypointdetection_tpu_torch/csrc/patch_attention.cu",
                            "pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py:52"),
    "subm_conv_fwd": ("pointcept_keypointdetection_tpu_torch/csrc/sparse_conv.cu",
                      "pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py:50"),
    "subm_conv_dw": ("pointcept_keypointdetection_tpu_torch/csrc/sparse_conv.cu",
                     "pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py:115"),
}


def input_sets(make, nbytes: int):
    return [make() for _ in range(copies_for(nbytes))]


def time_kernel(name, cases, kernel, plain, library, nbytes, flops, dtype):
    """One kernel's device ms beside its plain version's, the library call's and the bound."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    row = dict(ms=cuda_ms(kernel, cases), plain_ms=cuda_ms(plain, cases), library_ms=cuda_ms(library, cases),
               bound_ms=max(t_bytes, t_ops), t_bytes=t_bytes, t_ops=t_ops)
    print(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP) {stamp()}")
    return row


def time_attention(rng, n, heads, patch, dtype, backward: bool):
    """B1 (or with ``backward`` B2), its plain version and F.scaled_dot_product_attention (its backward:
    forward + backward less the forward, both timed) on the same inputs."""
    size = torch.tensor([], dtype=dtype).element_size()
    p = n // patch
    qkv_bytes = n * 3 * heads * 16 * size
    row_bytes = n * heads * 16 * size

    def make():
        qkv, valid, out, lse, g = attention_bwd_case(rng, n, heads, patch, dtype)
        qh = [t.detach().clone().requires_grad_(backward)
              for t in qkv.reshape(p, patch, 3, heads, 16).permute(2, 0, 3, 1, 4)]
        return (qkv, valid, out, lse, g, qh, valid.reshape(p, 1, 1, patch),
                g.reshape(p, patch, heads, 16).permute(0, 2, 1, 3).contiguous())

    def sdpa(qh, m):
        return F.scaled_dot_product_attention(qh[0], qh[1], qh[2], attn_mask=m, scale=0.25)

    if not backward:
        cases = input_sets(make, qkv_bytes + n + row_bytes)
        return time_kernel("B1", cases, lambda q, v, o, l, g, qh, m, gh: pa.patch_attention(q, v, patch, 0.25),
                           lambda q, v, o, l, g, qh, m, gh: pa.patch_attention_plain(q, v, patch, 0.25),
                           lambda q, v, o, l, g, qh, m, gh: sdpa(qh, m),
                           qkv_bytes + n + row_bytes, 4.0 * n * patch * 16 * heads, dtype)
    nbytes = 2 * qkv_bytes + n + row_bytes + n * heads * 16 * 4 + n * heads * 4  # dO in the dtype, O and lse in f32
    cases = input_sets(make, nbytes)
    row = time_kernel("B2", cases, lambda q, v, o, l, g, qh, m, gh: pa.patch_attention_backward(q, v, o, l, g, patch, 0.25),
                      lambda q, v, o, l, g, qh, m, gh: pa.patch_attention_backward_plain(q, v, g, patch, 0.25),
                      lambda q, v, o, l, g, qh, m, gh: torch.autograd.grad(sdpa(qh, m), qh, gh),
                      nbytes, 10.0 * n * patch * 16 * heads, dtype)
    fwd = cuda_ms(lambda q, v, o, l, g, qh, m, gh: sdpa(qh, m), cases)
    row["library_ms"] -= fwd
    print(f"    (library: SDPA forward + backward less its forward, {fwd:.4f} ms)")
    return row


def time_conv(rng, idx, c, dtype, dw: bool):
    """B3 (or with ``dw`` B4), its plain version and the gather + torch.matmul on the same inputs."""
    n = idx.shape[0]
    size = torch.tensor([], dtype=dtype).element_size()
    hits = int((idx < n).sum())

    def make():
        feat, w = conv_case(rng, idx, c, dtype)
        g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to("cuda", dtype)
        i = idx.clone()
        return feat, i, w, g, torch.cat([feat, feat.new_zeros(1, c)]), i.long(), w.reshape(27 * c, c)

    if not dw:
        nbytes = (n * c * 2 + 27 * c * c) * size + idx.numel() * 4
        return time_kernel("B3", input_sets(make, nbytes),
                           lambda f, i, w, g, fp, il, w2: sc.subm_conv(f, i, w),
                           lambda f, i, w, g, fp, il, w2: sc.subm_conv_plain(f, i, w),
                           lambda f, i, w, g, fp, il, w2: torch.matmul(fp[il].reshape(n, 27 * c), w2),
                           nbytes, 2.0 * hits * c * c, dtype)
    nbytes = n * c * 2 * size + idx.numel() * 4 + 27 * c * c * 4
    return time_kernel("B4", input_sets(make, nbytes),
                       lambda f, i, w, g, fp, il, w2: sc.subm_conv_dw(f, i, g),
                       lambda f, i, w, g, fp, il, w2: sc.subm_conv_dw_plain(f, i, g),
                       lambda f, i, w, g, fp, il, w2: torch.matmul(fp[il].permute(1, 2, 0), g),
                       nbytes, 2.0 * hits * c * c, dtype)


def phase_times(cfg, latencies, serve_maps, train_maps, errors, train):
    """Request latency, step time and each kernel's times; returns the kernels line, each row per
    training step: launches in one step of the trainer's run, errors at the training shapes, and
    times summed over a step's launches at the training levels, conv kernels on the trainer's maps."""
    print(f"request latency (host clock, POST to reply, {REQUESTS} requests): "
          f"median {statistics.median(latencies):.2f} ms, each {[round(x, 2) for x in latencies]} {stamp()}")
    timed = train["step_ms"][1:]  # the first step also warms up cuBLAS and the allocator
    print(f"training step time (host clock, batch {cfg.batch_size}, steps 2-{len(train['step_ms'])}): median "
          f"{statistics.median(timed):.2f} ms, each {[round(x, 2) for x in train['step_ms']]} {stamp()}")
    rng = np.random.default_rng(1)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")

    def add(totals, name, row, launches):
        t = totals.setdefault(name, dict.fromkeys(keys, 0.0))
        for key in keys:
            t[key] += launches * row[key]

    per_request = {}
    for n, c, heads, patch, depth in stage_shapes(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            print(f"serving level N={n} C={c} H={heads} patch={patch} {str(dtype)[6:]} (x{depth} per request):")
            rows = {"patch_attention_fwd": time_attention(rng, n, heads, patch, dtype, backward=False),
                    "subm_conv_fwd": time_conv(rng, serve_maps[n], c, dtype, dw=False)}
            if dtype == torch.float32:
                for name, row in rows.items():
                    add(per_request, name, row, depth)
    for name, t in per_request.items():
        print(f"{name} per request (f32, sum over its launches): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")

    per_step = {}
    launches = {"patch_attention_fwd": 1, "patch_attention_bwd": 1, "subm_conv_fwd": 2, "subm_conv_dw": 1}
    for n, c, heads, patch, depth in train_shapes(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            print(f"training level N={n} C={c} H={heads} patch={patch} {str(dtype)[6:]} (x{depth} Blocks per step):")
            rows = {"patch_attention_fwd": time_attention(rng, n, heads, patch, dtype, backward=False),
                    "patch_attention_bwd": time_attention(rng, n, heads, patch, dtype, backward=True),
                    "subm_conv_fwd": time_conv(rng, train_maps[n], c, dtype, dw=False),
                    "subm_conv_dw": time_conv(rng, train_maps[n], c, dtype, dw=True)}
            if dtype == torch.float32:
                for name, row in rows.items():
                    add(per_step, name, row, launches[name] * depth)
    kernels = []
    step = train["steps"][-1]  # every step launched the same counts (phase_train checks)
    for name, t in per_step.items():
        print(f"{name} per training step (f32, sum over its {step[name]} "
              f"launches): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms {stamp()}")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
            launches=step[name], max_abs_err=errors[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by="operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            library_ms=t["library_ms"],
        ))
    return kernels


def main() -> None:
    phase_device()
    phase_build()
    cfg = Config.fromfile(CONFIG)
    maps = phase_kernels(cfg)
    predictor = serve.build_predictor("offset_keypoint", cfg, None, cfg.slot_size, "cuda")
    rng = np.random.default_rng(2)
    clouds = [request_cloud(rng, CLOUD_POINTS) for _ in range(REQUESTS + 1)]
    warm = clouds.pop()
    predictor.predict(warm[:, :3], warm[:, 3:])  # cuBLAS handles and the allocator's pool, outside the timed requests
    latencies, _ = phase_serve(cfg, predictor, clouds)
    phase_cpu(cfg, predictor, clouds[0])
    del predictor
    train_maps = training_maps(cfg)
    errors = phase_train_kernels(cfg, train_maps)
    train = phase_train(cfg)
    phase_train_cpu(cfg)
    kernels = phase_times(cfg, latencies, maps, train_maps, errors, train)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
