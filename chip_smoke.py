#!/usr/bin/env python3
"""Drive the PyTorch port's offset-keypoint server on one NVIDIA GPU and hold
its hand-written kernels against their plain versions.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure:
  1. device: the card's name and power limit;
  2. build: nvcc builds every kernel of the path from ``csrc/``;
  3. kernels: B1 (patch attention) and B3 (sparse conv) against their plain
     versions at the full-width PTv3 shapes, in f32 and bf16;
  4. serve: the server of ``configs/my_dataset/offset_keypoint_ptv3.py``
     (seeded weights) answers 3 POSTs of ~20k-point body-like clouds; each
     kernel must launch once per Block per request;
  5. card against CPU: one request's outputs with the same weights on the CPU
     (plain versions);
  6. times: request latency (host clock); each kernel, its plain version
     and a library yardstick at every stage shape, beside the bound (CUDA
     events around a CUDA-graph replay, inputs read from HBM);
  7. summary: the kernels line, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import expit

from pointcept_keypointdetection_tpu_torch import serve
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import body_cloud
from pointcept_keypointdetection_tpu_torch.inference.keypoint import (
    OffsetKeypointPredictor,
    aggregate_keypoints,
    estimate_normals_curvature,
)
from pointcept_keypointdetection_tpu_torch.kernels import _build
from pointcept_keypointdetection_tpu_torch.kernels import patch_attention as pa
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc
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


def check_attention(rng, n, heads, patch, dtype) -> float:
    atol, rtol = TOL[dtype]
    qkv, valid = attention_case(rng, n, heads, patch, dtype)
    got = pa.patch_attention(qkv, valid, patch, 16**-0.5)
    ref = pa.patch_attention_plain(qkv, valid, patch, 16**-0.5)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(got).all())
    print(f"B1 patch_attention N={n} H={heads} D=16 patch={patch} {str(dtype)[6:]}: "
          f"max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"B1 disagrees with its plain version at N={n} H={heads} patch={patch} {dtype}")
    return err


def phase_kernels(cfg):
    """Each kernel against its plain version at every stage shape; returns the f32 errors and cases."""
    rng = np.random.default_rng(0)
    errors = {"patch_attention_fwd": 0.0, "subm_conv_fwd": 0.0}
    maps = {}
    for dtype in (torch.float32, torch.bfloat16):  # the key tiles of a patch of 1024 (bench.py's)
        check_attention(rng, cfg.slot_size, 4, 1024, dtype)
    for n, c, heads, patch, _ in stage_shapes(cfg):
        if n not in maps:
            maps[n] = surface_kernel_map(rng, n, z_sorted=n < cfg.slot_size)
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol = TOL[dtype]
            err = check_attention(rng, n, heads, patch, dtype)
            feat, w = conv_case(rng, maps[n], c, dtype)
            got = sc.subm_conv(feat, maps[n], w)
            ref = sc.subm_conv_plain(feat, maps[n], w)
            torch.cuda.synchronize()
            cerr = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(got).all())
            hits = int((maps[n] < n).sum())
            print(f"B3 subm_conv N={n} Cin=Cout={c} K=27 hits={hits} {str(dtype)[6:]}: "
                  f"max_abs_err={cerr:.3e} tol=atol {atol:g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"B3 disagrees with its plain version at N={n} C={c} {dtype}")
            if dtype == torch.float32:
                errors["patch_attention_fwd"] = max(errors["patch_attention_fwd"], err)
                errors["subm_conv_fwd"] = max(errors["subm_conv_fwd"], cerr)
    return errors, maps


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


def phase_times(cfg, latencies, maps, errors, counts):
    print(f"request latency (host clock, POST to reply, {REQUESTS} requests): "
          f"median {statistics.median(latencies):.2f} ms, each {[round(x, 2) for x in latencies]} {stamp()}")
    rng = np.random.default_rng(1)
    totals = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0)
              for name in counts}

    def add(name, launches, ms, plain_ms, library_ms, nbytes, flops, dtype):
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        bound = max(t_bytes, t_ops)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP) x{launches}/request {stamp()}")
        if dtype == torch.float32:
            t = totals[name]
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms), ("bound_ms", bound),
                             ("t_bytes", t_bytes), ("t_ops", t_ops)):
                t[key] += launches * val

    for n, c, heads, patch, launches in stage_shapes(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            size = torch.tensor([], dtype=dtype).element_size()
            label = str(dtype)[6:]
            qkv, valid = attention_case(rng, n, heads, patch, dtype)
            p = n // patch
            nbytes = n * 3 * heads * 16 * size + n + n * heads * 16 * size
            cases = []
            for _ in range(copies_for(nbytes)):
                q, v = qkv.clone(), valid.clone()
                cases.append((q, v, q.reshape(p, patch, 3, heads, 16).permute(2, 0, 3, 1, 4).contiguous(),
                              v.reshape(p, 1, 1, patch)))
            print(f"B1 N={n} H={heads} patch={patch} {label} ({len(cases)} input sets):")
            add("patch_attention_fwd", launches,
                cuda_ms(lambda q, v, qh, m: pa.patch_attention(q, v, patch, 0.25), cases),
                cuda_ms(lambda q, v, qh, m: pa.patch_attention_plain(q, v, patch, 0.25), cases),
                cuda_ms(lambda q, v, qh, m: F.scaled_dot_product_attention(qh[0], qh[1], qh[2], attn_mask=m,
                                                                           scale=0.25), cases),
                nbytes, 4.0 * n * patch * 16 * heads, dtype)
            del cases
            feat, w = conv_case(rng, maps[n], c, dtype)
            hits = int((maps[n] < n).sum())
            nbytes = (n * c * 2 + 27 * c * c) * size + maps[n].numel() * 4
            cases = []
            for _ in range(copies_for(nbytes)):
                f, i, wc = feat.clone(), maps[n].clone(), w.clone()
                cases.append((f, i, wc, torch.cat([f, f.new_zeros(1, c)]), i.long(), wc.reshape(27 * c, c)))
            print(f"B3 N={n} Cin=Cout={c} hits={hits} {label} ({len(cases)} input sets):")
            add("subm_conv_fwd", launches,
                cuda_ms(lambda f, i, wc, fp, il, w2: sc.subm_conv(f, i, wc), cases),
                cuda_ms(lambda f, i, wc, fp, il, w2: sc.subm_conv_plain(f, i, wc), cases),
                cuda_ms(lambda f, i, wc, fp, il, w2: torch.matmul(fp[il].reshape(n, 27 * c), w2), cases),
                nbytes, 2.0 * hits * c * c, dtype)
            del cases

    sources = {"patch_attention_fwd": ("pointcept_keypointdetection_tpu_torch/csrc/patch_attention.cu",
                                       "pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py:32"),
               "subm_conv_fwd": ("pointcept_keypointdetection_tpu_torch/csrc/sparse_conv.cu",
                                 "pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py:50")}
    kernels = []
    for name, t in totals.items():
        print(f"{name} per request (f32, sum over its {counts[name] // REQUESTS} launches): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")
        kernels.append(dict(
            name=name, route="cuda", source=sources[name][0], replaces=sources[name][1],
            launches=counts[name], max_abs_err=errors[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by="operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            library_ms=t["library_ms"],
        ))
    return kernels


def main() -> None:
    phase_device()
    phase_build()
    cfg = Config.fromfile(CONFIG)
    errors, maps = phase_kernels(cfg)
    predictor = serve.build_predictor("offset_keypoint", cfg, None, cfg.slot_size, "cuda")
    rng = np.random.default_rng(2)
    clouds = [request_cloud(rng, CLOUD_POINTS) for _ in range(REQUESTS + 1)]
    warm = clouds.pop()
    predictor.predict(warm[:, :3], warm[:, 3:])  # cuBLAS handles and the allocator's pool, outside the timed requests
    latencies, counts = phase_serve(cfg, predictor, clouds)
    phase_cpu(cfg, predictor, clouds[0])
    kernels = phase_times(cfg, latencies, maps, errors, counts)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
