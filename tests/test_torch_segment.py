"""The port's segmentation path against the JAX package on the CPU.

A small ``DefaultSegmentorV2`` (3 stages of depth 1, so that each Block
attends in the first order and two orders suffice; channels 16-48, head dim
16, patch 16, slot divisors (1, 4, 16) and ``kmap_depth`` 10 as in the bench,
slot 256, 4 input channels as the ``pigseg`` config) gets seeded JAX
variables, converted into the port.  JAX compiles its forward once per dtype,
in a module fixture; the ``pigseg`` predictor of ``tools/serve.py`` is handed
that compiled f32 forward and the same variables (its ``_built`` cache) in
place of its own init and checkpoint restore, which would compile twice more.

Tolerances: f32 logits on valid rows within 1e-4 x max(1, max|jax|) (f32
sums in other orders through five Blocks), argmax equal except where JAX's
two best logits are closer than twice that; bf16 logits (params cast to bf16
as ``bench.py:172-180`` casts them; the port's through
``cast_parameters``, the bench's own cast) within twice JAX bf16's own error
against JAX f32 on the same inputs, and, against JAX f32 on the same
bf16-rounded params, off by at least a quarter of JAX bf16's error there
(a port that computed in f32 inside would be off by f32 rounding only).  Integer paths (pooling, the predictor's
voxel pick) match exactly.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_for

from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu_torch import bench, serve
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import body_cloud
from pointcept_keypointdetection_tpu_torch.inference.keypoint import estimate_normals_curvature
from pointcept_keypointdetection_tpu_torch.inference.segment import SegmentPredictor
from pointcept_keypointdetection_tpu_torch.models import PointBatch, build_model, cast_parameters
from tools.serve import _SegPredictor as JaxSegPredictor

SLOT = 256
GRID = 0.12
KEYS = ("coord", "feat", "grid_coord", "valid")
BACKBONE = dict(
    type="PT-v3m1", in_channels=4, order=("z", "hilbert"), stride=(2, 2), enc_depths=(1, 1, 1),
    enc_channels=(16, 32, 48), enc_num_head=(1, 2, 3), enc_patch_size=(16, 16, 16), dec_depths=(1, 1),
    dec_channels=(16, 32), dec_num_head=(1, 2), dec_patch_size=(16, 16), slot_divisors=(1, 4, 16), kmap_depth=10,
    drop_path=0.0,
)
CFG = dict(type="DefaultSegmentorV2", num_classes=5, backbone_out_channels=16, backbone=BACKBONE,
           criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
F32_TOL = 1e-4
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _body_request(seed, n):
    """A body-like cloud as the server receives it: [n, 7] = xyz (mm), normal, curvature."""
    coord = body_cloud(np.random.default_rng(seed), n)
    return np.concatenate([coord, estimate_normals_curvature(coord)], axis=1)


def _scenes(predictor):
    """{name: padded rows}: the predictor's rows of a body cloud (pads last), and the bench's
    generator at the slot's size (pads among the rows; its pooled levels overflow)."""
    cloud = _body_request(1, 600)
    data, _ = predictor.prepare(cloud[:, :3], cloud[:, 3:], GRID)
    n = data["coord"].shape[0]
    assert 0 < n < SLOT
    body = {k: np.pad(v, [(0, SLOT - n)] + [(0, 0)] * (v.ndim - 1)) for k, v in data.items()}
    body["valid"] = np.arange(SLOT) < n
    scene = bench.scene(SLOT)
    scene["feat"] = scene["feat"][:, :4]
    return {"body": body, "bench": scene}


def _jax_point(b, dtype):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"].astype(dtype), grid_coord=b["grid_coord"],
                         valid=b["valid"], num_samples=1)


@pytest.fixture(scope="module")
def case():
    """Seeded JAX variables, the port's predictor with them, and JAX's logits in f32 and bf16 on the scenes."""
    model = jax_build_model(CFG)
    variables = jax_variables_for(build_model(CFG), np.random.default_rng(0))
    params16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.dtype == np.float32 else x, variables["params"])
    variables16 = dict(variables, params=params16)
    rounded = dict(variables, params=jax.tree.map(lambda x: x.astype(jnp.float32), params16))
    predictor = SegmentPredictor(CFG, convert_variables(variables), slot_size=SLOT, device="cpu")
    scenes = _scenes(predictor)
    args = {name: {k: jnp.asarray(s[k]) for k in KEYS} for name, s in scenes.items()}
    # the compile of one dtype (XLA's cheaper CPU passes: the numbers do not need them) overlaps the
    # tracing of the other: the two are most of the file's time
    with ThreadPoolExecutor(2) as pool:
        compiles = {}
        for dtype, v in ((jnp.float32, variables), (jnp.bfloat16, variables16)):
            fn = jax.jit(lambda v, b, dtype=dtype: model.apply(v, _jax_point(b, dtype), b, train=False)["seg_logits"])
            compiles[dtype] = pool.submit(fn.lower(v, args["body"]).compile, FAST_COMPILE)
        forwards = {dtype: future.result() for dtype, future in compiles.items()}
    logits = {(name, key): np.asarray(forwards[dt](v, b), np.float32) for name, b in args.items()
              for key, dt, v in ((jnp.float32, jnp.float32, variables), (jnp.bfloat16, jnp.bfloat16, variables16),
                                 ("rounded", jnp.float32, rounded))}
    return dict(variables=variables, variables16=variables16, predictor=predictor, scenes=scenes, logits=logits,
                f32=forwards[jnp.float32])


def _port_logits(model, scene, dtype=torch.float32):
    b = {k: torch.from_numpy(scene[k]) for k in KEYS}
    point = PointBatch(coord=b["coord"], feat=b["feat"].to(dtype), grid_coord=b["grid_coord"], valid=b["valid"],
                       num_samples=1)
    with torch.inference_mode():
        return model(point)["seg_logits"]


def _assert_labels_match(got, ref_logits, err):
    """Labels equal except where the reference's two best logits are closer than twice ``err``."""
    top2 = np.sort(ref_logits, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= 2 * err
    differ = got != ref_logits.argmax(1)
    assert not (differ & ~tie).any(), f"{int((differ & ~tie).sum())} labels differ away from a tie"


@pytest.mark.parametrize("name", ["body", "bench"])
def test_segmentor_matches_jax_f32(case, name):
    scene = case["scenes"][name]
    valid = scene["valid"]
    if name == "bench":  # the premise: both pooled levels hold more cells than their capacity
        for shift, cap in ((1, SLOT // 4), (2, SLOT // 16)):
            assert len(np.unique(scene["grid_coord"][valid] >> shift, axis=0)) > cap
    got = _port_logits(case["predictor"].model, scene)
    ref = case["logits"][(name, jnp.float32)]
    assert got.dtype == torch.float32 and got.shape == (SLOT, 5)
    got = got.numpy()[valid]
    err = F32_TOL * max(1.0, float(np.abs(ref[valid]).max()))
    np.testing.assert_allclose(got, ref[valid], rtol=0, atol=err)
    _assert_labels_match(got.argmax(1), ref[valid], err)


@pytest.mark.parametrize("name", ["body", "bench"])
def test_segmentor_bf16_matches_jax_bf16(case, name):
    model = build_model(CFG).eval()
    model.load_state_dict(convert_variables(case["variables"]))
    cast_parameters(model, torch.bfloat16)
    assert model.seg_head.weight.dtype == torch.bfloat16
    assert model.backbone.stem_norm.running_var.dtype == torch.float32
    scene = case["scenes"][name]
    valid = scene["valid"]
    got = _port_logits(model, scene, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()[valid]
    ref16, ref32 = case["logits"][(name, jnp.bfloat16)][valid], case["logits"][(name, jnp.float32)][valid]
    ref32r = case["logits"][(name, "rounded")][valid]
    jax_err = float(np.abs(ref16 - ref32).max())
    port_err = float(np.abs(got - ref16).max())
    jax_err_r, port_err_r = float(np.abs(ref16 - ref32r).max()), float(np.abs(got - ref32r).max())
    scale = max(1.0, float(np.abs(ref32).max()))
    print(f"{name}: port bf16 vs JAX bf16 {port_err:.4g}, JAX bf16 vs JAX f32 {jax_err:.4g} "
          f"({jax_err / scale:.4g} of max(1, max|f32|)), port bf16 vs JAX f32 "
          f"{float(np.abs(got - ref32).max()):.4g}; on the rounded params, JAX bf16 vs JAX f32 {jax_err_r:.4g}, "
          f"port bf16 vs JAX f32 {port_err_r:.4g}; argmax agreement with JAX f32 "
          f"{float((got.argmax(1) == ref32.argmax(1)).mean()):.4f}")
    assert 0 < jax_err and port_err <= 2 * jax_err
    assert port_err_r >= jax_err_r / 4  # the port rounds to bf16 as JAX does, not only its params


def test_bench_backbone_builds():
    """``bench.py``'s model dict, ``chain_cpe0="direct"`` included, builds as it stands."""
    cfg = bench.model_config()
    assert cfg["backbone"]["chain_cpe0"] == "direct" and cfg["backbone"]["kmap_depth"] == 10
    model = build_model(cfg)
    assert model.backbone.slot_divisors == (1, 4, 16, 64, 128)
    assert [model.backbone._stage_cap(bench.POINTS, s) for s in range(5)] == [102400, 25600, 7168, 2048, 1024]
    with pytest.raises(NotImplementedError):
        build_model(dict(cfg, backbone=dict(cfg["backbone"], kmap_mode="chain")))


def test_convert_casts_params_only(case):
    state = convert_variables(case["variables"])
    assert set(state) == set(build_model(CFG).state_dict())
    model = build_model(CFG)
    model.load_state_dict(state)
    cast_parameters(model, torch.bfloat16)
    assert model.seg_head.weight.dtype == torch.bfloat16
    assert model.backbone.stem_weight.dtype == torch.bfloat16
    assert model.backbone.stem_norm.running_mean.dtype == torch.float32
    assert model.backbone.stem_norm.running_var.dtype == torch.float32


def test_segmentor_raises_on_targets(case):
    """With targets the segmentor computes its criteria's loss (``test_torch_segtrain.py`` holds it
    against JAX); a criterion that is not ported raises when the model is built."""
    scene = case["scenes"]["body"]
    b = {k: torch.from_numpy(scene[k]) for k in KEYS}
    point = PointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"], num_samples=1)
    with torch.no_grad():
        out = case["predictor"].model(point, dict(segment=torch.zeros(SLOT, dtype=torch.int32)))
    assert out["loss"].dtype == torch.float32 and torch.isfinite(out["loss"])
    with pytest.raises(NotImplementedError, match="FocalLoss"):
        build_model(dict(CFG, criteria=[dict(type="FocalLoss")]))


def _jax_server(case):
    predictor = JaxSegPredictor(types.SimpleNamespace(model=CFG), None, SLOT)
    f32 = case["f32"]
    predictor._built = (case["variables"], lambda v, b: jnp.argmax(f32(v, {k: b[k] for k in KEYS}), -1))
    return predictor


def test_segment_predictor_matches_jax_server(case):
    """On a cloud with one point per voxel, the only clouds ``tools/serve.py`` answers (see
    ``inference/segment.py``): its answer for point i is the port's for point k, where k is the
    rank of point i's code (``inverse``)."""
    rng = np.random.default_rng(4)
    lattice = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coord = (lattice * 100.0 + rng.normal(0, 5, lattice.shape)).astype(np.float32)
    feat = rng.normal(size=(coord.shape[0], 4)).astype(np.float32)
    port = case["predictor"]
    data, inverse = port.prepare(coord, feat, 0.05)
    assert data["coord"].shape[0] == coord.shape[0]  # one point per voxel
    got = port.predict(coord, feat, 0.05)
    ref = _jax_server(case).predict(coord, feat, grid_size=0.05)
    assert got.dtype == np.float32 and got.shape == ref.shape == (coord.shape[0],)
    logits = port.forward(data)[inverse]  # each point's voxel's logits
    _assert_labels_match(ref.astype(np.int64), logits[inverse], F32_TOL * max(1.0, float(np.abs(logits).max())))
    np.testing.assert_array_equal(got, logits.argmax(1))


def test_segment_predictor_labels_every_point(case):
    """A body cloud whose points share voxels: every point gets its voxel's label, and the voxels'
    labels are JAX's on the predictor's rows."""
    cloud = _body_request(1, 600)
    port = case["predictor"]
    data, inverse = port.prepare(cloud[:, :3], cloud[:, 3:], GRID)
    n = data["coord"].shape[0]
    assert n < cloud.shape[0]  # voxels are shared
    got = port.predict(cloud[:, :3], cloud[:, 3:], GRID)
    assert got.shape == (cloud.shape[0],) and got.dtype == np.float32
    scene = case["scenes"]["body"]
    np.testing.assert_array_equal(scene["grid_coord"][:n], data["grid_coord"])
    ref = case["logits"][("body", jnp.float32)][:n]
    _assert_labels_match(got.astype(np.int64), ref[inverse], F32_TOL * max(1.0, float(np.abs(ref).max())))
    with pytest.raises(ValueError, match="slot size"):
        SegmentPredictor(CFG, slot_size=64, device="cpu").prepare(cloud[:, :3], cloud[:, 3:], GRID)


def test_pigseg_server_round_trip(case):
    predictor = serve.build_predictor("pigseg", types.SimpleNamespace(model=CFG), convert_variables(case["variables"]),
                                      SLOT, "cpu")
    cloud = _body_request(2, 200)  # at most 200 voxels at the server's grid of 0.02
    server = serve.make_server(predictor, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        replies = []
        for cols in (7, 3):  # with the request's normals and curvature, and estimated
            url = f"http://127.0.0.1:{server.server_address[1]}/predict?cols={cols}"
            body = cloud[:, :cols].astype(np.float32).tobytes()
            with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=60) as r:
                replies.append(np.frombuffer(r.read(), np.float32))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    np.testing.assert_array_equal(replies[0], predictor.predict(cloud[:, :3], cloud[:, 3:]))
    np.testing.assert_array_equal(replies[1], predictor.predict(cloud[:, :3]))


def test_bench_prints_one_json_line(monkeypatch, capsys):
    """The CLI, its scene and its timing rule on the CPU; the full-width model runs on the card."""
    narrow = dict(BACKBONE, in_channels=6, enc_patch_size=(bench.PATCH,) * 3, dec_patch_size=(bench.PATCH,) * 2)
    monkeypatch.setattr(bench, "model_config", lambda: dict(CFG, backbone=narrow, num_classes=20, criteria=()))
    monkeypatch.setattr(bench, "WINDOWS", (1, 2))
    bench.main(["--points", "2048", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "ptv3_semseg_forward_scenes_per_sec" and result["value"] > 0
    assert set(result) == {"metric", "value", "unit"} and "cpu" in result["unit"]
