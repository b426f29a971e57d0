"""The port's OffsetKeypoint PT-v3m1, predictor and server against the JAX package.

A small model (2 stages, stage 1 of depth 2 so that ``convert.py`` splits an
``nn.scan`` stack, channels <= 24, patch 32, slot 256, k=5 stem) gets seeded
JAX parameters (``jax.eval_shape`` shapes, numpy values), one jitted JAX
apply, and the same weights converted into the port.  Outputs on valid rows
agree within 5e-5 (f32 sums in another order through four blocks).
"""

import functools
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_parity import jax_variables_like

from pointcept_keypointdetection_tpu.inference.keypoint import OffsetKeypointPredictor as JaxPredictor
from pointcept_keypointdetection_tpu.inference.keypoint import aggregate_keypoints as jax_aggregate
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu_torch import serve
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets.collate import pad_sample
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import body_cloud
from pointcept_keypointdetection_tpu_torch.inference.keypoint import OffsetKeypointPredictor
from pointcept_keypointdetection_tpu_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT = 256
GRID = 0.1
CFG = dict(
    type="OffsetKeypointPTv3",
    num_keypoints=6,
    hidden_dim=32,
    backbone_conf=dict(
        type="PT-v3m1", in_channels=4, stride=(2,), enc_depths=(1, 2), enc_channels=(16, 24),
        enc_num_head=(1, 2), enc_patch_size=(32, 32), dec_depths=(1,), dec_channels=(16,),
        dec_num_head=(1,), dec_patch_size=(32,), slot_divisors=(1, 2), drop_path=0.0,
    ),
)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    coord = body_cloud(rng, n)
    return coord, rng.normal(size=(n, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """Seeded JAX variables, the port's prepared rows of one cloud, and JAX's outputs on them."""
    rng = np.random.default_rng(0)
    model = jax_build_model(CFG)
    coord, feat = _cloud(1, 300)

    def point_of(b):
        return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                             num_samples=1)

    zeros = dict(coord=jnp.zeros((SLOT, 3)), feat=jnp.zeros((SLOT, 4)), grid_coord=jnp.zeros((SLOT, 3), jnp.int32),
                 valid=jnp.ones((SLOT,), bool))
    shapes = jax.eval_shape(functools.partial(model.init, train=False), {"params": jax.random.PRNGKey(0)},
                            point_of(zeros), zeros)
    variables = jax_variables_like(shapes, rng)
    state = convert_variables(variables)
    predictor = OffsetKeypointPredictor(CFG, state, slot_size=SLOT, device="cpu")
    data, centroid, scale = predictor.prepare(coord, feat, GRID)
    batch = pad_sample(data, SLOT)
    assert 0 < data["coord"].shape[0] < SLOT  # pads present
    args = (variables, {k: jnp.asarray(batch[k]) for k in ("coord", "feat", "grid_coord", "valid")})
    # XLA's cheaper CPU passes: the compile is most of the file's time, and the numbers do not need them
    out = jax.jit(lambda v, b: model.apply(v, point_of(b), b, train=False)).lower(*args).compile(FAST_COMPILE)(*args)
    return dict(state=state, predictor=predictor, coord=coord, feat=feat, data=data, centroid=centroid,
                scale=scale, jax_out=jax.tree.map(np.asarray, out))


def test_model_matches_jax(case):
    res = case["predictor"].forward(case["data"])
    n = case["data"]["coord"].shape[0]
    for key in ("offset_pred", "mask_logits"):
        np.testing.assert_allclose(res[key], case["jax_out"][key][:n], rtol=5e-5, atol=5e-5, err_msg=key)


def test_stem_weight_cache_follows_load_state_dict(case):
    predictor = OffsetKeypointPredictor(CFG, slot_size=SLOT, device="cpu")  # seeded weights
    stale = predictor.forward(case["data"])  # builds and keeps the packed stem weight
    predictor.model.load_state_dict(case["state"])
    res = predictor.forward(case["data"])
    ref = case["predictor"].forward(case["data"])
    for key in ("offset_pred", "mask_logits"):
        np.testing.assert_allclose(res[key], ref[key], rtol=0, atol=1e-6, err_msg=key)
    assert not np.allclose(stale["offset_pred"], res["offset_pred"], atol=1e-3)


def test_convert_splits_scan_stacks(case):
    state = case["state"]
    assert "backbone.enc1_block1.attn.qkv.weight" in state and "backbone.enc1_blocks" not in str(list(state))
    assert set(state) == set(build_model(CFG).state_dict())


@pytest.mark.parametrize("method", ["argmax", "weighted"])
def test_predictor_matches_jax(case, method):
    got = case["predictor"].predict(case["coord"], case["feat"], GRID, method=method)
    n = case["data"]["coord"].shape[0]
    out = case["jax_out"]
    prob = np.asarray(jax.nn.sigmoid(out["mask_logits"]))[:n]
    ref = jax_aggregate(case["data"]["coord"], out["offset_pred"][:n], prob, method) * case["scale"] + case["centroid"]
    assert got.shape == (6, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * case["scale"])


def test_prepare_matches_jax_predictor():
    """Same voxel pick, coord-prefix rule and deterministic subsample as the JAX predictor."""
    coord, feat = _cloud(2, 2000)
    port = OffsetKeypointPredictor(CFG, slot_size=SLOT, device="cpu")
    jax_pred = JaxPredictor(CFG, slot_size=SLOT)
    data, centroid, scale = port.prepare(coord, feat[:, :1], GRID)  # 1 + 3 = in_channels: coords prefixed
    ref, ref_centroid, ref_scale, _ = jax_pred._prepare(coord, feat[:, :1], GRID)
    n = ref["coord"].shape[0]
    assert n > SLOT and data["feat"].shape == (SLOT, 4)
    keep = np.sort(np.random.default_rng(0).choice(n, SLOT, replace=False))  # as JAX predict() does
    for key in ("coord", "feat", "grid_coord"):
        np.testing.assert_array_equal(data[key], ref[key][keep], err_msg=key)
    np.testing.assert_array_equal(centroid, ref_centroid)
    assert scale == ref_scale


class _CoordEcho(nn.Module):
    """offset = -coord, so each candidate is 0 exactly when the outputs stay on their rows."""

    def forward(self, point):
        n = point.coord.shape[0]
        return {"offset_pred": -point.coord[:, None, :].expand(n, 6, 3),
                "mask_logits": point.coord[:, :1].expand(n, 6) * 10}


@pytest.mark.parametrize("method", ["argmax", "weighted"])
def test_predictor_rows_stay_aligned_above_slot_size(method):
    coord, feat = _cloud(3, 3000)
    predictor = OffsetKeypointPredictor(CFG, slot_size=SLOT, device="cpu")
    assert predictor.prepare(coord, feat, GRID)[0]["coord"].shape[0] == SLOT  # subsampled
    predictor.model = _CoordEcho()
    got = predictor.predict(coord, feat, GRID, method=method)
    np.testing.assert_allclose(got, np.broadcast_to(coord.mean(0), (6, 3)), rtol=0, atol=1e-3)


def test_pad_sample_subsamples_only_with_a_generator():
    sample = dict(coord=np.arange(30, dtype=np.float32).reshape(10, 3), feat=np.ones((10, 2), np.float32))
    with pytest.raises(ValueError):
        pad_sample(sample, 4)
    a = pad_sample(sample, 4, np.random.default_rng(5))
    b = pad_sample(sample, 4, np.random.default_rng(5))
    np.testing.assert_array_equal(a["coord"], b["coord"])
    assert a["valid"].all() and a["coord"].shape == (4, 3)
    padded = pad_sample(sample, 16)
    assert padded["valid"].sum() == 10 and (padded["coord"][10:] == 0).all()


def test_server_answers_like_the_predictor(case):
    predictor = case["predictor"]
    server = serve.make_server(predictor, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = np.concatenate([case["coord"], case["feat"]], axis=1).astype(np.float32).tobytes()
        url = f"http://127.0.0.1:{server.server_address[1]}/predict?method=weighted"
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=60) as r:
            got = np.frombuffer(r.read(), np.float32).reshape(-1, 3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    np.testing.assert_allclose(got, predictor.predict(case["coord"], case["feat"], method="weighted"), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown task"):
        serve.build_predictor("segment", None)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, pointcept_keypointdetection_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'): importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack', 'ml_dtypes',\n"
        "                                                    'pointcept_keypointdetection_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_predictor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        OffsetKeypointPredictor(CFG, slot_size=SLOT)
