"""The port's Swin3D-v1m1, ``three_nn_interpolate`` and ``KeypointSwin3DVote`` against the JAX package
on the CPU.

``three_nn_interpolate`` (the brute path) against JAX's, called eagerly as
the port's ``knn`` rounds: equal picks, and a sample with fewer than 3 valid
base points takes JAX's fillers (its bucketed path, ``cell_size`` > 0, and
``KnnUpsample`` with a cell are ``tests/test_torch_stratified.py``'s, beside
``knn_bucketed``).  Swin3D (2 samples of 128 slots with 12
pad rows, coordinates uniform in [0, 1.2) at grid 0.05, patch 32, windows of
4, a plain and a shifted Block per stage, drop path 0) in each cRSE mode:
``XYZ`` and ``XYZ_RGB_NORM`` (6 input channels, quant 2) over one stage,
``XYZ_RGB`` (4 input channels, the rest of the signal zeros) over two stages
(a plain and a shifted Block, grid down-sampling, a Block, the 3-NN
up-sampling and a decoder Block); one training step of
``KeypointSwin3DVote`` over one stage of one Block (the outputs, the loss, ``mean_dist``,
every gradient by ``convert.py`` name and the running statistics).  The same seeded weights on both sides, names from
``jax.eval_shape``.  JAX compiles its forwards and its value-and-grad as one
function, in a thread started by the file's first test, with XLA's cheaper
CPU passes.  Under ``jit`` JAX's ``knn`` may round a distance otherwise than
eagerly; the test asserts that every up-sampling query's third and fourth
nearest base points lie further apart than such rounding, so the 3-NN picks
inside the model are the same on both sides.

Tolerance: f32 within 1e-4 x max(1, max|ref|) per tensor; the interpolation
1e-6 x max(1, max|ref|); running statistics 1e-6.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_like

from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.ops.knn import three_nn_interpolate as jax_three_nn
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.engines.hooks.keypoint_evaluator import KeypointEvaluator
from pointcept_keypointdetection_tpu_torch.models import build_model, init_weights
from pointcept_keypointdetection_tpu_torch.models import swin3d
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch
from pointcept_keypointdetection_tpu_torch.ops.knn import knn, three_nn_interpolate

SLOT, SAMPLES, PADS, K = 128, 2, 12, 6
ONE_STAGE = dict(type="Swin3D-v1m1", depths=(2,), channels=(16,), num_heads=(2,), window_sizes=(4,), patch_size=32,
                 slot_divisors=(1,), drop_path_rate=0.0)
TWO_STAGES = dict(ONE_STAGE, depths=(2, 2), channels=(16, 32), num_heads=(2, 4), window_sizes=(4, 4),
                  slot_divisors=(1, 2))
FORWARDS = {
    "XYZ": dict(ONE_STAGE, in_channels=4, crse="XYZ"),
    "XYZ_RGB": dict(TWO_STAGES, in_channels=4, crse="XYZ_RGB", depths=(2, 1)),
    "XYZ_RGB_NORM": dict(ONE_STAGE, in_channels=6, crse="XYZ_RGB_NORM", quant_size=2),
}
VOTE = dict(type="KeypointSwin3DVote", num_keypoints=K, hidden_dim=32, vote_radius=0.3,
            backbone_conf=dict(ONE_STAGE, in_channels=4, depths=(1,)))
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
TOL = 1e-4


def _batch(seed, channels=4):
    """2 slots of 116 unique voxels in [0, 24)^3 and 12 pads, coordinates in [0, 1.2), features in
    [-1, 1] (the cRSE's colour and normal range), keypoints among the points."""
    rng = np.random.default_rng(seed)
    n = SAMPLES * SLOT
    grid = np.zeros((n, 3), np.int32)
    valid = np.zeros(n, bool)
    for b in range(SAMPLES):
        cells = rng.choice(24**3, SLOT - PADS, replace=False)
        grid[b * SLOT : b * SLOT + SLOT - PADS] = np.stack(np.unravel_index(cells, (24,) * 3), 1)
        valid[b * SLOT : b * SLOT + SLOT - PADS] = True
    coord = ((grid + rng.uniform(0, 1, grid.shape)) * 0.05).astype(np.float32)
    feat = rng.uniform(-1, 1, (n, channels)).astype(np.float32) * valid[:, None]
    return dict(coord=coord, feat=feat, grid_coord=grid, valid=valid,
                keypoint=rng.uniform(0.2, 1.0, (SAMPLES, K, 3)).astype(np.float32),
                scale=rng.uniform(300, 900, SAMPLES).astype(np.float32))


def _jax_point(b):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES)


def _port_point(b):
    return PointBatch(coord=torch.from_numpy(b["coord"]), feat=torch.from_numpy(b["feat"]),
                      grid_coord=torch.from_numpy(b["grid_coord"]), valid=torch.from_numpy(b["valid"]),
                      num_samples=SAMPLES)


def _three_nn_case():
    """Two samples of base points, the second with 2 valid ones: its third neighbour is JAX's filler."""
    rng = np.random.default_rng(4)
    base_valid = np.ones(40, bool)
    base_valid[22:] = False
    return (rng.uniform(0, 1, (50, 3)).astype(np.float32), rng.uniform(0, 1, (40, 3)).astype(np.float32),
            rng.normal(size=(40, 8)).astype(np.float32), np.repeat(np.arange(2), 25).astype(np.int32),
            np.repeat(np.arange(2), 20).astype(np.int32), base_valid)


def _jax_reference():
    case = tuple(map(jnp.asarray, _three_nn_case()))  # eagerly: knn's rounding outside jit
    three_nn = {"batched": np.asarray(jax_three_nn(*case)), "unbatched": np.asarray(jax_three_nn(*case[:3]))}
    models = {key: jax_build_model(dict(cfg)) for key, cfg in FORWARDS.items()}
    models["vote"] = jax_build_model(dict(VOTE))
    batches = {key: {k: jnp.asarray(v) for k, v in _batch(1, cfg["in_channels"]).items()}
               for key, cfg in FORWARDS.items()}
    batches["vote"] = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    variables = {}
    for i, (key, model) in enumerate(models.items()):
        b = batches[key]
        args = (_jax_point(b), b) if key == "vote" else (_jax_point(b),)
        shapes = jax.eval_shape(lambda m=model, a=args: m.init({"params": jax.random.PRNGKey(0)}, *a, train=False))
        variables[key] = jax_variables_like(shapes, np.random.default_rng(20 + i))

    def run(v):
        forwards = {key: models[key].apply(v[key], _jax_point(batches[key]), train=False) for key in FORWARDS}
        b = batches["vote"]

        def loss_fn(p):
            out, mutated = models["vote"].apply({"params": p, "batch_stats": v["vote"]["batch_stats"]},
                                                _jax_point(b), b, train=True, mutable=["batch_stats"])
            return out["loss"], (out, mutated["batch_stats"])

        return forwards, jax.value_and_grad(loss_fn, has_aux=True)(v["vote"]["params"])

    forwards, ((_, (outputs, stats)), grads) = jax.jit(run).lower(variables).compile(FAST_COMPILE)(variables)
    return dict(variables=variables, three_nn=three_nn, forwards=jax.tree.map(np.asarray, forwards),
                vote=dict(outputs=jax.tree.map(np.asarray, outputs), grads=jax.tree.map(np.array, grads),
                          stats=jax.tree.map(np.array, stats)))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def _model(cfg, variables):
    model = build_model(dict(cfg))
    state = convert_variables(variables)
    assert set(state) == set(model.state_dict())  # convert.py names every parameter and statistic
    model.load_state_dict(state)
    return model


def _close(got, ref, what, tol=TOL):
    ref = torch.tensor(np.asarray(ref))
    torch.testing.assert_close(got.detach().float(), ref, rtol=0, atol=tol * max(1.0, ref.abs().max().item()),
                               msg=lambda m: f"{what}: {m}")


def _upsampling_queries(model, b):
    """Run the port's model on ``b``, recording each KnnUpsample's (skip, pooled) batches."""
    seen = []
    plain = swin3d.KnnUpsample.forward

    def record(self, pooled, skip):
        seen.append((skip, pooled))
        return plain(self, pooled, skip)

    swin3d.KnnUpsample.forward = record
    try:
        out = model(_port_point(b))
    finally:
        swin3d.KnnUpsample.forward = plain
    return out, seen


def _assert_clear_third_neighbour(seen):
    """Each query's 3rd and 4th nearest valid base points of its sample lie more than 1e-5 x d3 apart
    (f32 rounding moves a squared distance by ~1e-7 of it), so both packages pick the same three."""
    assert seen
    for skip, pooled in seen:
        _, sqd = knn(skip.coord, pooled.coord, 4, skip.batch, pooled.batch, pooled.valid)
        gap = sqd[:, 3] - sqd[:, 2]
        assert bool((gap > 1e-5 * sqd[:, 2]).all()), float((gap / sqd[:, 2]).min())


def test_three_nn_interpolate_matches_jax(reference):
    args = tuple(map(torch.from_numpy, _three_nn_case()))
    _close(three_nn_interpolate(*args), reference["three_nn"]["batched"], "three_nn_interpolate", 1e-6)
    _close(three_nn_interpolate(*args[:3]), reference["three_nn"]["unbatched"], "three_nn_interpolate unbatched",
           1e-6)


@pytest.mark.parametrize("crse", list(FORWARDS))
def test_swin3d_forward_matches_jax(reference, crse):
    cfg = FORWARDS[crse]
    model = _model(cfg, reference["variables"][crse]).eval()
    b = _batch(1, cfg["in_channels"])
    with torch.no_grad():
        out, seen = _upsampling_queries(model, b)
    if len(cfg["depths"]) > 1:
        _assert_clear_third_neighbour(seen)
    assert any(blk.attn.shifted for blk in model.modules() if isinstance(blk, swin3d.SwinBlock))
    _close(out, reference["forwards"][crse], f"Swin3D {crse}")


def test_swin3d_crse_groups_follow_the_mode():
    for crse, groups in (("XYZ", {"xyz"}), ("XYZ_RGB", {"xyz", "rgb"}), ("XYZ_RGB_NORM", {"xyz", "rgb", "norm"})):
        model = build_model(dict(ONE_STAGE, in_channels=6, crse=crse))
        names = {name.rsplit(".", 1)[-1] for name, _ in model.named_parameters() if name.endswith("_table")}
        assert names == {f"{g}_{kind}_table" for g in groups for kind in "qkv"}
    model = build_model(dict(TWO_STAGES, in_channels=4, upsample_cell_sizes=(0.1,)))
    assert model.up0.knn_cell_size == 0.1 and build_model(dict(TWO_STAGES, in_channels=4)).up0.knn_cell_size == 0


def test_vote_keypoint_swin3d_training_step_matches_jax(reference):
    ref = reference["vote"]
    model = _model(VOTE, reference["variables"]["vote"]).train()
    b = _batch(2)
    out = model(_port_point(b), {k: torch.from_numpy(v) for k, v in b.items()})
    for name in ("votes", "keypoint_pred"):
        _close(out[name], ref["outputs"][name], name)
    for name in ("loss", "mean_dist"):
        np.testing.assert_allclose(out[name].item(), float(ref["outputs"][name]), rtol=TOL, err_msg=name)
    out["loss"].backward()
    grads = convert_variables({"params": ref["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, g in grads.items():
        _close(params[name].grad, g, f"gradient {name}")
    stats = convert_variables({"batch_stats": ref["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) == {"backbone.embed_norm.running_mean", "backbone.embed_norm.running_var"}
    for name, s in stats.items():
        torch.testing.assert_close(buffers[name], s, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def test_keypoint_evaluator_reads_the_vote_head():
    """``KeypointEvaluator`` passes the batch to the model, as JAX's eval step does: the voting head's
    ``keypoint_pred`` comes from the points near the targets, so without the batch it has none."""
    model = init_weights(build_model(dict(VOTE)), torch.Generator().manual_seed(0))
    b = _batch(2)
    batch_np = dict(b, num_samples=SAMPLES)
    trainer = types.SimpleNamespace(model=model, val_loader=[batch_np], device="cpu", comm_info={},
                                    storage=types.SimpleNamespace(put_scalar=lambda *a, **k: None))
    hook = KeypointEvaluator()
    hook.trainer = trainer
    hook.after_epoch()
    with torch.no_grad():
        out = model.eval()(_port_point(b), {k: torch.from_numpy(v) for k, v in b.items()})
    want = (out["keypoint_pred"] - torch.from_numpy(b["keypoint"])).norm(dim=-1) * torch.from_numpy(b["scale"])[:, None]
    np.testing.assert_allclose(-trainer.comm_info["current_metric_value"], want.mean().item(), rtol=1e-6)
