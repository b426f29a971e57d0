"""The port's MinkUNet and SPVCNN against the JAX package on the CPU.

Three ``DefaultSegmentor`` s with a cross-entropy criterion, each over 2
samples of 128 slots (116 voxels, one point per voxel in [0, 48)^3 at grid
0.05, 12 pad rows; 4 input channels, 5 classes): MinkUNet14A and MinkUNet50
(Bottleneck) at JAX's tiny plan (``tests/test_mink_unet.py:30``: planes 8-16,
init_dim 8; MinkUNet50 at one block a stage, as ``:73`` takes it) and SPVCNN
at base width 8 (``tests/test_backbones_misc.py:71``: channels (8, 16), one
layer each, slot divisors (1, 2)).  The span keeps a few dozen voxels at the
stride-16 level: over a 24^3 span its batch statistics come from a handful
of rows, a deep step's gradients reach ~800 and f32 rounding alone moves
them by several percent between the two packages.  With the same
seeded weights (names from ``jax.eval_shape``, carried over by
``convert.py``): the training-mode forward's logits on the valid rows and
the sown ``backbone_feat`` (the logits) within 1e-4 x max(1, max|jax|); that
training step's loss (relative), every gradient by ``convert.py`` name and
the running statistics after it within 1e-3 x max(1, max|jax|).  (The
running statistics' eval path is MaskedBatchNorm's, which the SpUNet and
OA-CNNs files hold against JAX.)  SPVCNN's
``_continuous_grid``, ``voxel_to_point_trilinear`` and ``point_to_voxel``
alone on a stage of the parents at ``grid >> 1``: within 1e-5.  JAX
computes these in a thread started by the file's first test (each model's
step compiled on a thread of its own, with XLA's cheaper CPU passes) and
traces the full-width MinkUNet34C and SPVCNN configs, whose flax names and
shapes ``convert.py`` must carry onto the port's.  The fifteen MinkUNet plans
are JAX's.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import FAST_COMPILE, assert_close, jax_variables_like, port_model, slotted_scene

from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.models import PointBatch, build_model
from pointcept_keypointdetection_tpu_torch.models import mink_unet, spvcnn
from pointcept_keypointdetection_tpu_torch.utils.config import Config

SLOT, SAMPLES, VALID, SPAN = 128, 2, 116, 48
TINY = dict(in_channels=4, num_classes=5, planes=(8, 8, 16, 16, 16, 16, 8, 8), init_dim=8)
BACKBONES = {
    "MinkUNet14A": dict(type="MinkUNet14A", **TINY),
    "MinkUNet50": dict(type="MinkUNet50", layers=(1,) * 8, **TINY),
    "SPVCNN": dict(type="SPVCNN", in_channels=4, num_classes=5, base_channels=8, channels=(8, 16), layers=(1, 1),
                   slot_divisors=(1, 2)),
}
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
MODELS = {name: dict(type="DefaultSegmentor", backbone=bb, criteria=CRITERIA) for name, bb in BACKBONES.items()}
FULL_WIDTH = ("configs/semantic_kitti/semseg-minkunet34c-0-base.py", "configs/semantic_kitti/semseg-spvcnn-v1m1-0-base.py")
PLANS = ("MinkUNet14", "MinkUNet18", "MinkUNet34", "MinkUNet50", "MinkUNet101", "MinkUNet14A", "MinkUNet14B",
         "MinkUNet14C", "MinkUNet14D", "MinkUNet18A", "MinkUNet18B", "MinkUNet18D", "MinkUNet34A", "MinkUNet34B",
         "MinkUNet34C")
TOL, STEP_TOL, OP_TOL = 1e-4, 1e-3, 1e-5


def _batch():
    rng = np.random.default_rng(7)
    b = slotted_scene(rng, SAMPLES, SLOT, VALID, SPAN)
    b.pop("batch")
    b["coord"][~b["valid"]] = 0.0
    b["feat"] = (rng.normal(size=(SAMPLES * SLOT, 4)) * b["valid"][:, None]).astype(np.float32)
    b["segment"] = np.where(b["valid"], rng.integers(0, 5, SAMPLES * SLOT), -1).astype(np.int32)
    return b


def _stage(batch):
    """The parents at grid >> 1 of each sample's voxels, SLOT rows a sample, with seeded features."""
    rng = np.random.default_rng(9)
    half = SLOT
    grid = np.zeros((SAMPLES * half, 3), np.int32)
    valid = np.zeros(SAMPLES * half, bool)
    for s in range(SAMPLES):
        rows = slice(s * SLOT, (s + 1) * SLOT)
        parents = np.unique(batch["grid_coord"][rows][batch["valid"][rows]] >> 1, axis=0)
        grid[s * half: s * half + len(parents)] = parents
        valid[s * half: s * half + len(parents)] = True
    feat = (rng.normal(size=(SAMPLES * half, 6)) * valid[:, None]).astype(np.float32)
    pfeat = rng.normal(size=(SAMPLES * SLOT, 6)).astype(np.float32)
    return dict(grid_coord=grid, valid=valid, feat=feat, coord=np.zeros((SAMPLES * half, 3), np.float32)), pfeat


def _reference(batch):
    """Every JAX reading of the file: each model's training step compiled as a function of its own, on
    threads side by side; the point-voxel ops; the full-width configs' variable shapes."""
    import jax
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
    from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
    from pointcept_keypointdetection_tpu.models import spvcnn as jax_spvcnn

    b = {k: jnp.asarray(v) for k, v in batch.items()}
    point = JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                          num_samples=SAMPLES)
    stage_np, pfeat = _stage(batch)
    stage = JaxPointBatch(num_samples=SAMPLES, **{k: jnp.asarray(v) for k, v in stage_np.items()})
    models = {name: jax_build_model(dict(cfg)) for name, cfg in MODELS.items()}
    variables = {name: jax_variables_like(jax.eval_shape(
        lambda m=m: m.init({"params": jax.random.PRNGKey(0)}, point, b, train=False)), np.random.default_rng(i))
        for i, (name, m) in enumerate(models.items())}
    full = {}
    for path in FULL_WIDTH:
        m = jax_build_model(dict(Config.fromfile(path).model))
        full[path] = jax.eval_shape(lambda m=m: m.init({"params": jax.random.PRNGKey(0)}, point, b, train=False))

    def run(name, v):
        m = models[name]

        def loss_fn(p):
            step, mutated = m.apply({"params": p, "batch_stats": v["batch_stats"]}, point, b, train=True,
                                    mutable=["batch_stats", "intermediates"])
            return step["loss"], (step["seg_logits"], mutated)

        (loss, (logits, mutated)), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
        return dict(logits=logits, feat=mutated["intermediates"]["backbone_feat"][0], loss=loss, grads=grads,
                    stats=mutated["batch_stats"])

    def ops():
        cont = jax_spvcnn._continuous_grid(point, 0.05)
        return dict(cont=cont, trilinear=jax_spvcnn.voxel_to_point_trilinear(stage, point, cont, 2),
                    pooled=jax_spvcnn.point_to_voxel(stage, point, jnp.asarray(pfeat), 1))

    def compiled(name):
        fn = jax.jit(functools.partial(run, name))
        return fn.lower(variables[name]).compile(FAST_COMPILE)(variables[name])

    # side by side they took 22 s against 25 s as one function (8 CPU cores): XLA compiles one while Python
    # traces another
    with ThreadPoolExecutor(len(models)) as pool:
        futures = {name: pool.submit(compiled, name) for name in models}
        out = {"ops": jax.jit(ops).lower().compile(FAST_COMPILE)()}
        out.update({name: future.result() for name, future in futures.items()})
    out = jax.tree.map(np.array, out)
    for name in MODELS:
        out[name]["variables"] = variables[name]
    out["full"] = {path: jax.tree.map(lambda leaf: tuple(leaf.shape), shapes) for path, shapes in full.items()}
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_reference, _batch())


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def _port_point(batch):
    return PointBatch(coord=torch.from_numpy(batch["coord"]), feat=torch.from_numpy(batch["feat"]),
                      grid_coord=torch.from_numpy(batch["grid_coord"]), valid=torch.from_numpy(batch["valid"]),
                      num_samples=SAMPLES)


@pytest.mark.parametrize("plan", PLANS)
def test_plans_match_jax(plan):
    from pointcept_keypointdetection_tpu.models import MODELS as JAX_MODELS

    theirs = JAX_MODELS.build(dict(type=plan, in_channels=4, num_classes=19))
    with torch.device("meta"):
        ours = build_model(dict(type=plan, in_channels=4, num_classes=19))
    assert (ours.layers, ours.planes, ours.block) == (tuple(theirs.layers), tuple(theirs.planes), theirs.block)
    exp = 4 if theirs.block == "bottleneck" else 1
    assert ours.final.in_features == theirs.planes[7] * exp and ours.conv0.weight.shape == (125, 4, 32)


@pytest.mark.parametrize("path", FULL_WIDTH, ids=["minkunet34c", "spvcnn"])
def test_full_width_flax_names_and_shapes(reference, path):
    from flax.traverse_util import flatten_dict, unflatten_dict

    shapes = reference["full"][path]
    zeros = {col: unflatten_dict({k: np.zeros(s, np.float32) for k, s in flatten_dict(tree).items()})
             for col, tree in shapes.items()}
    state = convert_variables(zeros)
    with torch.device("meta"):
        model = build_model(dict(Config.fromfile(path).model))
    ours = model.state_dict()
    assert set(state) == set(ours)
    assert all(tuple(state[k].shape) == tuple(ours[k].shape) for k in ours)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_backbone_feat_match_jax(reference, name):
    """The training-mode forward (the batch's statistics), the forward of the step below."""
    batch, ref = _batch(), reference[name]
    model = port_model(MODELS[name], ref["variables"]).train()
    valid = batch["valid"]
    with torch.no_grad():
        out = model(_port_point(batch), backbone_feat=True)
    assert_close(out["seg_logits"][torch.from_numpy(valid)], ref["logits"][valid], f"{name} logits", TOL)
    assert_close(out["backbone_feat"][torch.from_numpy(valid)], ref["feat"][valid], f"{name} backbone_feat", TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_training_step_matches_jax(reference, name):
    batch, ref = _batch(), reference[name]
    model = port_model(MODELS[name], ref["variables"]).train()
    out = model(_port_point(batch), {"segment": torch.from_numpy(batch["segment"])})
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=STEP_TOL)
    out["loss"].backward()
    grads = convert_variables({"params": ref["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for key, g in grads.items():
        assert_close(params[key].grad, g, f"{name} gradient {key}", STEP_TOL)
    stats = convert_variables({"batch_stats": ref["stats"]})
    buffers = {k: t for k, t in model.state_dict().items() if k not in params}
    assert set(stats) == set(buffers)
    for key, s in stats.items():
        assert_close(buffers[key], s.numpy(), f"{name} running statistic {key}", STEP_TOL)


def test_spvcnn_point_voxel_ops_match_jax(reference):
    batch, ref = _batch(), reference["ops"]
    stage_np, pfeat = _stage(batch)
    point = _port_point(batch)
    stage = PointBatch(num_samples=SAMPLES, **{k: torch.from_numpy(v) for k, v in stage_np.items()})
    cont = spvcnn._continuous_grid(point, 0.05)
    assert_close(cont, ref["cont"], "continuous grid", OP_TOL)
    assert_close(spvcnn.voxel_to_point_trilinear(stage, point, cont, 2), ref["trilinear"], "trilinear", OP_TOL)
    assert_close(spvcnn.point_to_voxel(stage, point, torch.from_numpy(pfeat), 1), ref["pooled"], "pooled", OP_TOL)


def test_minkunet34c_runs_47_convs_over_6_maps(monkeypatch):
    """The recipe's MinkUNet34C: the K = 125 stem, 2 convs per BasicBlock (23 blocks), over the stem's map,
    one K = 27 map per stage and the full-resolution K = 27 map of the last decoder stage."""
    model = build_model(dict(Config.fromfile(FULL_WIDTH[0]).model.backbone, planes=(8,) * 8, init_dim=8)).eval()
    convs, maps = [], []
    plain_conv, plain_map = mink_unet.SubMConv.forward, mink_unet.kernel_map
    monkeypatch.setattr(mink_unet.SubMConv, "forward", lambda self, f, k: convs.append(self.weight.shape[0]) or
                        plain_conv(self, f, k))
    monkeypatch.setattr(mink_unet, "kernel_map", lambda p, size=3: maps.append((p.num_points, size)) or
                        plain_map(p, size))
    with torch.no_grad():
        out = model(_port_point(_batch()))
    assert out.shape == (SAMPLES * SLOT, 19) and torch.isfinite(out).all()
    assert len(convs) == 47 and convs.count(125) == 1
    assert maps == [(256, 5), (128, 3), (64, 3), (32, 3), (16, 3), (256, 3)]
