"""The port's OctFormer-v1m1 and its heads against the JAX package on the CPU.

A small OctFormer (channels 16, 32; 2 Blocks per stage, the second of each
dilated; heads 2, 4; patch 16, dilation 2; drop path 0) over 2 samples of
144 slots with 12 pad rows, coordinates uniform in [0, 1.2) at grid 0.05 with
one point per voxel (as GridSample leaves a cloud; two points in one voxel
make JAX's sort-merge map and the port's searchsorted map pick different
rows).  The slot is 144, not 128: a dilated patch spans two samples only where
a sample's rows of one residue, S / D, are no multiple of the patch (S = 128,
D = 2 and patch 16 align every patch with a sample), and the test asserts
that some patch does.  With the same seeded weights (names from
``jax.eval_shape``, carried over by ``convert.py``): ``DefaultSegmentorV2``'s
eval forward over it (the backbone's features, read off JAX's
``backbone_feat``, the logits and the loss); one training step of
``KeypointOctFormer`` over its first stage (a plain and a dilated Block;
JAX's Dropout mask read off its output and put into the port's) and of
``OffsetKeypointOctFormer`` over both stages at one Block each (pooling and
the decoder): the outputs, the losses and every gradient by ``convert.py``
name, the running statistics after it; ``SubMConv`` with a bias.  JAX
compiles its three references as one function, in a thread started by the
file's first test, with XLA's cheaper CPU passes.

Tolerance: f32 within 1e-4 x max(1, max|ref|) per tensor (outputs, losses,
gradients); running statistics 1e-6.  ``KeypointModel``'s first Dense feeds
a training-mode BatchNorm, so its bias's gradient is 0 up to rounding on
both sides: each side's within 1e-4 x the largest gradient of that norm's
bias.
"""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_like

from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models.sparse_unet import SubMConv as JaxSubMConv
from pointcept_keypointdetection_tpu.ops import sparse as jax_sparse
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.models.octformer import dilated_perm
from pointcept_keypointdetection_tpu_torch.models.sparse_unet import SubMConv
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch
from pointcept_keypointdetection_tpu_torch.ops import sparse

SLOT, SAMPLES, PADS, K = 144, 2, 12, 6
BACKBONE = dict(type="OctFormer-v1m1", in_channels=4, channels=(16, 32), num_blocks=(2, 2), num_heads=(2, 4),
                patch_size=16, dilation=2, slot_divisors=(1, 2), drop_path_rate=0.0)
# the training steps split the backbone's parts between them: one stage of a plain and a dilated Block
# under the keypoint head, two stages of one plain Block under the offset head (pooling and the decoder)
MODELS = {
    "seg": dict(type="DefaultSegmentorV2", num_classes=3, backbone_out_channels=16, backbone=BACKBONE,
                criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]),
    "keypoint": dict(type="KeypointOctFormer", num_keypoints=K, hidden_dim=32, backbone_conf=dict(
        BACKBONE, channels=(16,), num_blocks=(2,), num_heads=(2,), slot_divisors=(1,))),
    "offset": dict(type="OffsetKeypointOctFormer", num_keypoints=K, hidden_dim=32,
                   backbone_conf=dict(BACKBONE, num_blocks=(1, 1))),
}
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
TOL = 1e-4


def _batch(seed):
    """2 slots of 132 unique voxels in [0, 24)^3 and 12 pads, coordinates in [0, 1.2), and targets."""
    rng = np.random.default_rng(seed)
    n = SAMPLES * SLOT
    grid = np.zeros((n, 3), np.int32)
    valid = np.zeros(n, bool)
    for b in range(SAMPLES):
        cells = rng.choice(24**3, SLOT - PADS, replace=False)
        grid[b * SLOT : b * SLOT + SLOT - PADS] = np.stack(np.unravel_index(cells, (24,) * 3), 1)
        valid[b * SLOT : b * SLOT + SLOT - PADS] = True
    coord = ((grid + rng.uniform(0, 1, grid.shape)) * 0.05).astype(np.float32)
    feat = rng.normal(size=(n, 4)).astype(np.float32) * valid[:, None]
    return dict(coord=coord, feat=feat, grid_coord=grid, valid=valid,
                keypoint=rng.uniform(0.1, 1.1, (SAMPLES, K, 3)).astype(np.float32),
                scale=rng.uniform(300, 900, SAMPLES).astype(np.float32),
                keypoint_offset=rng.normal(0, 0.1, (n, K, 3)).astype(np.float32),
                keypoint_mask=(rng.uniform(size=(n, K)) < 0.3).astype(np.float32),
                segment=rng.integers(0, 3, n).astype(np.int32))


def _jax_point(b):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES)


def _port_point(b):
    return PointBatch(coord=torch.from_numpy(b["coord"]), feat=torch.from_numpy(b["feat"]),
                      grid_coord=torch.from_numpy(b["grid_coord"]), valid=torch.from_numpy(b["valid"]),
                      num_samples=SAMPLES)


def _captured(mdl, method):
    return method == "__call__" and (isinstance(mdl, fnn.Dropout) or type(mdl).__name__ == "MaskedBatchNorm")


def _conv_case():
    """A k=3 map of the first sample's voxels, features [N, 16] and the seeded conv variables."""
    b = _batch(3)
    rows = slice(0, SLOT)
    return b["grid_coord"][rows], b["valid"][rows], b["feat"][rows].repeat(4, 1), np.random.default_rng(9)


def _backbone_names(bb):
    """The flax modules of an OctFormer of ``bb``'s stages and Blocks (every one in the test's full backbone)."""
    stages = len(bb["channels"])
    names = ["embed"] + [f"stage{s}_block{i}" for s in range(stages) for i in range(bb["num_blocks"][s])]
    names += [f"down{s}" for s in range(1, stages)]
    return names + [f"up{s}_{part}" for s in range(stages - 1) for part in ("proj", "skip", "norm")]


def _jax_reference():
    b = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    models = {key: jax_build_model(dict(cfg)) for key, cfg in MODELS.items()}
    # the names and shapes of jax.eval_shape: the full backbone's from the segmentor's init, each head's
    # from its model's init over a backbone of no Blocks; the heads' backbones take their subtrees
    shapes = {"seg": jax.eval_shape(lambda: models["seg"].init({"params": jax.random.PRNGKey(0)}, _jax_point(b), b,
                                                                train=False))}
    for key in ("keypoint", "offset"):
        bare = jax_build_model(dict(MODELS[key], backbone_conf=dict(BACKBONE, channels=(16,), num_blocks=(0,),
                                                                    num_heads=(2,), slot_divisors=(1,))))
        head = jax.eval_shape(lambda m=bare: m.init({"params": jax.random.PRNGKey(0)}, _jax_point(b), b, train=False))
        full = shapes["seg"]["params"]["OctFormer_0"]
        head["params"]["OctFormer_0"] = {name: full[name] for name in _backbone_names(MODELS[key]["backbone_conf"])}
        shapes[key] = head
    variables = {key: jax_variables_like(shapes[key], np.random.default_rng(10 + i))
                 for i, key in enumerate(models)}
    grid, valid, feat, rng = _conv_case()
    conv = JaxSubMConv(16, jax_sparse.SparseConvSpec.cube(3), use_bias=True)

    def conv_apply(cv):
        batch0 = jnp.zeros(SLOT, jnp.int32)
        index = jax_sparse.build_voxel_index(jnp.asarray(grid), batch0, jnp.asarray(valid), 16)
        kmap = jax_sparse.build_kernel_map(index, jnp.asarray(grid), batch0, jnp.asarray(valid),
                                           jax_sparse.SparseConvSpec.cube(3), 16)
        return kmap, conv.apply(cv, jnp.asarray(feat), kmap) if cv is not None else None

    conv_vars = jax_variables_like(jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                                                                    conv_apply(None)[0])), rng)

    def step(key, params, batch_stats):
        def loss_fn(p):
            out, mutated = models[key].apply(
                {"params": p, "batch_stats": batch_stats}, _jax_point(b), b, train=True,
                mutable=["batch_stats", "intermediates"], rngs={"dropout": jax.random.PRNGKey(7)},
                capture_intermediates=_captured)
            return out["loss"], (out, mutated)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def run(v, cv):
        seg, inter = models["seg"].apply(v["seg"], _jax_point(b), b, train=False, mutable=["intermediates"])
        steps = {key: step(key, v[key]["params"], v[key].get("batch_stats", {})) for key in ("keypoint", "offset")}
        return seg, inter, conv_apply(cv)[1], steps

    seg, inter, conv_out, steps = jax.jit(run).lower(variables, conv_vars).compile(FAST_COMPILE)(variables, conv_vars)
    out = {}
    for key, ((_, (outputs, mutated)), grads) in steps.items():
        out[key] = dict(outputs=jax.tree.map(np.asarray, outputs), grads=jax.tree.map(np.array, grads),
                        stats=jax.tree.map(np.array, mutated.get("batch_stats", {})),
                        inter=jax.tree.map(np.asarray, mutated.get("intermediates", {})))
    return dict(variables=variables, steps=out, seg=jax.tree.map(np.asarray, seg),
                backbone_feat=np.asarray(inter["intermediates"]["backbone_feat"][0]),
                conv=dict(variables=conv_vars, out=np.asarray(conv_out)))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def _model(key, variables):
    model = build_model(dict(MODELS[key]))
    state = convert_variables(variables)
    assert set(state) == set(model.state_dict())  # convert.py names every parameter and statistic
    model.load_state_dict(state)
    return model


def _close(got, ref, what, tol=TOL):
    ref = torch.tensor(np.asarray(ref))
    torch.testing.assert_close(got.detach().float(), ref, rtol=0, atol=tol * max(1.0, ref.abs().max().item()),
                               msg=lambda m: f"{what}: {m}")


def _check_step(key, model, out, ref, scalars):
    for name in scalars:
        np.testing.assert_allclose(out[name].item(), float(ref["outputs"][name]), rtol=TOL, err_msg=name)
    out["loss"].backward()
    grads = convert_variables({"params": ref["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, g in grads.items():
        if key == "keypoint" and name == "head.0.bias":  # 0 up to rounding (the docstring)
            scale = grads["head.1.bias"].abs().max().item()
            for side in (params[name].grad, g):
                assert side.abs().max().item() <= TOL * scale, name
            continue
        _close(params[name].grad, g, f"{key} gradient {name}")
    stats = convert_variables({"batch_stats": ref["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, s in stats.items():
        torch.testing.assert_close(buffers[name], s, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def test_some_dilated_patch_spans_two_samples():
    """At both levels of the test's backbone a dilated patch holds rows of both samples, so the
    per-pair sample mask is exercised (and pad rows share patches with valid ones)."""
    model = build_model(dict(BACKBONE))
    point = _port_point(_batch(1)).serialize(orders=("z",))
    spans = []
    for n, cap in ((SAMPLES * SLOT, SLOT), (SAMPLES * model._stage_cap(SLOT, 1), model._stage_cap(SLOT, 1))):
        order = dilated_perm(torch.arange(n), BACKBONE["dilation"])
        batch = (order // cap).reshape(-1, BACKBONE["patch_size"])
        spans.append(int((batch.min(1).values != batch.max(1).values).sum()))
    assert all(s > 0 for s in spans), spans
    assert point.serialized_order.shape == (1, SAMPLES * SLOT)


def test_segmentor_forward_matches_jax(reference):
    model = _model("seg", reference["variables"]["seg"]).eval()
    b = _batch(1)
    feats = {}
    model.backbone.register_forward_hook(lambda m, i, o: feats.__setitem__("backbone", o))
    with torch.no_grad():
        out = model(_port_point(b), {k: torch.from_numpy(v) for k, v in b.items()})
    assert out["seg_logits"].shape == (SAMPLES * SLOT, 3)
    _close(feats["backbone"], reference["backbone_feat"], "backbone features")
    _close(out["seg_logits"], reference["seg"]["seg_logits"], "seg_logits")
    np.testing.assert_allclose(out["loss"].item(), float(reference["seg"]["loss"]), rtol=TOL)


def test_keypoint_octformer_training_step_matches_jax(reference, monkeypatch):
    ref = reference["steps"]["keypoint"]
    inter = ref["inter"]
    dropped = inter["Dropout_0"]["__call__"][0]
    kept_in = np.maximum(inter["MaskedBatchNorm_0"]["__call__"][0], 0)  # the Dropout's input: ReLU of the norm
    mask = torch.from_numpy(np.where(kept_in > 0, dropped != 0, True))
    model = _model("keypoint", reference["variables"]["keypoint"]).train()
    monkeypatch.setattr(model.head[3], "forward",
                        lambda x, generator: torch.where(mask, x / (1.0 - 0.3), torch.zeros((), dtype=x.dtype)))
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = model(_port_point(_batch(1)), b, torch.Generator().manual_seed(0))
    _close(out["keypoint_pred"], ref["outputs"]["keypoint_pred"], "keypoint_pred")
    _check_step("keypoint", model, out, ref, ("loss", "mean_dist"))


def test_offset_keypoint_octformer_training_step_matches_jax(reference):
    ref = reference["steps"]["offset"]
    model = _model("offset", reference["variables"]["offset"]).train()
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = model(_port_point(_batch(1)), b, torch.Generator().manual_seed(0))
    for name in ("offset_pred", "mask_logits"):
        _close(out[name], ref["outputs"][name], name)
    _check_step("offset", model, out, ref, ("loss", "cls_loss", "reg_loss"))


def test_subm_conv_bias_matches_jax(reference):
    """``SubMConv(bias=True)``: the conv over the map plus the bias, as JAX's ``use_bias``."""
    grid, valid, feat, _ = _conv_case()
    conv = SubMConv(16, 16, 3, bias=True)
    params = reference["conv"]["variables"]["params"]
    conv.load_state_dict({"weight": torch.from_numpy(params["weight"]), "bias": torch.from_numpy(params["bias"])})
    g, v, b0 = torch.from_numpy(grid), torch.from_numpy(valid), torch.zeros(SLOT, dtype=torch.int64)
    kmap = sparse.build_kernel_map(sparse.build_voxel_index(g, b0, v), g, b0, v, sparse.SparseConvSpec.cube(3))
    with torch.no_grad():
        out = conv(torch.from_numpy(feat), kmap)
        plain = SubMConv(16, 16, 3)
        plain.load_state_dict({"weight": conv.weight})
        np.testing.assert_allclose((out - plain(torch.from_numpy(feat), kmap)).numpy(),
                                   np.broadcast_to(params["bias"], out.shape), rtol=0, atol=1e-6)
    _close(out, reference["conv"]["out"], "SubMConv with bias")
    assert SubMConv(16, 16, 3).bias is None and "bias" not in SubMConv(16, 16, 3).state_dict()
