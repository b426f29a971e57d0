"""The port's global keypoint heads, the body-measure regressor and their losses against the JAX
package on the CPU.

``KeypointModel`` (``KeypointPTv3Plus`` over a one-stage PT-v3plus: K = 125,
bottleneck 16), ``PigBodyRegressor`` with ``RegressionL1Loss`` and
``VoteKeypointModel`` over a one-stage PT-v3m1 (the heads' claims do not
depend on the serialization: one order, z), each with the same seeded
weights and batch (2 samples of 128 slots with pads): one training step (the
outputs, the losses, ``mean_dist``, ``mae_i``, every gradient by
``convert.py`` name, the running statistics after it) and ``KeypointModel``'s
eval forward on its running statistics.  flax's Dropout draws from its own
rng stream: the test reads JAX's mask off the Dropout's output
(``capture_intermediates``) and puts it into the port's Dropout; the port's
own draws are checked for their rate.  JAX compiles the four references as
one function, in a thread started by the file's first test, with XLA's
cheaper CPU passes.  ``convert.py`` maps each head's flax variables onto
every parameter and buffer of the port's model, from memory and from a
flax-msgpack checkpoint the JAX package writes.

Tolerances: outputs 5e-5 x max(1, max|jax|) (f32 sums in other orders through
the backbone); losses, ``mean_dist`` and ``mae_i`` 1e-5 relative; gradients
2e-5 x max(1, max|g|) per tensor; running statistics 1e-6.
``KeypointModel``'s first Dense feeds a training-mode BatchNorm, which takes
any shift out, so its bias's gradient is 0 up to rounding on both sides: each
side's within 2e-5 x the largest gradient of that norm's bias.
``RegressionL1Loss`` 1e-6 relative.
"""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_for, slotted_scene

from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models.losses import build_criteria as jax_build_criteria
from pointcept_keypointdetection_tpu.utils.checkpoint import save_checkpoint
from pointcept_keypointdetection_tpu_torch.convert import convert_variables, load_weights
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.models.losses import build_criteria
from pointcept_keypointdetection_tpu_torch.models.norm import Dropout
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch

SLOT, SAMPLES, K = 128, 2, 6
ONE_STAGE = dict(order=("z",), stride=(), enc_depths=(1,), enc_channels=(16,), enc_num_head=(1,),
                 enc_patch_size=(32,), dec_depths=(), dec_channels=(), dec_num_head=(), dec_patch_size=(),
                 slot_divisors=(1,), in_channels=4, drop_path=0.0, shuffle_orders=False)
PTV3 = dict(type="PT-v3m1", **ONE_STAGE)
PTV3PLUS = dict(type="PT-v3plus", cpe_kernel_size=5, cpe_bottleneck=16, **ONE_STAGE)
MODELS = {
    "keypoint": dict(type="KeypointPTv3Plus", num_keypoints=K, hidden_dim=32, backbone_conf=PTV3PLUS),
    "pig": dict(type="PigBodyRegressor", num_measures=7, backbone=PTV3, criteria=[dict(type="RegressionL1Loss")]),
    "vote": dict(type="VoteKeypointModel", num_keypoints=K, hidden_dim=32, vote_radius=0.2, backbone_conf=PTV3),
}
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch(seed):
    rng = np.random.default_rng(seed)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=100, span=8)
    n = SAMPLES * SLOT
    return dict(coord=scene["coord"], feat=rng.normal(size=(n, 4)).astype(np.float32),
                grid_coord=scene["grid_coord"], valid=scene["valid"],
                keypoint=rng.uniform(0.05, 0.35, (SAMPLES, K, 3)).astype(np.float32),
                scale=rng.uniform(300, 900, SAMPLES).astype(np.float32),
                weight_label=rng.normal(50, 20, (SAMPLES, 7)).astype(np.float32))


def _jax_point(b):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES)


def _port_point(b):
    return PointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                      num_samples=SAMPLES)


def _captured(mdl, method):
    return method == "__call__" and (isinstance(mdl, fnn.Dropout) or type(mdl).__name__ == "MaskedBatchNorm")


def _jax_reference():
    """Training steps of the three heads (the keypoint head's Dropout output and norm output captured)
    and the keypoint head's eval forward, in one compile."""
    b = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    models = {key: jax_build_model(dict(cfg)) for key, cfg in MODELS.items()}
    variables = {key: jax_variables_for(build_model(dict(cfg)), np.random.default_rng(i))
                 for i, (key, cfg) in enumerate(MODELS.items())}

    def step(key, params, batch_stats):
        def loss_fn(p):
            out, mutated = models[key].apply(
                {"params": p, "batch_stats": batch_stats}, _jax_point(b), b, train=True,
                mutable=["batch_stats", "intermediates"], rngs={"dropout": jax.random.PRNGKey(7)},
                capture_intermediates=_captured)
            return out["loss"], (out, mutated)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    def run(v):
        steps = {key: step(key, v[key]["params"], v[key]["batch_stats"]) for key in models}
        return steps, models["keypoint"].apply(v["keypoint"], _jax_point(b), b, train=False)

    steps, evaluated = jax.jit(run).lower(variables).compile(FAST_COMPILE)(variables)
    out = {}
    for key, ((_, (outputs, mutated)), grads) in steps.items():
        out[key] = dict(outputs=jax.tree.map(np.asarray, outputs), grads=jax.tree.map(np.array, grads),
                        stats=jax.tree.map(np.array, mutated["batch_stats"]),
                        inter=jax.tree.map(np.asarray, mutated["intermediates"]))
    return dict(variables=variables, steps=out, eval=jax.tree.map(np.asarray, evaluated))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def _model(key, variables):
    model = build_model(dict(MODELS[key]))
    model.load_state_dict(convert_variables(variables))
    return model


def _close(got, ref, tol, what):
    ref = torch.tensor(np.asarray(ref))
    torch.testing.assert_close(got.detach().float(), ref, rtol=0, atol=tol * max(1.0, ref.abs().max().item()),
                               msg=lambda m: f"{what}: {m}")


def _check_step(key, model, out, ref, scalars):
    for name in scalars:
        np.testing.assert_allclose(out[name].item(), float(ref["outputs"][name]), rtol=1e-5, err_msg=name)
    out["loss"].backward()
    grads = convert_variables({"params": ref["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, g in grads.items():
        if key == "keypoint" and name == "head.0.bias":  # 0 up to rounding (the docstring)
            scale = grads["head.1.bias"].abs().max().item()
            for side in (params[name].grad, g):
                assert side.abs().max().item() <= 2e-5 * scale, name
            continue
        _close(params[name].grad, g, 2e-5, f"{key} gradient {name}")
    stats = convert_variables({"batch_stats": ref["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, s in stats.items():
        torch.testing.assert_close(buffers[name], s, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def test_keypoint_head_training_step_matches_jax(reference, monkeypatch):
    ref = reference["steps"]["keypoint"]
    inter = ref["inter"]
    dropped = inter["Dropout_0"]["__call__"][0]
    kept_in = np.maximum(inter["MaskedBatchNorm_0"]["__call__"][0], 0)  # the Dropout's input: ReLU of the norm
    mask = torch.from_numpy(np.where(kept_in > 0, dropped != 0, True))
    assert 0 < int((~mask).sum()) < mask.numel()  # JAX dropped some and kept some
    model = _model("keypoint", reference["variables"]["keypoint"]).train()
    monkeypatch.setattr(model.head[3], "forward",
                        lambda x, generator: torch.where(mask, x / (1.0 - 0.3), torch.zeros((), dtype=x.dtype)))
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = model(_port_point(b), b, torch.Generator().manual_seed(0))
    _close(out["keypoint_pred"], ref["outputs"]["keypoint_pred"], 5e-5, "keypoint_pred")
    _check_step("keypoint", model, out, ref, ("loss", "mean_dist"))
    assert model.head[1].eps == 1e-5 and model.head[1].momentum == 0.1


def test_keypoint_head_eval_matches_jax(reference):
    model = _model("keypoint", reference["variables"]["keypoint"]).eval()
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    with torch.no_grad():
        out = model(_port_point(b), b)
    ref = reference["eval"]
    _close(out["keypoint_pred"], ref["keypoint_pred"], 5e-5, "keypoint_pred")
    for name in ("loss", "mean_dist"):
        np.testing.assert_allclose(out[name].item(), float(ref[name]), rtol=1e-5, err_msg=name)
    with torch.no_grad():  # no targets: the prediction alone, the same one
        alone = model(_port_point(b))
    assert set(alone) == {"keypoint_pred"} and torch.equal(alone["keypoint_pred"], out["keypoint_pred"])


def test_pig_body_regressor_training_step_matches_jax(reference):
    ref = reference["steps"]["pig"]
    model = _model("pig", reference["variables"]["pig"]).train()
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = model(_port_point(b), b)
    _close(out["measure_pred"], ref["outputs"]["measure_pred"], 5e-5, "measure_pred")
    _check_step("pig", model, out, ref, ("loss",) + tuple(f"mae_{i}" for i in range(7)))


def test_vote_keypoint_training_step_matches_jax(reference):
    ref = reference["steps"]["vote"]
    model = _model("vote", reference["variables"]["vote"]).train()
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = model(_port_point(b), b)
    for name in ("votes", "keypoint_pred"):
        _close(out[name], ref["outputs"][name], 5e-5, name)
    _check_step("vote", model, out, ref, ("loss", "mean_dist"))
    # the in-radius weights follow the slot layout: sample 1's keypoints only weigh sample 1's rows
    point = _port_point(b)
    kp = b["keypoint"].repeat_interleave(SLOT, dim=0)
    inside = ((point.coord[:, None, :] - kp).norm(dim=-1) <= 0.2) & point.valid[:, None]
    assert inside[:SLOT].any() and inside[SLOT:].any()


def test_regression_l1_loss_matches_jax():
    rng = np.random.default_rng(6)
    pred, target = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(5, 7)).astype(np.float32)
    valid = np.array([True, False, True, True, False])
    crit, ref = build_criteria([dict(type="RegressionL1Loss", loss_weight=0.5)]), jax_build_criteria(
        [dict(type="RegressionL1Loss", loss_weight=0.5)])
    for v in (None, valid):
        got = crit(torch.from_numpy(pred), torch.from_numpy(target), None if v is None else torch.from_numpy(v))
        want = ref(jnp.asarray(pred), jnp.asarray(target), None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_dropout_keeps_elements_at_its_rate_and_scales_them():
    drop = Dropout(0.3).train()
    x = torch.ones(20000, 4)
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y > 0
    assert torch.all(y[kept] == 1 / 0.7) and torch.all(y[~kept] == 0)
    share = kept.float().mean().item()
    assert abs(share - 0.7) < 4 * (0.7 * 0.3 / x.numel()) ** 0.5
    assert drop.eval()(x, None) is x and Dropout(0.0).train()(x, None) is x
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x, None)


def test_convert_maps_each_head(reference, tmp_path):
    """Every flax variable of each head lands on a parameter or buffer of the port's model, and back: the
    state_dict from memory equals the one ``load_weights`` reads from the JAX package's checkpoint."""
    for key, variables in reference["variables"].items():
        model = build_model(dict(MODELS[key]))
        state = convert_variables(variables)
        assert set(state) == set(model.state_dict())
        model.load_state_dict(state)
        path = tmp_path / f"{key}.ckpt"
        save_checkpoint(str(path), {"params": variables["params"], "batch_stats": variables["batch_stats"],
                                    "epoch": 3})
        read = load_weights(str(path))
        assert set(read) == set(state) and all(torch.equal(read[k], state[k]) for k in state)
    names = set(build_model(dict(MODELS["keypoint"])).state_dict())
    assert {"head.1.running_mean", "head.1.running_var", "backbone.enc0_block0.cpe.down.weight",
            "backbone.enc0_block0.cpe.up.bias"} <= names
    assert "cls_head.weight" in build_model(dict(MODELS["pig"])).state_dict()


def test_unported_backbones_raise_where_built():
    """The heads over a backbone the port lacks raise where they are built; over the ported ones they build."""
    for cfg in (dict(type="KeypointModel", backbone_conf=dict(type="PT-v3m2", in_channels=4)),
                dict(type="OffsetKeypointModel", backbone_conf=dict(type="SGIFormer-v1m1", in_channels=4))):
        with pytest.raises(NotImplementedError, match="not ported"):
            build_model(cfg)
    for name, backbone, width in (("KeypointPTv2", "PT-v2m2", 48), ("KeypointPTv1", "PT-v1", 32),
                                  ("KeypointStratifiedTransformer", "ST-v1m2", 48), ("KeypointOACNNs", "OA-CNNs", 32),
                                  ("OffsetKeypointModel", "PT-v2m2", 48), ("KeypointModel", "SPVCNN", 32)):
        model = build_model(dict(type=name, num_keypoints=K, backbone_conf=dict(type=backbone, in_channels=4)))
        assert model.backbone.out_channels == width
    swin = dict(type="Swin3D-v1m1", in_channels=4, depths=(1,), channels=(16,), num_heads=(1,), window_sizes=(4,),
                slot_divisors=(1,))
    octformer = dict(type="OctFormer-v1m1", in_channels=4, channels=(16,), num_blocks=(1,), num_heads=(1,),
                     slot_divisors=(1,))
    for name, backbone in (("KeypointSwin3D", swin), ("KeypointSwin3DVote", swin), ("OffsetKeypointSwin3D", swin),
                           ("KeypointOctFormer", octformer), ("OffsetKeypointOctFormer", octformer)):
        model = build_model(dict(type=name, num_keypoints=K, backbone_conf=backbone))
        assert model.head[0].in_features == model.backbone.out_channels == 16
    sparse = build_model(dict(type="KeypointSparseUNet", num_keypoints=K, backbone_conf=dict(
        type="SpUNet-v1m1", in_channels=4, num_classes=0, channels=(16, 16, 16, 16), layers=(1, 1, 1, 1))))
    assert sparse.head[0].in_features == 16
