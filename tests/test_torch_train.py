"""The port's training path against the JAX package on the CPU.

One training step of a small OffsetKeypoint PT-v3m1 (2 stages, channels
<= 24, patch 32, two serialization orders, z and hilbert, 2 samples of 128 slots with pads, ``drop_path`` 0,
``shuffle_orders`` False, ``clip_grad`` low enough to clip) with the same
seeded weights and batch: the loss, every gradient (by ``convert.py``
name), the parameters after one AdamW + cosine step and the BN running
statistics.  The JAX value-and-grad is compiled once, in a module fixture.
Tolerances: loss 1e-5 relative; gradients 2e-5 x max(1, max|g|) per tensor
(f32 sums in another order through three blocks and their backward); running
statistics 1e-6; the parameters after the clip and the optimizer step on
JAX's gradients 1e-7 + 2.5e-7 relative (two f32 ulps: the update is
rounded into the parameter in another order of operations).  Integer and
data-pipeline outputs match exactly.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch_parity import jax_variables_for, slotted_scene

from pointcept_keypointdetection_tpu.datasets.dataloader import Dataloader as JaxDataloader
from pointcept_keypointdetection_tpu.datasets.synthetic import SyntheticKeypointDataset as JaxSynthetic
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from pointcept_keypointdetection_tpu.ops.segment import segment_reduce as jax_segment_reduce
from pointcept_keypointdetection_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
from pointcept_keypointdetection_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets.dataloader import Dataloader
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import SyntheticKeypointDataset
from pointcept_keypointdetection_tpu_torch.engines.train import Trainer
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.models import point_transformer_v3 as ptv3
from pointcept_keypointdetection_tpu_torch.models.norm import DropPath, MaskedBatchNorm
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch
from pointcept_keypointdetection_tpu_torch.ops.segment import segment_reduce
from pointcept_keypointdetection_tpu_torch.train import main as train_main
from pointcept_keypointdetection_tpu_torch.utils.config import Config
from pointcept_keypointdetection_tpu_torch.utils.optimizer import build_optimizer, clip_grad
from pointcept_keypointdetection_tpu_torch.utils.scheduler import build_scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT, SAMPLES, K = 128, 2, 6
LR, WD, CLIP, TOTAL = 1e-3, 0.05, 0.5, 10
CFG = dict(
    type="OffsetKeypointPTv3",
    num_keypoints=K,
    hidden_dim=32,
    backbone_conf=dict(
        type="PT-v3m1", in_channels=4, order=("z", "hilbert"), stride=(2,), enc_depths=(1, 1), enc_channels=(16, 24),
        enc_num_head=(1, 2), enc_patch_size=(32, 32), dec_depths=(1,), dec_channels=(16,),
        dec_num_head=(1,), dec_patch_size=(32,), slot_divisors=(1, 2), drop_path=0.0, shuffle_orders=False,
    ),
)
OPT = dict(type="AdamW", lr=LR, weight_decay=WD)
SCHED = dict(type="CosineAnnealingLR", eta_min=1e-5)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch(seed):
    rng = np.random.default_rng(seed)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=100, span=8)
    n = SAMPLES * SLOT
    mask = (rng.random((n, K)) < 0.3).astype(np.float32)
    return dict(coord=scene["coord"], feat=rng.normal(size=(n, 4)).astype(np.float32),
                grid_coord=scene["grid_coord"], valid=scene["valid"],
                keypoint_offset=(rng.normal(size=(n, K, 3)) * 0.3).astype(np.float32) * mask[..., None],
                keypoint_mask=mask)


def _jax_point(b):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES)


def _port_point(b):
    return PointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                      num_samples=SAMPLES)


@pytest.fixture(scope="module")
def step():
    """JAX's loss, grads, new batch stats and params after one trainer step (clip + AdamW + cosine)."""
    model = jax_build_model(CFG)
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    variables = jax_variables_for(build_model(CFG), np.random.default_rng(0))

    def loss_fn(params, batch_stats, b):
        out, mutated = model.apply({"params": params, "batch_stats": batch_stats}, _jax_point(b), b, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return out["loss"], (mutated["batch_stats"], out)

    args = (variables["params"], variables["batch_stats"], batch)
    # XLA's cheaper CPU passes: the compile is most of the file's time, and the numbers do not need them
    (loss, (new_bs, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    # the trainer's optimizer on the parameters raveled into one vector: clip by global norm and
    # AdamW act elementwise apart from the norm, and one leaf keeps the compile short
    flat, unravel = ravel_pytree(variables["params"])
    tx = jax_build_optimizer(OPT, jax_build_scheduler(SCHED, TOTAL, LR), grad_clip=CLIP)
    new_params = unravel(jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        ravel_pytree(grads)[0], flat))
    to_np = functools.partial(jax.tree.map, np.array)  # writable copies for torch.from_numpy
    return dict(variables=variables, loss=float(loss), cls=float(out["cls_loss"]), reg=float(out["reg_loss"]),
                grads=to_np(grads), batch_stats=to_np(new_bs), params=to_np(new_params))


def test_training_step_matches_jax(step):
    model = build_model(CFG)
    model.load_state_dict(convert_variables(step["variables"]))
    model.train()
    batch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    out = model(_port_point(batch), batch)
    for key, ref in (("loss", step["loss"]), ("cls_loss", step["cls"]), ("reg_loss", step["reg"])):
        np.testing.assert_allclose(out[key].item(), ref, rtol=1e-5, err_msg=key)
    out["loss"].backward()

    grads = convert_variables({"params": step["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, ref in grads.items():
        tol = 2e-5 * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(params[name].grad, ref, rtol=0, atol=tol, msg=lambda m, name=name: f"{name}: {m}")

    stats = convert_variables({"batch_stats": step["batch_stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) and len(stats) == 4  # stem + the pooling norm, mean and var
    for name, ref in stats.items():
        torch.testing.assert_close(buffers[name], ref, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")

    # the optimizer step on JAX's gradients: AdamW's first step moves a parameter by
    # lr * g / (|g| + 1e-8), which for a gradient near 0 turns its rounding into a change of lr
    for name, ref in grads.items():
        params[name].grad = ref.clone()
    optimizer = build_optimizer(OPT, model.parameters())
    schedule = build_scheduler(SCHED, TOTAL, LR)
    for group in optimizer.param_groups:
        group["lr"] = schedule(0)
    norm = clip_grad(model.parameters(), CLIP)
    assert norm > CLIP  # the clip is exercised
    optimizer.step()
    for name, ref in convert_variables({"params": step["params"]}).items():
        torch.testing.assert_close(params[name].detach(), ref, rtol=2.5e-7, atol=1e-7,
                                   msg=lambda m, name=name: f"{name}: {m}")


def test_schedule_and_clip_match_optax():
    ours = build_scheduler(SCHED, 37, 2e-3)
    ref = jax_build_scheduler(SCHED, 37, 2e-3)
    for s in (0, 1, 18, 36, 37, 50):
        np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-6)
    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    for max_norm in (0.5, 100.0):  # clipped, not clipped
        ps = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
        for p, a in zip(ps, arrays):
            p.grad = torch.from_numpy(a.copy())
        clip_grad(ps, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in arrays], None)
        for p, r in zip(ps, ref):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


def test_masked_batch_norm_training_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(50, 8)).astype(np.float32)
    valid = rng.random(50) > 0.3
    w = rng.normal(size=(50, 8)).astype(np.float32)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                            "bias": rng.normal(size=8).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    bn = JaxMaskedBatchNorm(8)

    def f(params, xx):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, valid, False,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y_ref, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(variables["params"], x)

    ours = MaskedBatchNorm(8).train()
    ours.load_state_dict(convert_variables(variables))
    xt = torch.from_numpy(x).requires_grad_()
    y = ours(xt, torch.from_numpy(valid))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_pooling_gradients_match_jax_with_ties(reduce):
    """Rows tying for a segment's max share its gradient; a max of exactly 0
    keeps all of it; an empty segment gives 0; ids past the end are dropped."""
    data = np.array([[1, 2], [1, 0], [3, 5], [-2, 5], [0, 0], [7, 7], [0, -1]], np.float32)
    ids = np.array([0, 0, 1, 1, 3, 5, 3], np.int32)  # segment 2 empty, id 5 dropped
    w = np.arange(1, 11, dtype=np.float32).reshape(5, 2)
    ref_out, vjp = jax.vjp(lambda d: jax_segment_reduce(d, jnp.asarray(ids), 5, reduce), jnp.asarray(data))
    (ref_grad,) = vjp(jnp.asarray(w))
    x = torch.from_numpy(data).requires_grad_()
    out = segment_reduce(x, torch.from_numpy(ids), 5, reduce)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=0, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=0, atol=1e-7)


def _datasets(num_points=600):
    transform = [
        dict(type="Update", keys_dict=dict()),
        dict(type="GridSample", grid_size=0.05, mode="train", return_grid_coord=True),
        dict(type="ShufflePoint"),
        dict(type="Collect", keys=("coord", "grid_coord", "keypoint_offset", "keypoint_mask", "scale", "centroid"),
             feat_keys=("feat",)),
    ]
    kw = dict(split="train", num_scenes=3, num_points=num_points, offset_radius=300.0, transform=transform, loop=2)
    return JaxSynthetic(**kw), SyntheticKeypointDataset(**kw)


def test_dataloader_batches_match_jax():
    jax_ds, ds = _datasets()
    kw = dict(batch_size=2, slot_size=160, shuffle=True, drop_last=False, seed=3)
    np.random.seed(7)
    ref = list(JaxDataloader(jax_ds, prefetch=0, **kw))
    for prefetch in (0, 2):
        np.random.seed(7)
        got = list(Dataloader(ds, prefetch=prefetch, **kw))
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert any(b["valid"].all() for b in ref)  # some scenes filled their slots: the subsample ran


def _shuffle_case():
    rng = np.random.default_rng(5)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=90, span=8)
    return PointBatch(coord=torch.from_numpy(scene["coord"]), feat=torch.from_numpy(rng.normal(size=(256, 4)).astype(
        np.float32)), grid_coord=torch.from_numpy(scene["grid_coord"]), valid=torch.from_numpy(scene["valid"]),
        num_samples=SAMPLES)


def test_shuffled_serialization_permutes_the_orders():
    point = _shuffle_case()
    base = point.serialize()
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(6):
        sh = point.serialize(generator=gen)
        perm = []
        for o, inv in zip(sh.serialized_order, sh.serialized_inverse):
            i = next(i for i in range(4) if torch.equal(o, base.serialized_order[i]))
            assert torch.equal(inv, base.serialized_inverse[i])
            perm.append(i)
        assert sorted(perm) == [0, 1, 2, 3]
        seen.add(tuple(perm))
    assert len(seen) > 1


def test_shuffled_forward_does_not_reuse_the_z_sort(monkeypatch):
    perms = []
    real = ptv3.build_voxel_index

    def spy(*args, **kwargs):
        perms.append(args[4] if len(args) > 4 else kwargs.get("precomputed_perm"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ptv3, "build_voxel_index", spy)
    cfg = dict(CFG, backbone_conf=dict(CFG["backbone_conf"], shuffle_orders=True))
    model = build_model(cfg).train()
    point = _shuffle_case()
    with pytest.raises(ValueError, match="generator"):
        model(point)
    out = model(point, generator=torch.Generator().manual_seed(1))
    assert perms and all(p is None for p in perms)
    assert torch.isfinite(out["offset_pred"]).all()
    perms.clear()
    with torch.no_grad():
        model.eval()(point)
    assert perms and all(p is not None for p in perms)


def test_training_after_an_inference_mode_forward():
    """A served request (inference mode) first, then a training step: the stem's cached
    slot table must not be an inference tensor."""
    model = build_model(CFG).eval()
    point = _shuffle_case()
    with torch.inference_mode():
        model(point)
    out = model.train()(point)
    out["offset_pred"].sum().backward()
    assert model.backbone.stem_weight.grad is not None


def test_drop_path_keeps_samples_at_its_rate_and_scales_them():
    dp = DropPath(0.25).train()
    x = torch.ones(4000 * 3, 2)
    y = dp(x, 4000, torch.Generator().manual_seed(0)).reshape(4000, 3, 2)
    kept = y[:, 0, 0] > 0
    assert torch.all(y[kept] == 1 / 0.75) and torch.all(y[~kept] == 0)  # whole samples, scaled
    assert abs(kept.float().mean().item() - 0.75) < 4 * (0.75 * 0.25 / 4000) ** 0.5
    assert dp.eval()(x, 4000, None) is x and DropPath(0.0).train()(x, 4000, None) is x
    with pytest.raises(ValueError):
        dp.train()(x, 4000, None)


def _cli_args(save_path, *extra):
    return ["--config-file", os.path.join(REPO, "configs/synthetic/offset-keypoint-mini.py"), "--device", "cpu",
            "--options", f"save_path={save_path}", "model.backbone_conf.stem_kernel=5", "slot_size=256",
            "data.train.num_scenes=4", "data.train.loop=1", "data.val.num_scenes=2", "batch_size=2",
            "clip_grad=1.0", *extra]


def test_trainer_cli_trains_saves_and_resumes(tmp_path):
    trainer = train_main(_cli_args(tmp_path, "eval_epoch=1"))
    assert trainer.step == 2 and trainer.epoch == 0
    assert np.isfinite(trainer.comm_info["metrics"]["loss"])
    last = tmp_path / "model" / "model_last.pth"
    assert last.is_file() and (tmp_path / "model" / "model_best.pth").is_file()
    assert (tmp_path / "config.py").is_file() and (tmp_path / "train.log").is_file()
    saved = torch.load(last, weights_only=True)
    assert saved["epoch"] == 1 and saved["step"] == 2
    resumed = train_main(_cli_args(tmp_path, "eval_epoch=2", "resume=True"))
    assert resumed.start_epoch == 1 and resumed.step == 4 and resumed.epoch == 1
    assert torch.load(last, weights_only=True)["step"] == 4


def test_trainer_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = Config.fromfile(os.path.join(REPO, "configs/synthetic/offset-keypoint-mini.py"))
    cfg.merge_from_dict({"save_path": str(tmp_path)})
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg)
    with pytest.raises(NotImplementedError, match="remat"):  # a training option not ported yet
        cfg.merge_from_dict({"remat": True})
        Trainer(cfg, device="cpu")
