"""The port's segmentor training against the JAX package on the CPU.

Losses, the one-cycle schedule, the segmentation transforms, the two
segmentation datasets, collation, the evaluator, one training step of a narrow
``DefaultSegmentorV2`` (5 Blocks: two stages of two and one decoder Block,
channels 16-32, patch 16, one serialization order, ``shuffle_orders`` False,
drop path 0, 2 samples of 128 slots with pads, CE + Lovász over 3 classes
with ignored rows) in f32 and under ``amp`` bf16, and the ``train`` CLI on the
pigseg config at a tiny width.  JAX compiles one function, which holds the
f32 value-and-grad and the amp one, in a module fixture with XLA's cheaper
CPU passes.  Weights, labels and gradients meet through ``convert.py``.

Tolerances: losses and their gradients 1e-5 relative plus 1e-7 (f32 sums in
another order); the schedule 1e-6 relative plus 1e-6 x the peak rate (JAX
computes it in f32, whose rounding near the peak is a few 1e-7 of it); the
transforms, datasets, collation and the evaluator's counts exactly; the f32
step as ``test_torch_train.py``: loss 1e-5 relative, gradients 2e-5 x
max(1, max|g|) per tensor, running statistics 1e-6; the amp step within
``AMP_RATIO`` times JAX bf16's own deviation from JAX f32 per tensor (see
there).
"""

import copy
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_for, slotted_scene

from pointcept_keypointdetection_tpu.datasets import transform as jax_transform
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate
from pointcept_keypointdetection_tpu.datasets.pigseg import PigDataset as JaxPigDataset
from pointcept_keypointdetection_tpu.datasets.synthetic import SyntheticSemSegDataset as JaxSemSeg
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models.losses import build_criteria as jax_build_criteria
from pointcept_keypointdetection_tpu.utils.misc import intersection_and_union_jax
from pointcept_keypointdetection_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets import transform as port_transform
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.datasets.pigseg import PigDataset
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import SyntheticSemSegDataset, body_cloud
from pointcept_keypointdetection_tpu_torch.engines.hooks.evaluator import SemSegEvaluator
from pointcept_keypointdetection_tpu_torch.engines.train import Trainer
from pointcept_keypointdetection_tpu_torch.kernels.sparse_conv import subm_conv_dw_plain, subm_conv_plain
from pointcept_keypointdetection_tpu_torch.models import PointBatch, build_model
from pointcept_keypointdetection_tpu_torch.models.losses import build_criteria
from pointcept_keypointdetection_tpu_torch.ops.sparse import sparse_conv
from pointcept_keypointdetection_tpu_torch.train import main as train_main
from pointcept_keypointdetection_tpu_torch.utils.config import Config, DictAction
from pointcept_keypointdetection_tpu_torch.utils.events import EventStorage
from pointcept_keypointdetection_tpu_torch.utils.misc import intersection_and_union
from pointcept_keypointdetection_tpu_torch.utils.scheduler import build_scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIGSEG = os.path.join(REPO, "configs/pigseg/semseg-ptv3-v1m1-0-base.py")
SEMSEG_MINI = os.path.join(REPO, "configs/synthetic/semseg-spunet-mini.py")
SLOT, SAMPLES, CLASSES = 128, 2, 3
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
CFG = dict(
    type="DefaultSegmentorV2", num_classes=CLASSES, backbone_out_channels=16, criteria=CRITERIA,
    backbone=dict(type="PT-v3m1", in_channels=4, order=("z",), stride=(2,), enc_depths=(2, 2), enc_channels=(16, 32),
                  enc_num_head=(1, 2), enc_patch_size=(16, 16), dec_depths=(1,), dec_channels=(16,),
                  dec_num_head=(1,), dec_patch_size=(16,), slot_divisors=(1, 4), kmap_depth=10, drop_path=0.0,
                  shuffle_orders=False, scan_blocks=False),
)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# the amp step: the port's bf16 against JAX's bf16, per tensor, at most AMP_RATIO x JAX bf16's deviation
# from JAX f32 on the same tensor (plus a floor of one bf16 ulp of the tensor's size); the readings are
# in the test's output
AMP_RATIO = 2.0
TINY_PIGSEG = [
    "model.backbone.enc_depths=(1,1)", "model.backbone.enc_channels=(16,16)", "model.backbone.enc_num_head=(1,1)",
    "model.backbone.enc_patch_size=(16,16)", "model.backbone.dec_depths=(1,)", "model.backbone.dec_channels=(16,)",
    "model.backbone.dec_num_head=(1,)", "model.backbone.dec_patch_size=(16,)", "model.backbone.stride=(2,)",
    "model.backbone.slot_divisors=(1,2)", "model.backbone_out_channels=16", "slot_size=256", "batch_size=2",
]


# ---- losses -----------------------------------------------------------------------------------------


def _loss_case(mode):
    """Logits with exact ties in the Lovász errors (repeated rows), ignored and invalid rows."""
    rng = np.random.default_rng(0)
    n = 96
    if mode == "binary":
        pred = rng.normal(size=n).astype(np.float32)
        pred[:8] = 1.0  # hinge 1 - pred * sign = 0 exactly for the positives among them
        pred[8:16] = pred[16:24]  # tied errors
        target = rng.integers(0, 2, n).astype(np.int32)
        target[8:16] = target[16:24]
    else:
        pred = rng.normal(size=(n, 4)).astype(np.float32)
        target = rng.integers(0, 4, n).astype(np.int32)
        pred[10:30] = pred[40:60]  # tied errors in every class
        target[10:30] = target[40:60]
    target[rng.random(n) < 0.15] = -1
    valid = rng.random(n) > 0.1
    return pred, target, valid


LOSSES = {
    "ce": dict(type="CrossEntropyLoss"),
    "ce-weight-smooth": dict(type="CrossEntropyLoss", weight=[0.5, 1.0, 2.0, 1.5], label_smoothing=0.1,
                             loss_weight=0.7),
    "ce-sum": dict(type="CrossEntropyLoss", reduction="sum"),
    "lovasz-multiclass": dict(type="LovaszLoss", mode="multiclass"),
    "lovasz-binary": dict(type="LovaszLoss", mode="binary", loss_weight=0.5),
}


@functools.cache
def _jax_losses():
    """Every loss case's value and gradient in JAX, compiled as one function for the file's loss tests."""
    cases = {name: _loss_case(loss.get("mode", "multiclass")) for name, loss in LOSSES.items()}

    def run(preds):
        out = {}
        for name, loss in LOSSES.items():
            crit, (_, target, valid) = jax_build_criteria([loss]), cases[name]
            out[name] = jax.value_and_grad(lambda p, c=crit, t=target, v=valid: c(p, jnp.asarray(t),
                                                                                  valid=jnp.asarray(v)))(preds[name])
        return out

    preds = {name: jnp.asarray(case[0]) for name, case in cases.items()}
    return jax.jit(run).lower(preds).compile(FAST_COMPILE)(preds)


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(name):
    loss = LOSSES[name]
    pred, target, valid = _loss_case(loss.get("mode", "multiclass"))
    crit = build_criteria([loss])
    ref, ref_grad = _jax_losses()[name]
    p = torch.from_numpy(pred).requires_grad_()
    got = crit(p, torch.from_numpy(target), valid=torch.from_numpy(valid))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-7)
    assert np.abs(np.asarray(ref_grad)).max() > 0


def test_lovasz_sort_is_stable_on_ties():
    """Tied errors keep their row order, as ``jnp.argsort`` does: reversing two tied rows
    moves their gradients with them only if the sort is stable."""
    pred, target, valid = _loss_case("multiclass")
    crit = build_criteria([dict(type="LovaszLoss")])
    p = torch.from_numpy(pred).requires_grad_()
    crit(p, torch.from_numpy(target), valid=torch.from_numpy(valid)).backward()
    tied = valid[10:30] & valid[40:60] & (target[10:30] >= 0)
    assert tied.any()
    # the earlier of two tied rows sorts first, so the two get different Lovász weights
    assert not torch.equal(p.grad[10:30][torch.from_numpy(tied)], p.grad[40:60][torch.from_numpy(tied)])


def test_unported_loss_raises():
    with pytest.raises(NotImplementedError, match="FocalLoss"):
        build_criteria([dict(type="FocalLoss")])


# ---- schedule -------------------------------------------------------------------------------------


@pytest.mark.parametrize("sched", [
    dict(type="OneCycleLR", pct_start=0.05, div_factor=10.0, final_div_factor=1000.0),
    dict(type="OneCycleLR", max_lr=0.01),
], ids=["pigseg", "defaults"])
def test_onecycle_matches_optax_at_every_step(sched):
    total, base_lr = 45, 2e-3
    ours, ref = build_scheduler(sched, total, base_lr), jax_build_scheduler(sched, total, base_lr)
    got = [ours(s) for s in range(total + 3)]
    want = [float(ref(jnp.int32(s))) for s in range(total + 3)]
    peak = sched.get("max_lr", base_lr)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)
    assert max(got) == pytest.approx(peak)


def test_onecycle_refuses_a_warmup_of_no_steps():
    sched = dict(type="OneCycleLR", pct_start=0.05)
    assert np.isnan(float(jax_build_scheduler(sched, 10, 1e-3)(jnp.int32(3))))  # optax: 0 / 0
    with pytest.raises(ValueError, match="pct_start"):
        build_scheduler(sched, 10, 1e-3)


# ---- data ------------------------------------------------------------------------------------------


def _sample(seed=0, n=500):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    return dict(coord=rng.uniform(-2, 3, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
                segment=rng.integers(0, 5, n).astype(np.int32))


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=key)


TRANSFORMS = [
    dict(type="CenterShift", apply_z=True),
    dict(type="CenterShift", apply_z=False),
    dict(type="RandomRotate", angle=[-1, 1], axis="z", p=0.5),
    dict(type="RandomRotate", angle=[-1 / 64, 1 / 64], axis="x", center=[0, 0, 0], always_apply=True),
    dict(type="RandomRotate", angle=[-1, 1], axis="y", p=1.0),
    dict(type="RandomScale", scale=[0.9, 1.1]),
    dict(type="RandomScale", scale=[0.9, 1.1], anisotropic=True),
    dict(type="RandomFlip", p=0.5),
    dict(type="RandomJitter", sigma=0.005, clip=0.02),
    dict(type="NormalizeColor"),
]


@pytest.mark.parametrize("cfg", TRANSFORMS, ids=lambda c: c["type"])
def test_transforms_match_jax(cfg):
    for seed in range(4):  # several draws: rotate or not, flip one axis or both
        sample = _sample(seed)
        np.random.seed(seed)
        ref = jax_transform.TRANSFORMS.build(dict(cfg))(copy.deepcopy(sample))
        np.random.seed(seed)
        got = port_transform.TRANSFORMS.build(dict(cfg))(copy.deepcopy(sample))
        _assert_same(got, ref)


def _semseg_kw(split):
    cfg = Config.fromfile(SEMSEG_MINI)
    return dict(split=split, num_scenes=2, num_points=1500, num_classes=6, transform=cfg.data[split].transform)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_semseg_dataset_matches_jax(split):
    ref, got = JaxSemSeg(**_semseg_kw(split)), SyntheticSemSegDataset(**_semseg_kw(split))
    assert len(got) == len(ref) == 2
    for i in range(2):
        np.random.seed(i)
        want = ref[i]
        np.random.seed(i)
        _assert_same(got[i], want)
        assert want["feat"].shape[1] == 6  # coord + colour, the ScanNet recipe's in_channels
    # test mode without a test_cfg (the transforms but Collect, which would drop the scene's name): one
    # fragment per scene, every row of it (tests/test_torch_spunet.py holds the ScanNet recipe's test_cfg)
    kw = dict(_semseg_kw(split), test_mode=True)
    kw["transform"] = kw["transform"][:-1]
    ref, got = JaxSemSeg(**kw), SyntheticSemSegDataset(**kw)
    np.random.seed(0)
    want = ref[0]
    np.random.seed(0)
    scene = got[0]
    assert len(scene["fragment_list"]) == len(want["fragment_list"]) == 1 and scene["name"] == want["name"]
    np.testing.assert_array_equal(scene["segment"], want["segment"])
    _assert_same(scene["fragment_list"][0], want["fragment_list"][0])


def pig_cloud(rng, n):
    """An N x 8 pig cloud as the pigseg data holds it: xyz (mm), normal, curvature, label
    (1 body, 0 floor)."""
    nb = n * 2 // 3
    body = body_cloud(rng, nb)
    floor = np.stack([rng.uniform(-1200, 1200, n - nb), rng.uniform(-800, 800, n - nb),
                      rng.normal(-700, 2, n - nb)], 1)
    normal = np.zeros((n, 3))
    normal[:nb] = body / np.linalg.norm(body, axis=1, keepdims=True)
    normal[nb:, 2] = 1
    curvature = np.concatenate([rng.uniform(0, 0.2, nb), np.zeros(n - nb)])[:, None]
    label = (np.arange(n) < nb)[:, None]
    return np.concatenate([np.concatenate([body, floor]), normal, curvature, label], 1).astype(np.float32)


def write_pig_clouds(root, counts, n, seed=0):
    rng = np.random.default_rng(seed)
    for split, k in counts.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(k):
            cloud = pig_cloud(rng, n)
            if i == 0:
                cloud[5, 2] = np.nan  # culled rows
                cloud[7, 6] = np.nan
                cloud[9, :3] = [6000.0, 0.0, 0.0]  # beyond 5 m of the median
            np.save(os.path.join(root, split, f"pig{i}.npy"), cloud)


@pytest.mark.parametrize("split", ["train", "val"])
def test_pig_dataset_matches_jax(tmp_path, split):
    write_pig_clouds(tmp_path, {split: 2}, 800)
    cfg = Config.fromfile(PIGSEG)
    kw = dict(split=split, data_root=str(tmp_path), transform=cfg.data[split].transform)
    ref, got = JaxPigDataset(**kw), PigDataset(**kw)
    assert len(got) == len(ref) == 2
    for i in range(2):
        np.random.seed(i)
        want = ref[i]
        np.random.seed(i)
        _assert_same(got[i], want)
    plain = PigDataset(split=split, data_root=str(tmp_path))[0]
    assert plain["coord"].shape[0] == 800 - 3 and np.isfinite(plain["coord"]).all()  # two NaN rows, one far point
    assert set(np.unique(plain["segment"])) == {0, 1}


def test_collate_pads_segment_as_jax():
    rng = np.random.default_rng(1)
    samples = [dict(coord=rng.normal(size=(n, 3)).astype(np.float32), grid_coord=rng.integers(0, 9, (n, 3)),
                    feat=rng.normal(size=(n, 4)).astype(np.float32), segment=rng.integers(-1, 3, n).astype(np.int32))
               for n in (70, 200)]
    np.random.seed(3)
    ref = jax_collate(copy.deepcopy(samples), 128)
    np.random.seed(3)
    got = collate(copy.deepcopy(samples), 128, np.random)
    _assert_same(got, ref)
    assert (got["segment"][~got["valid"]] == -1).all()


# ---- evaluator ---------------------------------------------------------------------------------------


class _Logits(torch.nn.Module):
    """A model that answers the val batch's stored logits."""

    def forward(self, point, batch=None):
        return {"seg_logits": batch["logits"], "loss": batch["logits"].sum() * 0 + 0.5}


def test_semseg_evaluator_matches_jax_counts():
    rng = np.random.default_rng(2)
    k, batches = 4, []
    for _ in range(3):
        n = 2 * 64
        batches.append(dict(coord=rng.normal(size=(n, 3)).astype(np.float32), feat=np.zeros((n, 1), np.float32),
                            grid_coord=np.zeros((n, 3), np.int32), valid=rng.random(n) > 0.2,
                            segment=rng.integers(-1, k, n).astype(np.int32),
                            logits=rng.normal(size=(n, k)).astype(np.float32), num_samples=2))
    sums = np.zeros((3, k))
    for b in batches:
        pred = b["logits"].argmax(1)
        ref = intersection_and_union_jax(jnp.asarray(pred), jnp.asarray(b["segment"]), k, -1, jnp.asarray(b["valid"]))
        got = intersection_and_union(torch.from_numpy(pred), torch.from_numpy(b["segment"]), k, -1,
                                     torch.from_numpy(b["valid"]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        sums += np.stack([np.asarray(r) for r in ref])

    hook = SemSegEvaluator()
    trainer = type("T", (), {})()
    trainer.cfg = Config(dict(data=dict(num_classes=k)))
    trainer.model, trainer.val_loader, trainer.device = _Logits(), batches, "cpu"
    trainer.storage, trainer.comm_info = EventStorage(), {}
    hook.trainer = trainer
    hook.after_epoch()
    inter, union, target = sums
    h = trainer.storage.histories()
    assert h["val/mIoU"].latest == pytest.approx(np.mean(inter / np.maximum(union, 1)), abs=1e-12)
    assert h["val/mAcc"].latest == pytest.approx(np.mean(inter / np.maximum(target, 1)), abs=1e-12)
    assert h["val/allAcc"].latest == pytest.approx(inter.sum() / target.sum(), abs=1e-12)
    assert h["val/loss"].latest == pytest.approx(0.5)
    assert trainer.comm_info["current_metric_value"] == h["val/mIoU"].latest


# ---- the trainer and the CLI ------------------------------------------------------------------------


def _cli_args(save_path, data_root, *extra):
    # pct_start 0.5: a warm-up of at least one step in runs of 2 and 4 steps (the recipe's 0.05 needs 20)
    return ["--config-file", PIGSEG, "--device", "cpu", "--options", f"save_path={save_path}",
            f"data.train.data_root={data_root}", f"data.val.data_root={data_root}", "scheduler.pct_start=0.5",
            *TINY_PIGSEG, *extra]


def test_pigseg_cli_trains_evaluates_saves_and_resumes(tmp_path):
    data = tmp_path / "data"
    write_pig_clouds(data, {"train": 4, "val": 2}, 600)
    trainer = train_main(_cli_args(tmp_path / "exp", data, "eval_epoch=1"))
    assert trainer.step == 2 and np.isfinite(trainer.comm_info["metrics"]["loss"])
    assert 0.0 <= trainer.comm_info["current_metric_value"] <= 1.0
    log = (tmp_path / "exp" / "train.log").read_text()
    assert "Val result: mIoU/mAcc/allAcc" in log
    last = tmp_path / "exp" / "model" / "model_last.pth"
    assert last.is_file() and (tmp_path / "exp" / "model" / "model_best.pth").is_file()
    resumed = train_main(_cli_args(tmp_path / "exp", data, "eval_epoch=2", "resume=True"))
    assert resumed.start_epoch == 1 and resumed.step == 4
    assert torch.load(last, weights_only=True)["step"] == 4


def _tiny(cfg, **options):
    cfg.merge_from_dict({k: DictAction._parse_value(v) for k, v in (o.split("=", 1) for o in TINY_PIGSEG)})
    cfg.merge_from_dict(options)
    return cfg


def test_trainer_amp_casts_the_features_only(tmp_path):
    data = tmp_path / "data"
    write_pig_clouds(data, {"train": 2}, 400)
    cfg = _tiny(Config.fromfile(PIGSEG), save_path=str(tmp_path / "exp"), amp="bf16", seed=0, evaluate=False,
                **{"data.train.data_root": str(data), "data.train.loop": 20})
    trainer = Trainer(cfg, device="cpu")
    seen = []
    backbone = trainer.model.backbone
    forward = backbone.forward
    backbone.forward = lambda point, generator=None: seen.append(point.feat.dtype) or forward(point, generator)
    trainer.comm_info["input_dict"] = next(iter(trainer.train_loader))
    trainer.run_step()
    assert seen == [torch.bfloat16]
    assert np.isfinite(trainer.comm_info["metrics"]["loss"])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in trainer.model.parameters())
    cfg.merge_from_dict({"amp": "int8"})
    with pytest.raises(ValueError, match="amp"):
        Trainer(cfg, device="cpu")


def test_scannet_recipe_builds_with_its_param_dicts_ignored(tmp_path):
    """The recipe's top-level ``param_dicts`` is read by neither JAX nor the port: one group, one rate."""
    cfg = Config.fromfile(os.path.join(REPO, "configs/scannet/semseg-pt-v3m1-0-base.py"))
    assert cfg.param_dicts and "param_dicts" not in cfg.optimizer and cfg.amp == "bf16"
    data = dict(type="SyntheticSemSegDataset", num_scenes=2, num_points=600, num_classes=20,
                transform=Config.fromfile(SEMSEG_MINI).data.train.transform)
    _tiny(cfg, save_path=str(tmp_path), mix_prob=0.0, **{"data.train": dict(data, _delete_=True, loop=20),
                                                          "evaluate": False, "model.backbone.in_channels": 6})
    trainer = Trainer(cfg, device="cpu")
    assert len(trainer.optimizer.param_groups) == 1
    assert trainer.optimizer.param_groups[0]["lr"] == 0.006
    assert trainer.amp_dtype == torch.bfloat16


# ---- one training step ----------------------------------------------------------------------------


def _batch():
    rng = np.random.default_rng(1)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=100, span=8)
    segment = rng.integers(0, CLASSES, SAMPLES * SLOT).astype(np.int32)
    segment[rng.random(SAMPLES * SLOT) < 0.1] = -1
    segment[~scene["valid"]] = -1  # collate's pad value
    return dict(coord=scene["coord"], grid_coord=scene["grid_coord"], valid=scene["valid"], segment=segment,
                feat=rng.normal(size=(SAMPLES * SLOT, 4)).astype(np.float32))


def _jax_step():
    """JAX's loss, grads, new batch stats and logits' dtype of one training step, f32 and amp bf16
    (``engines/train.py:219-226``: only the features cast, the loss to f32), in one compile."""
    model = jax_build_model(CFG)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = jax_variables_for(build_model(CFG), np.random.default_rng(0))

    def loss_fn(params, batch_stats, b, dtype):
        point = JaxPointBatch(coord=b["coord"], feat=b["feat"].astype(dtype), grid_coord=b["grid_coord"],
                              valid=b["valid"], num_samples=SAMPLES)
        out, mutated = model.apply({"params": params, "batch_stats": batch_stats}, point, b, train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return out["loss"].astype(jnp.float32), (mutated["batch_stats"], out["seg_logits"])

    def both(params, batch_stats, b):
        return {name: jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats, b, dtype)
                for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}

    args = (variables["params"], variables["batch_stats"], batch)
    out = jax.jit(both).lower(*args).compile(FAST_COMPILE)(*args)
    res = {}
    for name, ((loss, (stats, logits)), grads) in out.items():
        res[name] = dict(loss=float(loss), logits_dtype=logits.dtype, grads=jax.tree.map(np.array, grads),
                         stats=jax.tree.map(np.array, stats))
    return dict(variables=variables, **res)


@pytest.fixture(scope="module", autouse=True)
def jax_step_future():
    """The JAX step, traced and compiled in a thread from the file's first test on: the compile
    (most of the file's time) runs beside the tests before the step's."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_step)


@pytest.fixture(scope="module")
def step(jax_step_future):
    return jax_step_future.result()


def _port_step(variables, dtype):
    model = build_model(CFG)
    model.load_state_dict(convert_variables(variables))
    model.train()
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    point = PointBatch(coord=b["coord"], feat=b["feat"].to(dtype), grid_coord=b["grid_coord"], valid=b["valid"],
                       num_samples=SAMPLES)
    out = model(point, b)
    out["loss"].backward()
    return model, out


def test_segmentor_training_step_matches_jax(step):
    model, out = _port_step(step["variables"], torch.float32)
    ref = step["f32"]
    np.testing.assert_allclose(out["loss"].item(), ref["loss"], rtol=1e-5)
    grads = convert_variables({"params": ref["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, want in grads.items():
        tol = 2e-5 * max(1.0, want.abs().max().item())
        torch.testing.assert_close(params[name].grad, want, rtol=0, atol=tol, msg=lambda m, name=name: f"{name}: {m}")
    stats = convert_variables({"batch_stats": ref["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) and len(stats) == 4  # stem and pooling norms, mean and var
    for name, want in stats.items():
        torch.testing.assert_close(buffers[name], want, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def test_segmentor_amp_step_matches_jax_amp(step):
    model, out = _port_step(step["variables"], torch.bfloat16)
    assert out["seg_logits"].dtype == torch.float32 and step["bf16"]["logits_dtype"] == jnp.float32  # flax's promotion
    assert out["loss"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in model.parameters())
    ref16, ref32 = step["bf16"], step["f32"]
    tensors = {"loss": ({"loss": torch.tensor(ref16["loss"])}, {"loss": torch.tensor(ref32["loss"])},
                        {"loss": out["loss"].detach()}),
               "grad": (convert_variables({"params": ref16["grads"]}), convert_variables({"params": ref32["grads"]}),
                        {k: p.grad for k, p in model.named_parameters()}),
               "stat": (convert_variables({"batch_stats": ref16["stats"]}),
                        convert_variables({"batch_stats": ref32["stats"]}), dict(model.named_buffers()))}
    worst = 0.0
    for kind, (want16, want32, got) in tensors.items():
        for name, w16 in want16.items():
            jax_err = (w16 - want32[name]).abs().max().item()
            port_err = (got[name] - w16).abs().max().item()
            floor = 2**-8 * w16.abs().max().item()
            worst = max(worst, port_err / max(jax_err, floor))
            assert port_err <= AMP_RATIO * max(jax_err, floor), (kind, name, port_err, jax_err)
    # and the port rounds as JAX does: against JAX f32 it is off by about JAX bf16's own deviation, not by
    # f32 rounding alone (a port computing in f32 inside would read ~1e-4 here)
    grads16, grads32, port = tensors["grad"]
    off = max((port[k] - grads32[k]).abs().max().item() / (grads16[k] - grads32[k]).abs().max().item() for k in port)
    print(f"amp step: port bf16 against JAX bf16, at most {worst:.3f} x JAX bf16's deviation from JAX f32; port "
          f"bf16 against JAX f32, up to {off:.3f} x that deviation")
    assert off >= 0.25


def test_conv_weight_gradient_reaches_f32_weight_unrounded():
    """Under amp the xCPE's f32 W meets bf16 features: the conv computes with W in bf16, and W's
    gradient is B4's f32 dW (here its plain version), not a bf16 rounding of it, as in JAX's
    ``_subm_conv_sym``, whose backward returns dW in W's dtype."""
    rng = np.random.default_rng(6)
    n, c = 64, 8
    kmap = SimpleNamespace(neighbor_idx=torch.from_numpy(rng.integers(0, n + 1, (n, 27)).astype(np.int32)))
    feat = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(27, c, c)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(torch.bfloat16)
    out = sparse_conv(feat, kmap, w)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, subm_conv_plain(feat, kmap.neighbor_idx, w.detach().to(torch.bfloat16)),
                               rtol=0, atol=0)
    out.backward(g)
    dw = subm_conv_dw_plain(feat, kmap.neighbor_idx, g)
    assert w.grad.dtype == torch.float32 and not torch.equal(dw, dw.to(torch.bfloat16).float())
    torch.testing.assert_close(w.grad, dw, rtol=0, atol=0)
