"""The committed instance-segmentation checkpoint and the insseg path in the port, against the JAX package.

``exp/insseg_r3`` (PG-v1m1 over a small SpUNet, k=3 stem, trained weights)
through the port's ``test`` CLI on the CPU, against JAX's ``InsSegTester`` on
the same 6 val scenes, and on one of them mapped onto a raw-resolution cloud
(``origin_coord``) by the port's 1-nn ``knn``; the ``InsSegEvaluator`` hook after a tiny CPU
training run of the mini insseg recipe, against JAX's clustering,
association and AP applied to the same model's outputs; and the CLI's
default device and weight lookup.

The scenes: ``GridSample`` (train mode) draws them from the global
``np.random``, so each package's are made after ``np.random.seed`` of the
recipe's seed, 7, in the main thread; JAX's tester is handed its scenes and
runs in a thread started by the file's first test (its forward compiled
with XLA's cheaper CPU passes), the port's CLI builds its own after a fresh
seed.  ``scripts/insseg_r3_anchor_by_seed.py`` reads both packages at other
seeds (mAP 0.749739-0.766294 over seeds 0-3 and 7, equal in both).

Tolerances: the scenes equal; mAP, AP50 and AP25 within 1e-4 of JAX's (the
labels come from the same f32 distances and integer clustering, so they are
expected equal to 4 decimals or better) and at or above the bounds of
``tests/test_insseg_checkpoint.py``: mAP 0.70, AP50 0.85 (and AP25 0.85);
the hook's mAP, AP50 and AP25 equal to JAX's pipeline on the same outputs.
"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one torch thread)

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate
from pointcept_keypointdetection_tpu.engines.hooks import insseg_evaluator as jax_eval
from pointcept_keypointdetection_tpu.engines.test import InsSegTester as JaxInsSegTester
from pointcept_keypointdetection_tpu.engines.test import sample_to_device as jax_sample_to_device
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models import point_group as jax_pg
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from pointcept_keypointdetection_tpu.utils.config import Config as JaxConfig
from pointcept_keypointdetection_tpu_torch import test as test_cli
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device
from pointcept_keypointdetection_tpu_torch.engines.hooks.insseg_evaluator import InsSegEvaluator
from pointcept_keypointdetection_tpu_torch.engines.test import InsSegTester
from pointcept_keypointdetection_tpu_torch.engines.train import Trainer
from pointcept_keypointdetection_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "exp", "insseg_r3", "config.py")
CKPT = os.path.join(REPO, "exp", "insseg_r3", "model_params.ckpt")
MINI = os.path.join(REPO, "configs", "synthetic", "insseg-pointgroup-mini.py")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SEED = 7  # the recipe's
AP_TOL = 1e-4


class Scenes:
    """Scenes made beforehand, handed out as fresh copies (the testers pop their keys)."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return copy.deepcopy(self.scenes[i])


def _scenes(builder, cfg):
    ds = builder(dict(cfg.data.test))
    np.random.seed(SEED)
    return [ds[i] for i in range(len(ds))]


def _projected(scenes):
    """The first scene with a raw-resolution cloud to map the proposals onto: ``origin_coord`` (2 rows per
    voxel row on average, 1 mm of noise) with its ``origin_segment`` and ``origin_instance``."""
    rng = np.random.default_rng(9)
    out = []
    for scene in scenes[:1]:
        n = min(scene["coord"].shape[0], 4096)  # the rows the tester keeps at its capacity
        pick = rng.integers(0, n, 2 * n)
        origin = (scene["coord"][pick] + 0.001 * rng.normal(size=(2 * n, 3))).astype(np.float32)
        out.append(dict(scene, origin_coord=origin, origin_segment=scene["segment"][pick],
                        origin_instance=scene["instance"][pick]))
    return out


def _jax_anchor(scenes, tmp):
    """In a thread: JAX's InsSegTester over the scenes, with the checkpoint's variables, then over the
    first with a raw-resolution cloud to map onto."""
    cfg = JaxConfig.fromfile(CONFIG)
    cfg.save_path = tmp
    ck = jax_load_checkpoint(CKPT)
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    t = cfg.test
    tester = JaxInsSegTester(cfg, segment_ignore_index=tuple(t.segment_ignore_index), cluster_thresh=t.cluster_thresh,
                             cluster_min_points=t.cluster_min_points, capacity=t.capacity,
                             model=jax_build_model(dict(cfg.model)), variables=variables, test_loader=Scenes(scenes))
    tester._build_forward()  # JAX's own forward, compiled here with the cheaper passes (one capacity)
    # a scene's rows truncated to the capacity, as the tester truncates them: a collate of more would draw
    # its subsample from np.random, which the main thread's tests use
    probe = jax_sample_to_device(jax_collate([{k: v[:t.capacity] for k, v in scenes[0].items()}], t.capacity))
    forward = tester._forward.lower(variables, probe).compile(FAST_COMPILE)
    tester._forward = lambda v, batch: forward(v, {k: batch[k] for k in probe})  # the model reads no other key
    result = tester.test()
    tester.test_dataset = Scenes(_projected(scenes))
    return result, tester.test()


@pytest.fixture(scope="module", autouse=True)
def reference_future(tmp_path_factory):
    """Both packages' val scenes (seeded, one after the other), then JAX's tester in a thread."""
    cfg = Config.fromfile(CONFIG)
    jax_scenes, port_scenes = _scenes(jax_build_dataset, cfg), _scenes(build_dataset, cfg)
    with ThreadPoolExecutor(1) as pool:
        yield jax_scenes, port_scenes, pool.submit(_jax_anchor, jax_scenes, str(tmp_path_factory.mktemp("jax")))


def test_val_scenes_are_the_same_in_both_packages(reference_future):
    jax_scenes, port_scenes, _ = reference_future
    assert len(port_scenes) == len(jax_scenes) == 6
    for got, ref in zip(port_scenes, jax_scenes):
        assert set(got) == set(ref)
        for key, value in ref.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_test_cli_defaults_to_the_card_and_finds_the_weight(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        test_cli.main(["--config-file", CONFIG, "--options", f"save_path={tmp_path}"])
    cfg = Config.fromfile(CONFIG)
    cfg.save_path = str(tmp_path)
    args = {k: v for k, v in cfg.test.items() if k != "type"}
    tester = InsSegTester(cfg, device="cpu", test_loader=Scenes([]), **args)
    assert os.path.samefile(tester.weight_path(), CKPT) and tester.capacity == 4096
    assert tester.cluster_thresh == 0.08 and tester.segment_ignore_index == (-1, 0, 1)


def test_insseg_evaluator_after_a_tiny_training_run(tmp_path):
    """The mini insseg recipe, 2 steps on the CPU, then the hook: its mAP, AP50 and AP25 are JAX's
    clustering, proposals, association and AP over the same val batches and model outputs; the extra
    loss scalars reach the trainer's metrics."""
    cfg = Config.fromfile(MINI)
    cfg.merge_from_dict({"save_path": str(tmp_path), "eval_epoch": 1, "batch_size": 2, "slot_size": 1024,
                         "num_worker": 0, "data.train.num_scenes": 4, "data.train.loop": 1,
                         "data.train.num_points": 2000, "data.val.num_scenes": 2, "data.val.num_points": 2000})
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert {"loss", "loss_seg", "loss_bias", "loss_dir"} <= set(trainer.comm_info["metrics"])
    hook = next(h for h in trainer.hooks if isinstance(h, InsSegEvaluator))
    assert trainer.comm_info["current_metric_name"] == "mAP"
    assert set(hook.last_times) == {"forward_s", "cluster_s", "ap_s"}
    assert os.path.isfile(tmp_path / "model" / "model_last.pth")

    model = trainer.model.eval()
    scenes = []
    for batch_np in trainer.val_loader:
        b = sample_to_device(batch_np, "cpu")
        point = build_point_batch(b, batch_np["num_samples"])
        with torch.no_grad():
            out = model(point, b)
        probs = torch.softmax(out["seg_logits"], -1).numpy()
        seg_pred = probs.argmax(-1).astype(np.int32)
        batch_ids = point.batch.numpy()
        labels = jax_pg.cluster_proposals(jnp.asarray(batch_np["coord"]), jnp.asarray(seg_pred),
                                          jnp.asarray(out["bias_pred"].numpy()), jnp.asarray(batch_np["valid"]),
                                          jnp.asarray(batch_ids), hook.cluster_thresh, hook.segment_ignore_index,
                                          hook.min_points)
        masks, classes, scores = jax_pg.proposals_from_labels(labels, seg_pred, probs)
        scenes += jax_eval.associate_batch(masks, classes, scores, batch_np["valid"], batch_ids, batch_np["segment"],
                                           batch_np["instance"], int(batch_np["num_samples"]), cfg.data.num_classes,
                                           hook.segment_ignore_index, hook.instance_ignore_index)
    class_ids = [c for c in range(cfg.data.num_classes) if c not in hook.segment_ignore_index]
    ref = jax_eval.summarize_ap(jax_eval.evaluate_matches(scenes, class_ids))
    got = trainer.comm_info["current_metric_value"]
    assert got == ref[0] or (np.isnan(got) and np.isnan(ref[0])), (got, ref)


# ---- JAX's readings (its thread runs while the tests above run) ----------------------------------------


def test_insseg_r3_anchor_through_the_test_cli_matches_jax(reference_future, tmp_path):
    """The port's ``test`` CLI on the CPU over ``exp/insseg_r3/config.py`` with its committed weight."""
    np.random.seed(SEED)
    got = test_cli.main(["--config-file", CONFIG, "--device", "cpu", "--options", f"save_path={tmp_path}"])
    ref = reference_future[2].result()[0]
    print(f"exp/insseg_r3 (np.random seed {SEED}): port mAP/AP50/AP25 {got['mAP']:.6f}/{got['AP50']:.6f}/"
          f"{got['AP25']:.6f}, JAX {ref['mAP']:.6f}/{ref['AP50']:.6f}/{ref['AP25']:.6f}")
    for key in ("mAP", "AP50", "AP25"):
        assert abs(got[key] - ref[key]) <= AP_TOL, (key, got, ref)
    assert got["mAP"] >= 0.70 and got["AP50"] >= 0.85 and got["AP25"] >= 0.85, got


def test_insseg_tester_maps_proposals_to_the_raw_points_as_jax(reference_future, tmp_path):
    """The tester's 1-nn map of the proposal masks onto ``origin_coord``, scored on ``origin_segment`` and
    ``origin_instance`` (`engines/test.py:575-590`), port against JAX on the same scenes."""
    cfg = Config.fromfile(CONFIG)
    cfg.save_path = str(tmp_path)
    args = {k: v for k, v in cfg.test.items() if k != "type"}
    tester = InsSegTester(cfg, device="cpu", test_loader=Scenes(_projected(reference_future[1])), **args)
    got, ref = tester.test(), reference_future[2].result()[1]
    print(f"mapped to the raw points (1 scene): port {got}, JAX {ref}")
    for key in ("mAP", "AP50", "AP25"):
        assert abs(got[key] - ref[key]) <= AP_TOL, (key, got, ref)
    assert got["AP50"] > 0.5
