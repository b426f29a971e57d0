"""Keypoint validation after every epoch: the counterparts of
``KeypointEvaluator`` and ``OffsetKeypointEvaluator``
(``pointcept_keypointdetection_tpu/engines/hooks/keypoint_evaluator.py:
26-73``, ``:114-196``).

``KeypointEvaluator`` (the global-regression heads): per val sample and
keypoint, the distance between ``keypoint_pred`` and the normalized target
times the sample's ``scale``; it logs the mean per keypoint over the val set
and their mean, and publishes minus that mean as the metric the checkpoint
saver keeps the best of.

``OffsetKeypointEvaluator``, per val sample: the ground-truth keypoint is
the mean of (point + target offset) over the points whose target mask is
set; the prediction is
``aggregate_keypoints`` over the valid rows, ``argmax`` (the point of
highest confidence and its offset) and ``weighted`` (confidence-weighted
mean above ``threshold``).  Distances are in mm (times the sample's scale);
the negated mean of ``aggregate`` is the metric the checkpoint saver keeps
the best of.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import expit

from ...inference.keypoint import aggregate_keypoints
from ...utils.logger import get_root_logger
from ..common import build_point_batch, sample_to_device
from . import HOOKS, HookBase

METHODS = ("argmax", "weighted")


@HOOKS.register_module()
class KeypointEvaluator(HookBase):
    def after_epoch(self):
        trainer = self.trainer
        if trainer.val_loader is None:
            return
        model = trainer.model
        dist_sum, count = 0.0, 0
        model.eval()
        with torch.no_grad():
            for batch_np in trainer.val_loader:
                ns = batch_np["num_samples"]
                out = model(build_point_batch(sample_to_device(batch_np, trainer.device), ns))
                pred = out["keypoint_pred"].float().cpu().numpy()  # [B, K, 3], normalized
                dist = np.linalg.norm(pred - batch_np["keypoint"], axis=-1) * batch_np["scale"][:, None]
                dist_sum = dist_sum + dist.sum(0)
                count += ns
        model.train()
        logger = get_root_logger()
        per_kp = np.atleast_1d(dist_sum / max(count, 1))
        mean_dist = float(per_kp.mean())
        for k, v in enumerate(per_kp):
            logger.info(f"Keypoint_{k} mean distance: {v:.2f}")
        logger.info(f"Val result: mean keypoint distance {mean_dist:.2f}")
        trainer.storage.put_scalar("val/keypoint_dist", mean_dist)
        trainer.comm_info["current_metric_value"] = -mean_dist  # the smallest distance wins
        trainer.comm_info["current_metric_name"] = "neg_keypoint_dist"


def keypoint_distances(coord, valid, offset_pred, mask_prob, offset_gt, mask_gt, scale, num_samples, threshold):
    """{method: [B, K] distances in mm} over the slots of one batch (numpy arrays)."""
    s = coord.shape[0] // num_samples
    out = {m: [] for m in METHODS}
    for b in range(num_samples):
        rows = slice(b * s, (b + 1) * s)
        v = valid[rows]
        c = coord[rows][v]
        w = mask_gt[rows][v]  # [n, K]
        cand = c[:, None, :] + offset_gt[rows][v]
        gt = (cand * w[..., None]).sum(0) / np.maximum(w.sum(0), 1e-6)[:, None]
        for m in METHODS:
            pred = aggregate_keypoints(c, offset_pred[rows][v], mask_prob[rows][v], m, threshold)
            out[m].append(np.linalg.norm(pred - gt, axis=-1) * scale[b])
    return {m: np.stack(d) for m, d in out.items()}


@HOOKS.register_module()
class OffsetKeypointEvaluator(HookBase):
    def __init__(self, aggregate: str = "argmax", threshold: float = 0.5):
        if aggregate not in METHODS:
            raise ValueError(f"aggregate must be one of {METHODS}, got {aggregate!r}")
        self.aggregate = aggregate
        self.threshold = threshold

    def after_epoch(self):
        trainer = self.trainer
        if trainer.val_loader is None:
            return
        model = trainer.model
        sums = {m: 0.0 for m in METHODS}
        count = 0
        model.eval()
        with torch.no_grad():
            for batch_np in trainer.val_loader:
                ns = batch_np["num_samples"]
                batch = sample_to_device(batch_np, trainer.device)
                out = model(build_point_batch(batch, ns))
                dist = keypoint_distances(
                    batch_np["coord"], batch_np["valid"], out["offset_pred"].float().cpu().numpy(),
                    expit(out["mask_logits"].float().cpu().numpy()), batch_np["keypoint_offset"],
                    batch_np["keypoint_mask"], batch_np["scale"], ns, self.threshold)
                for m in METHODS:
                    sums[m] = sums[m] + dist[m].sum(0)
                count += ns
        model.train()
        logger = get_root_logger()
        means = {}
        for m in METHODS:
            per_kp = sums[m] / max(count, 1)
            means[m] = float(np.mean(per_kp))
            logger.info(f"Keypoint mean distance [{m}]: {means[m]:.2f} (per-KP: "
                        f"{' / '.join(f'{v:.1f}' for v in np.atleast_1d(per_kp))})")
        mean_dist = means[self.aggregate]
        logger.info(f"Val result: mean keypoint distance {mean_dist:.2f} ({self.aggregate})")
        trainer.storage.put_scalar("val/keypoint_dist", mean_dist)
        trainer.storage.put_scalar("val/keypoint_dist_weighted", means["weighted"])
        trainer.storage.put_scalar("val/keypoint_dist_argmax", means["argmax"])
        trainer.comm_info["current_metric_value"] = -mean_dist
        trainer.comm_info["current_metric_name"] = "neg_keypoint_dist"
