"""Instance segmentation evaluation: ScanNet-devkit AP and the ``InsSegEvaluator`` hook.

The port's copies of ``associate_instances``, ``associate_batch``,
``evaluate_matches`` and ``summarize_ap`` (``pointcept_keypointdetection_tpu/
engines/hooks/insseg_evaluator.py:25-267``), host numpy, line for line: per
scene, predicted masks are associated with the ground-truth instances they
intersect; AP per class at IoU overlaps 0.5:0.05:0.95 (mAP) and 0.25, with
the devkit's minimum region size and its forgiveness of void and
too-small-instance overlaps.

``InsSegEvaluator`` (`insseg_evaluator.py:270-312`): after every epoch, each
val batch runs the model in eval mode (f32 features, as the JAX eval step,
``amp`` or not); the softmax's argmax and the shifts are clustered
(``models.point_group.cluster_proposals``: labels global over the batch),
the proposals scored by their mean confidence, associated per sample
(``associate_batch``) and evaluated over all val scenes.  Logged: mAP, AP50
and AP25; stored: ``val/mAP``, the metric the checkpoint saver keeps the
best of.  The times of the forwards and of the clustering are kept in
``last_times`` (host clock, each ending in a host read).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from ...models.point_group import cluster_proposals, proposals_from_labels
from ...utils.logger import get_root_logger
from ..common import build_point_batch, sample_to_device
from . import HOOKS, HookBase

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


def associate_instances(
    pred_classes: np.ndarray,  # int[P]
    pred_scores: np.ndarray,  # float[P]
    pred_masks: np.ndarray,  # bool[P, N]
    segment: np.ndarray,  # int[N]
    instance: np.ndarray,  # int[N]
    num_classes: int,
    segment_ignore_index: Sequence[int] = (-1,),
    instance_ignore_index: int = -1,
):
    """Build the per-scene gt/pred association structure."""
    void_mask = np.isin(segment, segment_ignore_index)
    gt: Dict[int, List[dict]] = {c: [] for c in range(num_classes) if c not in segment_ignore_index}
    pr: Dict[int, List[dict]] = {c: [] for c in gt}

    ids, idx, counts = np.unique(instance, return_index=True, return_counts=True)
    seg_of = segment[idx]
    for i in range(len(ids)):
        if ids[i] == instance_ignore_index or seg_of[i] in segment_ignore_index:
            continue
        if seg_of[i] not in gt:
            continue
        gt[seg_of[i]].append(
            dict(instance_id=ids[i], vert_count=counts[i], matched_pred=[])
        )

    uid = 0
    for p in range(len(pred_classes)):
        c = int(pred_classes[p])
        if c in segment_ignore_index or c not in pr:
            continue
        mask = pred_masks[p] != 0
        vert = int(mask.sum())
        if vert < MIN_REGION_SIZE:
            continue
        inst = dict(
            uid=uid,
            confidence=float(pred_scores[p]),
            vert_count=vert,
            void_intersection=int(np.logical_and(void_mask, mask).sum()),
            matched_gt=[],
        )
        uid += 1
        for g in gt[c]:
            inter = int(np.logical_and(instance == g["instance_id"], mask).sum())
            if inter > 0:
                inst["matched_gt"].append(dict(g, intersection=inter))
                g["matched_pred"].append(dict(inst, intersection=inter))
        pr[c].append(inst)
    return gt, pr


def associate_batch(
    masks: np.ndarray,  # bool[P, N_total] proposal masks over the padded batch
    classes: np.ndarray,
    scores: np.ndarray,
    valid: np.ndarray,  # bool[N_total]
    batch_ids: np.ndarray,  # int[N_total] slot -> sample id
    segment: np.ndarray,
    instance: np.ndarray,
    num_samples: int,
    num_classes: int,
    segment_ignore_index: Sequence[int] = (-1,),
    instance_ignore_index: int = -1,
) -> List[dict]:
    """Per-SAMPLE association structures for a collated val batch.

    Instance ids are scene-local (0..k per scene): a collated batch treated
    as one scene would fuse same-id instances across scenes and crater the
    AP (regression: round-3 training logs reported mAP 0.017 where the
    per-scene tester measured 0.739 on the same checkpoint).  Clusters never
    cross samples — ``cluster_proposals`` respects ``point.batch`` — so each
    proposal is assigned to the sample its points live in.
    """
    scenes = []
    for s in range(num_samples):
        sel = valid & (batch_ids == s)
        if not sel.any():
            continue
        if len(masks):
            keep = masks[:, sel].any(axis=1)
            m_s, c_s, s_s = masks[keep][:, sel], classes[keep], scores[keep]
        else:
            m_s, c_s, s_s = masks, classes, scores
        gt, pr = associate_instances(
            c_s, s_s, m_s, segment[sel], instance[sel],
            num_classes, segment_ignore_index, instance_ignore_index,
        )
        scenes.append(dict(gt=gt, pr=pr))
    return scenes


def evaluate_matches(scenes: List[dict], class_ids: Sequence[int]):
    """AP per (class, overlap) over the scene association structures.

    Exact ScanNet-devkit semantics (verified numerically against the
    reference implementation in tests/test_reference_oracle.py):
    greedy highest-priority matching with a per-overlap visited set, GT
    min-region filtering, void/small-GT forgiveness for unmatched
    predictions, and threshold-wise precision/recall integrated with the
    [-0.5, 0, 0.5] convolution step widths
    (`engines/hooks/evaluator.py:344-546`).
    """
    ap = np.zeros((len(class_ids), len(OVERLAPS)))
    for oi, overlap_th in enumerate(OVERLAPS):
        # scene-local visited sets: one prediction may satisfy only one gt
        visited = {}
        for si, scene in enumerate(scenes):
            for c in class_ids:
                for m in scene["pr"].get(c, []):
                    visited[(si, m["uid"])] = False
        for ci, c in enumerate(class_ids):
            y_true, y_score = [], []
            hard_false_negatives = 0
            has_gt = has_pred = False
            for si, scene in enumerate(scenes):
                preds = scene["pr"].get(c, [])
                gts = [g for g in scene["gt"].get(c, []) if g["vert_count"] >= MIN_REGION_SIZE]
                has_gt |= len(gts) > 0
                has_pred |= len(preds) > 0

                cur_true = list(np.ones(len(gts)))
                cur_score = list(np.full(len(gts), -np.inf))
                cur_match = list(np.zeros(len(gts), bool))
                for gi, g in enumerate(gts):
                    found = False
                    for m in g["matched_pred"]:
                        if visited[(si, m["uid"])]:
                            continue
                        iou = m["intersection"] / (
                            g["vert_count"] + m["vert_count"] - m["intersection"]
                        )
                        if iou > overlap_th:
                            conf = m["confidence"]
                            if cur_match[gi]:
                                # lower-confidence duplicate match -> FP
                                hi, lo = max(cur_score[gi], conf), min(cur_score[gi], conf)
                                cur_score[gi] = hi
                                cur_true.append(0.0)
                                cur_score.append(lo)
                                cur_match.append(True)
                            else:
                                found = True
                                cur_match[gi] = True
                                cur_score[gi] = conf
                                visited[(si, m["uid"])] = True
                    if not found:
                        hard_false_negatives += 1
                for t, sc, mt in zip(cur_true, cur_score, cur_match):
                    if mt:
                        y_true.append(t)
                        y_score.append(sc)

                # unmatched predictions -> false positives unless mostly void
                for m in preds:
                    matched = any(
                        m2["intersection"]
                        / (m2["vert_count"] + m["vert_count"] - m2["intersection"])
                        > overlap_th
                        for m2 in m["matched_gt"]
                    )
                    if not matched:
                        num_ignore = m["void_intersection"]
                        for m2 in m["matched_gt"]:
                            # overlaps with too-small gt instances are forgiven
                            if m2["vert_count"] < MIN_REGION_SIZE:
                                num_ignore += m2["intersection"]
                        if num_ignore / max(m["vert_count"], 1) <= overlap_th:
                            y_true.append(0.0)
                            y_score.append(m["confidence"])

            if has_gt and has_pred and y_score:
                order = np.argsort(np.asarray(y_score))
                ys = np.asarray(y_score)[order]
                yt = np.asarray(y_true)[order]
                yt_cum = np.cumsum(yt)
                thresholds, unique_indices = np.unique(ys, return_index=True)
                npr = len(unique_indices) + 1
                num_examples = len(ys)
                num_true = yt_cum[-1] if len(yt_cum) else 0
                precision = np.zeros(npr)
                recall = np.zeros(npr)
                yt_cum = np.append(yt_cum, 0)
                for idx_res, idx_scores in enumerate(unique_indices):
                    cumsum = yt_cum[idx_scores - 1]
                    tp = num_true - cumsum
                    fp = num_examples - idx_scores - tp
                    fn = cumsum + hard_false_negatives
                    precision[idx_res] = float(tp) / (tp + fp)
                    recall[idx_res] = float(tp) / (tp + fn) if (tp + fn) else 0.0
                precision[-1] = 1.0
                recall[-1] = 0.0
                r_conv = np.append(np.append(recall[0], recall), 0.0)
                step = np.convolve(r_conv, [-0.5, 0, 0.5], "valid")
                ap[ci, oi] = float(np.dot(precision, step))
            elif has_gt:
                ap[ci, oi] = 0.0
            else:
                ap[ci, oi] = np.nan
    return ap


def summarize_ap(ap: np.ndarray):
    with np.errstate(invalid="ignore"):
        o50 = np.where(np.isclose(OVERLAPS, 0.5))[0][0]
        o25 = np.where(np.isclose(OVERLAPS, 0.25))[0][0]
        main = ~np.isclose(OVERLAPS, 0.25)
        all_ap = np.nanmean(ap[:, main])
        ap50 = np.nanmean(ap[:, o50])
        ap25 = np.nanmean(ap[:, o25])
    return float(all_ap), float(ap50), float(ap25)


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1, cluster_thresh=0.05,
                 min_points=100):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.cluster_thresh = cluster_thresh
        self.min_points = min_points
        self.last_times: Dict[str, float] = {}

    def after_epoch(self):
        if self.trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        logger = get_root_logger()
        num_classes = trainer.cfg.data.num_classes
        model = trainer.model
        model.eval()
        scenes, forward_s, cluster_s = [], 0.0, 0.0
        for batch_np in trainer.val_loader:
            ns = batch_np["num_samples"]
            t0 = time.perf_counter()
            batch = sample_to_device(batch_np, trainer.device)
            point = build_point_batch(batch, ns)
            with torch.no_grad():
                out = model(point, batch)
                probs = torch.softmax(out["seg_logits"].float(), -1)
                seg_pred = probs.argmax(-1).to(torch.int32)
                seg_probs = probs.cpu().numpy()
            t1 = time.perf_counter()
            with torch.no_grad():
                labels = cluster_proposals(point.coord, seg_pred, out["bias_pred"], point.valid, point.batch,
                                           self.cluster_thresh, self.segment_ignore_index, self.min_points)
            t2 = time.perf_counter()
            forward_s, cluster_s = forward_s + t1 - t0, cluster_s + t2 - t1
            seg_pred = seg_pred.cpu().numpy()
            # proposal masks + mean-confidence scores (`point_group_v1m1_base.py:150-176`)
            masks, classes, scores = proposals_from_labels(labels, seg_pred, seg_probs)
            scenes.extend(associate_batch(
                masks, classes, scores, np.asarray(batch_np["valid"]), point.batch.cpu().numpy(),
                np.asarray(batch_np["segment"]), np.asarray(batch_np["instance"]), int(ns), num_classes,
                self.segment_ignore_index, self.instance_ignore_index))
        model.train()
        class_ids = [c for c in range(num_classes) if c not in self.segment_ignore_index]
        t0 = time.perf_counter()
        all_ap, ap50, ap25 = summarize_ap(evaluate_matches(scenes, class_ids))
        self.last_times = dict(forward_s=forward_s, cluster_s=cluster_s, ap_s=time.perf_counter() - t0)
        logger.info(f"Val result: mAP/AP50/AP25 {all_ap:.4f}/{ap50:.4f}/{ap25:.4f}")
        trainer.storage.put_scalar("val/mAP", all_ap)
        trainer.comm_info["current_metric_value"] = all_ap
        trainer.comm_info["current_metric_name"] = "mAP"
