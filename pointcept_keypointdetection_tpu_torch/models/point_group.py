"""PointGroup instance segmentation: the port's ``PointGroup`` (``PG-v1m1`` over
SpUNet, ``PG-v1m2`` over PTv3), ``cluster_proposals`` and
``proposals_from_labels`` (``pointcept_keypointdetection_tpu/models/
point_group.py:32-160``).

backbone -> per-point features -> ``seg_head`` (semantic logits) and
``offset_fc`` -> ``offset_norm`` -> ReLU -> ``offset_head`` (the shift of
each point to its instance's centre).  The heads are flax ``nn.Dense``
without a dtype, so they compute in the promoted dtype of their input and
their f32 parameters: f32 under ``amp`` too.  ``offset_norm`` is flax's
``nn.LayerNorm`` with its defaults: eps 1e-6 and the fast variance
E[x^2] - E[x]^2, not PTv3's LayerNorm (eps 1e-5).

Losses, in f32, where the batch has ``segment`` and ``instance_centroid``:
the criteria's semantic loss, an L1 of the shift against ``instance_centroid
- coord`` over the points of an instance, and 1 - the cosine of the two;
``loss`` is their sum, and each is returned beside it.

Inference clusters ``coord + bias_pred`` with ``ops.cluster.
connected_components`` over the non-ignored predicted classes; cluster
labels are global over the collated batch (clusters never cross samples).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cluster import connected_components
from .builder import MODELS, build_model
from .losses import build_criteria
from .norm import LayerNorm
from .sparse_unet import _dense
from .structure import PointBatch


@MODELS.register_module("PG-v1m1")
@MODELS.register_module("PG-v1m2")
class PointGroup(nn.Module):
    def __init__(self, backbone: Dict[str, Any], criteria: Sequence[Dict[str, Any]] = (dict(type="CrossEntropyLoss"),),
                 backbone_out_channels: int = 64, semantic_num_classes: int = 20, semantic_ignore_index: int = -1,
                 segment_ignore_index: Sequence[int] = (-1, 0, 1), instance_ignore_index: int = -1,
                 cluster_thresh: float = 1.5, voxel_size: float = 0.02):
        super().__init__()
        c = backbone_out_channels
        self.backbone = build_model(dict(backbone))
        self.seg_head = nn.Linear(c, semantic_num_classes)
        self.offset_fc = nn.Linear(c, c)
        self.offset_norm = LayerNorm(c, eps=1e-6, fast_variance=True)
        self.offset_head = nn.Linear(c, 3)
        self.criteria = build_criteria([dict(cc) for cc in criteria])
        self.instance_ignore_index = instance_ignore_index

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        feat = self.backbone(point, generator)
        seg_logits = _dense(feat, self.seg_head)
        bias_pred = _dense(F.relu(self.offset_norm(_dense(feat, self.offset_fc))), self.offset_head)
        out = {"seg_logits": seg_logits, "bias_pred": bias_pred}
        if batch is None or "instance_centroid" not in batch or "segment" not in batch:
            return out
        loss_seg = self.criteria(seg_logits, batch["segment"], valid=point.valid)
        w = ((batch["instance"] != self.instance_ignore_index) & point.valid).float()
        count = w.sum().clamp_min(1.0)
        gt_bias = batch["instance_centroid"] - point.coord
        shift = bias_pred.float()
        loss_bias = torch.sum((shift - gt_bias).abs().sum(-1) * w) / count
        norms = torch.linalg.norm(gt_bias, dim=-1) * torch.linalg.norm(shift, dim=-1)
        cosine = torch.sum(shift * gt_bias, dim=-1) / norms.clamp_min(1e-8)
        loss_dir = torch.sum((1.0 - cosine) * w) / count
        out.update(loss=loss_seg + loss_bias + loss_dir, loss_seg=loss_seg, loss_bias=loss_bias, loss_dir=loss_dir)
        return out


def cluster_proposals(coord: torch.Tensor, seg_pred: torch.Tensor, bias_pred: torch.Tensor, valid: torch.Tensor,
                      batch: Optional[torch.Tensor] = None, cluster_thresh: float = 0.03,
                      segment_ignore_index: Tuple[int, ...] = (-1, 0, 1), min_points: int = 50,
                      dual: bool = False) -> np.ndarray:
    """Instance labels int32[N] on the host (-1: background) from clustering ``coord + bias_pred``
    over the non-ignored predicted classes, clusters under ``min_points`` dropped; ``dual`` also
    clusters ``coord`` and fills the uncovered points from those clusters."""
    ignore = tuple(int(i) for i in segment_ignore_index)
    labels = connected_components(coord + bias_pred.to(coord.dtype), seg_pred, valid, cluster_thresh, batch=batch,
                                  ignore_classes=ignore).cpu().numpy()
    if dual:
        lab_a = connected_components(coord, seg_pred, valid, cluster_thresh, batch=batch,
                                     ignore_classes=ignore).cpu().numpy()
        offset = labels.max() + 1 if labels.max() >= 0 else 0
        fill = (labels < 0) & (lab_a >= 0)
        labels[fill] = lab_a[fill] + offset
    uniq, counts = np.unique(labels[labels >= 0], return_counts=True)
    small = uniq[counts < min_points]
    if small.size:
        labels[np.isin(labels, small)] = -1
    return labels


def proposals_from_labels(labels, seg_pred, seg_probs=None, propose_points: int = 0):
    """Cluster labels -> (masks bool[P, N], classes [P], scores [P]): a proposal's class is its
    members' majority predicted class, its score their mean probability of it (the cluster's share
    of the points without probabilities); proposals of ``propose_points`` points or fewer dropped."""
    labels = np.asarray(labels)
    seg_pred = np.asarray(seg_pred)
    masks, classes, scores = [], [], []
    for u in np.unique(labels[labels >= 0]):
        m = labels == u
        if propose_points and m.sum() <= propose_points:
            continue
        cls = np.bincount(seg_pred[m]).argmax()
        if seg_probs is not None:
            score = float(np.asarray(seg_probs)[m, cls].mean())
        else:
            score = float(m.sum()) / max(len(labels), 1)
        masks.append(m)
        classes.append(int(cls))
        scores.append(score)
    if not masks:
        return np.zeros((0, len(labels)), bool), np.zeros(0, int), np.zeros(0)
    return np.stack(masks), np.asarray(classes, int), np.asarray(scores)
