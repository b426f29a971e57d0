"""Segmentation wrappers and the pig body-measure regressor: the counterparts of
``DefaultSegmentor``, ``DefaultSegmentorV2`` and ``PigBodyRegressor``
(``pointcept_keypointdetection_tpu/models/default.py:27-45``, ``:79-106``,
``:167-196``).

``DefaultSegmentor``'s backbone returns the logits itself (SpUNet's head);
with ``segment`` in the batch and ``criteria`` configured, ``loss`` is
``criteria(logits, segment, valid=point.valid)``.

Both segmentors hand out JAX's sown ``backbone_feat`` (`default.py:40`,
``:100``), which the SLAM front end pools into a scan embedding, only when
the caller asks (``backbone_feat=True``): ``DefaultSegmentor``'s is its
logits, ``DefaultSegmentorV2``'s the backbone's features before the head.

``DefaultSegmentorV2``'s backbone returns per-point features and the wrapper owns a linear seg
head.  The head is flax ``nn.Dense`` without a ``dtype``, so it computes in
the promoted dtype of its input and its parameters: bf16 in the bench, where
both are bf16, and f32 under ``amp``, where the features are bf16 and the
parameters f32.  With targets (``segment``) in the batch and ``criteria``
configured, ``loss`` is ``criteria(logits, segment, valid=point.valid)``;
the losses compute in f32 whatever the logits' dtype.

``PigBodyRegressor``'s backbone features are mean-pooled per sample (over
the slot, as ``KeypointModel``'s) into Dense 256 -> ReLU -> Dense 128 ->
ReLU -> ``cls_head`` (``num_measures`` outputs, in the labels' own units);
with ``weight_label`` [B, num_measures] in the batch, ``loss`` is the
criteria's (``RegressionL1Loss``) and ``mae_{i}`` the mean absolute error of
measure i over the batch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .builder import MODELS, build_model
from .keypoint import PromotedDense, pooled_features
from .losses import build_criteria
from .structure import PointBatch


@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    """backbone -> ``{"seg_logits": [N, num_classes]}`` (+ ``loss``, + ``backbone_feat`` when asked)."""

    def __init__(self, backbone: Dict[str, Any], criteria: Sequence[Dict[str, Any]] = ()):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria([dict(c) for c in criteria])

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, backbone_feat: bool = False) -> Dict[str, torch.Tensor]:
        logits = self.backbone(point, generator)
        out = {"seg_logits": logits}
        if backbone_feat:
            out["backbone_feat"] = logits
        if batch is not None and "segment" in batch and self.criteria.criteria:
            out["loss"] = self.criteria(logits, batch["segment"], valid=point.valid)
        return out


@MODELS.register_module()
class DefaultSegmentorV2(nn.Module):
    """backbone -> per-point features -> ``seg_head`` -> ``{"seg_logits": [N, num_classes]}`` (+ ``loss``, + the
    features as ``backbone_feat`` when asked)."""

    def __init__(self, backbone: Dict[str, Any], num_classes: int = 20, backbone_out_channels: int = 64,
                 criteria: Sequence[Dict[str, Any]] = ()):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.seg_head = nn.Linear(backbone_out_channels, num_classes)
        self.criteria = build_criteria([dict(c) for c in criteria])

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, backbone_feat: bool = False) -> Dict[str, torch.Tensor]:
        feat = self.backbone(point, generator)
        dtype = torch.promote_types(feat.dtype, self.seg_head.weight.dtype)
        logits = F.linear(feat.to(dtype), self.seg_head.weight.to(dtype), self.seg_head.bias.to(dtype))
        out = {"seg_logits": logits}
        if backbone_feat:
            out["backbone_feat"] = feat
        if batch is not None and "segment" in batch and self.criteria.criteria:
            out["loss"] = self.criteria(logits, batch["segment"], valid=point.valid)
        return out


@MODELS.register_module()
class PigBodyRegressor(nn.Module):
    """backbone -> mean pool per sample -> MLP -> ``measure_pred`` [B, num_measures]."""

    def __init__(self, backbone: Dict[str, Any], num_measures: int = 7,
                 criteria: Sequence[Dict[str, Any]] = (dict(type="RegressionL1Loss"),)):
        super().__init__()
        self.num_measures = num_measures
        self.backbone = build_model(dict(backbone))
        self.head = nn.Sequential(PromotedDense(self.backbone.out_channels, 256), nn.ReLU(), PromotedDense(256, 128),
                                  nn.ReLU())
        self.cls_head = PromotedDense(128, num_measures)
        self.criteria = build_criteria([dict(c) for c in criteria])

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        pred = self.cls_head(self.head(pooled_features(self.backbone(point, generator), point)))
        out = {"measure_pred": pred}
        if batch is not None and "weight_label" in batch:
            target = batch["weight_label"].reshape(-1, self.num_measures)
            out["loss"] = self.criteria(pred, target)
            mae = (pred - target).abs().mean(0)
            out.update({f"mae_{i}": mae[i] for i in range(self.num_measures)})
        return out
