"""Keypoint heads over a backbone and their losses: the counterparts of
``pointcept_keypointdetection_tpu/models/keypoint.py``.

* ``KeypointModel`` (`keypoint.py:33-65`), registered under the reference
  names ``KeypointPTv3``, ``KeypointPTv3Plus``, ``KeypointSparseUNet`` and the
  other ``Keypoint<Backbone>`` aliases (`:110-121`, `:184`): global regression.
  The backbone's valid rows are mean-pooled per sample (divided by the slot
  size, as JAX's ``segment_mean`` over the slot), then Dense ->
  MaskedBatchNorm over the B pooled rows (momentum 0.1, eps 1e-5) -> ReLU ->
  Dropout 0.3 -> Dense -> ReLU -> Dense to [B, K, 3]; the loss is the MSE in
  normalized units and ``mean_dist`` the keypoint distance times ``scale``.
* ``OffsetKeypointModel`` (`:68-106`): dense per-point offset + mask head.
* ``VoteKeypointModel`` (`:132-178`, ``KeypointSwin3DVote``): per-point votes,
  a smooth-L1 loss over the points within ``vote_radius`` of each keypoint,
  and their mean vote as the prediction.

The heads' Dense layers are flax's without a ``dtype`` (``PromotedDense``).
An alias whose backbone the port lacks (Swin3D, OctFormer, ...) raises where
it is built.  The head modules keep flax's call order: ``head.{2i}`` is
``Dense_{i}`` (``convert.py``); ``KeypointModel``'s ``head.1`` is its
``MaskedBatchNorm_0`` and ``head.3`` its Dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_mean
from .builder import MODELS, build_model
from .norm import Dropout, MaskedBatchNorm
from .structure import PointBatch


class PromotedDense(nn.Linear):
    """flax ``nn.Dense`` without a ``dtype`` (the heads'): it computes in the promoted dtype of its
    input and its parameters, f32 for bf16 features and f32 parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), None if self.bias is None else self.bias.to(dtype))


def build_backbone(head: str, conf: Dict[str, Any]) -> nn.Module:
    if conf["type"] not in MODELS:
        raise NotImplementedError(f"{head}: backbone {conf['type']!r} is not ported yet")
    return build_model(dict(conf))


def pooled_features(feat: torch.Tensor, point: PointBatch) -> torch.Tensor:
    """[B, C]: the valid rows' features summed per sample over its slot, divided by the slot size."""
    return segment_mean(feat * point.valid[:, None].to(feat.dtype), point.batch, point.num_samples)


def keypoint_distance(pred: torch.Tensor, target: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean keypoint distance, times each sample's ``scale`` where the batch has it."""
    dist = (pred - target).norm(dim=-1)  # [B, K]
    if "scale" in batch:
        dist = dist * batch["scale"].reshape(-1, 1)
    return dist.mean()


class KeypointModel(nn.Module):
    """backbone -> mean pool per sample -> MLP -> ``keypoint_pred`` [B, K, 3]."""

    def __init__(self, backbone_conf: Dict[str, Any], num_keypoints: int = 6, hidden_dim: int = 256):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.backbone = build_backbone("KeypointModel", backbone_conf)
        self.head = nn.ModuleList([
            PromotedDense(self.backbone.out_channels, hidden_dim),
            MaskedBatchNorm(hidden_dim, eps=1e-5, momentum=0.1),
            PromotedDense(hidden_dim, hidden_dim),
            Dropout(0.3),
            PromotedDense(hidden_dim, num_keypoints * 3),
        ])

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``keypoint_pred`` [B, K, 3]; with ``keypoint`` [B, K, 3] in ``batch`` also loss and mean_dist.
        ``generator`` drives the backbone's shuffles and drop path and the head's Dropout in training."""
        dense0, norm, dense1, dropout, dense2 = self.head
        x = dense0(pooled_features(self.backbone(point, generator), point))
        x = F.relu(norm(x, torch.ones(x.shape[0], dtype=torch.bool, device=x.device)))
        x = F.relu(dense1(dropout(x, generator)))
        pred = dense2(x).reshape(-1, self.num_keypoints, 3)
        out = {"keypoint_pred": pred}
        if batch is not None and "keypoint" in batch:
            target = batch["keypoint"]
            out["loss"] = (pred - target).square().mean()
            out["mean_dist"] = keypoint_distance(pred, target, batch)
        return out


class OffsetKeypointModel(nn.Module):
    """backbone -> per-point MLP -> [N, K, 4] = offset (3) + mask logit (1)."""

    def __init__(self, backbone_conf: Dict[str, Any], num_keypoints: int = 6, hidden_dim: int = 256,
                 reg_loss_weight: float = 2.0):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.reg_loss_weight = reg_loss_weight
        self.backbone = build_model(dict(backbone_conf))
        self.head = nn.Sequential(
            nn.Linear(self.backbone.out_channels, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, num_keypoints * 4),
        )

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """offset_pred [N, K, 3] and mask_logits [N, K]; with targets in
        ``batch`` (``keypoint_offset`` [N, K, 3], ``keypoint_mask`` [N, K])
        also loss, cls_loss and reg_loss (`keypoint.py:88-105`)."""
        pred = self.head(self.backbone(point, generator)).reshape(-1, self.num_keypoints, 4)
        out = {"offset_pred": pred[..., :3], "mask_logits": pred[..., 3]}
        if batch is not None and "keypoint_offset" in batch:
            offset_gt, mask_gt = batch["keypoint_offset"], batch["keypoint_mask"]
            pvalid = point.valid[:, None].to(torch.float32)
            # BCE over the valid points, from log-sigmoid
            ml = out["mask_logits"].float()
            bce = -(mask_gt * F.logsigmoid(ml) + (1 - mask_gt) * F.logsigmoid(-ml))
            cls_loss = (bce * pvalid).sum() / (pvalid.sum() * self.num_keypoints).clamp_min(1.0)
            # L1 over the offsets of the points inside a keypoint's radius
            vm = (mask_gt > 0.5).to(torch.float32) * pvalid
            l1 = (out["offset_pred"].float() - offset_gt).abs() * vm[..., None]
            reg_loss = l1.sum() / (vm.sum() * 3 + 1e-6)
            out.update(loss=cls_loss + reg_loss * self.reg_loss_weight, cls_loss=cls_loss, reg_loss=reg_loss)
        return out


class VoteKeypointModel(nn.Module):
    """backbone -> per-point votes [N, K, 3]; the prediction is the mean of point + vote over the
    points within ``vote_radius`` (normalized units) of each ground-truth keypoint."""

    def __init__(self, backbone_conf: Dict[str, Any], num_keypoints: int = 6, hidden_dim: int = 256,
                 vote_radius: float = 0.5):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.vote_radius = vote_radius
        self.backbone = build_backbone("VoteKeypointModel", backbone_conf)
        self.head = nn.Sequential(PromotedDense(self.backbone.out_channels, hidden_dim), nn.ReLU(),
                                  PromotedDense(hidden_dim, num_keypoints * 3))

    def forward(self, point: PointBatch, batch: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``votes`` [N, K, 3]; with ``keypoint`` [B, K, 3] in ``batch`` also loss, keypoint_pred and
        mean_dist (`keypoint.py:152-177`)."""
        k = self.num_keypoints
        votes = self.head(self.backbone(point, generator)).reshape(-1, k, 3)
        pred_points = point.coord[:, None, :] + votes
        out = {"votes": votes}
        if batch is not None and "keypoint" in batch:
            kp = batch["keypoint"]
            b, s = point.num_samples, point.slot_size
            kp_per_point = kp.repeat_interleave(s, dim=0)  # jnp.repeat(kp, S, axis=0): row i is sample i // S's
            dist = (point.coord[:, None, :] - kp_per_point).norm(dim=-1)
            w = ((dist <= self.vote_radius) & point.valid[:, None]).to(torch.float32)  # [N, K]
            absd = (pred_points - kp_per_point).float().abs()
            smooth_l1 = torch.where(absd < 1.0, 0.5 * absd**2, absd - 0.5).sum(-1)
            out["loss"] = (smooth_l1 * w).sum() / (w.sum() * 3).clamp_min(1.0)
            wp = w.reshape(b, s, k, 1)
            agg = (pred_points.reshape(b, s, k, 3) * wp).sum(1) / wp.sum(1).clamp_min(1e-6)
            out["keypoint_pred"] = agg
            out["mean_dist"] = keypoint_distance(agg, kp, batch)
        return out


for _name in ("KeypointPTv3", "KeypointPTv1", "KeypointPTv2", "KeypointSwin3D", "KeypointOACNNs",
              "KeypointOctFormer", "KeypointStratifiedTransformer", "KeypointSparseUNet", "KeypointModel",
              "KeypointPTv3Plus"):
    MODELS.register_module(name=_name, module=KeypointModel)
for _name in ("OffsetKeypointPTv3", "OffsetKeypointModel"):
    MODELS.register_module(name=_name, module=OffsetKeypointModel)
for _name in ("KeypointSwin3DVote", "VoteKeypointModel"):
    MODELS.register_module(name=_name, module=VoteKeypointModel)
