"""Dense offset-keypoint head over a backbone, and its loss: the counterpart of
``OffsetKeypointModel`` (``pointcept_keypointdetection_tpu/models/
keypoint.py:68-106``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .builder import MODELS, build_model
from .structure import PointBatch


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


for _name in ("OffsetKeypointPTv3", "OffsetKeypointModel"):
    MODELS.register_module(name=_name, module=OffsetKeypointModel)
