"""Dense offset-keypoint head over a backbone: the forward of
``OffsetKeypointModel`` (``pointcept_keypointdetection_tpu/models/
keypoint.py:68-106``).  The loss comes with the training slice."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from .builder import MODELS, build_model
from .structure import PointBatch


class OffsetKeypointModel(nn.Module):
    """backbone -> per-point MLP -> [N, K, 4] = offset (3) + mask logit (1)."""

    def __init__(self, backbone_conf: Dict[str, Any], num_keypoints: int = 6, hidden_dim: int = 256,
                 reg_loss_weight: float = 2.0):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.backbone = build_model(dict(backbone_conf))
        self.head = nn.Sequential(
            nn.Linear(self.backbone.out_channels, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Linear(hidden_dim, num_keypoints * 4),
        )

    def forward(self, point: PointBatch) -> Dict[str, torch.Tensor]:
        pred = self.head(self.backbone(point)).reshape(-1, self.num_keypoints, 4)
        return {"offset_pred": pred[..., :3], "mask_logits": pred[..., 3]}


for _name in ("OffsetKeypointPTv3", "OffsetKeypointModel"):
    MODELS.register_module(name=_name, module=OffsetKeypointModel)
