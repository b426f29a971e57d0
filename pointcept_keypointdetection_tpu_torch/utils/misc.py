"""Segmentation metrics: the port's ``intersection_and_union_jax``
(``pointcept_keypointdetection_tpu/utils/misc.py:55``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def intersection_and_union(output: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int = -1,
                           valid_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Per-class (intersection, union, target) counts, three int64 [num_classes] tensors on the
    inputs' device, over the entries whose target is not ``ignore_index`` and whose
    ``valid_mask`` is set; no read back to the host."""
    output = output.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index
    if valid_mask is not None:
        valid = valid & valid_mask.reshape(-1)
    weights = valid.long()
    safe_target = torch.where(valid, target, 0)
    safe_output = torch.where(valid, output, 0)

    def count(index, w):
        return torch.zeros(num_classes, dtype=torch.int64, device=output.device).scatter_add_(0, index, w)

    intersection = count(safe_target, weights * (safe_output == safe_target).long())
    area_target = count(safe_target, weights)
    union = count(safe_output, weights) + area_target - intersection
    return intersection, union, area_target
