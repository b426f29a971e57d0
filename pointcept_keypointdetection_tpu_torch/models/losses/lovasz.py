"""Lovász-softmax loss: the port's ``LovaszLoss`` (``pointcept_keypointdetection_tpu/
models/losses/lovasz.py:27-61``), multiclass over all points with the
``classes="present"`` rule, and binary hinge.

Each class sorts its errors in descending order with a stable sort, as
``jnp.argsort`` does: on tied errors the order, and so the gradient each row
receives, is the reference's.  Padded, ignored and invalid rows carry zero
error and zero ground truth, so they add nothing to the Lovász extension.
The multiclass case sorts all classes in one call, one row per class; the
work is one full-length sort per class and step.
"""

from __future__ import annotations

from typing import Optional

import torch

from .builder import LOSSES
from .misc import valid_and_not_ignored


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. errors sorted in descending order,
    along the last axis of the binary ground truth ``gt_sorted``."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp_min(1.0)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


@LOSSES.register_module()
class LovaszLoss:
    def __init__(self, mode: str = "multiclass", loss_weight: float = 1.0, ignore_index: int = -1):
        if mode not in ("multiclass", "binary"):
            raise ValueError(f"LovaszLoss: mode must be multiclass or binary, got {mode!r}")
        self.mode = mode
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, valid: Optional[torch.Tensor] = None):
        ok = valid_and_not_ignored(target, self.ignore_index, valid)
        okf = ok.float()
        if self.mode == "binary":
            signs = 2.0 * target.float() - 1.0
            hinge = 1.0 - pred.float() * signs
            errors = torch.maximum(hinge, torch.zeros_like(hinge)) * okf  # ties share the gradient, as jnp.maximum
            order = torch.argsort(-errors, stable=True)
            gt_sorted = (target.float() * okf)[order]
            return self.loss_weight * torch.dot(errors[order], lovasz_grad(gt_sorted))

        num_classes = pred.shape[-1]
        prob = torch.softmax(pred.float(), dim=-1)
        tgt = torch.where(ok, target, 0)
        classes = torch.arange(num_classes, device=pred.device)
        fg = (tgt[None, :] == classes[:, None]).float() * okf  # [C, N]
        errors = (fg - prob.t()).abs() * okf
        order = torch.argsort(-errors, dim=-1, stable=True)
        gt_sorted = fg.gather(-1, order)
        losses = (errors.gather(-1, order) * lovasz_grad(gt_sorted)).sum(-1)
        present = (fg.sum(-1) > 0).float()
        return self.loss_weight * (losses * present).sum() / present.sum().clamp_min(1.0)
