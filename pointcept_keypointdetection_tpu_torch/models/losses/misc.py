"""Losses over padded point batches: the port's ``CrossEntropyLoss`` and
``RegressionL1Loss`` (``pointcept_keypointdetection_tpu/models/losses/
misc.py:31-64``, ``:174-185``).  The other losses of that file are not ported
yet."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .builder import LOSSES


def valid_and_not_ignored(target: torch.Tensor, ignore_index: int, valid: Optional[torch.Tensor]) -> torch.Tensor:
    ok = target != ignore_index
    if valid is not None:
        ok = ok & valid
    return ok


@LOSSES.register_module()
class CrossEntropyLoss:
    """Mean (or sum) of the per-row negative log-likelihood over the rows that
    are valid and not ``ignore_index``, each weighted by its class's
    ``weight``; the logits go to f32 before ``log_softmax``."""

    def __init__(self, weight: Optional[Sequence[float]] = None, reduction: str = "mean",
                 label_smoothing: float = 0.0, loss_weight: float = 1.0, ignore_index: int = -1):
        self.weight = None if weight is None else torch.tensor(weight, dtype=torch.float32)
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, valid: Optional[torch.Tensor] = None):
        ok = valid_and_not_ignored(target, self.ignore_index, valid)
        tgt = torch.where(ok, target, 0).long()
        logp = F.log_softmax(pred.float(), dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        if self.label_smoothing > 0:
            smooth = -logp.mean(-1)
            nll = (1.0 - self.label_smoothing) * nll + self.label_smoothing * smooth
        mask = ok.float()
        if self.weight is not None:
            mask = mask * self.weight.to(pred.device)[tgt]
        if self.reduction == "sum":
            loss = (nll * mask).sum()
        else:
            loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return self.loss_weight * loss


@LOSSES.register_module()
class RegressionL1Loss:
    """Mean absolute error of k-dim regression targets in f32 (the pig body measures), over the
    rows that ``valid`` keeps (every row without it)."""

    def __init__(self, loss_weight: float = 1.0):
        self.loss_weight = loss_weight

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, valid: Optional[torch.Tensor] = None):
        loss = (pred.float() - target.float()).abs()
        if valid is None:
            mask = torch.ones_like(loss)
        else:
            mask = valid.reshape(valid.shape + (1,) * (loss.dim() - valid.dim())).expand_as(loss).to(loss.dtype)
        return self.loss_weight * (loss * mask).sum() / mask.sum().clamp_min(1.0)
