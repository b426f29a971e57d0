"""Normalization over masked point batches, eval branches.

Counterparts of ``pointcept_keypointdetection_tpu/models/norm.py``.  Only
inference is ported: ``MaskedBatchNorm`` and ``DropPath`` raise in training
mode until the training slice brings valid-row statistics and per-sample
drop masks.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over points with running statistics; eps 1e-3 (`norm.py:29`),
    not ``nn.BatchNorm1d``'s 1e-5."""

    def __init__(self, features: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("MaskedBatchNorm: only the eval branch is ported")
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Per-row LayerNorm, eps 1e-5, computed in f32 and cast back."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth per sample: the identity at eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0:
            raise NotImplementedError("DropPath: only the eval branch is ported")
        return x
