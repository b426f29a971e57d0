"""Normalization, stochastic depth and dropout over masked point batches.

Counterparts of ``pointcept_keypointdetection_tpu/models/norm.py``: batch
statistics come from the valid rows only, and drop path keeps or drops whole
samples (slots); ``Dropout`` is flax's, for the keypoint heads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over points with running statistics; eps 1e-3 (`norm.py:29`),
    not ``nn.BatchNorm1d``'s 1e-5.

    Training (`norm.py:43-53`): mean and the biased variance over the valid
    rows (divided by the valid count), with the gradient flowing through
    both; the running statistics follow the torch convention
    new = (1 - m) * old + m * batch."""

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
            w = valid.to(torch.float32)[:, None]
            xf = x.float()
            count = w.sum().clamp_min(1.0)
            mean = (xf * w).sum(0) / count
            var = ((xf - mean).square() * w).sum(0) / count
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Per-row LayerNorm, computed in f32 and cast back.  The defaults are the JAX package's own
    ``LayerNorm`` (`norm.py:59-73`, PTv3's): eps 1e-5, variance E[(x - E[x])^2].  Flax's
    ``nn.LayerNorm`` (PointGroup's ``offset_norm``) is ``eps=1e-6, fast_variance=True``: variance
    max(0, E[x^2] - E[x]^2)."""

    def __init__(self, features: int, eps: float = 1e-5, fast_variance: bool = False):
        super().__init__()
        self.eps = eps
        self.fast_variance = fast_variance
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        if self.fast_variance:
            var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        else:
            var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with probability 1 - rate, drawn
    from the caller's generator (a CPU ``torch.Generator``), and scaled by 1 / (1 - rate); the
    identity at eval or rate 0.  flax draws from its ``dropout`` rng stream, which this cannot
    reproduce: the same rate, other draws."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout: training with rate > 0 needs a generator")
        keep = torch.bernoulli(torch.full(x.shape, 1.0 - self.rate), generator=generator).bool()
        if x.is_cuda:
            keep = keep.pin_memory()
        keep = keep.to(x.device, non_blocking=True)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth per sample (`norm.py:101-121`): in training each
    sample's slot is kept with probability 1 - rate, drawn from the caller's
    generator, and scaled by 1 / (1 - rate); the identity at eval or rate 0.
    The branch is computed for every sample and then masked, so the work of
    a step does not depend on the draws."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, num_samples: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath: training with rate > 0 needs a generator")
        keep = torch.bernoulli(torch.full((num_samples,), 1.0 - self.rate), generator=generator).bool()
        if x.is_cuda:  # a copy from pageable memory would make the host wait for the card in every Block
            keep = keep.pin_memory()
        per_point = keep.to(x.device, non_blocking=True).repeat_interleave(x.shape[0] // num_samples)[:, None]
        return torch.where(per_point, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))
