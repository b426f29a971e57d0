"""Serialized patch attention and the permutation gather around it.

Counterparts of ``pointcept_keypointdetection_tpu/ops/attention.py``.
``patch_attention`` is ``kernels/patch_attention.py::attention``: kernel B1
(and B2 in the backward) on a CUDA tensor, the plain version
(``patch_attention_xla`` without RPE: f32 logits, -1e9 on invalid keys
only) on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..kernels.patch_attention import attention as patch_attention  # noqa: F401


class _TakePermutation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x[perm]

    @staticmethod
    def backward(ctx, grad):
        (inv_perm,) = ctx.saved_tensors
        return grad[inv_perm], None, None


def take_permutation(x: torch.Tensor, perm: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a permutation of the rows, whose gradient is the gather
    ``g[inv_perm]`` rather than autograd's scatter (`attention.py:66-88`)."""
    return _TakePermutation.apply(x, perm, inv_perm)
