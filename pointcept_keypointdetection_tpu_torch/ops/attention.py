"""Serialized patch attention and the permutation gather around it.

Counterparts of ``pointcept_keypointdetection_tpu/ops/attention.py``.
``patch_attention`` is the kernel wrapper of ``kernels/patch_attention.py``:
kernel B1 on a CUDA tensor, the plain version (``patch_attention_xla``
without RPE: f32 logits, -1e9 on invalid keys only) on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..kernels.patch_attention import patch_attention, patch_attention_plain  # noqa: F401


def take_permutation(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a permutation of the rows (forward only for now)."""
    return x[perm]
