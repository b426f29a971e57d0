"""64-bit spatial codes as signed int64 tensors.

The JAX package carries ``batch << 3*depth | curve_code`` as uint32 (hi, lo)
pairs (``pointcept_keypointdetection_tpu/ops/codes.py``) because it avoids
x64 mode.  PyTorch has int64 on every device, so the port keeps one int64
per code.  int64 is signed: codes stay non-negative as long as the spatial
bits plus the batch bits fit in 63, which ``check_code_bits`` asserts.  The
largest int64 is the sentinel that sorts invalid rows last.
"""

from __future__ import annotations

import torch

CODE_MAX = torch.iinfo(torch.int64).max


def check_code_bits(depth: int, num_samples: int) -> None:
    """Raise unless ``3*depth`` spatial bits plus the batch bits fit in 63."""
    bits = 3 * depth + max(int(num_samples - 1).bit_length(), 0)
    if bits > 63:
        raise ValueError(f"codes need {bits} bits (depth {depth}, {num_samples} samples); int64 holds 63")


def code_or_batch(code: torch.Tensor, batch: torch.Tensor, depth: int) -> torch.Tensor:
    """``batch << 3*depth | code`` (`serialization/default.py:21-23`)."""
    return code | (batch.to(torch.int64) << (3 * depth))


def code_fill_invalid(code: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Set invalid entries to CODE_MAX so they sort last."""
    return torch.where(valid, code, torch.full_like(code, CODE_MAX))


def code_shr(code: torch.Tensor, shift: int) -> torch.Tensor:
    """Right shift by a static number of bits, the batch bits included (`codes.py:48-62`); the codes
    are non-negative, so the arithmetic shift is the logical one."""
    if not 0 <= shift < 64:
        raise ValueError(f"shift must be in [0, 64), got {shift}")
    return code >> shift


def code_lexsort(code: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of the codes (`codes.py:102-105`), int64 positions."""
    return torch.sort(code, stable=True).indices
