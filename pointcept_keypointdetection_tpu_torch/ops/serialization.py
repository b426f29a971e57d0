"""Space-filling-curve codecs: Morton (z-order) and Hilbert, as int64 tensors.

Bit layouts are those of ``pointcept_keypointdetection_tpu/ops/
serialization.py`` and of the reference goldens in ``tests/golden/``:

* z-order: bit ``i`` of x -> code bit ``3i+2``, y -> ``3i+1``, z -> ``3i``.
* hilbert: Skilling's AxesToTranspose, then the same interleave.
* ``*-trans`` orders swap x and y first; the batch index goes above the
  ``3*depth`` spatial bits.

``z_order_encode_np`` is the host-side numpy codec the predictor uses to pick
one point per voxel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .codes import code_or_batch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def z_order_encode_np(grid_coord: np.ndarray, depth: int = 16) -> np.ndarray:
    """Morton-encode int coords (N, 3) -> uint64 keys, depth bits per axis."""
    x = grid_coord[:, 0].astype(np.uint64)
    y = grid_coord[:, 1].astype(np.uint64)
    z = grid_coord[:, 2].astype(np.uint64)
    key = np.zeros_like(x)
    for i in range(depth):
        mask = np.uint64(1 << i)
        key |= ((x & mask) << np.uint64(2 * i + 2)) | ((y & mask) << np.uint64(2 * i + 1)) | (
            (z & mask) << np.uint64(2 * i)
        )
    return key


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Move bit i of a (<= 21-bit) int64 to bit 3i."""
    v = v & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def _interleave3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, depth: int) -> torch.Tensor:
    if depth > 21:
        raise ValueError(f"depth {depth} > 21 does not fit 63 bits")
    m = (1 << depth) - 1
    return (_spread3(x & m) << 2) | (_spread3(y & m) << 1) | _spread3(z & m)


def z_order_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Morton-encode non-negative int coords (N, 3) -> int64 codes."""
    g = grid_coord.to(torch.int64)
    return _interleave3(g[:, 0], g[:, 1], g[:, 2], depth)


def _axes_to_transpose(x, y, z, depth: int):
    """Skilling's AxesToTranspose over int64 lanes (values below 2**32)."""
    X = [x, y, z]
    m = 1 << (depth - 1)
    q = m
    while q > 1:
        p = q - 1
        for i in range(3):
            on = (X[i] & q) != 0
            X[0] = torch.where(on, X[0] ^ p, X[0])
            t = torch.where(on, torch.zeros_like(X[0]), (X[0] ^ X[i]) & p)
            X[0] = X[0] ^ t
            X[i] = X[i] ^ t
        q >>= 1
    for i in range(1, 3):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    q = m
    while q > 1:
        on = (X[2] & q) != 0
        t = torch.where(on, t ^ (q - 1), t)
        q >>= 1
    return [a ^ t for a in X]


def hilbert_encode(grid_coord: torch.Tensor, depth: int = 16) -> torch.Tensor:
    """Hilbert-encode non-negative int coords (N, 3) -> int64 codes."""
    g = grid_coord.to(torch.int64) & 0xFFFFFFFF
    X = _axes_to_transpose(g[:, 0], g[:, 1], g[:, 2], depth)
    return _interleave3(X[0], X[1], X[2], depth)


def encode(
    grid_coord: torch.Tensor,
    batch: Optional[torch.Tensor] = None,
    depth: int = 16,
    order: str = "z",
) -> torch.Tensor:
    """Encode incl. the batch prefix. Mirrors `serialization/default.py:9-24`."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order}")
    if order.endswith("-trans"):
        grid_coord = grid_coord[:, [1, 0, 2]]
    if order.startswith("z"):
        code = z_order_encode(grid_coord, depth)
    else:
        code = hilbert_encode(grid_coord, depth)
    if batch is not None:
        code = code_or_batch(code, batch, depth)
    return code
