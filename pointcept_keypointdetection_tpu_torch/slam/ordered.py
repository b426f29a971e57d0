"""f32 arithmetic that gives the same bits on the card and on the CPU.

A registration gates every scan point on its neighbours' distances, the
planarity of their plane and its residual; a pose one ulp apart moves some
point across a gate, and the next iterations carry the difference on.  So
the odometry's device code uses only operations whose f32 result does not
depend on the device:

* single IEEE operations (+, -, *, / by a tensor, floor, compare),
  never a fused kernel that a compiler may contract into a multiply-add, and
  no division by a Python number (the CUDA kernel multiplies by its
  reciprocal there);
* sums in a fixed order: left to right over a short axis (``osum``) and
  pairwise over a long one (``tree_sum``), where a library's reduction or
  matmul picks its own order;
* sqrt, sin, cos and arccos evaluated in f64 and rounded to f32, so that
  the result is the correctly rounded one on both sides (the f32 library
  functions of the card and the CPU differ in the last bit, sqrt among
  them);
* the 6x6 normal equations by a Cholesky solve written out here.

Constants are filled on the device (``const``): a copy from the host's
memory would make the host wait for the device.
"""

from __future__ import annotations

import torch


def osum(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Sum over a short axis, left to right."""
    parts = x.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc.unsqueeze(dim) if keepdim else acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 pairwise: zeros pad it to a power of two, then halves are added until one row is left."""
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.cat([x, x.new_zeros((size - n,) + x.shape[1:])])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of ``value`` on ``like``'s device and dtype, filled there (no copy from the host, which
    would wait for the device)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def div(a, b):
    """a / b as one IEEE division, a Python number made a tensor on the other operand's device first."""
    if not isinstance(a, torch.Tensor):
        a = const(a, b)
    if not isinstance(b, torch.Tensor):
        b = const(b, a)
    return torch.div(a, b)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).to(x.dtype)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).to(x.dtype)


def arccos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(x.double()).to(x.dtype)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The 2-norm over the last axis: sqrt(((x^2 + y^2) + z^2))."""
    return sqrt(osum(x * x, -1, keepdim))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., n, m] @ b [..., m, p] (broadcast), each entry summed over m left to right."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return acc


def matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a [..., n, m] @ v [..., m]."""
    return matmul(a, v[..., None])[..., 0]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def solve_spd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H^-1 g for a small symmetric positive-definite H [n, n] by Cholesky, H = L L^T, a column of L at a time
    (each column's sums over the earlier columns in order; no host read)."""
    n = H.shape[0]
    cols = []  # cols[j] = L[j:, j]
    for j in range(n):
        s = H[j:, j]
        for k in range(j):
            s = s - cols[k][j - k:] * cols[k][j - k]
        d = sqrt(s[0])
        cols.append(torch.cat([d[None], s[1:] / d]))
    r, y = g, []  # forward: L y = g
    for j in range(n):
        y.append(r[j] / cols[j][0])
        r = torch.cat([r[:j + 1], r[j + 1:] - cols[j][1:] * y[j]])
    r, x = torch.stack(y), [None] * n  # back: L^T x = y
    for i in reversed(range(n)):
        x[i] = r[i] / cols[i][0]
        if i:
            r = torch.cat([r[:i] - torch.stack([cols[k][i - k] for k in range(i)]) * x[i], r[i:]])
    return torch.stack(x)
