"""SO(3) and SE(3) on tensors: the counterpart of ``pointcept_keypointdetection_tpu/slam/se3.py``.

Rotations are 3x3 matrices, twists [w, v] with the rotation first, every
function batched over leading axes and in the caller's dtype and device.
The formulas and their small-angle branches are JAX's, in the fixed-order
f32 operations of ``ordered.py`` (the same bits on the card and the CPU).
``so3_log`` clips the cosine to 1 - 1e-7 (f32: 0.99999988), so its angle
never falls below ~4.9e-4 rad and its scale stays finite; the pose graph's
residual differentiates through that clip (forward mode, as JAX's
``jacfwd``).
"""

from __future__ import annotations

import torch

from . import ordered as o
from .ordered import norm

_EPS = 1e-8


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: [..., 3] -> [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]; I + hat(w) below 1e-6 rad."""
    theta = norm(w, keepdim=True)[..., None]  # [..., 1, 1]
    K = hat(o.div(w, torch.clamp_min(theta[..., 0], _EPS)))
    eye = _eye(w).expand(K.shape)
    s, c = o.sin(theta), o.cos(theta)
    R = eye + s * K + (1 - c) * o.matmul(K, K)
    return torch.where(theta > 1e-6, R, eye + hat(w))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]."""
    trace = o.osum(R.diagonal(dim1=-2, dim2=-1))
    cos_theta = torch.clamp(o.div(trace - 1, 2.0), -1 + 1e-7, 1 - 1e-7)
    theta = o.arccos(cos_theta)
    w_hat = o.div(R - R.transpose(-1, -2), 2.0)
    w = torch.stack([w_hat[..., 2, 1], w_hat[..., 0, 2], w_hat[..., 1, 0]], -1)
    t = theta[..., None]
    scale = torch.where(t > 1e-6, o.div(t, torch.clamp_min(o.sin(theta)[..., None], _EPS)), torch.ones_like(t))
    return w * scale


def se3_exp(xi: torch.Tensor):
    """Twist [..., 6] (w, v) -> (R [..., 3, 3], t [..., 3])."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta = norm(w, keepdim=True)[..., None]
    K = hat(o.div(w, torch.clamp_min(theta[..., 0], _EPS)))
    eye = _eye(xi).expand(R.shape)
    s, c = o.sin(theta), o.cos(theta)
    safe = torch.clamp_min(theta, _EPS)
    V = eye + o.div(1 - c, safe) * K + o.div(theta - s, safe) * o.matmul(K, K)
    V = torch.where(theta > 1e-6, V, eye + o.div(hat(w), 2.0))
    return R, o.matvec(V, v)


def se3_compose(R1, t1, R2, t2):
    """(R1, t1) o (R2, t2)."""
    return o.matmul(R1, R2), o.matvec(R1, t2) + t1


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -o.matvec(Rt, t)


def transform(R, t, points):
    """Apply (R, t) to points [..., N, 3]."""
    return o.matmul(points, R.transpose(-1, -2)) + t[..., None, :]
