"""Pose-graph optimization over SE(3) keyframe poses: the counterpart of
``pointcept_keypointdetection_tpu/slam/pose_graph.py``.

Gauss-Newton on a dense [6K, 6K] normal system in f32 (K keyframes; 151 MB
at K = 1024), solved on the graph's device.  Edge residual
``r = log(Z_ij^-1 T_i^-1 T_j)`` with right perturbations; each edge's two
6x6 Jacobians are forward-mode derivatives of that residual at a zero
perturbation (``torch.func.jvp`` along each of the 6 axes, as JAX's
``jacfwd``).  Optional per-node priors toward the initial poses; the first
node (and every invalid one) is fixed by elimination.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp

from . import se3


class PoseGraph(NamedTuple):
    R: torch.Tensor  # [K, 3, 3]
    t: torch.Tensor  # [K, 3]
    node_valid: torch.Tensor  # bool[K]
    edge_i: torch.Tensor  # int64[E]
    edge_j: torch.Tensor  # int64[E]
    Z_R: torch.Tensor  # [E, 3, 3] relative measurement i -> j
    Z_t: torch.Tensor  # [E, 3]
    edge_weight: torch.Tensor  # f32[E] (0 = invalid)


def _edge_error(Ri, ti, Rj, tj, Z_R, Z_t) -> torch.Tensor:
    Rii, tii = se3.se3_inverse(Ri, ti)
    R_rel, t_rel = se3.se3_compose(Rii, tii, Rj, tj)  # T_i^-1 T_j
    ZRi, Zti = se3.se3_inverse(Z_R, Z_t)
    R_err, t_err = se3.se3_compose(ZRi, Zti, R_rel, t_rel)
    return torch.cat([se3.so3_log(R_err), t_err], dim=-1)


def residuals(graph: PoseGraph) -> torch.Tensor:
    """Per-edge 6-vector residuals [E, 6] (w, v)."""
    i, j = graph.edge_i, graph.edge_j
    return _edge_error(graph.R[i], graph.t[i], graph.R[j], graph.t[j], graph.Z_R, graph.Z_t)


def _jacobians(g: PoseGraph):
    """(Ji, Jj) [E, 6, 6]: d residual / d right perturbation of node i and of node j, at zero."""
    Ri, ti, Rj, tj = g.R[g.edge_i], g.t[g.edge_i], g.R[g.edge_j], g.t[g.edge_j]

    def res(xi_i, xi_j):
        dRi, dti = se3.se3_exp(xi_i)
        dRj, dtj = se3.se3_exp(xi_j)
        return _edge_error(Ri @ dRi, (Ri @ dti[..., None])[..., 0] + ti, Rj @ dRj,
                           (Rj @ dtj[..., None])[..., 0] + tj, g.Z_R, g.Z_t)

    zeros = g.t.new_zeros(g.edge_i.shape[0], 6)
    cols_i, cols_j = [], []
    for a in range(6):
        axis = torch.zeros_like(zeros)
        axis[:, a] = 1.0
        cols_i.append(jvp(lambda x: res(x, zeros), (zeros,), (axis,))[1])
        cols_j.append(jvp(lambda x: res(zeros, x), (zeros,), (axis,))[1])
    return torch.stack(cols_i, -1), torch.stack(cols_j, -1)


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-6, fix_first: bool = True,
             prior_weight=0.0) -> PoseGraph:
    """``iters`` Gauss-Newton steps (`pose_graph.py:57-146`).  ``prior_weight`` (a scalar or a per-node [K]
    tensor) > 0 anchors every node to its initial pose with that information weight."""
    K = graph.R.shape[0]
    dev = graph.R.device
    R_prior, t_prior = graph.R, graph.t
    prior_w = torch.as_tensor(prior_weight, dtype=torch.float32, device=dev).expand(K)
    use_prior = isinstance(prior_weight, torch.Tensor) or bool(np.any(np.asarray(prior_weight) > 0))
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    anchor = ~graph.node_valid.clone()
    anchor[0] |= fix_first
    free = (~anchor).repeat_interleave(6).to(torch.float32)  # [K*6]
    ei, ej = graph.edge_i, graph.edge_j
    w = graph.edge_weight[:, None, None]
    g = graph
    for _ in range(iters):
        r = residuals(g)  # [E, 6]
        Ji, Jj = _jacobians(g)
        H = torch.zeros((K, K, 6, 6), dtype=torch.float32, device=dev)
        b = torch.zeros((K, 6), dtype=torch.float32, device=dev)
        H.index_put_((ei, ei), w * torch.einsum("eab,eac->ebc", Ji, Ji), accumulate=True)
        H.index_put_((ej, ej), w * torch.einsum("eab,eac->ebc", Jj, Jj), accumulate=True)
        H.index_put_((ei, ej), w * torch.einsum("eab,eac->ebc", Ji, Jj), accumulate=True)
        H.index_put_((ej, ei), w * torch.einsum("eab,eac->ebc", Jj, Ji), accumulate=True)
        wr = r * g.edge_weight[:, None]
        b.index_put_((ei,), -torch.einsum("eab,ea->eb", Ji, wr), accumulate=True)
        b.index_put_((ej,), -torch.einsum("eab,ea->eb", Jj, wr), accumulate=True)
        if use_prior:
            # log(T_prior^-1 T) per node; its Jacobian is the identity to first order
            w_prior = se3.so3_log(R_prior.transpose(-1, -2) @ g.R)
            v_prior = (R_prior.transpose(-1, -2) @ (g.t - t_prior)[..., None])[..., 0]
            r_prior = torch.cat([w_prior, v_prior], dim=-1)
            idx = torch.arange(K, device=dev)
            H[idx, idx] += prior_w[:, None, None] * eye6
            b = b - prior_w[:, None] * r_prior
        H = H.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        b = b.reshape(K * 6)
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free + damping)
        delta = torch.linalg.solve_ex(H, b * free)[0].reshape(K, 6)
        delta = torch.where(anchor[:, None], torch.zeros_like(delta), delta)
        dR, dt = se3.se3_exp(delta)
        g = g._replace(R=g.R @ dR, t=(g.R @ dt[..., None])[..., 0] + g.t)
    return g
