"""Point-to-plane ICP, scan to map: the counterpart of
``pointcept_keypointdetection_tpu/slam/registration.py``.

Per Gauss-Newton iteration: the scan moved by the current pose; its k
nearest map points (the grid-bucketed search of ``ops/knn.py``, its index
built once per registration, or brute force); a plane fitted to each
neighbourhood (``_eig3x3_smallest``); Huber-weighted point-to-plane
residuals gated on the neighbours within ``max_corr_dist``, their count, the
planarity and the residual; one damped 6x6 normal-equation solve; a
left-multiplied SE(3) update with the rotation about the sensor's position.

Every tensor stays on the caller's device: the loop makes no host read, so
a registration is one stream of launches and the caller reads its result
once.  The arithmetic is ``ordered.py``'s: the card and the CPU register a
scan to the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.knn import build_knn_index, knn, knn_query_index
from . import ordered as o
from . import se3


class RegistrationResult(NamedTuple):
    R: torch.Tensor  # [3, 3]
    t: torch.Tensor  # [3]
    rmse: torch.Tensor  # scalar, the gated point-to-plane RMSE of the last iteration
    inliers: torch.Tensor  # int64 scalar, the gated correspondences of the last iteration


def _det3x3(a: torch.Tensor) -> torch.Tensor:
    """The determinant of [..., 3, 3] by JAX's own closed form for 3x3 (``jnp.linalg.det``), term for term."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2] + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1] - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _eig3x3_smallest(cov: torch.Tensor):
    """Smallest and middle eigenvalues and the smallest eigenvector of symmetric 3x3 matrices [..., 3, 3]
    in closed form (`registration.py:40-79`): the trigonometric roots of the characteristic polynomial from
    the arccos of the clipped determinant, the eigenvector as the longest of three cross products of rows
    of A - lambda_min I, and +z where all three vanish (an isotropic or rank-deficient covariance, which
    the planarity gate rejects).

    Near a double root (a plane of three points) the arccos amplifies a last-bit difference of the
    determinant: JAX's own jitted and eager runs differ there in lambda_min on the same matrix."""
    a = cov
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = o.div(o.osum(a.diagonal(dim1=-2, dim2=-1)), 3.0)
    aq = a - q[..., None, None] * eye
    p2 = o.osum((aq * aq).flatten(-2))
    p = o.sqrt(torch.clamp_min(o.div(p2, 6.0), 1e-30))
    b = o.div(aq, p[..., None, None])
    r = torch.clamp(o.div(_det3x3(b), 2.0), -1.0, 1.0)
    phi = o.div(o.arccos(r), 3.0)
    lam_max = q + 2.0 * p * o.cos(phi)
    lam_min = q + 2.0 * p * o.cos(phi + 2.0 * np.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    m = a - lam_min[..., None, None] * eye
    cands = torch.stack([o.cross(m[..., 0, :], m[..., 1, :]), o.cross(m[..., 0, :], m[..., 2, :]),
                         o.cross(m[..., 1, :], m[..., 2, :])], -2)
    best = o.osum(cands * cands).argmax(-1)  # the first of equal lengths, as jnp.argmax
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    nrm = o.sqrt(torch.clamp_min(o.osum(v * v, keepdim=True), 1e-30))
    v = torch.where(nrm > 1e-12, o.div(v, nrm), eye[2])  # +z
    return lam_min, lam_mid, v


def _fit_planes(neighbors: torch.Tensor, nbr_valid: torch.Tensor):
    """neighbors [N, k, 3] -> (centroid [N, 3], normal [N, 3], planarity [N]) over the valid neighbours
    (`registration.py:82-91`)."""
    w = nbr_valid.to(torch.float32)[..., None]
    count = torch.clamp_min(o.osum(w, 1), 1.0)
    centroid = o.div(o.osum(neighbors * w, 1), count)
    centered = (neighbors - centroid[:, None, :]) * w
    cov = o.div(o.osum(centered[..., :, None] * centered[..., None, :], 1), count[..., None])
    lam_min, lam_mid, normal = _eig3x3_smallest(cov)
    planarity = 1.0 - o.div(lam_min, torch.clamp_min(lam_mid, 1e-9))
    return centroid, normal, planarity


def point_to_plane_icp(
    source: torch.Tensor,  # [N, 3] scan points (sensor frame)
    source_valid: torch.Tensor,  # bool[N]
    target: torch.Tensor,  # [M, 3] map points (world frame)
    target_valid: torch.Tensor,  # bool[M]
    R_init: torch.Tensor,
    t_init: torch.Tensor,
    iters: int = 8,
    k: int = 5,
    max_corr_dist: float = 1.0,
    huber_delta: float = 0.3,
    damping: float = 1e-4,
    min_planarity: float = 0.7,
    bucketed: bool = True,
    cell_cap: int = 64,
    index_depth: Optional[int] = None,
    cell_size: Optional[float] = None,
    lattice_origin=None,
    search_every: int = 1,
) -> RegistrationResult:
    """(R, t) registering ``source`` onto ``target`` from (``R_init``, ``t_init``) (`registration.py:94-245`).

    ``bucketed``: the grid search at cell ``max_corr_dist`` with ``cell_cap`` rows a cell and the cell codes
    checked (exact for every correspondence the distance gate keeps, while no cell overflows: ``cell_cap``
    must hold ceil(max_corr_dist / map_voxel + 1)^3 map points), over a ``2^index_depth`` cell domain (16
    without it); with ``cell_size`` and ``lattice_origin`` (the map's voxel and origin) instead the unit-cell
    search: one row a cell, the ring of cells within ``max_corr_dist``, no code check.  ``bucketed=False``:
    brute force (``ops/knn.knn``, which reads the host).  ``search_every`` m: search and fit the planes only
    at every m-th iteration and keep them between."""
    n = source.shape[0]
    if bucketed:
        depth = index_depth if index_depth is not None else 16
        cell = cell_size if cell_size is not None else max_corr_dist
        unit_cell = cell_size is not None and lattice_origin is not None
        cap = 1 if unit_cell else cell_cap
        ring = int(np.ceil(max_corr_dist / cell)) if unit_cell else 1
        index = build_knn_index(target, cell, base_valid=target_valid, cell_cap=cap, depth=depth,
                                lattice_origin=lattice_origin)

        def corr(p_w):
            return knn_query_index(index, p_w, k, cell, cell_cap=cap, depth=depth, ring_radius=ring,
                                   verify_codes=not unit_cell, lattice_origin=lattice_origin,
                                   ring_corr_cells=(max_corr_dist / cell) if unit_cell else None)
    else:
        def corr(p_w):
            return knn(p_w, target, k, base_valid=target_valid)

    def search_and_fit(p_w):
        idx, sqd = corr(p_w)
        idx = idx.long()
        nbr_valid = (sqd < max_corr_dist**2) & target_valid[idx]
        centroid, normal, planarity = _fit_planes(target[idx], nbr_valid)
        return centroid, normal, planarity, nbr_valid.sum(-1)

    R, t = R_init, t_init
    eye6 = torch.eye(6, dtype=torch.float32, device=source.device)
    huber = o.const(huber_delta, source)
    fit = None
    for i in range(iters):
        p_w = se3.transform(R, t, source)  # [N, 3]
        if fit is None or search_every <= 1 or i % search_every == 0:
            fit = search_and_fit(p_w)
        centroid, normal, planarity, nbr_count = fit
        r = o.osum(normal * (p_w - centroid))
        absr = torch.abs(r)
        good = source_valid & (nbr_count >= 3) & (planarity > min_planarity) & (absr < max_corr_dist)
        w = torch.where(absr <= huber_delta, torch.ones_like(r), o.div(huber, torch.clamp_min(absr, 1e-9)))
        w = w * good.to(torch.float32)
        # the rotation pivots on the sensor's position: lever arms are ranges, not distances from the world origin
        lever = p_w - t
        J = torch.cat([o.cross(lever, normal), normal], dim=-1)  # [N, 6]
        H = o.tree_sum((J * w[:, None])[:, :, None] * J[:, None, :]) + damping * eye6
        g = o.tree_sum(J * (w * r)[:, None])
        delta = -o.solve_spd(H, g)
        dR, dt = se3.se3_exp(delta)
        R = o.matmul(dR, R)
        t = t + dt
        inliers = torch.sum(good)
        rmse = o.sqrt(o.div(o.tree_sum(r * r * good.to(torch.float32)), torch.clamp_min(inliers, 1).to(torch.float32)))
    if iters == 0:
        zero = torch.zeros((), dtype=torch.float32, device=source.device)
        return RegistrationResult(R=R, t=t, rmse=zero, inliers=zero.long())
    return RegistrationResult(R=R, t=t, rmse=rmse, inliers=inliers)
