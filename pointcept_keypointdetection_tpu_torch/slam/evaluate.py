"""Trajectory evaluation: Umeyama alignment, ATE, RPE and the KITTI pose file.

The port's own copy of ``pointcept_keypointdetection_tpu/slam/evaluate.py``:
host-side numpy in f64, run once per trajectory.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning est -> gt.

    est/gt: [N, 3] positions. Returns (s, R, t).
    """
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe**2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def absolute_trajectory_error(
    est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True
) -> Tuple[float, np.ndarray]:
    """ATE RMSE (m) after optional SE(3) Umeyama alignment. Returns (rmse, per-frame errors)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align:
        s, R, t = umeyama_alignment(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err**2))), err


def relative_pose_error(est_positions: np.ndarray, gt_positions: np.ndarray, delta: int = 1):
    """Translational RPE over a frame delta (drift metric)."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err**2))), err


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry ground-truth pose file -> [N, 3, 4] matrices."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    return data
