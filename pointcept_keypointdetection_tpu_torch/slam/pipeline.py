"""LiDAR odometry, scan to map: the counterpart of ``pointcept_keypointdetection_tpu/slam/pipeline.py``.

Per scan: on the host (numpy), the range gate, the semantic filter of the
dynamic classes, one point per ``scan_voxel`` and the padding to
``scan_capacity``; then on the device, with no host read, the damped
constant-velocity prediction and its motion clamp, point-to-plane ICP
against the sliding voxel map (not on the first scan), the health and
fusion gates, the second motion clamp, and the map's insert and prune.
``process`` reads the pose, the RMSE and the inlier count once, at the end.
The device arithmetic is ``ordered.py``'s, so the card and the CPU track a
sequence to the same bits.

The correspondence search is the one JAX runs on the CPU: bucketed at
``max_corr_dist`` with ``cell_cap`` rows a cell, on every device.  (JAX
picks the unit-cell search on a TPU only; both give the same
correspondences within the distance gate, and ``point_to_plane_icp`` keeps
the unit-cell arguments.)  JAX's executable cache (``utils/aot_cache``) has
no counterpart: the step is eager PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.serialization import z_order_encode_np
from . import ordered as o
from . import se3
from .registration import point_to_plane_icp
from .voxel_map import VoxelMap, insert, prune


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; a CUDA device raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SLAM: device is cuda but no CUDA device is available (pass device='cpu')")
    return device


@dataclasses.dataclass
class OdometryConfig:
    scan_capacity: int = 16384  # padded downsampled scan size
    map_capacity: int = 262144
    scan_voxel: float = 0.5
    map_voxel: float = 0.4
    icp_iters: int = 8
    search_every: int = 1  # correspondence search every m-th GN iteration (1: every one)
    knn_k: int = 5
    max_corr_dist: float = 1.0
    huber_delta: float = 0.3
    min_planarity: float = 0.7
    map_radius: float = 150.0
    min_range: float = 2.5  # drop ego returns
    max_range: float = 80.0
    dynamic_classes: Tuple[int, ...] = ()  # semantic train-ids to drop
    map_origin: Tuple[float, float, float] = (-800.0, -800.0, -200.0)
    max_motion: float = 3.0  # per-frame translation clamp (m)
    min_inlier_frac: float = 0.25  # accept ICP and fuse only with this share of scan points as inliers
    insert_rmse_gate: float = 0.08  # and fuse only below this registration RMSE
    velocity_damping: float = 0.9  # v_pred = velocity_damping * v


def search_depth(cfg: OdometryConfig) -> Optional[int]:
    """The correspondence index's depth (`pipeline.py:155-158`): the pruned map's span (2 map_radius, plus
    a max_motion of drift either way) in search cells, None (16) where 3 x depth exceeds 31."""
    span = (2.0 * cfg.map_radius + 2.0 * cfg.max_motion) / cfg.max_corr_dist + 8
    depth = max(int(np.ceil(np.log2(span))), 4)
    return None if 3 * depth > 31 else depth


def insert_depth(cfg: OdometryConfig) -> Optional[int]:
    """The map insert's code depth (`pipeline.py:199-206`): the merged set's span, 2 max(map_radius,
    max_range) plus 2 max_motion, in map voxels; None where 3 x depth exceeds 31."""
    span = (2.0 * max(cfg.map_radius, cfg.max_range) + 2.0 * cfg.max_motion) / cfg.map_voxel + 8
    depth = max(int(np.ceil(np.log2(span))), 4)
    return depth if 3 * depth <= 31 else None


def search_cell_cap(cfg: OdometryConfig) -> int:
    """Rows a search cell holds: every map voxel of a max_corr_dist cell, at most 128."""
    return min(int(np.ceil(cfg.max_corr_dist / cfg.map_voxel) + 1) ** 3, 128)


class LidarOdometry:
    """Scan-to-map odometry on ``device`` (the card by default; a CUDA device raises where there is none)."""

    def __init__(self, config: Optional[OdometryConfig] = None, device: Union[str, torch.device] = "cuda"):
        self.cfg = config or OdometryConfig()
        self.device = resolve_device(device)
        self.vmap = VoxelMap.create(self.cfg.map_capacity, self.cfg.map_voxel, self.cfg.map_origin, self.device)
        self.poses: List[np.ndarray] = []  # [4, 4] world_T_sensor
        eye, zero = torch.eye(3, device=self.device), torch.zeros(3, device=self.device)
        self._R, self._t, self._R_prev, self._t_prev = eye, zero, eye, zero
        self._frame = 0

    # -- host-side preprocessing ----------------------------------------
    def _preprocess(self, scan: np.ndarray, labels: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """(points f32 [scan_capacity, 3], valid [scan_capacity]) (`pipeline.py:89-113`)."""
        cfg = self.cfg
        pts = scan[:, :3].astype(np.float32)
        keep = np.isfinite(pts).all(axis=1)
        rng = np.linalg.norm(pts, axis=1)
        keep &= (rng > cfg.min_range) & (rng < cfg.max_range)
        if labels is not None and cfg.dynamic_classes:
            keep &= ~np.isin(labels, cfg.dynamic_classes)
        pts = pts[keep]
        grid = np.floor(pts / cfg.scan_voxel).astype(np.int64)
        grid -= grid.min(0) if len(grid) else 0
        if len(pts):
            key = z_order_encode_np(np.minimum(grid, 2**16 - 1), depth=16)
            _, first = np.unique(key, return_index=True)
            pts = pts[np.sort(first)]
        n = len(pts)
        if n > cfg.scan_capacity:
            sel = np.random.default_rng(0).choice(n, cfg.scan_capacity, replace=False)
            pts = pts[sel]
            n = cfg.scan_capacity
        out = np.zeros((cfg.scan_capacity, 3), np.float32)
        out[:n] = pts
        valid = np.zeros(cfg.scan_capacity, bool)
        valid[:n] = True
        return out, valid

    # -- the per-scan update, on the device ------------------------------
    def _step(self, vmap: VoxelMap, R_prev, t_prev, R_prev2, t_prev2, scan, valid, do_icp: bool):
        """(`pipeline.py:116-220`): ``do_icp`` is the host's frame count, so JAX's ``lax.cond`` is a branch
        here; ``healthy`` and ``fuse`` stay on the device."""
        cfg = self.cfg
        Ri, ti = se3.se3_inverse(R_prev2, t_prev2)
        dR, dt = se3.se3_compose(Ri, ti, R_prev, t_prev)
        g = cfg.velocity_damping
        dt = g * dt
        dR = se3.so3_exp(g * se3.so3_log(dR))
        R0, t0 = se3.se3_compose(R_prev, t_prev, dR, dt)
        # the physical-motion clamp on the prediction
        step_t = t0 - t_prev
        t0 = t_prev + step_t * torch.clamp(o.div(cfg.max_motion, torch.clamp_min(se3.norm(step_t), 1e-9)), max=1.0)

        if do_icp:
            res = point_to_plane_icp(
                scan, valid, vmap.points, vmap.valid, R0, t0, iters=cfg.icp_iters, k=cfg.knn_k,
                max_corr_dist=cfg.max_corr_dist, huber_delta=cfg.huber_delta, damping=1e-4,
                min_planarity=cfg.min_planarity, cell_cap=search_cell_cap(cfg), index_depth=search_depth(cfg),
                search_every=cfg.search_every)
            R, t, rmse, inliers = res
            # an unhealthy registration coasts on the clamped prediction; only a good one is fused
            n_scan = torch.clamp_min(torch.sum(valid), 1)
            healthy = inliers >= cfg.min_inlier_frac * n_scan
            R = torch.where(healthy, R, R0)
            t = torch.where(healthy, t, t0)
            fuse = healthy & (rmse < cfg.insert_rmse_gate)
        else:
            zero = torch.zeros((), dtype=torch.float32, device=scan.device)
            R, t, rmse, inliers = R0, t0, zero, zero.long()
            fuse = torch.ones((), dtype=torch.bool, device=scan.device)
        # the accepted pose's clamp
        step_t = t - t_prev
        t = t_prev + step_t * torch.clamp(o.div(2.0 * cfg.max_motion, torch.clamp_min(se3.norm(step_t), 1e-9)), max=1.0)

        world = se3.transform(R, t, scan)
        new_map = insert(vmap, world, valid & fuse, code_depth=insert_depth(cfg))
        new_map = prune(new_map, t, cfg.map_radius)
        return new_map, R, t, rmse, inliers

    def process(self, scan: np.ndarray, labels: Optional[np.ndarray] = None) -> np.ndarray:
        """Feed one scan (N, >=3). Returns the 4x4 world_T_sensor pose (f64)."""
        pts, valid = self._preprocess(scan, labels)
        self.vmap, R, t, rmse, inliers = self._step(
            self.vmap, self._R, self._t, self._R_prev, self._t_prev,
            torch.from_numpy(pts).to(self.device, non_blocking=True),
            torch.from_numpy(valid).to(self.device, non_blocking=True), self._frame > 0)
        self._R_prev, self._t_prev = self._R, self._t
        self._R, self._t = R, t
        # the scan's one host read: pose, RMSE and inliers in one copy
        out = torch.cat([R.reshape(-1), t, rmse.reshape(1), inliers.to(torch.float32).reshape(1)]).cpu().numpy()
        self.last_rmse = float(out[12])
        self.last_inliers = int(out[13])
        self.last_scan_points = int(valid.sum())
        self._frame += 1
        pose = np.eye(4, dtype=np.float64)
        pose[:3, :3] = out[:9].reshape(3, 3)
        pose[:3, 3] = out[9:12]
        self.poses.append(pose)
        return pose

    @property
    def positions(self) -> np.ndarray:
        return np.array([p[:3, 3] for p in self.poses])
