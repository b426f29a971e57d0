"""The SLAM back end: the counterpart of ``pointcept_keypointdetection_tpu/slam/semantic_slam.py``.

``SemanticSLAM`` wraps ``LidarOdometry`` with keyframes (by distance and
angle), an odometry edge between consecutive keyframes, loop candidates by
pose proximity and by descriptor similarity (``frontend.py``, with a
yaw-aligned guess at the matched place), each verified by ICP of the
keyframes' stored scans and kept only within the drift budget of its chain,
loop edges weighted by their ICP residual, a pose-graph solve every
``optimize_every`` keyframes with the odometry prior faded inside verified
loop spans, and ``final_trajectory``'s retro-correction of every frame
through its keyframe.  The keyframe store is host numpy (f32 poses, as in
JAX); the registrations and the graph solve run on the odometry's device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from .frontend import DescriptorConfig, DescriptorIndex, relative_yaw, scan_descriptor
from .pipeline import LidarOdometry, OdometryConfig
from .pose_graph import PoseGraph, optimize
from .registration import point_to_plane_icp


@dataclasses.dataclass
class SlamConfig:
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    keyframe_dist: float = 2.0  # m translation between keyframes
    keyframe_angle: float = 0.3  # rad rotation between keyframes
    max_keyframes: int = 512
    loop_closure: bool = True
    loop_min_gap: int = 30  # keyframes between loop candidates
    loop_max_dist: float = 8.0  # m candidate gate
    loop_min_inliers: int = 1500
    optimize_every: int = 10  # keyframes between pose-graph solves
    keyframe_scan_size: int = 4096  # stored downsampled scan per keyframe
    loop_descriptor: bool = True  # descriptor candidates besides pose proximity
    loop_desc_topk: int = 2
    loop_desc_min_sim: float = 0.75
    loop_desc_corr_dist: float = 2.0  # ICP gate for descriptor candidates
    # drift budget: a loop edge's correction of keyframe k must be <= base + rate x the chain's length
    loop_drift_rate: float = 0.10
    loop_drift_base: float = 1.0
    # loop-edge information: clip((sigma / rmse)^2, max loop_weight_max)
    loop_weight_sigma: float = 0.05
    loop_weight_max: float = 100.0
    # per-node prior toward the odometry poses, faded by 1 / (1 + the spanning loop edges' weights / it)
    graph_prior_weight: float = 0.2


class SemanticSLAM:
    """Odometry, keyframes, loop closure and the pose graph on ``device`` (the card by default)."""

    def __init__(self, config: Optional[SlamConfig] = None, device: Union[str, torch.device] = "cuda"):
        self.cfg = config or SlamConfig()
        self.odo = LidarOdometry(self.cfg.odometry, device)
        self.device = self.odo.device
        self.kf_R: List[np.ndarray] = []
        self.kf_t: List[np.ndarray] = []
        self.kf_scan: List[np.ndarray] = []
        self.kf_scan_valid: List[np.ndarray] = []
        self.kf_frame: List[int] = []
        self.edges: List[tuple] = []  # (i, j, Z_R, Z_t, weight)
        self._frame = 0
        self.descriptor_index = DescriptorIndex()
        self.descriptor_cfg = DescriptorConfig()
        self.embed_fn = None  # scan [N, 3+] -> vector, where process() gets no embedding
        self._anchors: List[tuple] = []  # per frame: (keyframe, T_rel = kf_T^-1 frame_T)
        self._loop_count = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.float32) if a.dtype != bool else a).to(self.device)

    # -- keyframing ------------------------------------------------------
    def _is_keyframe(self, R, t) -> bool:
        if not self.kf_R:
            return True
        dt = np.linalg.norm(t - self.kf_t[-1])
        dR = self.kf_R[-1].T @ R
        angle = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        return dt > self.cfg.keyframe_dist or angle > self.cfg.keyframe_angle

    def _add_keyframe(self, R, t, scan, valid, labels=None, embedding=None):
        cfg = self.cfg
        if len(self.kf_R) >= cfg.max_keyframes:
            return
        k = len(self.kf_R)
        if cfg.loop_closure and cfg.loop_descriptor:
            emb = embedding
            if emb is None and self.embed_fn is not None:
                emb = self.embed_fn(scan)
            desc, profile = scan_descriptor(scan, labels, emb, self.descriptor_cfg)
            self.descriptor_index.add(desc, profile)
        if k > 0:
            Ri, ti = self.kf_R[-1].T, -self.kf_R[-1].T @ self.kf_t[-1]
            self.edges.append((k - 1, k, Ri @ R, Ri @ t + ti, 1.0))
        # a small scan for loop verification
        n = min(len(scan), cfg.keyframe_scan_size)
        sel = np.linspace(0, len(scan) - 1, n).astype(int) if len(scan) else np.array([], int)
        stored = np.zeros((cfg.keyframe_scan_size, 3), np.float32)
        stored_valid = np.zeros(cfg.keyframe_scan_size, bool)
        stored[:n] = scan[sel]
        stored_valid[:n] = valid[sel] if valid is not None else True
        self.kf_R.append(R.copy())
        self.kf_t.append(t.copy())
        self.kf_scan.append(stored)
        self.kf_scan_valid.append(stored_valid)
        self.kf_frame.append(self._frame)
        if cfg.loop_closure:
            self._try_loop_closure(k)
        if cfg.optimize_every and (k + 1) % cfg.optimize_every == 0 and len(self.edges) > k:
            self._optimize_graph()

    # -- loop closure ----------------------------------------------------
    def _loop_candidates(self, k: int):
        """(j, R0, t0, corr_dist): the nearest keyframe by position with the current pose as the guess, and
        the descriptor matches with the yaw-aligned guess at the matched place."""
        cfg = self.cfg
        t_k = self.kf_t[k]
        out = []
        best = None
        for j in range(0, k - cfg.loop_min_gap):
            d = np.linalg.norm(self.kf_t[j] - t_k)
            if d < cfg.loop_max_dist and (best is None or d < best[1]):
                best = (j, d)
        if best is not None:
            out.append((best[0], self.kf_R[k], self.kf_t[k], 1.0))
        if cfg.loop_descriptor and len(self.descriptor_index) > k:
            matches = self.descriptor_index.query(self.descriptor_index.descriptor(k), max_index=k - cfg.loop_min_gap,
                                                  topk=cfg.loop_desc_topk, min_sim=cfg.loop_desc_min_sim)
            for j, _sim in matches:
                if any(j == c[0] for c in out):
                    continue
                yaw = relative_yaw(self.descriptor_index.profile(k), self.descriptor_index.profile(j))
                c, s = np.cos(yaw), np.sin(yaw)
                Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
                out.append((j, self.kf_R[j] @ Rz, self.kf_t[j], cfg.loop_desc_corr_dist))
        return out

    def _try_loop_closure(self, k: int):
        cfg = self.cfg
        scan_k, valid_k = self._tensor(self.kf_scan[k]), self._tensor(self.kf_scan_valid[k])
        best_edge = None
        for j, R0, t0, corr in self._loop_candidates(k):
            scan_j_world = self.kf_scan[j] @ self.kf_R[j].T + self.kf_t[j]
            depth = max(int(np.ceil(np.log2(140.0 / corr + 8))), 4)  # keyframe scans reach <= ~60 m
            res = point_to_plane_icp(scan_k, valid_k, self._tensor(scan_j_world), self._tensor(self.kf_scan_valid[j]),
                                     self._tensor(R0), self._tensor(t0), iters=10, max_corr_dist=corr,
                                     index_depth=depth if 3 * depth <= 31 else None)
            out = torch.cat([res.R.reshape(-1), res.t, res.rmse.reshape(1),
                             res.inliers.to(torch.float32).reshape(1)]).cpu().numpy()
            inl = int(out[13])
            if inl < cfg.loop_min_inliers:
                continue
            # the drift budget: the edge's correction of keyframe k must be explicable by the j..k chain's drift
            chain_len = sum(float(np.linalg.norm(self.kf_t[i + 1] - self.kf_t[i])) for i in range(j, k))
            t_k2 = out[9:12]
            if float(np.linalg.norm(t_k2 - self.kf_t[k])) > cfg.loop_drift_base + cfg.loop_drift_rate * chain_len:
                continue
            if best_edge is None or inl > best_edge[0]:
                best_edge = (inl, j, out[:9].reshape(3, 3), t_k2, float(out[12]))
        if best_edge is None:
            return
        _, j, R_k, t_k2, rmse = best_edge
        Ri, ti = self.kf_R[j].T, -self.kf_R[j].T @ self.kf_t[j]
        weight = min((cfg.loop_weight_sigma / max(rmse, 1e-4)) ** 2, cfg.loop_weight_max)
        self.edges.append((j, k, Ri @ R_k, Ri @ t_k2 + ti, weight))
        self._loop_count += 1

    # -- pose graph solve ------------------------------------------------
    def _optimize_graph(self):
        K = len(self.kf_R)
        dev = self.device
        graph = PoseGraph(
            R=self._tensor(np.stack(self.kf_R)), t=self._tensor(np.stack(self.kf_t)),
            node_valid=torch.ones(K, dtype=torch.bool, device=dev),
            edge_i=torch.tensor([e[0] for e in self.edges], device=dev),
            edge_j=torch.tensor([e[1] for e in self.edges], device=dev),
            Z_R=self._tensor(np.stack([e[2] for e in self.edges])),
            Z_t=self._tensor(np.stack([e[3] for e in self.edges])),
            edge_weight=self._tensor(np.array([e[4] for e in self.edges])))
        # fade the odometry prior inside verified loop spans
        pw = self.cfg.graph_prior_weight
        loop_info = np.zeros(K, np.float32)
        for i, j, _, _, w in self.edges:
            if abs(j - i) > 1:  # a loop edge
                lo, hi = min(i, j), max(i, j)
                loop_info[lo + 1: hi + 1] += w
        prior_w = pw / (1.0 + loop_info / max(pw, 1e-6))
        out = optimize(graph, iters=6, prior_weight=self._tensor(prior_w))
        new_R, new_t = out.R.cpu().numpy(), out.t.cpu().numpy()
        # the last keyframe's correction moves the live odometry pose
        old_R, old_t = self.kf_R[-1], self.kf_t[-1]
        corr_R = new_R[-1] @ old_R.T
        corr_t = new_t[-1] - corr_R @ old_t
        for i in range(K):
            self.kf_R[i], self.kf_t[i] = new_R[i], new_t[i]
        cur_R, cur_t = self.odo._R.cpu().numpy(), self.odo._t.cpu().numpy()
        self.odo._R = self._tensor(corr_R @ cur_R)
        self.odo._t = self._tensor(corr_R @ cur_t + corr_t)

    # -- main entry ------------------------------------------------------
    def process(self, scan: np.ndarray, labels: Optional[np.ndarray] = None,
                embedding: Optional[np.ndarray] = None) -> np.ndarray:
        pose = self.odo.process(scan, labels)
        R, t = pose[:3, :3].astype(np.float32), pose[:3, 3].astype(np.float32)
        n_kf = len(self.kf_R)
        if self._is_keyframe(R, t):
            pts = scan[:, :3].astype(np.float32)
            self._add_keyframe(R, t, pts, np.isfinite(pts).all(1), labels, embedding)
        if len(self.kf_R) > n_kf:
            # the new keyframe's pose is this frame's (a solve inside _add_keyframe may have moved it since)
            self._anchors.append((len(self.kf_R) - 1, np.eye(4)))
        else:
            k = len(self.kf_R) - 1
            kf_R, kf_t = self.kf_R[k], self.kf_t[k]
            T_rel = np.eye(4)
            T_rel[:3, :3] = kf_R.T @ pose[:3, :3]
            T_rel[:3, 3] = kf_R.T @ (pose[:3, 3] - kf_t)
            self._anchors.append((k, T_rel))
        self._frame += 1
        return pose

    def final_trajectory(self, optimize_final: bool = True) -> np.ndarray:
        """[N, 4, 4] poses, each frame re-based on its keyframe's optimized pose (a loop closure fixes the
        past)."""
        if optimize_final and len(self.edges) >= len(self.kf_R):
            self._optimize_graph()
        out = []
        for k, T_rel in self._anchors:
            T_kf = np.eye(4)
            T_kf[:3, :3] = self.kf_R[k]
            T_kf[:3, 3] = self.kf_t[k]
            out.append(T_kf @ T_rel)
        return np.stack(out) if out else np.zeros((0, 4, 4))

    @property
    def loop_count(self) -> int:
        """Number of ICP-verified loop-closure edges added to the graph."""
        return self._loop_count

    @property
    def keyframe_count(self) -> int:
        return len(self.kf_R)

    @property
    def edge_count(self) -> int:
        return len(self.edges)

    @property
    def positions(self) -> np.ndarray:
        return self.odo.positions

    @property
    def keyframe_positions(self) -> np.ndarray:
        return np.stack(self.kf_t) if self.kf_t else np.zeros((0, 3))
