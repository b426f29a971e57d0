"""Keyframe place recognition for loop closure: the port's own copy of
``pointcept_keypointdetection_tpu/slam/frontend.py`` (host-side numpy).

A keyframe descriptor is the weighted concatenation of L2-normalized parts:
a yaw-invariant (range ring x height band) occupancy histogram, a semantic
class histogram of the scan's labels where there are labels, and a learned
embedding where the caller has one (``run_slam``'s model-label path passes
the labeller's pooled backbone features).  The yaw between a query and a
match comes from the circular cross-correlation of their azimuthal range
profiles: an initial guess for ICP verification under any positional drift.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class DescriptorConfig:
    def __init__(
        self,
        range_bins: int = 12,
        height_bins: int = 6,
        azimuth_bins: int = 60,
        max_range: float = 60.0,
        height_min: float = -3.0,
        height_max: float = 9.0,
        num_classes: int = 32,
        w_geometric: float = 1.0,
        w_semantic: float = 0.5,
        w_embedding: float = 1.0,
    ):
        self.range_bins = range_bins
        self.height_bins = height_bins
        self.azimuth_bins = azimuth_bins
        self.max_range = max_range
        self.height_min = height_min
        self.height_max = height_max
        self.num_classes = num_classes
        self.w_geometric = w_geometric
        self.w_semantic = w_semantic
        self.w_embedding = w_embedding


def _l2n(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def scan_descriptor(
    points: np.ndarray,
    labels: Optional[np.ndarray] = None,
    embedding: Optional[np.ndarray] = None,
    cfg: Optional[DescriptorConfig] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (descriptor, azimuth_profile) for a sensor-frame scan [N, 3+].

    The descriptor is the weighted concat of L2-normalized parts (so cosine
    similarity decomposes into a weighted mean of per-part cosines); the
    azimuth profile (mean range per azimuth bin) is kept separately for
    yaw recovery at match time.
    """
    cfg = cfg or DescriptorConfig()
    pts = np.asarray(points[:, :3], np.float32)
    ok = np.isfinite(pts).all(1)
    pts = pts[ok]
    rng = np.linalg.norm(pts[:, :2], axis=1)
    keep = (rng > 1e-3) & (rng < cfg.max_range)
    pts, rng = pts[keep], rng[keep]

    r_bin = np.minimum(
        (rng / cfg.max_range * cfg.range_bins).astype(np.int32), cfg.range_bins - 1
    )
    h = np.clip(pts[:, 2], cfg.height_min, cfg.height_max)
    h_bin = np.minimum(
        ((h - cfg.height_min) / (cfg.height_max - cfg.height_min) * cfg.height_bins).astype(
            np.int32
        ),
        cfg.height_bins - 1,
    )
    geo = np.zeros((cfg.range_bins, cfg.height_bins), np.float64)
    np.add.at(geo, (r_bin, h_bin), 1.0)
    geo = _l2n(np.sqrt(geo / max(len(pts), 1)).reshape(-1))  # sqrt: soft counts

    parts = [cfg.w_geometric * geo]
    if labels is not None:
        lab = np.asarray(labels).reshape(-1)[ok][keep]
        sem = np.bincount(
            np.clip(lab, 0, cfg.num_classes - 1), minlength=cfg.num_classes
        ).astype(np.float64)
        parts.append(cfg.w_semantic * _l2n(np.sqrt(sem)))
    if embedding is not None:
        parts.append(cfg.w_embedding * _l2n(np.asarray(embedding, np.float64).reshape(-1)))

    desc = _l2n(np.concatenate(parts))

    az = np.arctan2(pts[:, 1], pts[:, 0])  # [-pi, pi)
    az_bin = np.minimum(
        ((az + np.pi) / (2 * np.pi) * cfg.azimuth_bins).astype(np.int32),
        cfg.azimuth_bins - 1,
    )
    prof_sum = np.zeros(cfg.azimuth_bins, np.float64)
    prof_cnt = np.zeros(cfg.azimuth_bins, np.float64)
    np.add.at(prof_sum, az_bin, rng)
    np.add.at(prof_cnt, az_bin, 1.0)
    profile = prof_sum / np.maximum(prof_cnt, 1.0)
    return desc.astype(np.float32), profile.astype(np.float32)


def relative_yaw(profile_query: np.ndarray, profile_match: np.ndarray) -> float:
    """Yaw rotating the QUERY scan into the MATCH scan's frame, from the
    circular cross-correlation of azimuthal range profiles (10-degree-ish
    resolution — an ICP initial guess, not a final estimate)."""
    a = profile_query - profile_query.mean()
    b = profile_match - profile_match.mean()
    nbins = len(a)
    # correlate a rolled by s against b; best s = yaw shift in bins
    fa = np.fft.rfft(a)
    fb = np.fft.rfft(b)
    corr = np.fft.irfft(fb * np.conj(fa), n=nbins)
    shift = int(np.argmax(corr))
    # a point at azimuth theta in the query appears at theta + yaw in the match
    yaw = shift * 2 * np.pi / nbins
    if yaw > np.pi:
        yaw -= 2 * np.pi
    return float(yaw)


class DescriptorIndex:
    """Flat cosine-similarity index over keyframe descriptors (keyframe
    counts are hundreds; brute force is exact and instant)."""

    def __init__(self):
        self._desc: List[np.ndarray] = []
        self._profiles: List[np.ndarray] = []

    def __len__(self) -> int:
        return len(self._desc)

    def add(self, desc: np.ndarray, profile: np.ndarray) -> None:
        self._desc.append(np.asarray(desc, np.float32))
        self._profiles.append(np.asarray(profile, np.float32))

    def profile(self, i: int) -> np.ndarray:
        return self._profiles[i]

    def descriptor(self, i: int) -> np.ndarray:
        return self._desc[i]

    def query(
        self, desc: np.ndarray, max_index: int, topk: int = 3, min_sim: float = 0.0
    ) -> List[Tuple[int, float]]:
        """Top-k (index, cosine) among entries with index < max_index."""
        if max_index <= 0 or not self._desc:
            return []
        mat = np.stack(self._desc[:max_index])
        sims = mat @ np.asarray(desc, np.float32)
        order = np.argsort(-sims)[:topk]
        return [(int(i), float(sims[i])) for i in order if sims[i] >= min_sim]
