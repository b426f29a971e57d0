"""Seeded synthetic point clouds for smoke runs, training and tests.

``make_pig`` and ``SyntheticKeypointDataset`` are copies of
``pointcept_keypointdetection_tpu/datasets/synthetic.py:127-205``: the same
seed gives the same scenes and the same mm-unit offset and mask targets.
"""

from __future__ import annotations

import numpy as np

from .builder import DATASETS
from .transform import Compose


def body_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """A pig-like closed surface in mm, float32 [n, 3]: ellipsoid trunk
    (1.2 x 0.5 x 0.6 m), head, four legs, 2 mm noise."""
    parts = []
    n_trunk, n_head = n * 6 // 10, n // 10
    th = np.arccos(rng.uniform(-1, 1, n_trunk))
    ph = rng.uniform(0, 2 * np.pi, n_trunk)
    parts.append(np.stack([600 * np.sin(th) * np.cos(ph), 250 * np.sin(th) * np.sin(ph), 300 * np.cos(th)], 1))
    th = np.arccos(rng.uniform(-1, 1, n_head))
    ph = rng.uniform(0, 2 * np.pi, n_head)
    parts.append(np.stack([700 + 150 * np.sin(th) * np.cos(ph), 120 * np.sin(th) * np.sin(ph),
                           100 + 130 * np.cos(th)], 1))
    rest = n - n_trunk - n_head
    for i, (x, y) in enumerate([(-350, -120), (-350, 120), (350, -120), (350, 120)]):
        m = rest // 4 if i < 3 else rest - 3 * (rest // 4)
        a = rng.uniform(0, 2 * np.pi, m)
        parts.append(np.stack([x + 60 * np.cos(a), y + 60 * np.sin(a), rng.uniform(-700, -250, m)], 1))
    return (np.concatenate(parts) + rng.normal(0, 2, (n, 3))).astype(np.float32)


def make_pig(rng: np.random.Generator, num_points: int):
    """Ellipsoid body + keypoints at nose/tail/leg extremes (mm units)."""
    axes = np.array([600.0, 220.0, 260.0]) * rng.uniform(0.8, 1.2, 3)
    u = rng.normal(size=(num_points, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = rng.uniform(0.9, 1.0, (num_points, 1)) ** 0.3
    coord = (u * r * axes).astype(np.float32)
    center = rng.uniform(-50, 50, 3).astype(np.float32)
    coord += center
    normal = (u / np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-6)).astype(np.float32)
    curvature = rng.uniform(0, 1, (num_points, 1)).astype(np.float32)
    kp = np.array(
        [[axes[0], 0, 0], [-axes[0], 0, 0], [0, axes[1], 0], [0, -axes[1], 0], [0, 0, axes[2]], [0, 0, -axes[2]]],
        np.float32,
    ) + center
    return coord, np.concatenate([normal, curvature], 1), kp


@DATASETS.register_module()
class SyntheticKeypointDataset:
    """Offset-keypoint synthetic scenes: normalized coords, normal + curvature
    features, and per-point offsets to every keypoint within
    ``offset_radius`` mm with their masks."""

    def __init__(self, split="train", num_scenes=8, num_points=4096, num_keypoints=6, offset_radius=300.0,
                 transform=None, seed=0, loop=1, test_mode=False, dense_targets=True):
        if test_mode:
            raise NotImplementedError("SyntheticKeypointDataset: test mode is not ported yet")
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.num_keypoints = num_keypoints
        self.offset_radius = offset_radius
        self.transform = Compose(transform)
        self.seed = seed + (0 if split == "train" else 10_000)
        self.loop = loop
        self.dense_targets = dense_targets

    def __getitem__(self, idx):
        idx = idx % self.num_scenes
        rng = np.random.default_rng(self.seed + idx)
        coord, feat, kp = make_pig(rng, self.num_points)
        centroid = coord.mean(0)
        coord = coord - centroid
        scale = float(np.sqrt((coord**2).sum(1)).max())
        coord = coord / scale
        kpn = (kp - centroid) / scale
        data = dict(
            coord=coord,
            feat=feat,
            keypoint=kpn.astype(np.float32),
            centroid=centroid.astype(np.float32),
            scale=np.float32(scale),
            name=f"pig{idx}",
        )
        if self.dense_targets:
            offsets = kpn[None, :, :] - coord[:, None, :]
            dist = np.linalg.norm(offsets, axis=-1) * scale
            mask = (dist <= self.offset_radius).astype(np.float32)
            data["keypoint_offset"] = (offsets * mask[..., None]).astype(np.float32)
            data["keypoint_mask"] = mask
        return self.transform(data)

    def __len__(self):
        return self.num_scenes * self.loop
