"""Seeded synthetic point clouds for smoke runs, training and tests.

``make_scene``, ``SyntheticSemSegDataset``, ``make_pig`` and
``SyntheticKeypointDataset`` are copies of ``pointcept_keypointdetection_tpu/
datasets/synthetic.py``: the same seed gives the same scenes, labels and
mm-unit offset and mask targets.
"""

from __future__ import annotations

import copy

import numpy as np

from .builder import DATASETS
from .transform import TRANSFORMS, Compose


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


def make_scene(rng: np.random.Generator, num_points: int, num_classes: int):
    """A toy room (`synthetic.py:17-60`): a floor plane (class 0), a wall plane
    (class 1) and blobs whose class follows their height band; each blob is one
    instance, floor and wall are instance -1; colour is a per-class tint plus noise."""
    n_floor = num_points // 3
    n_wall = num_points // 3
    n_obj = num_points - n_floor - n_wall
    floor = np.stack([rng.uniform(0, 4, n_floor), rng.uniform(0, 4, n_floor), rng.normal(0, 0.01, n_floor)], 1)
    wall = np.stack([rng.uniform(0, 4, n_wall), rng.normal(0, 0.01, n_wall), rng.uniform(0, 2, n_wall)], 1)
    objs, labels, inst_ids = [], [], []
    n_left = n_obj
    inst = 0
    while n_left > 0:
        k = int(min(rng.integers(200, 600), n_left))
        center = np.array([rng.uniform(0.5, 3.5), rng.uniform(0.5, 3.5), rng.uniform(0.2, 1.0)])
        pts = center + rng.normal(0, 0.15, (k, 3))
        bands = max(num_classes - 2, 1)
        cls = 2 + min(int((center[2] - 0.2) / 0.8 * bands), bands - 1)
        objs.append(pts)
        labels.append(np.full(k, cls))
        inst_ids.append(np.full(k, inst))
        inst += 1
        n_left -= k
    coord = np.concatenate([floor, wall] + objs).astype(np.float32)
    segment = np.concatenate([np.zeros(n_floor), np.ones(n_wall)] + labels).astype(np.int32)
    segment = np.minimum(segment, num_classes - 1)
    instance = np.concatenate([np.full(n_floor, -1), np.full(n_wall, -1)] + inst_ids).astype(np.int32)
    base = (coord - coord.min(0)) / (np.ptp(coord, axis=0) + 1e-6) * 60
    tint = np.stack([(segment * 53) % 256, (segment * 101) % 256, (segment * 197) % 256], 1)
    color = np.clip(0.7 * tint + base + rng.normal(0, 8, coord.shape), 0, 255)
    return coord, color.astype(np.float32), segment, instance


@DATASETS.register_module()
class SyntheticSemSegDataset:
    """Synthetic rooms for semantic segmentation (`synthetic.py:63-135`);
    scene i of a split is ``make_scene`` seeded with seed + i (+ 10,000
    outside train).

    Test mode (for ``SemSegTester``): a scene goes through ``transform``,
    then each ``test_cfg.aug_transform`` variant of a deep copy through the
    ``voxelize`` transform (GridSample's test mode: parts with ``index``),
    each part through ``crop`` where set, and every fragment through
    ``post_transform``; returned as ``{"segment", "name", "fragment_list"}``.
    As in JAX, the scene-level ``origin_segment`` and ``inverse`` that a
    ``Copy`` and a GridSample with ``return_inverse`` leave in ``transform``'s
    output are not carried into that dict."""

    def __init__(self, split="train", num_scenes=8, num_points=8192, num_classes=6, transform=None, seed=0, loop=1,
                 test_mode=False, test_cfg=None):
        self.num_scenes = num_scenes
        self.num_points = num_points
        self.num_classes = num_classes
        self.transform = Compose(transform)
        self.seed = seed + (0 if split == "train" else 10_000)
        self.loop = loop if not test_mode else 1
        self.test_mode = test_mode
        if test_mode:
            tc = test_cfg or {}
            self.test_voxelize = TRANSFORMS.build(dict(tc["voxelize"])) if tc.get("voxelize") else None
            self.test_crop = TRANSFORMS.build(dict(tc["crop"])) if tc.get("crop") else None
            self.post_transform = Compose(tc.get("post_transform"))
            self.aug_transform = [Compose(aug) for aug in tc.get("aug_transform", [[]])]

    def get_data(self, idx):
        idx = idx % self.num_scenes
        rng = np.random.default_rng(self.seed + idx)
        coord, color, segment, instance = make_scene(rng, self.num_points, self.num_classes)
        return dict(coord=coord, color=color, segment=segment, instance=instance, name=f"scene{idx}")

    def prepare_test_data(self, idx):
        data_dict = self.transform(self.get_data(idx))
        result_dict = dict(segment=data_dict.pop("segment"), name=data_dict.pop("name"))
        fragment_list = []
        for aug in self.aug_transform:
            data = aug(copy.deepcopy(data_dict))
            if self.test_voxelize is not None:
                parts = self.test_voxelize(data)
            else:
                data["index"] = np.arange(data["coord"].shape[0])
                parts = [data]
            for part in parts:
                fragment_list += self.test_crop(part) if self.test_crop else [part]
        result_dict["fragment_list"] = [self.post_transform(f) for f in fragment_list]
        return result_dict

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_data(idx)
        return self.transform(self.get_data(idx))

    def __len__(self):
        return self.num_scenes * self.loop


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
