"""The pig keypoint readers: the port's ``KeypointDataset`` and
``OffsetKeypointDataset`` (``pointcept_keypointdetection_tpu/datasets/
keypoint_dataset.py:36-204``).

On disk, per split: ``<data_root>/<split>/pointclouds/<ts>.npy`` (N x 7: xyz,
normal, curvature) and ``<data_root>/<split>/keypoints/<ts>_关键点坐标.npy``
(or ``<ts>.npy``; K x 3 keypoints).  NaNs become 0; a file whose keypoints are
not K x 3, or whose cloud is empty, is replaced by a sample drawn with the
global ``np.random``, as JAX's is.  The cloud is centred on its centroid and
divided by its largest radius (``scale``), and the keypoints with it;
``centroid`` and ``scale`` stay in the sample for de-normalization.

``OffsetKeypointDataset``'s dense targets: ``keypoint_offset`` (N, K, 3) and
``keypoint_mask`` (N, K), online (``offset = keypoint - point``, kept where
its length is at most ``offset_radius``, in the cloud's units) or read from
``keypoints/<ts>_keypoint_offset.npy`` (N, K, 4); the offsets are divided by
``scale``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.logger import get_root_logger
from .builder import DATASETS
from .transform import Compose

KEYPOINT_LABEL_SUFFIX = "_关键点坐标"


def find_keypoint_path(kp_dir: str, timestamp: str) -> Optional[str]:
    for candidate in (f"{timestamp}{KEYPOINT_LABEL_SUFFIX}.npy", f"{timestamp}.npy"):
        path = os.path.join(kp_dir, candidate)
        if os.path.exists(path):
            return path
    return None


def normalize_cloud(coord: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centred coords / scale, centroid, scale) in f32, the scale the largest radius (1 where it is
    ~0): the readers' normalization and the predictors'."""
    centroid = coord.mean(axis=0)
    coord = coord - centroid
    scale = float(np.sqrt((coord**2).sum(axis=1)).max())
    scale = scale if scale > 1e-6 else 1.0
    return (coord / scale).astype(np.float32), centroid.astype(np.float32), scale


class _KeypointBase:
    def __init__(self, split, data_root, transform, test_mode, loop, num_keypoints):
        self.data_root = data_root
        self.split = split
        self.num_keypoints = num_keypoints
        self.transform = Compose(transform)
        self.test_mode = test_mode
        self.loop = loop if not test_mode else 1
        self.data_list = self._get_file_list()
        get_root_logger().info("[%s] %d keypoint samples under %s", split, len(self.data_list), data_root)

    def _get_file_list(self):
        split_path = os.path.join(self.data_root, self.split)
        if not os.path.exists(split_path):
            raise ValueError(f"data path missing: {split_path}")
        data_list = []
        for feat_path in sorted(glob.glob(os.path.join(split_path, "pointclouds", "*.npy"))):
            timestamp = os.path.splitext(os.path.basename(feat_path))[0]
            kp_path = find_keypoint_path(os.path.join(split_path, "keypoints"), timestamp)
            if kp_path is None:
                get_root_logger().warning("no keypoint label for %s", timestamp)
                continue
            data_list.append(dict(feat_path=feat_path, keypoint_path=kp_path, name=timestamp))
        return data_list

    def _load_cloud(self, info):
        raw = np.load(info["feat_path"]).astype(np.float32)
        return np.nan_to_num(raw[:, 0:3]), np.nan_to_num(raw[:, 3:])

    def _load_keypoints(self, info):
        kp = np.nan_to_num(np.load(info["keypoint_path"]).astype(np.float32))
        if kp.ndim == 1 and kp.size % 3 == 0:
            kp = kp.reshape(-1, 3)
        if kp.shape != (self.num_keypoints, 3):
            return None
        return kp

    def _resample(self):
        return self[np.random.randint(0, len(self.data_list))]

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class KeypointDataset(_KeypointBase):
    """Global-regression targets: the normalized (K, 3) keypoints of each cloud."""

    def __init__(self, split="train", data_root="data", transform=None, test_mode=False, loop=1, num_keypoints=6):
        super().__init__(split, data_root, transform, test_mode, loop, num_keypoints)

    def __getitem__(self, idx):
        info = self.data_list[idx % len(self.data_list)]
        coord, feat = self._load_cloud(info)
        keypoint = self._load_keypoints(info)
        if keypoint is None or coord.shape[0] == 0:
            return self._resample()
        coord, centroid, scale = normalize_cloud(coord)
        data_dict = dict(coord=coord, feat=feat, keypoint=((keypoint - centroid) / scale).astype(np.float32),
                         name=info["name"], centroid=centroid, scale=np.float32(scale))
        return self.transform(data_dict)


@DATASETS.register_module()
class OffsetKeypointDataset(_KeypointBase):
    """Dense offset + mask targets per point."""

    def __init__(self, split="train", data_root="data", transform=None, test_mode=False, loop=1,
                 offset_radius=None, online_offset=None, num_keypoints=6):
        self.offset_radius = None if offset_radius is None else float(offset_radius)
        self.online_offset = self.offset_radius is not None if online_offset is None else online_offset
        if self.online_offset and self.offset_radius is None:
            raise ValueError("online_offset=True requires offset_radius")
        super().__init__(split, data_root, transform, test_mode, loop, num_keypoints)

    def _get_file_list(self):
        if self.online_offset:
            return super()._get_file_list()
        split_path = os.path.join(self.data_root, self.split)
        data_list = []
        for feat_path in sorted(glob.glob(os.path.join(split_path, "pointclouds", "*.npy"))):
            timestamp = os.path.splitext(os.path.basename(feat_path))[0]
            label_path = os.path.join(split_path, "keypoints", f"{timestamp}_keypoint_offset.npy")
            if os.path.exists(label_path):
                data_list.append(dict(feat_path=feat_path, label_path=label_path, name=timestamp))
        return data_list

    def _offset_target(self, coord, keypoint):
        offsets = keypoint[None, :, :] - coord[:, None, :]  # (N, K, 3)
        mask = (np.linalg.norm(offsets, axis=-1) <= self.offset_radius).astype(np.float32)
        return offsets * mask[..., None], mask

    def __getitem__(self, idx):
        info = self.data_list[idx % len(self.data_list)]
        coord, feat = self._load_cloud(info)
        if coord.shape[0] == 0:
            return self._resample()
        keypoint = None
        if self.online_offset:
            keypoint = self._load_keypoints(info)
            if keypoint is None:
                return self._resample()
            offset, mask = self._offset_target(coord, keypoint)
        else:
            target = np.nan_to_num(np.load(info["label_path"]).astype(np.float32))
            if target.ndim != 3 or target.shape[1:] != (self.num_keypoints, 4) or target.shape[0] != coord.shape[0]:
                return self._resample()
            offset, mask = target[..., :3], target[..., 3]
        coord, centroid, scale = normalize_cloud(coord)
        data_dict = dict(coord=coord, feat=feat, keypoint_offset=(offset / scale).astype(np.float32),
                         keypoint_mask=mask.astype(np.float32), name=info["name"], centroid=centroid,
                         scale=np.float32(scale))
        if keypoint is not None:
            data_dict["keypoint"] = ((keypoint - centroid) / scale).astype(np.float32)
        return self.transform(data_dict)
