"""Pig clouds: the port's ``PigDataset`` and ``PigWeightDataset``
(``pointcept_keypointdetection_tpu/datasets/pigseg.py:24-56``, ``:59-85``).

``PigDataset``: each sample is one ``<data_root>/<split>/*.npy`` file of
shape (N, 8): xyz in mm, normal, curvature and the label.  Rows with a NaN
are dropped, the cloud is centred on its median, and points 5 m (5000 mm) or
farther from it are dropped; ``feat`` is normal + curvature.

``PigWeightDataset``: ``<data_root>/<split>/pointclouds/<name>.npy`` (N x 7)
paired with ``labels/<name>.npy`` (the 7 body measures, ``weight_label``);
NaNs become 0 and the cloud is centred on its mean, never scaled (its size
is the signal).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.logger import get_root_logger
from .builder import DATASETS
from .transform import Compose


@DATASETS.register_module()
class PigDataset:
    def __init__(self, split="train", data_root="data", transform=None, test_mode=False, loop=1):
        if test_mode:
            raise NotImplementedError("PigDataset: test mode is not ported yet")
        self.data_root = data_root
        self.split = split
        self.transform = Compose(transform)
        self.loop = loop
        self.data_list = sorted(glob.glob(os.path.join(data_root, split, "*.npy")))
        get_root_logger().info("[%s] %d pig semseg samples", split, len(self.data_list))

    def __getitem__(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        raw = np.load(path).astype(np.float32)
        raw = raw[~np.isnan(raw).any(axis=1)]
        coord = raw[:, 0:3]
        feat = raw[:, 3:7]
        segment = raw[:, 7].astype(np.int32)
        coord = coord - np.median(coord, axis=0)
        inlier = np.linalg.norm(coord, axis=1) < 5000.0
        data_dict = dict(coord=coord[inlier], feat=feat[inlier], segment=segment[inlier],
                         name=os.path.splitext(os.path.basename(path))[0])
        return self.transform(data_dict)

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class PigWeightDataset:
    def __init__(self, split="train", data_root="data", transform=None, test_mode=False, loop=1):
        self.data_root = data_root
        self.split = split
        self.transform = Compose(transform)
        self.test_mode = test_mode
        self.loop = loop if not test_mode else 1
        split_path = os.path.join(data_root, split)
        self.data_list = []
        for cloud in sorted(glob.glob(os.path.join(split_path, "pointclouds", "*.npy"))):
            name = os.path.splitext(os.path.basename(cloud))[0]
            label = os.path.join(split_path, "labels", f"{name}.npy")
            if os.path.exists(label):
                self.data_list.append((cloud, label, name))
        get_root_logger().info("[%s] %d pig weight samples", split, len(self.data_list))

    def __getitem__(self, idx):
        cloud_path, label_path, name = self.data_list[idx % len(self.data_list)]
        raw = np.nan_to_num(np.load(cloud_path).astype(np.float32))
        label = np.load(label_path).astype(np.float32).reshape(-1)
        coord = raw[:, 0:3]
        data_dict = dict(coord=coord - coord.mean(axis=0), feat=raw[:, 3:], weight_label=label, name=name)
        return self.transform(data_dict)

    def __len__(self):
        return len(self.data_list) * self.loop
