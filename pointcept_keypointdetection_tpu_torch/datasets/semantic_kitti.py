"""SemanticKITTI scans: the port's copy of
``pointcept_keypointdetection_tpu/datasets/semantic_kitti.py`` (`:21-225`).

The layout is the raw KITTI one: ``<data_root>/dataset/sequences/<seq>/
velodyne/NNNNNN.bin`` (float32 [N, 4]: xyz, reflectance) beside
``labels/NNNNNN.label`` (uint32: the semantic id in the low 16 bits).  The
sequence splits, the 19-class learning map (ignore -1), its inverse and the
dynamic classes are the public semantic-kitti-api tables, copied here.

``SemanticKITTIDataset`` reads a split's scans (``coord``, ``strength``,
``segment``; -1 where a scan has no label file) and runs the config's
transforms; ``SemanticKITTIColorNormalDataset`` adds unit rays from the
sensor as normals and zero colours.  Test mode (fragments for the tester)
and ``SemanticKITTIImagePointDataset`` (camera frames for Concerto) are not
ported yet: test mode raises.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.logger import get_root_logger
from .builder import DATASETS
from .transform import Compose

SPLIT_SEQUENCES = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}

# raw id -> train id (0..18, ignore = -1)
LEARNING_MAP = {
    0: -1, 1: -1, 10: 0, 11: 1, 13: 4, 15: 2, 16: 4, 18: 3, 20: 4, 30: 5, 31: 6,
    32: 7, 40: 8, 44: 9, 48: 10, 49: 11, 50: 12, 51: 13, 52: -1, 60: 8, 70: 14,
    71: 15, 72: 16, 80: 17, 81: 18, 99: -1, 252: 0, 253: 6, 254: 5, 255: 7,
    256: 4, 257: 4, 258: 3, 259: 4,
}

# train id -> a canonical raw id (for submission writers)
LEARNING_MAP_INV = {
    -1: 0, 0: 10, 1: 11, 2: 15, 3: 18, 4: 20, 5: 30, 6: 31, 7: 32, 8: 40, 9: 44,
    10: 48, 11: 49, 12: 50, 13: 51, 14: 70, 15: 71, 16: 72, 17: 80, 18: 81,
}

# train ids of the movable classes (vehicles, persons, riders), which a SLAM front end drops
DYNAMIC_CLASSES = tuple(range(8))


def _build_lut(mapping, default=-1):
    lut = np.full(max(mapping) + 1, default, dtype=np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return lut


_LEARNING_LUT = _build_lut(LEARNING_MAP)


def read_scan(bin_path: str) -> np.ndarray:
    """A KITTI ``.bin`` scan: float32 [N, 4], xyz and reflectance."""
    return np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)


def read_label(label_path: str) -> np.ndarray:
    """A ``.label`` file's train ids: the semantic low 16 bits through the learning map."""
    raw = np.fromfile(label_path, dtype=np.uint32) & 0xFFFF
    return _LEARNING_LUT[np.minimum(raw, len(_LEARNING_LUT) - 1)]


def map_to_raw_labels(train_ids: np.ndarray) -> np.ndarray:
    """Train ids back to canonical raw ids (uint32); ignore (-1) reads as train id 0's."""
    lut = np.zeros(20, np.uint32)
    for k, v in LEARNING_MAP_INV.items():
        if k >= 0:
            lut[k] = v
    return lut[np.maximum(train_ids, 0)].astype(np.uint32)


@DATASETS.register_module()
class SemanticKITTIDataset:
    def __init__(self, split="train", data_root="data/semantic_kitti", transform=None, test_mode=False,
                 test_cfg=None, loop=1, ignore_index=-1):
        if test_mode:
            raise NotImplementedError("SemanticKITTIDataset: test mode is not ported yet")
        self.data_root = data_root
        self.split = split
        self.transform = Compose(transform)
        self.loop = loop
        self.data_list = self.get_data_list()
        get_root_logger().info("Totally %d x %d samples in %s set.", len(self.data_list), self.loop, split)

    def get_data_list(self):
        splits = [self.split] if isinstance(self.split, str) else self.split
        data_list = []
        for split in splits:
            for seq in SPLIT_SEQUENCES[split]:
                data_list += sorted(glob.glob(os.path.join(self.data_root, "dataset", "sequences", seq, "velodyne",
                                                           "*.bin")))
        return data_list

    def get_data(self, idx):
        bin_path = self.data_list[idx % len(self.data_list)]
        scan = read_scan(bin_path)
        coord = scan[:, :3]
        strength = scan[:, 3:4]
        label_path = bin_path.replace("velodyne", "labels").replace(".bin", ".label")
        if os.path.exists(label_path):
            segment = read_label(label_path).astype(np.int32)
        else:
            segment = np.full(coord.shape[0], -1, np.int32)
        return dict(coord=coord, strength=strength, segment=segment, name=self.get_data_name(idx))

    def get_data_name(self, idx):
        path = self.data_list[idx % len(self.data_list)]
        seq = os.path.basename(os.path.dirname(os.path.dirname(path)))
        frame = os.path.splitext(os.path.basename(path))[0]
        return f"{seq}_{frame}"

    def __getitem__(self, idx):
        return self.transform(self.get_data(idx))

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class SemanticKITTIColorNormalDataset(SemanticKITTIDataset):
    """SemanticKITTI with the unit ray from the sensor as each point's normal and zero colours."""

    @staticmethod
    def estimate_normals(points, center=np.array([0.0, 0.0, 0.0])):
        normals = points - center[None, :]
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        return normals / np.maximum(norms, 1e-9)

    def get_data(self, idx):
        data_dict = super().get_data(idx)
        coord = data_dict["coord"]
        data_dict["normal"] = self.estimate_normals(coord).astype(np.float32)
        data_dict["color"] = np.zeros_like(coord)
        return data_dict
