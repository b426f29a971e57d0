"""Host-side (numpy) transforms of the repo's offset-keypoint training config.

The port's copies of ``pointcept_keypointdetection_tpu/datasets/
transform.py:61-110, 383-523``: ``Compose``, ``Collect``, ``Update``,
``GridSample`` (train mode) and ``ShufflePoint``.  Their random draws come
from the global ``np.random`` stream, as in the JAX package, so the same
seed gives the same samples.  The other transforms are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..ops.serialization import z_order_encode_np
from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")

# keys indexed per point by index-based transforms (`transform.py:29-45`)
VALID_INDEX_KEYS = (
    "coord",
    "origin_coord",
    "color",
    "feat",
    "normal",
    "strength",
    "segment",
    "instance",
    "displacement",
    "grid_coord",
    "keypoint_offset",
    "keypoint_mask",
    "correspondence",
)


def index_operator(data_dict, index):
    for key in data_dict.get("index_valid_keys", VALID_INDEX_KEYS):
        if key in data_dict:
            data_dict[key] = data_dict[key][index]
    return data_dict


class Compose:
    def __init__(self, cfg=None):
        self.transforms = [TRANSFORMS.build(dict(t)) for t in (cfg or [])]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Select keys; concatenate ``feat_keys`` into 'feat'."""

    def __init__(self, keys, feat_keys=("coord",)):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.feat_keys = [feat_keys] if isinstance(feat_keys, str) else list(feat_keys)

    def __call__(self, data_dict):
        out = {key: data_dict[key] for key in self.keys}
        feats = [data_dict[k] for k in self.feat_keys]
        feats = [f.reshape(f.shape[0], -1) if f.ndim > 1 else f.reshape(-1, 1) for f in feats]
        out["feat"] = np.concatenate(feats, axis=1).astype(np.float32)
        return out


@TRANSFORMS.register_module()
class Update:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data_dict):
        data_dict.update(self.keys_dict)
        return data_dict


def _voxel_runs(grid_coord: np.ndarray):
    """(by_voxel, run_start, run_len): rows sorted voxel by voxel by their exact
    48-bit Morton key; voxel v owns sorted positions run_start[v] : +run_len[v]."""
    if grid_coord.max() >= 2**16:
        raise ValueError("scene exceeds the 16-bit voxel extent")
    key = z_order_encode_np(grid_coord, depth=16)
    by_voxel = np.argsort(key, kind="stable")
    _, run_len = np.unique(key[by_voxel], return_counts=True)
    run_start = np.concatenate([[0], np.cumsum(run_len[:-1])])
    return by_voxel, run_start, run_len


@TRANSFORMS.register_module()
class GridSample:
    """Voxel down-sampling, train mode: one uniformly random row per voxel,
    drawn as one ``np.random.randint`` vector modulo the run lengths; always
    returns ``grid_coord``, shifted to start at 0."""

    def __init__(self, grid_size=0.05, mode="train", return_grid_coord=True):
        if mode != "train" or not return_grid_coord:
            raise NotImplementedError("GridSample: only mode='train' with grid_coord is ported")
        self.grid_size = grid_size

    def __call__(self, data_dict):
        grid_coord = np.floor(data_dict["coord"] / self.grid_size).astype(np.int64)
        grid_coord = grid_coord - grid_coord.min(0)
        by_voxel, run_start, run_len = _voxel_runs(grid_coord)
        offsets = np.random.randint(0, run_len.max(), run_len.size) % run_len
        data_dict["grid_coord"] = grid_coord
        return index_operator(data_dict, by_voxel[run_start + offsets])


@TRANSFORMS.register_module()
class ShufflePoint:
    def __call__(self, data_dict):
        return index_operator(data_dict, np.random.permutation(data_dict["coord"].shape[0]))
