"""Padded-slot collation: sample dicts -> fixed-shape batch arrays.

The port's copy of ``pointcept_keypointdetection_tpu/datasets/collate.py``,
cut to the single-view case of the predictor and the trainer (no multi-view
groups, no Mix3D).  Every per-point array is padded, or subsampled, to
exactly ``slot_size`` rows, and a ``valid`` mask marks the real rows.  The
subsample draws ``rng.choice(n, slot_size, replace=False)`` from the caller's
``rng``: the trainer's loader passes the global ``np.random``, which the
trainer seeds, and so draws what the JAX copy draws (`collate.py:75`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PER_POINT_KEYS = (
    "coord",
    "origin_coord",
    "grid_coord",
    "feat",
    "segment",
    "instance",
    "displacement",
    "keypoint_offset",
    "keypoint_mask",
    "instance_centroid",
    "inverse",
    "index",
)

_PAD_VALUES = {"segment": -1, "instance": -1}


def pad_sample(sample: Dict[str, np.ndarray], slot_size: int, rng=None) -> Dict[str, np.ndarray]:
    """Pad, or subsample with ``rng`` (a ``np.random.Generator`` or the
    ``np.random`` module), every per-point array to ``slot_size`` rows."""
    out = dict(sample)
    keys = [k for k in out if k in PER_POINT_KEYS]
    n = out["coord"].shape[0]
    if n > slot_size:
        if rng is None:
            raise ValueError(f"{n} points exceed slot_size={slot_size}: pass rng to subsample")
        idx = rng.choice(n, slot_size, replace=False)
        for key in keys:
            out[key] = out[key][idx]
        n = slot_size
    valid = np.zeros(slot_size, bool)
    valid[:n] = True
    for key in keys:
        arr = out[key]
        pad_width = [(0, slot_size - n)] + [(0, 0)] * (arr.ndim - 1)
        out[key] = np.pad(arr, pad_width, constant_values=_PAD_VALUES.get(key, 0))
    out["valid"] = valid
    return out


def collate(samples: List[Dict[str, np.ndarray]], slot_size: int, rng=None) -> Dict[str, np.ndarray]:
    """Collate sample dicts into one batch dict of [B*S, ...] arrays."""
    padded = [pad_sample(s, slot_size, rng) for s in samples]
    batch: Dict[str, np.ndarray] = {}
    for key in padded[0]:
        arrs = [p[key] for p in padded]
        if key == "valid" or key in PER_POINT_KEYS:
            batch[key] = np.concatenate(arrs, axis=0)
        else:
            batch[key] = np.stack(arrs, axis=0)
    for key, dtype in (("grid_coord", np.int32), ("segment", np.int32), ("instance", np.int32),
                       ("coord", np.float32), ("feat", np.float32)):
        if key in batch:
            batch[key] = batch[key].astype(dtype)
    batch["num_samples"] = len(samples)
    return batch
