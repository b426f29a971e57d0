"""Padded-slot collation: sample dicts -> fixed-shape batch arrays.

The port's copy of ``pointcept_keypointdetection_tpu/datasets/collate.py``,
cut to the single-view case of the predictors, the trainer and the tester
(no multi-view groups, no DINO side clouds).  Every per-point array is
padded, or subsampled, to exactly ``slot_size`` rows, and a ``valid`` mask
marks the real rows; a sample that already has its ``valid`` mask (a
padded test fragment) is kept as it is.  The subsample draws
``rng.choice(n, slot_size, replace=False)`` from the caller's ``rng``: the
trainer's loader passes the global ``np.random``, which the trainer seeds,
and so draws what the JAX copy draws (`collate.py:75`).

Mix3D (``mix_prob``, `collate.py:92-136`): with probability ``mix_prob``
(one ``rng.random()`` draw, made only where ``mix_prob`` > 0, as JAX's
``np.random.rand()``) and an even batch, each pair of samples (2i, 2i+1) is
padded to half a slot each and fused into slot 2i, and slot 2i+1 is left
empty (no valid row, segment -1).
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
    if "valid" in out:  # padded already
        if n != slot_size:
            raise ValueError(f"a padded sample of {n} rows does not fit slot_size={slot_size}")
        return out
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


def _mix3d(samples: List[Dict[str, np.ndarray]], slot_size: int, rng) -> List[Dict[str, np.ndarray]]:
    """Pairs of samples fused into one slot each, the slot after each pair empty."""
    half = slot_size // 2
    padded = [pad_sample(s, half, rng) for s in samples]
    fused = []
    for i in range(0, len(samples), 2):
        merged = {}
        for key in padded[i]:
            if (key == "valid" or key in PER_POINT_KEYS) and key in padded[i + 1]:
                merged[key] = np.concatenate([padded[i][key], padded[i + 1][key]], axis=0)
            else:
                merged[key] = padded[i][key]
        empty = {k: np.zeros_like(v) for k, v in merged.items()}
        empty["valid"] = np.zeros(slot_size, bool)
        if "segment" in empty:
            empty["segment"] = np.full_like(merged["segment"], -1)
        fused += [merged, empty]
    return fused


def collate(samples: List[Dict[str, np.ndarray]], slot_size: int, rng=None, mix_prob: float = 0.0
            ) -> Dict[str, np.ndarray]:
    """Collate sample dicts into one batch dict of [B*S, ...] arrays (Mix3D with ``mix_prob``)."""
    if mix_prob > 0 and rng.random() < mix_prob and len(samples) % 2 == 0:
        padded = _mix3d(samples, slot_size, rng)
    else:
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
