"""Batch assembly: collated numpy dicts -> tensors on a device -> PointBatch.

Copies of ``build_point_batch`` (``pointcept_keypointdetection_tpu/engines/
common.py:12``) and ``sample_to_device`` (``engines/test.py:101``).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..models.structure import PointBatch


def sample_to_device(batch: Dict, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """Every numeric array of a collated batch as a tensor on ``device``."""
    out = {}
    for key, value in batch.items():
        if key in ("name", "num_samples") or isinstance(value, (list, str)):
            continue
        arr = np.asarray(value)
        if arr.dtype == object or arr.dtype.kind in "US":
            continue
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def build_point_batch(batch: Dict[str, torch.Tensor], num_samples: Optional[int] = None) -> PointBatch:
    return PointBatch(
        coord=batch["coord"],
        feat=batch["feat"],
        grid_coord=batch["grid_coord"].to(torch.int32),
        valid=batch["valid"],
        num_samples=num_samples if num_samples is not None else batch["num_samples"],
    )
