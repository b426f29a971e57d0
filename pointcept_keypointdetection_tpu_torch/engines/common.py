"""Batch assembly: collated numpy dicts -> tensors on a device -> PointBatch,
and the predictors' model loading.

Copies of ``build_point_batch`` (``pointcept_keypointdetection_tpu/engines/
common.py:12``) and ``sample_to_device`` (``engines/test.py:101``).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..models import build_model, init_weights
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


def build_eval_model(model_cfg: Dict, state_dict: Optional[Dict[str, torch.Tensor]],
                     device: Union[str, torch.device], generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """The model of ``model_cfg`` in eval mode on ``device``, with ``state_dict`` (the port's
    layout, see ``convert.py``) or, without it, weights seeded from ``generator`` (seed 0 by
    default).  A CUDA device raises where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{model_cfg.get('type')}: device is cuda but no CUDA device is available")
    model = build_model(dict(model_cfg))
    if state_dict is None:
        init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    return model.to(device).eval()
