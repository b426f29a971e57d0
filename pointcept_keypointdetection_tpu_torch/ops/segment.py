"""Segmented reductions with a fixed segment count.

Counterparts of ``pointcept_keypointdetection_tpu/ops/segment.py``: ids
outside ``[0, num_segments)`` (the sentinel of invalid rows) are dropped, and
an empty segment gives 0, never the dtype's minimum (`segment.py:31-37`) —
pooled pad rows rely on that.
"""

from __future__ import annotations

import torch


def _kept(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    return data[keep], segment_ids[keep].to(torch.int64)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    rows, ids = _kept(data, segment_ids, num_segments)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, ids, rows)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    ones = data.new_ones((data.shape[0],))
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1)
    return total / count.reshape((num_segments,) + (1,) * (data.dim() - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    rows, ids = _kept(data, segment_ids, num_segments)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(rows)
    # include_self=False: a segment with rows takes their max; an empty one keeps 0
    return out.scatter_reduce_(0, index, rows, reduce="amax", include_self=False)


_REDUCERS = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}


def segment_reduce(data, segment_ids, num_segments: int, reduce: str = "sum"):
    return _REDUCERS[reduce](data, segment_ids, num_segments)
