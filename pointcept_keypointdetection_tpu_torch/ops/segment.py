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


def _per_segment_mean(total: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ones = total.new_ones(segment_ids.shape)
    count = segment_sum(ones, segment_ids, num_segments).clamp_min(1)  # whole numbers: exact in any order
    return total / count.reshape((num_segments,) + (1,) * (total.dim() - 1))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return _per_segment_mean(segment_sum(data, segment_ids, num_segments), segment_ids, num_segments)


def segment_sum_in_order(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_sum`` with each segment's rows added one after the other, in row order, on both devices,
    as the CPU's ``index_add_`` (and JAX on the CPU) adds them: the card's ``index_add_`` adds with atomics,
    in an order that changes from run to run, and ``index_put_`` with ``accumulate`` (a stable sort by
    segment, then each segment's rows in turn) takes its place there; on the CPU ``index_put_`` splits the
    rows between threads."""
    rows, ids = _kept(data, segment_ids, num_segments)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    if data.is_cuda:
        return out.index_put_((ids,), rows, accumulate=True)
    return out.index_add_(0, ids, rows)


def segment_mean_in_order(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``segment_mean`` over ``segment_sum_in_order``: for sums that a discontinuity reads (Swin3D's
    positions, which its cRSE floors and its 3-NN up-sampling weighs by inverse squared distance)."""
    return _per_segment_mean(segment_sum_in_order(data, segment_ids, num_segments), segment_ids, num_segments)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment max, 0 for an empty segment (`segment.py:31-37`).

    As in JAX, the max starts from the dtype's minimum, which an empty
    segment keeps and the last step turns into 0.  The gradient is shared
    equally by the rows that tie for a segment's max, in JAX and here; a
    max of 0 over rows is not mistaken for the empty segment's initial
    value (torch's ``include_self=False`` would share the gradient with it)."""
    rows, ids = _kept(data, segment_ids, num_segments)
    info = torch.finfo(data.dtype) if data.is_floating_point() else torch.iinfo(data.dtype)
    init = data.new_full((num_segments,) + data.shape[1:], info.min)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(rows)
    out = init.scatter_reduce(0, index, rows, reduce="amax", include_self=True)
    return torch.where(out == info.min, torch.zeros((), dtype=out.dtype, device=out.device), out)


_REDUCERS = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}


def segment_reduce(data, segment_ids, num_segments: int, reduce: str = "sum"):
    return _REDUCERS[reduce](data, segment_ids, num_segments)
