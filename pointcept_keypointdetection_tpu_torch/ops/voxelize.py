"""Unique voxels compacted into fixed per-sample slots.

Counterpart of ``slotted_unique`` in ``pointcept_keypointdetection_tpu/ops/
voxelize.py:63-132``, the engine under SerializedPooling.  The same integer
outputs: uniques of sample ``b`` land at rows ``[b*slot_capacity, ...)`` in
ascending code order, and a sample's uniques beyond its capacity (the
highest codes) are dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .codes import code_fill_invalid


class SlottedUniqueResult(NamedTuple):
    parent_row: torch.Tensor  # int64[N]: output row of the point's voxel; B*S_out if dropped/invalid
    head_row: torch.Tensor  # int64[B*S_out]: input row of the segment head; N if the slot is empty
    out_valid: torch.Tensor  # bool[B*S_out]
    counts: torch.Tensor  # int64[B*S_out]: input points per unique voxel
    num_unique: torch.Tensor  # int64 scalar, overflow included


def slotted_unique(
    code: torch.Tensor,
    valid: torch.Tensor,
    batch: torch.Tensor,
    num_samples: int,
    slot_capacity: int,
    precomputed_perm: Optional[torch.Tensor] = None,
) -> SlottedUniqueResult:
    """Unique batch-prefixed codes, compacted into ``num_samples`` slots.

    ``precomputed_perm``: a batch-major argsort of a refinement of the codes
    (the serialization's z order when ``code`` is the coarsened ``grid >> k``);
    it fixes which fine row heads each voxel, exactly as in the JAX package.
    """
    n = code.shape[0]
    dev = code.device
    filled = code_fill_invalid(code, valid)
    if precomputed_perm is None:
        perm = torch.sort(filled, stable=True).indices
    else:
        perm = precomputed_perm.to(torch.int64)
    sorted_code = filled[perm]
    sorted_valid = valid[perm]

    prev = torch.cat([sorted_code[:1] ^ 1, sorted_code[:-1]])
    is_head = sorted_valid & (sorted_code != prev)
    seg = torch.cumsum(is_head.to(torch.int64), 0) - 1
    num_unique = seg[-1] + 1 if n > 0 else torch.zeros((), dtype=torch.int64, device=dev)
    seg = torch.where(sorted_valid & (seg >= 0), seg, torch.full_like(seg, n))

    positions = torch.arange(n, device=dev)
    head_index = torch.full((n,), n, dtype=torch.int64, device=dev)
    head_index[seg[is_head]] = positions[is_head]  # global unique -> its first sorted position

    m = num_samples * slot_capacity
    has_head = head_index < n
    head_input_row = perm[head_index.clamp(max=n - 1)]
    head_batch = torch.where(has_head, batch.to(torch.int64)[head_input_row], torch.full_like(head_index, num_samples))
    gids = torch.arange(n, device=dev)
    base = torch.full((num_samples,), n, dtype=torch.int64, device=dev)
    base.scatter_reduce_(0, head_batch[has_head], gids[has_head], reduce="amin")
    rank = gids - base[head_batch.clamp(max=num_samples - 1)]
    slot_ok = has_head & (rank >= 0) & (rank < slot_capacity)
    out_row_of_unique = torch.where(slot_ok, head_batch * slot_capacity + rank, torch.full_like(rank, m))

    parent_sorted = torch.where(seg < n, out_row_of_unique[seg.clamp(max=n - 1)], torch.full_like(seg, m))
    parent_row = torch.empty_like(parent_sorted)
    parent_row[perm] = parent_sorted

    head_row = torch.full((m,), n, dtype=torch.int64, device=dev)
    head_row[out_row_of_unique[slot_ok]] = head_input_row[slot_ok]
    out_valid = head_row < n
    kept = valid & (parent_row < m)
    counts = torch.zeros((m,), dtype=torch.int64, device=dev)
    counts.index_add_(0, parent_row[kept], torch.ones_like(parent_row[kept]))
    return SlottedUniqueResult(parent_row, head_row, out_valid, counts, num_unique)
