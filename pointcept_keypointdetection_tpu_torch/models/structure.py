"""PointBatch: fixed per-sample slots of points, as a dataclass of tensors.

Counterpart of ``pointcept_keypointdetection_tpu/models/structure.py``.  A
batch is ``num_samples`` slots of exactly ``S`` rows each, stored flat as
``[B*S]``; validity is an explicit mask.  Serialization keeps slots: the sort
key is ``batch << 3*depth | code`` with an invalid row's spatial bits set to
all ones, so each order is a permutation inside the slots with the pads last
in their own slot, and attention patches never straddle samples.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.codes import check_code_bits
from ..ops.serialization import ORDERS, encode


def fill_invalid_keep_batch(code: torch.Tensor, valid: torch.Tensor, depth: int) -> torch.Tensor:
    """Set the low ``3*depth`` bits of invalid entries to ones, keeping the batch
    prefix, so pads sort to the end of their own slot (`structure.py:37-50`)."""
    return torch.where(valid, code, code | ((1 << (3 * depth)) - 1))


@dataclasses.dataclass
class PointBatch:
    coord: torch.Tensor  # f32[N, 3] metric coordinates
    feat: torch.Tensor  # [N, C]
    grid_coord: torch.Tensor  # int[N, 3] voxel coordinates, >= 0 per sample
    valid: torch.Tensor  # bool[N]
    num_samples: int
    serialized_order: Optional[torch.Tensor] = None  # int64[O, N]: sorted position -> row
    serialized_inverse: Optional[torch.Tensor] = None  # int64[O, N]: row -> sorted position

    @property
    def num_points(self) -> int:
        return self.coord.shape[0]

    @property
    def slot_size(self) -> int:
        return self.num_points // self.num_samples

    @property
    def batch(self) -> torch.Tensor:
        """int64[N] sample index of each row (implied by the slot layout)."""
        return torch.arange(self.num_points, device=self.coord.device) // self.slot_size

    def replace(self, **changes) -> "PointBatch":
        return dataclasses.replace(self, **changes)

    def serialize(self, orders=ORDERS, depth: int = 16, generator: Optional[torch.Generator] = None) -> "PointBatch":
        """Stable sort by each order's code (`structure.py:94-135`).

        ``generator``: permute the order list with one draw from it (the
        reference's ``shuffle_orders``); None keeps the given order."""
        check_code_bits(depth, self.num_samples)
        batch = self.batch
        iota = torch.arange(self.num_points, device=self.coord.device)
        perms, inverses = [], []
        for name in orders:
            code = fill_invalid_keep_batch(encode(self.grid_coord, batch, depth, name), self.valid, depth)
            perm = torch.sort(code, stable=True).indices
            inv = torch.empty_like(perm)
            inv[perm] = iota
            perms.append(perm)
            inverses.append(inv)
        if generator is not None and len(orders) > 1:
            # permuted on the host: the draw never goes to the card, so the host does not wait for it
            shuffle = torch.randperm(len(orders), generator=generator).tolist()
            perms, inverses = [perms[i] for i in shuffle], [inverses[i] for i in shuffle]
        return self.replace(serialized_order=torch.stack(perms), serialized_inverse=torch.stack(inverses))
