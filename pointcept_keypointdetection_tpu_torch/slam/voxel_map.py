"""The fixed-capacity voxel point map: the counterpart of
``pointcept_keypointdetection_tpu/slam/voxel_map.py``.

One point per voxel of ``voxel_size`` from ``origin``, deduplicated by the
z-order code of the voxel: the map's points come before a scan's, so a
voxel keeps its oldest point, and past capacity the highest codes are
dropped.  All on the map's device, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..ops.codes import code_or_batch
from ..ops.serialization import z_order_encode
from ..ops.voxelize import slotted_unique
from .ordered import norm

_DEPTH = 16


class VoxelMap(NamedTuple):
    points: torch.Tensor  # [M, 3] world frame
    valid: torch.Tensor  # bool[M]
    origin: torch.Tensor  # [3] world coordinates of voxel (0, 0, 0)
    voxel_size: torch.Tensor  # f32 scalar

    @staticmethod
    def create(capacity: int, voxel_size: float, origin=(-500.0, -500.0, -100.0),
               device: Union[str, torch.device] = "cuda") -> "VoxelMap":
        return VoxelMap(points=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
                        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
                        origin=torch.tensor(origin, dtype=torch.float32, device=device),
                        voxel_size=torch.tensor(voxel_size, dtype=torch.float32, device=device))

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def insert(vmap: VoxelMap, new_points: torch.Tensor, new_valid: torch.Tensor, code_depth=None) -> VoxelMap:
    """Merge world-frame points, one per voxel, the map's first (`voxel_map.py:44-86`).

    Voxels outside [0, 2^16) of the origin are dropped.  ``code_depth``: a bound the caller keeps on the
    merged set's voxel span (span + 4 <= 2^code_depth); where 3 * code_depth <= 31 the voxels are rebased
    to the merged set's own smallest voxel and coded at that depth, and voxels beyond it are dropped, as
    in JAX: z order is not translation-invariant, so the rebase decides which voxels survive at
    capacity."""
    m = vmap.capacity
    all_points = torch.cat([vmap.points, new_points.float()])
    all_valid = torch.cat([vmap.valid, new_valid.bool()])
    grid = torch.floor((all_points - vmap.origin) / vmap.voxel_size).to(torch.int32)
    all_valid = all_valid & ((grid >= 0) & (grid < (1 << _DEPTH))).all(-1)
    grid = grid.clamp(0, (1 << _DEPTH) - 1)
    depth = _DEPTH
    if code_depth is not None and 3 * code_depth <= 31:
        depth = code_depth
        gmin = torch.where(all_valid[:, None], grid, torch.full_like(grid, 1 << _DEPTH)).min(0).values
        grid = grid - gmin
        all_valid = all_valid & ((grid >= 0) & (grid < (1 << depth))).all(-1)
        grid = grid.clamp(0, (1 << depth) - 1)
    batch = torch.zeros(all_points.shape[0], dtype=torch.int64, device=all_points.device)
    code = code_or_batch(z_order_encode(grid, depth), batch, depth)
    su = slotted_unique(code, all_valid, batch, 1, m)  # a stable sort: a voxel's first row heads it
    head = su.head_row.clamp(max=all_points.shape[0] - 1)
    points = torch.where(su.out_valid[:, None], all_points[head], torch.zeros((), device=all_points.device))
    return vmap._replace(points=points, valid=su.out_valid)


def prune(vmap: VoxelMap, center: torch.Tensor, radius: float) -> VoxelMap:
    """Drop the map points farther than ``radius`` from ``center`` (the sliding window)."""
    return vmap._replace(valid=vmap.valid & (norm(vmap.points - center) <= radius))
