"""SPVCNN: the sparse point-voxel CNN.

Counterpart of ``pointcept_keypointdetection_tpu/models/spvcnn.py``
(`:42-205`): a point branch (a Dense stem, then a ``PointTransform`` MLP at
each fusion site) beside a voxel U-Net of SpUNet's pieces
(``models/sparse_unet.py``), the two exchanging features at three sites:
the bottleneck, the middle of the decoder and full resolution.

* ``voxel_to_point_trilinear`` (`:53-86`) devoxelizes a stage's features
  onto the points: the 8 stage voxels around each point's continuous
  position, found by a kernel map of the 8 corner offsets, weighed
  trilinearly, the weights of missing corners renormalized away.
* ``point_to_voxel`` (`:89-106`) averages the points' features into the
  stage voxel that holds each.
* ``_continuous_grid`` (`:42-50`) measures the points' positions in voxel
  units from a per-sample anchor, the mean of coord - voxel_size *
  grid_coord over the sample's slot.  The trilinear corners floor those
  positions, so the anchor's sum is taken in row order on either device
  (``segment_mean_in_order``): the card's atomic sum could round it to the
  other side of a floor.

On the card every ``SubMConv`` (the voxel stem and the ``BasicBlock`` s) is
kernel B3 forward and for the input gradient and B4 for the weight
gradient, one rulebook per stage's K = 27 map.  Module names are the flax
names (``point_stem``, ``point_stem_norm``, ``voxel_stem``,
``voxel_stem_norm``, ``down{s}``, ``down{s}_norm``, ``enc{s}_block{i}``,
``point_tf{0,1,2}.{fc, norm}``, ``up{s}``, ``up{s}_norm``, ``dec{s}_block``,
``head``); in a block ``conv1`` / ``conv2`` / ``proj`` are flax's
``SubMConv_0`` / ``SubMConv_1`` / ``Dense_0`` (``convert.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.segment import segment_mean, segment_mean_in_order
from ..ops.sparse import SparseConvSpec, build_kernel_map, build_voxel_index
from .builder import MODELS
from .norm import MaskedBatchNorm
from .sparse_unet import BasicBlock, InverseConvUp, StridedConvDown, SubMConv, _dense, kernel_map
from .structure import PointBatch

_DEPTH = 16
CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))


def _continuous_grid(point: PointBatch, voxel_size: float) -> torch.Tensor:
    """Each point's continuous position in full-resolution voxel units, ~grid_coord + frac + 0.5."""
    resid = point.coord - voxel_size * point.grid_coord.float()
    resid = torch.where(point.valid[:, None], resid, torch.zeros((), device=resid.device))
    anchor = segment_mean_in_order(resid, point.batch, point.num_samples)  # [B, 3]: each sample's grid origin
    return (point.coord - anchor[point.batch]) / voxel_size + 0.5  # voxel v covers [v, v + 1)


def voxel_to_point_trilinear(stage: PointBatch, point: PointBatch, cont: torch.Tensor, stride: int) -> torch.Tensor:
    """The stage's features at each point, trilinear over the 8 stage voxels around it."""
    n, m = point.num_points, stage.num_points
    if n < m:  # the map marks a missing corner with the query count
        raise ValueError(f"a stage of {m} rows above the points' {n}")
    q = cont / float(stride)
    base = torch.floor(q - 0.5)
    frac = q - 0.5 - base  # [N, 3] in [0, 1)
    sbatch = stage.batch
    index = build_voxel_index(stage.grid_coord, sbatch, stage.valid, _DEPTH)
    kmap = build_kernel_map(index, base.to(torch.int32), point.batch, point.valid, SparseConvSpec(offsets=CORNERS),
                            _DEPTH)
    nbr = kmap.neighbor_idx.to(torch.int64)
    feat_pad = torch.cat([stage.feat, stage.feat.new_zeros((1, stage.feat.shape[-1]))])
    # an embedding lookup, the gather's values: its backward sorts the rows and sums each once, where
    # autograd's index backward adds with atomics that serialize on the zero row (every missing corner's
    # and pad point's, ~60% of a scan's 8 N corners)
    gathered = F.embedding(nbr.clamp(max=m), feat_pad)  # [N, 8, C]
    offs = torch.tensor(CORNERS, dtype=torch.float32, device=cont.device)  # [8, 3]
    w = torch.prod(offs[None] * frac[:, None, :] + (1.0 - offs[None]) * (1.0 - frac[:, None, :]), dim=-1)  # [N, 8]
    w = torch.where(nbr < m, w, torch.zeros((), device=w.device))
    w = w / w.sum(1, keepdim=True).clamp_min(1e-8)
    return torch.einsum("nkc,nk->nc", gathered.float(), w).to(stage.feat.dtype)


def point_to_voxel(stage: PointBatch, point: PointBatch, pfeat: torch.Tensor, stride_log2: int) -> torch.Tensor:
    """The mean of the points' features in each stage voxel (0 where none)."""
    n, m = point.num_points, stage.num_points
    index = build_voxel_index(stage.grid_coord, stage.batch, stage.valid, _DEPTH)
    kmap = build_kernel_map(index, point.grid_coord >> stride_log2, point.batch, point.valid,
                            SparseConvSpec(offsets=((0, 0, 0),)), _DEPTH)
    rows = torch.where(point.valid, kmap.neighbor_idx[:, 0].to(torch.int64), n)
    w = point.valid.to(pfeat.dtype)
    pooled = segment_mean(pfeat * w[:, None], rows.clamp(max=m), m + 1)[:m]
    return pooled.to(pfeat.dtype)


class PointTransform(nn.Module):
    """The point branch's Dense + BN + ReLU (`spvcnn.py:109-121`)."""

    def __init__(self, in_channels: int, features: int, bn_momentum: float = 0.01):
        super().__init__()
        self.fc = nn.Linear(in_channels, features)
        self.norm = MaskedBatchNorm(features, momentum=bn_momentum)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(_dense(x, self.fc), valid))


@MODELS.register_module("SPVCNN")
class SPVCNN(nn.Module):
    """SPVCNN over a ``PointBatch``: per-point logits [N, num_classes] (the fused full-resolution features
    where ``num_classes`` is 0), in the input's rows.  ``voxel_size`` must be the pipeline's GridSample
    grid."""

    def __init__(self, in_channels: int = 4, num_classes: int = 0, base_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 96), layers: Sequence[int] = (2, 2, 2, 2),
                 slot_divisors: Sequence[int] = (1, 2, 4, 8), bn_momentum: float = 0.01, voxel_size: float = 0.05):
        super().__init__()
        self.channels, self.layers = tuple(channels), tuple(layers)
        self.slot_divisors, self.voxel_size = tuple(slot_divisors), voxel_size
        stages, c0 = len(self.channels), base_channels
        self.point_stem = nn.Linear(in_channels, c0)
        self.point_stem_norm = MaskedBatchNorm(c0, momentum=bn_momentum)
        self.voxel_stem = SubMConv(c0, c0, 3)
        self.voxel_stem_norm = MaskedBatchNorm(c0, momentum=bn_momentum)
        width, skip_widths = c0, []
        for s in range(stages):
            if s > 0:
                skip_widths.append(width)
                self.add_module(f"down{s}", StridedConvDown(width, self.channels[s]))
                self.add_module(f"down{s}_norm", MaskedBatchNorm(self.channels[s], momentum=bn_momentum))
                width = self.channels[s]
            for i in range(self.layers[s]):
                self.add_module(f"enc{s}_block{i}", BasicBlock(width, self.channels[s], bn_momentum))
                width = self.channels[s]
        self.point_tf0 = PointTransform(c0, self.channels[-1], bn_momentum)
        self.mid = max((stages - 1) // 2, 0)  # the decoder level of the second fusion
        z_width = self.channels[-1]
        for s in reversed(range(stages - 1)):
            self.add_module(f"up{s}", InverseConvUp(width, self.channels[s]))
            self.add_module(f"up{s}_norm", MaskedBatchNorm(self.channels[s], momentum=bn_momentum))
            self.add_module(f"dec{s}_block", BasicBlock(self.channels[s] + skip_widths[s], self.channels[s],
                                                        bn_momentum))
            width = self.channels[s]
            if s == self.mid and s > 0:
                self.point_tf1 = PointTransform(z_width, self.channels[s], bn_momentum)
                z_width = self.channels[s]
        self.point_tf2 = PointTransform(z_width, self.channels[0], bn_momentum)
        self.head = nn.Linear(self.channels[0], num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else self.channels[0]

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        stages, valid = len(self.channels), point.valid
        cont = _continuous_grid(point, self.voxel_size)
        z0 = F.relu(self.point_stem_norm(_dense(point.feat, self.point_stem), valid))
        kmaps = [kernel_map(point)]  # the points are voxel-unique: the stem's map is stage 0's
        x = point.replace(feat=F.relu(self.voxel_stem_norm(self.voxel_stem(z0, kmaps[0]), valid)))
        skips, sus = [], []
        for s in range(stages):
            if s > 0:
                skips.append(x)
                cap = max(point.slot_size // self.slot_divisors[s], 16)
                x, su = getattr(self, f"down{s}")(x, cap)
                x = x.replace(feat=F.relu(getattr(self, f"down{s}_norm")(x.feat, x.valid)))
                sus.append(su)
                kmaps.append(kernel_map(x))
            for i in range(self.layers[s]):
                x = x.replace(feat=getattr(self, f"enc{s}_block{i}")(x.feat, x.valid, kmaps[s]))
        bottom = stages - 1
        z = voxel_to_point_trilinear(x, point, cont, 1 << bottom) + self.point_tf0(z0, valid)
        x = x.replace(feat=point_to_voxel(x, point, z, bottom))
        for s in reversed(range(stages - 1)):
            skip = skips[s]
            up = getattr(self, f"up{s}")(x.feat, skip, sus[s])
            up = F.relu(getattr(self, f"up{s}_norm")(up, skip.valid))
            x = skip.replace(feat=torch.cat([up, skip.feat], -1))
            x = x.replace(feat=getattr(self, f"dec{s}_block")(x.feat, x.valid, kmaps[s]))
            if s == self.mid and s > 0:
                z = voxel_to_point_trilinear(x, point, cont, 1 << s) + self.point_tf1(z, valid)
                x = x.replace(feat=point_to_voxel(x, point, z, s))
        out = x.feat + self.point_tf2(z, valid)
        return _dense(out, self.head) if self.head is not None else out
