"""OA-CNNs: the omni-adaptive sparse CNN.

Counterpart of ``pointcept_keypointdetection_tpu/models/oacnns.py``: a k=3
``SubMConv`` stem, then per stage a stride-2 ``StridedConvDown`` into
``slotted_unique`` parents (from the second stage on), ``BasicBlock`` s over
the stage's own k=3 map and an ``AdaptiveAggregation``; per decoder level an
``InverseConvUp`` to the skip's rows, a norm, the skip concatenated and one
``BasicBlock`` (Cin = 2C, so its 1x1 projection skip).  The SpUNet pieces are
``models/sparse_unet.py``'s: every ``SubMConv`` is kernel B3 forward and for
the input gradient on the card and B4 for the weight gradient, over the
map's rulebook (one map and one rulebook per stage).

``AdaptiveAggregation`` (`oacnns.py:31-59`): branch 0 is a Dense of the
features; branch s (scales 2 and 4) is the mean of the features over each
voxel's parent at ``grid_coord >> shift`` (``slotted_unique`` at the level's
own slot, a ``segment_mean``), a Dense, and back to the children through a
zero pad row; a Dense gate over the features, softmaxed over the branches,
weighs them; then ``MaskedBatchNorm`` and ReLU.

Module names are the flax names (``stem``, ``stem_norm``, ``down{s}``,
``down{s}_norm``, ``enc{s}_block{i}``, ``oa{s}.{branch_id, branch_s0,
branch_s1, gate, norm}``, ``up{s}``, ``up{s}_norm``, ``dec{s}_block``,
``head``); inside a block ``conv1`` / ``conv2`` / ``proj`` are flax's
``SubMConv_0`` / ``SubMConv_1`` / ``Dense_0`` (``convert.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.codes import code_or_batch
from ..ops.segment import segment_mean
from ..ops.serialization import z_order_encode
from ..ops.sparse import KernelMap, SparseConvSpec, build_kernel_map, build_voxel_index
from ..ops.voxelize import slotted_unique
from .builder import MODELS
from .keypoint import PromotedDense
from .norm import MaskedBatchNorm
from .sparse_unet import BasicBlock, InverseConvUp, StridedConvDown, SubMConv
from .structure import PointBatch

_DEPTH = 16


def level_kernel_map(point: PointBatch) -> KernelMap:
    """A level's k=3 map over its own voxels."""
    batch = point.batch
    index = build_voxel_index(point.grid_coord, batch, point.valid, _DEPTH)
    return build_kernel_map(index, point.grid_coord, batch, point.valid, SparseConvSpec.cube(3), _DEPTH)


class AdaptiveAggregation(nn.Module):
    """Multi-scale context branches fused by a learned per-point gate."""

    def __init__(self, channels: int, scales: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.shifts = [(scale - 1).bit_length() for scale in scales if scale > 1]
        self.branch_id = PromotedDense(channels, channels)
        for si in range(len(self.shifts)):
            self.add_module(f"branch_s{si}", PromotedDense(channels, channels))
        self.gate = PromotedDense(channels, 1 + len(self.shifts))
        self.norm = MaskedBatchNorm(channels)

    def forward(self, point: PointBatch) -> torch.Tensor:
        batch, valid = point.batch, point.valid
        m = point.num_samples * point.slot_size
        branches = [self.branch_id(point.feat)]
        for si, shift in enumerate(self.shifts):
            code = code_or_batch(z_order_encode(point.grid_coord >> shift, _DEPTH), batch, _DEPTH)
            su = slotted_unique(code, valid, batch, point.num_samples, point.slot_size)
            pooled = getattr(self, f"branch_s{si}")(segment_mean(point.feat * valid[:, None], su.parent_row, m))
            pad = torch.cat([pooled, pooled.new_zeros((1, pooled.shape[1]))])
            branches.append(pad[su.parent_row.clamp(max=m)])
        gate = torch.softmax(self.gate(point.feat), -1)
        out = torch.einsum("nbc,nb->nc", torch.stack(branches, 1), gate)
        return F.relu(self.norm(out, valid))


@MODELS.register_module("OA-CNNs")
class OACNNs(nn.Module):
    """Per-point features [N, channels[0]] of the last decoder level (logits where ``num_classes`` > 0)."""

    def __init__(self, in_channels: int = 6, num_classes: int = 0, base_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 128), layers: Sequence[int] = (2, 2, 2, 2),
                 slot_divisors: Sequence[int] = (1, 2, 4, 8), bn_momentum: float = 0.01):
        super().__init__()
        self.channels, self.layers, self.slot_divisors = tuple(channels), tuple(layers), tuple(slot_divisors)
        self.stem = SubMConv(in_channels, base_channels, 3)
        self.stem_norm = MaskedBatchNorm(base_channels, momentum=bn_momentum)
        width = base_channels
        for s, c in enumerate(channels):
            if s > 0:
                self.add_module(f"down{s}", StridedConvDown(width, c))
                self.add_module(f"down{s}_norm", MaskedBatchNorm(c, momentum=bn_momentum))
            for i in range(layers[s]):
                self.add_module(f"enc{s}_block{i}", BasicBlock(width if i == 0 and s == 0 else c, c, bn_momentum))
            width = c
            self.add_module(f"oa{s}", AdaptiveAggregation(c))
        for s in reversed(range(len(channels) - 1)):
            self.add_module(f"up{s}", InverseConvUp(channels[s + 1], channels[s]))
            self.add_module(f"up{s}_norm", MaskedBatchNorm(channels[s], momentum=bn_momentum))
            self.add_module(f"dec{s}_block", BasicBlock(2 * channels[s], channels[s], bn_momentum))
        self.head = PromotedDense(channels[0], num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else channels[0]

    def _kernel_map(self, point: PointBatch) -> KernelMap:
        return level_kernel_map(point)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        slot0 = point.slot_size
        kmap = self._kernel_map(point)
        x = point.replace(feat=F.relu(self.stem_norm(self.stem(point.feat, kmap), point.valid)))
        skips, sus, kmaps = [], [], []
        for s in range(len(self.channels)):
            if s > 0:
                skips.append(x)
                x, su = getattr(self, f"down{s}")(x, max(slot0 // self.slot_divisors[s], 16))
                x = x.replace(feat=F.relu(getattr(self, f"down{s}_norm")(x.feat, x.valid)))
                sus.append(su)
                kmap = self._kernel_map(x)
            kmaps.append(kmap)
            for i in range(self.layers[s]):
                x = x.replace(feat=getattr(self, f"enc{s}_block{i}")(x.feat, x.valid, kmap))
            x = x.replace(feat=getattr(self, f"oa{s}")(x))
        for s in reversed(range(len(self.channels) - 1)):
            skip = skips[s]
            up = F.relu(getattr(self, f"up{s}_norm")(getattr(self, f"up{s}")(x.feat, skip, sus[s]), skip.valid))
            x = skip.replace(feat=torch.cat([up, skip.feat], -1))
            x = x.replace(feat=getattr(self, f"dec{s}_block")(x.feat, x.valid, kmaps[s]))
        return self.head(x.feat) if self.head is not None else x.feat
