"""SpUNet-v1m1: the submanifold sparse-conv U-Net.

Counterpart of ``pointcept_keypointdetection_tpu/models/sparse_unet.py:36-260``:
a stem ``SubMConv`` (k = ``stem_kernel``, 5 by default: 125 offsets) over
its own map, then per encoder stage a stride-2 ``StridedConvDown`` into
``slotted_unique`` parents at ``slot // slot_divisors[s]`` rows per sample,
a norm and ``BasicBlock`` residuals over a fresh k=3 map; per decoder stage
an ``InverseConvUp`` back to the skip's rows, a norm, the skip concatenated
and ``BasicBlock``s over the skip's map; a linear head.

Every ``SubMConv`` is ``ops.sparse.sparse_conv``: on the card kernel B3
forward and for the input gradient, B4 for the weight gradient, over the
map's rulebook, built once per map (the stem's k=5 map one, the k=3 maps one
per level).  The 8 masked products of the strided and inverse convs are
plain ``torch.matmul``, as JAX leaves them to XLA outside any Pallas kernel.

Module names follow flax's call order, so ``convert.py`` maps a JAX
checkpoint name by name: ``stem`` is ``SubMConv_0``, ``norms[i]`` is
``MaskedBatchNorm_i`` (the stem's, then one per encoder stage, then one per
decoder stage), ``downs[s]`` / ``ups[j]`` are ``StridedConvDown_s`` /
``InverseConvUp_j``, ``blocks[i]`` is ``BasicBlock_i`` (the encoder's, then
the decoder's, as they run), ``head`` is ``Dense_0``.  Inside a block,
``conv1`` / ``conv2`` are ``SubMConv_0`` / ``SubMConv_1`` and ``proj`` is
``Dense_0``.

Not ported: PDNorm (``pdnorm_conditions`` > 0, SpUNet-v1m3's wiring) raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.codes import code_or_batch
from ..ops.segment import segment_mean, segment_sum
from ..ops.serialization import z_order_encode
from ..ops.sparse import KernelMap, SparseConvSpec, build_kernel_map, build_voxel_index, sparse_conv
from ..ops.voxelize import SlottedUniqueResult, slotted_unique
from .builder import MODELS
from .norm import MaskedBatchNorm
from .structure import PointBatch

_DEPTH = 16  # bits per axis in voxel codes


def kernel_map(point: PointBatch, kernel_size: int = 3) -> KernelMap:
    """A level's k^3 map over its own voxels (MinkUNet's, SPVCNN's and OA-CNNs' levels)."""
    batch = point.batch
    index = build_voxel_index(point.grid_coord, batch, point.valid, _DEPTH)
    return build_kernel_map(index, point.grid_coord, batch, point.valid, SparseConvSpec.cube(kernel_size), _DEPTH)


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense`` without a dtype: computed in the promoted dtype of the input and the parameters."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class SubMConv(nn.Module):
    """Submanifold sparse conv over a precomputed kernel map; weight [K, Cin, Cout] and, with ``bias``
    (JAX's ``use_bias``, OctFormer's CPE), a bias [Cout] added after the conv (`sparse_unet.py:55-68`)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, bias: bool = False):
        super().__init__()
        k = len(SparseConvSpec.cube(kernel_size).offsets)
        self.weight = nn.Parameter(torch.zeros(k, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, feat: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
        return sparse_conv(feat, kmap, self.weight, self.bias)


class BasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN plus the skip (a bias-free 1x1 ``Dense`` + BN where the widths
    differ), then ReLU (`sparse_unet.py:65-90`)."""

    def __init__(self, in_channels: int, features: int, bn_momentum: float = 0.01):
        super().__init__()
        self.conv1 = SubMConv(in_channels, features, 3)
        self.norm1 = MaskedBatchNorm(features, momentum=bn_momentum)
        self.conv2 = SubMConv(features, features, 3)
        self.norm2 = MaskedBatchNorm(features, momentum=bn_momentum)
        if in_channels != features:
            self.proj = nn.Linear(in_channels, features, bias=False)
            self.norm_proj = MaskedBatchNorm(features, momentum=bn_momentum)

    def forward(self, feat: torch.Tensor, valid: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
        out = F.relu(self.norm1(self.conv1(feat, kmap), valid))
        out = self.norm2(self.conv2(out, kmap), valid)
        identity = feat
        if hasattr(self, "proj"):
            identity = self.norm_proj(_dense(feat, self.proj), valid)
        return F.relu(out + identity)


def child_offset_id(grid_coord: torch.Tensor) -> torch.Tensor:
    """Which of the 8 octants a voxel occupies inside its stride-2 parent (`sparse_unet.py:93-96`)."""
    bits = grid_coord & 1
    return (bits[:, 0] << 2) | (bits[:, 1] << 1) | bits[:, 2]


def _octant_products(feat: torch.Tensor, weight: torch.Tensor, off: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """sum_k where(off == k & valid, feat @ W[k], 0) in f32: JAX's 8 masked dense products."""
    out = feat.new_zeros((feat.shape[0], weight.shape[2]), dtype=torch.float32)
    x = feat.float()
    for k in range(8):
        sel = ((off == k) & valid)[:, None]
        out = out + torch.where(sel, x @ weight[k].float(), torch.zeros((), device=feat.device))
    return out


class StridedConvDown(nn.Module):
    """SparseConv3d(kernel 2, stride 2): each valid child's product with its octant's W, summed into
    its parent voxel, the parents compacted by ``slotted_unique`` (`sparse_unet.py:99-138`)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(8, in_channels, features))

    def forward(self, point: PointBatch, slot_capacity: int) -> Tuple[PointBatch, SlottedUniqueResult]:
        n = point.num_points
        parent_grid = point.grid_coord >> 1
        batch = point.batch
        code = code_or_batch(z_order_encode(parent_grid, _DEPTH), batch, _DEPTH)
        su = slotted_unique(code, point.valid, batch, point.num_samples, slot_capacity)
        m = point.num_samples * slot_capacity
        transformed = _octant_products(point.feat, self.weight, child_offset_id(point.grid_coord), point.valid)
        out_feat = segment_sum(transformed, su.parent_row, m).to(point.feat.dtype)
        out_coord = segment_mean(point.coord * point.valid[:, None], su.parent_row, m)
        head = su.head_row.clamp(max=n - 1)
        out_grid = torch.where(su.out_valid[:, None], parent_grid[head], torch.zeros_like(parent_grid[head]))
        pooled = PointBatch(coord=out_coord, feat=out_feat, grid_coord=out_grid, valid=su.out_valid,
                            num_samples=point.num_samples)
        return pooled, su


class InverseConvUp(nn.Module):
    """SparseInverseConv3d(kernel 2): each valid child takes its parent's features times its octant's
    W; a child whose parent was dropped reads the zero row M (`sparse_unet.py:141-163`)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(8, in_channels, features))

    def forward(self, parent_feat: torch.Tensor, child: PointBatch, su: SlottedUniqueResult) -> torch.Tensor:
        m, cin = parent_feat.shape
        parent_pad = torch.cat([parent_feat, parent_feat.new_zeros((1, cin))])
        gathered = parent_pad[su.parent_row.clamp(max=m)]
        out = _octant_products(gathered, self.weight, child_offset_id(child.grid_coord), child.valid)
        return out.to(parent_feat.dtype)


@MODELS.register_module("SpUNet-v1m1")
@MODELS.register_module("SpUNet-v1m2")  # the BN-momentum variant: pass bn_momentum
@MODELS.register_module("SpUNet-v1m3")  # the PDNorm variant: raises with pdnorm_conditions > 0
class SpUNet(nn.Module):
    """MinkUNet-topology sparse U-Net over a ``PointBatch``: per-point logits [N, num_classes] (the
    decoder's features where ``num_classes`` is 0), in the input's rows."""

    def __init__(self, in_channels: int, num_classes: int, base_channels: int = 32,
                 channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2), stem_kernel: int = 5, bn_momentum: float = 0.01,
                 slot_divisors: Sequence[int] = (1, 2, 4, 8), pdnorm_conditions: int = 0):
        super().__init__()
        if pdnorm_conditions:
            raise NotImplementedError("SpUNet: PDNorm (pdnorm_conditions > 0, SpUNet-v1m3) is not ported yet")
        if len(layers) % 2 or len(layers) != len(channels):
            raise ValueError(f"SpUNet: layers {layers} and channels {channels} must be one even length")
        self.layers, self.channels = tuple(layers), tuple(channels)
        self.stem_kernel, self.slot_divisors = stem_kernel, tuple(slot_divisors)
        stages = len(layers) // 2
        self.stem = SubMConv(in_channels, base_channels, stem_kernel)
        widths = [base_channels]  # the skip widths, level by level
        norm_widths, downs, ups, blocks = [base_channels], [], [], []
        width = base_channels
        for s in range(stages):
            downs.append(StridedConvDown(width, channels[s]))
            norm_widths.append(channels[s])
            width = channels[s]
            for _ in range(layers[s]):
                blocks.append(BasicBlock(width, width, bn_momentum))
            widths.append(width)
        for j, s in enumerate(reversed(range(stages))):
            dec = channels[len(channels) - s - 2]
            ups.append(InverseConvUp(width, dec))
            norm_widths.append(dec)
            width = dec + widths[s]
            for _ in range(layers[len(channels) - s - 1]):
                blocks.append(BasicBlock(width, dec, bn_momentum))
                width = dec
        self.norms = nn.ModuleList(MaskedBatchNorm(c, momentum=bn_momentum) for c in norm_widths)
        self.downs, self.ups, self.blocks = nn.ModuleList(downs), nn.ModuleList(ups), nn.ModuleList(blocks)
        self.head = nn.Linear(width, num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else width

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        stages = len(self.layers) // 2
        batch, valid, grid = point.batch, point.valid, point.grid_coord
        index0 = build_voxel_index(grid, batch, valid, _DEPTH)
        kmap_stem = build_kernel_map(index0, grid, batch, valid, SparseConvSpec.cube(self.stem_kernel), _DEPTH)
        kmap0 = kmap_stem if self.stem_kernel == 3 else build_kernel_map(
            index0, grid, batch, valid, SparseConvSpec.cube(3), _DEPTH)
        feat = F.relu(self.norms[0](self.stem(point.feat, kmap_stem), valid))
        skips, sus, kmaps = [point.replace(feat=feat)], [], [kmap0]
        blocks = iter(self.blocks)
        for s in range(stages):
            cap = max(point.slot_size // self.slot_divisors[s], 1)
            pooled, su = self.downs[s](skips[-1], cap)
            pooled = pooled.replace(feat=F.relu(self.norms[1 + s](pooled.feat, pooled.valid)))
            b = pooled.batch
            index = build_voxel_index(pooled.grid_coord, b, pooled.valid, _DEPTH)
            kmap = build_kernel_map(index, pooled.grid_coord, b, pooled.valid, SparseConvSpec.cube(3), _DEPTH)
            for _ in range(self.layers[s]):
                pooled = pooled.replace(feat=next(blocks)(pooled.feat, pooled.valid, kmap))
            skips.append(pooled)
            sus.append(su)
            kmaps.append(kmap)
        x = skips[-1]
        for j, s in enumerate(reversed(range(stages))):
            skip = skips[s]
            up = self.ups[j](x.feat, skip, sus[s])
            up = F.relu(self.norms[1 + stages + j](up, skip.valid))
            x = skip.replace(feat=torch.cat([up, skip.feat], -1))
            for _ in range(self.layers[len(self.channels) - s - 1]):
                x = x.replace(feat=next(blocks)(x.feat, x.valid, kmaps[s]))
        return _dense(x.feat, self.head) if self.head is not None else x.feat
