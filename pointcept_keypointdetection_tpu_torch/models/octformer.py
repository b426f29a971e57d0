"""OctFormer-v1m1: octree window attention over fixed slots.

Counterpart of ``pointcept_keypointdetection_tpu/models/octformer.py``: a
sorted Morton order is the octree traversal, so a window of ``patch_size``
consecutive rows of the z order is an octree attention window, and the
dilated window of every ``dilation``-th octant is the ``[N/D, D] -> [D, N/D]``
transpose of that order before patching (``_dilated_perm``, over the whole
batch).  Each Block: the CPE (a k=3 ``SubMConv`` with bias over the level's
kernel map, kernel B3 forward and for the input gradient, B4 for the weight
gradient on the card) added to the features, then pre-norm attention and a
pre-norm MLP, each through ``DropPath``.  Down-sampling is ``_MortonDown``
(``slotted_unique`` parents at ``ceil(max(slot // div, patch) / patch) *
patch`` rows per sample, a segment max of the projected features, the
segment mean of the coordinates); the decoder adds each level's projected
skip to its parent's projected features and normalizes.

The attention is plain torch, as JAX computes it outside any Pallas kernel
(`octformer.py:46-84`): its mask is per (query, key) pair, the key valid and
of the query's own sample, since a dilated patch may span two samples, where
kernel B1's mask is per key only.  Logits and softmax in f32, -1e9 on a
masked pair.  Dense layers are flax ``nn.Dense`` without a dtype
(``PromotedDense``), norms the JAX package's ``LayerNorm`` (eps 1e-5), gelu
flax's tanh approximation.  Module names are the flax names, so
``convert.py`` maps a JAX checkpoint name by name.  Drop path draws from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.codes import code_or_batch
from ..ops.segment import segment_max, segment_mean_in_order
from ..ops.serialization import z_order_encode
from ..ops.sparse import KernelMap, SparseConvSpec, build_kernel_map, build_voxel_index
from ..ops.voxelize import SlottedUniqueResult, slotted_unique
from .builder import MODELS
from .keypoint import PromotedDense
from .norm import DropPath, LayerNorm
from .point_transformer_v3 import gelu
from .sparse_unet import SubMConv
from .structure import PointBatch

_DEPTH = 16


def dilated_perm(order: torch.Tensor, dilation: int) -> torch.Tensor:
    """Regroup a sorted order so that positions of one residue mod ``dilation`` are contiguous."""
    if dilation <= 1:
        return order
    n = order.shape[0]
    return order.reshape(n // dilation, dilation).T.reshape(n)


def inverse_of(order: torch.Tensor) -> torch.Tensor:
    """``zeros.at[order].set(arange)``: the row -> position inverse of a permutation, by scatter."""
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    return inverse


class OctreeAttention(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, dilation: int = 1):
        super().__init__()
        self.num_heads, self.patch_size, self.dilation = num_heads, patch_size, dilation
        self.qkv = PromotedDense(channels, 3 * channels)
        self.proj = PromotedDense(channels, channels)

    def forward(self, point: PointBatch) -> torch.Tensor:
        n, c = point.feat.shape[0], self.qkv.in_features
        h, k = self.num_heads, self.patch_size
        d, p = c // h, n // k
        order = dilated_perm(point.serialized_order[0], self.dilation)
        inverse = inverse_of(order)
        qkv = self.qkv(point.feat)
        qkv_p = qkv[order].reshape(p, k, 3, h, d)
        valid_s = point.valid[order].reshape(p, k)
        batch_s = point.batch[order].reshape(p, k)
        # a dilated patch may span samples: a key counts where it is valid and of the query's sample
        key_ok = valid_s[:, None, :] & (batch_s[:, None, :] == batch_s[:, :, None])  # [p, query, key]
        q = qkv_p[:, :, 0].transpose(1, 2)
        kk = qkv_p[:, :, 1].transpose(1, 2)
        v = qkv_p[:, :, 2].transpose(1, 2)
        logits = torch.einsum("phkd,phmd->phkm", (q * d**-0.5).float(), kk.float())
        logits = torch.where(key_ok[:, None], logits, torch.full((), -1e9, device=logits.device))
        attn = torch.softmax(logits, -1).to(v.dtype)
        out = torch.einsum("phkm,phmd->phkd", attn.float(), v.float())
        out = out.transpose(1, 2).reshape(n, c).to(qkv.dtype)
        return self.proj(out[inverse])


class OctFormerBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, dilation: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.cpe = SubMConv(channels, channels, 3, bias=True)
        self.norm1 = LayerNorm(channels)
        self.attn = OctreeAttention(channels, num_heads, patch_size, dilation)
        self.norm2 = LayerNorm(channels)
        self.mlp1 = PromotedDense(channels, int(channels * mlp_ratio))
        self.mlp2 = PromotedDense(int(channels * mlp_ratio), channels)
        self.drop_path = DropPath(drop_path)

    def forward(self, point: PointBatch, kmap: KernelMap, generator: Optional[torch.Generator]) -> PointBatch:
        b = point.num_samples
        feat = point.feat + self.cpe(point.feat, kmap)
        feat = feat + self.drop_path(self.attn(point.replace(feat=self.norm1(feat))), b, generator)
        feat = feat + self.drop_path(self.mlp2(gelu(self.mlp1(self.norm2(feat)))), b, generator)
        return point.replace(feat=feat)


def pool_parents(point: PointBatch, feat: torch.Tensor,
                 slot_capacity: int) -> Tuple[PointBatch, SlottedUniqueResult, torch.Tensor]:
    """The stride-2 parents of ``point``'s voxels, compacted into ``slot_capacity`` rows per sample by
    ``slotted_unique``: the max of ``feat`` over each parent's valid children (0 where it has none), the
    mean coordinate, the parent's grid; and (the parents, the pooling, each parent's head row).
    ``_MortonDown`` and Swin3D's ``GridDownsample`` (`swin3d.py:208-231`) pool alike."""
    batch, b = point.batch, point.num_samples
    parent = point.grid_coord >> 1
    code = code_or_batch(z_order_encode(parent, _DEPTH), batch, _DEPTH)
    su = slotted_unique(code, point.valid, batch, b, slot_capacity)
    m = b * slot_capacity
    feat = torch.where(point.valid[:, None], feat, torch.full((), float("-inf"), dtype=feat.dtype, device=feat.device))
    pooled = segment_max(feat, su.parent_row, m)
    pooled = torch.where(torch.isfinite(pooled), pooled, torch.zeros((), dtype=pooled.dtype, device=pooled.device))
    coord = segment_mean_in_order(point.coord * point.valid[:, None], su.parent_row, m)  # Swin3D's 3-NN reads it
    head = su.head_row.clamp(max=point.num_points - 1)
    grid = torch.where(su.out_valid[:, None], parent[head], torch.zeros_like(parent[head]))
    return PointBatch(coord=coord, feat=pooled, grid_coord=grid, valid=su.out_valid, num_samples=b), su, head


class MortonDown(nn.Module):
    """``_MortonDown`` (`octformer.py:174-193`): the projected features pooled into the parents, which
    are serialized in z order."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.proj = PromotedDense(in_channels, out_channels)

    def forward(self, point: PointBatch, slot_capacity: int) -> Tuple[PointBatch, SlottedUniqueResult]:
        out, su, _ = pool_parents(point, self.proj(point.feat), slot_capacity)
        return out.serialize(orders=("z",), depth=_DEPTH), su


@MODELS.register_module("OctFormer-v1m1")
class OctFormer(nn.Module):
    """Per-point features [N, channels[0]] of the last decoder level (logits where ``num_classes`` > 0)."""

    def __init__(self, in_channels: int = 6, channels: Sequence[int] = (96, 192, 384, 384),
                 num_blocks: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (6, 12, 24, 24),
                 patch_size: int = 32, dilation: int = 4, drop_path_rate: float = 0.5,
                 slot_divisors: Sequence[int] = (1, 2, 4, 8), num_classes: int = 0):
        super().__init__()
        self.channels, self.num_blocks = tuple(channels), tuple(num_blocks)
        self.patch_size, self.slot_divisors = patch_size, tuple(slot_divisors)
        self.embed = PromotedDense(in_channels, channels[0])
        total, blk = sum(num_blocks), 0
        for s in range(len(channels)):
            if s > 0:
                self.add_module(f"down{s}", MortonDown(channels[s - 1], channels[s]))
            for i in range(num_blocks[s]):
                self.add_module(f"stage{s}_block{i}", OctFormerBlock(
                    channels[s], num_heads[s], patch_size, dilation=1 if i % 2 == 0 else dilation,
                    drop_path=drop_path_rate * blk / max(total - 1, 1)))
                blk += 1
        for s in reversed(range(len(channels) - 1)):
            self.add_module(f"up{s}_proj", PromotedDense(channels[s + 1], channels[s]))
            self.add_module(f"up{s}_skip", PromotedDense(channels[s], channels[s]))
            self.add_module(f"up{s}_norm", LayerNorm(channels[s]))
        self.head = PromotedDense(channels[0], num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else channels[0]

    def _stage_cap(self, slot0: int, s: int) -> int:
        cap = max(slot0 // self.slot_divisors[s], self.patch_size)
        return -(-cap // self.patch_size) * self.patch_size

    def _kernel_map(self, point: PointBatch) -> KernelMap:
        """A level's k=3 map, from a join of its own (`octformer.py:147-149`)."""
        batch = point.batch
        index = build_voxel_index(point.grid_coord, batch, point.valid, _DEPTH)
        return build_kernel_map(index, point.grid_coord, batch, point.valid, SparseConvSpec.cube(3), _DEPTH)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        slot0 = point.slot_size
        x = point.replace(feat=self.embed(point.feat)).serialize(orders=("z",), depth=_DEPTH)
        skips, sus = [], []
        for s in range(len(self.channels)):
            if s > 0:
                skips.append(x)
                x, su = getattr(self, f"down{s}")(x, self._stage_cap(slot0, s))
                sus.append(su)
            kmap = self._kernel_map(x)
            for i in range(self.num_blocks[s]):
                x = getattr(self, f"stage{s}_block{i}")(x, kmap, generator)
        for s in reversed(range(len(self.channels) - 1)):
            skip = skips[s]
            feat = getattr(self, f"up{s}_proj")(x.feat)
            pad = torch.cat([feat, feat.new_zeros((1, feat.shape[1]))])
            up = pad[sus[s].parent_row.clamp(max=feat.shape[0])]
            skip_feat = getattr(self, f"up{s}_skip")(skip.feat)
            x = skip.replace(feat=getattr(self, f"up{s}_norm")(up + skip_feat))
        return self.head(x.feat) if self.head is not None else x.feat
