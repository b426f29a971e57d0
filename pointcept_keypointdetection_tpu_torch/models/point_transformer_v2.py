"""PT-v2m2: grouped vector attention over k-nearest neighbourhoods.

Counterpart of ``pointcept_keypointdetection_tpu/models/point_transformer_v2.py``:
a patch embedding (Dense, BatchNorm, ReLU and a ``BlockSequence`` of
``patch_embed_depth`` Blocks over 8 neighbours), then per encoder stage a
``GridPool`` (each sample's points into the voxels of ``grid_sizes[s]`` from
its smallest valid coordinate: a segment max of the projected features, the
mean coordinate, ``slotted_unique`` parents at ``slot // slot_divisors[s]``
rows) and a ``BlockSequence``; per decoder stage an ``UnpoolWithSkip`` (each
child takes its parent's projected features plus its own projected skip) and
a ``BlockSequence``.  A ``BlockSequence`` finds each point's neighbours once
and its Blocks share them; a Block is fc1, norm, ``GroupedVectorAttention``
(q, k, v; the relation k - q plus the positional bias MLP of the coordinate
offsets; weights per group, softmaxed over the neighbours with the missing
ones masked; the weighted sum of the values plus the bias), norm, fc3, norm,
drop path, the residual and ReLU.

The neighbours: ``knn_impl="auto"`` takes the brute ``knn`` below a slot of
16384 (the fork's configs, slot 8192) and ``knn_bucketed`` from there, at
``grid_sizes[s]`` x 2.5 (x 1 for the patch embedding), cell cap 64;
``"brute"`` and ``"bucketed"`` force one.  Everything is plain torch, as JAX
computes it outside any Pallas kernel.  The norms are ``MaskedBatchNorm`` at
momentum 0.1, eps 1e-5; the ones over the [N x S] neighbour rows count every
row, pad queries' included, as JAX's do.  The pooled coordinates add their
rows in order on both devices (``segment_mean_in_order``): the next level's
kNN ranks distances to them, so their rounding must not depend on the
device.  Module names are the flax names
(``convert.py``).  Drop path draws from the caller's ``torch.Generator``.
Not ported: PDNorm (``pdnorm_conditions`` > 0, PT-v2m3) raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.codes import code_or_batch
from ..ops.knn import knn, knn_bucketed
from ..ops.segment import segment_max, segment_mean_in_order
from ..ops.serialization import z_order_encode
from ..ops.voxelize import SlottedUniqueResult, slotted_unique
from .builder import MODELS
from .keypoint import PromotedDense
from .norm import DropPath, MaskedBatchNorm
from .structure import PointBatch

_DEPTH = 16


def _norm(channels: int) -> MaskedBatchNorm:
    return MaskedBatchNorm(channels, eps=1e-5, momentum=0.1)


def norm_all_rows(x: torch.Tensor, norm: MaskedBatchNorm) -> torch.Tensor:
    """A norm over the rows of [N, S, C] neighbour features, every row counted."""
    flat = x.reshape(-1, x.shape[-1])
    return norm(flat, torch.ones(flat.shape[0], dtype=torch.bool, device=x.device)).reshape(x.shape)


def find_neighbours(point: PointBatch, k: int, cell_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's k nearest valid points of its sample, and which of them exist (the query valid)."""
    batch = point.batch
    if cell_size > 0:
        idx, sqd = knn_bucketed(point.coord, point.coord, k, cell_size, batch, batch, point.valid, cell_cap=64)
    else:
        idx, sqd = knn(point.coord, point.coord, k, batch, batch, point.valid)
    return idx.long(), (sqd < 1e9) & point.valid[:, None]


class GroupedVectorAttention(nn.Module):
    def __init__(self, channels: int, groups: int, qkv_bias: bool = True, pe_multiplier: bool = False,
                 pe_bias: bool = True):
        super().__init__()
        self.groups = groups
        self.linear_q = PromotedDense(channels, channels, bias=qkv_bias)
        self.bn_q = _norm(channels)
        self.linear_k = PromotedDense(channels, channels, bias=qkv_bias)
        self.bn_k = _norm(channels)
        self.linear_v = PromotedDense(channels, channels, bias=qkv_bias)
        if pe_multiplier:
            self.pem1, self.bn_pem = PromotedDense(3, channels), _norm(channels)
            self.pem2 = PromotedDense(channels, channels)
        if pe_bias:
            self.peb1, self.bn_peb = PromotedDense(3, channels), _norm(channels)
            self.peb2 = PromotedDense(channels, channels)
        self.we1, self.bn_we, self.we2 = PromotedDense(channels, groups), _norm(groups), PromotedDense(groups, groups)

    def forward(self, feat: torch.Tensor, coord: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        q = F.relu(self.bn_q(self.linear_q(feat), valid))
        k = F.relu(self.bn_k(self.linear_k(feat), valid))
        v = self.linear_v(feat)
        key, value = k[nbr_idx], v[nbr_idx]  # [N, S, C]
        pos = coord[nbr_idx] - coord[:, None, :]
        relation = key - q[:, None, :]
        if hasattr(self, "pem1"):
            relation = relation * self.pem2(F.relu(norm_all_rows(self.pem1(pos), self.bn_pem)))
        if hasattr(self, "peb1"):
            peb = self.peb2(F.relu(norm_all_rows(self.peb1(pos), self.bn_peb)))
            relation = relation + peb
            value = value + peb
        w = self.we2(F.relu(norm_all_rows(self.we1(relation), self.bn_we)))  # [N, S, G]
        mask = nbr_mask[..., None]
        w = torch.softmax(torch.where(mask, w, torch.full((), -1e9, dtype=w.dtype, device=w.device)), 1) * mask
        n, s, c = value.shape
        out = torch.einsum("nsgi,nsg->ngi", value.reshape(n, s, self.groups, c // self.groups), w)
        return out.reshape(n, c)


class Block(nn.Module):
    def __init__(self, channels: int, groups: int, qkv_bias: bool = True, pe_multiplier: bool = False,
                 pe_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.fc1 = PromotedDense(channels, channels, bias=False)
        self.norm1 = _norm(channels)
        self.attn = GroupedVectorAttention(channels, groups, qkv_bias, pe_multiplier, pe_bias)
        self.norm2 = _norm(channels)
        self.fc3 = PromotedDense(channels, channels, bias=False)
        self.norm3 = _norm(channels)
        self.dp = DropPath(drop_path)

    def forward(self, point: PointBatch, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                generator: Optional[torch.Generator]) -> PointBatch:
        valid = point.valid
        feat = F.relu(self.norm1(self.fc1(point.feat), valid))
        feat = F.relu(self.norm2(self.attn(feat, point.coord, nbr_idx, nbr_mask, valid), valid))
        feat = self.dp(self.norm3(self.fc3(feat), valid), point.num_samples, generator)
        return point.replace(feat=F.relu(point.feat + feat))


class BlockSequence(nn.Module):
    def __init__(self, depth: int, channels: int, groups: int, neighbours: int = 16, qkv_bias: bool = True,
                 pe_multiplier: bool = False, pe_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.neighbours, self.depth = neighbours, depth
        for i in range(depth):
            self.add_module(f"block{i}", Block(channels, groups, qkv_bias, pe_multiplier, pe_bias, drop_path))

    def forward(self, point: PointBatch, cell_size: float, generator: Optional[torch.Generator]) -> PointBatch:
        """``cell_size``: the bucketed search's cell, or 0 for the brute ``knn``."""
        nbr_idx, nbr_mask = find_neighbours(point, self.neighbours, cell_size)
        for i in range(self.depth):
            point = getattr(self, f"block{i}")(point, nbr_idx, nbr_mask, generator)
        return point


class GridPool(nn.Module):
    """Voxel-grid pooling from each sample's smallest valid coordinate (`point_transformer_v2.py:182-220`)."""

    def __init__(self, in_channels: int, out_channels: int, grid_size: float):
        super().__init__()
        self.grid_size = grid_size
        self.fc = PromotedDense(in_channels, out_channels, bias=False)
        self.norm = _norm(out_channels)

    def forward(self, point: PointBatch, slot_capacity: int) -> Tuple[PointBatch, SlottedUniqueResult]:
        batch, b, valid = point.batch, point.num_samples, point.valid
        big = torch.where(valid[:, None], point.coord, torch.full((), float("inf"), device=point.coord.device))
        start = torch.full((b, 3), float("inf"), device=big.device).scatter_reduce(
            0, batch[:, None].expand(-1, 3), big, reduce="amin")
        grid = torch.floor((point.coord - start[batch]) / self.grid_size).to(torch.int32)
        grid = grid.clamp(0, (1 << _DEPTH) - 1)
        code = code_or_batch(z_order_encode(grid, _DEPTH), batch, _DEPTH)
        su = slotted_unique(code, valid, batch, b, slot_capacity)
        m = b * slot_capacity
        feat = F.relu(self.norm(self.fc(point.feat), valid))
        feat = torch.where(valid[:, None], feat, torch.zeros((), dtype=feat.dtype, device=feat.device))
        pooled_feat = segment_max(feat, su.parent_row, m)
        pooled_coord = segment_mean_in_order(point.coord * valid[:, None], su.parent_row, m)  # the next kNN ranks them
        head = su.head_row.clamp(max=point.num_points - 1)
        pooled_grid = torch.where(su.out_valid[:, None], grid[head], torch.zeros_like(grid[head]))
        return PointBatch(coord=pooled_coord, feat=pooled_feat, grid_coord=pooled_grid, valid=su.out_valid,
                          num_samples=b), su


class UnpoolWithSkip(nn.Module):
    """Map-backend unpooling plus the projected skip (`point_transformer_v2.py:223-250`)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int):
        super().__init__()
        self.proj = PromotedDense(in_channels, out_channels, bias=False)
        self.norm = _norm(out_channels)
        self.proj_skip = PromotedDense(skip_channels, out_channels, bias=False)
        self.norm_skip = _norm(out_channels)

    def forward(self, pooled: PointBatch, skip: PointBatch, su: SlottedUniqueResult) -> PointBatch:
        feat = F.relu(self.norm(self.proj(pooled.feat), pooled.valid))
        skip_feat = F.relu(self.norm_skip(self.proj_skip(skip.feat), skip.valid))
        pad = torch.cat([feat, feat.new_zeros((1, feat.shape[1]))])
        return skip.replace(feat=pad[su.parent_row.clamp(max=feat.shape[0])] + skip_feat)


@MODELS.register_module("PT-v2m2")
@MODELS.register_module("PT-v2m1")  # the same design (`point_transformer_v2.py:254-255`)
class PointTransformerV2(nn.Module):
    """Per-point features [N, dec_channels[0]] of the last decoder stage."""

    def __init__(self, in_channels: int = 6, patch_embed_depth: int = 1, patch_embed_channels: int = 48,
                 patch_embed_groups: int = 6, patch_embed_neighbours: int = 8,
                 enc_depths: Sequence[int] = (2, 2, 6, 2), enc_channels: Sequence[int] = (96, 192, 384, 512),
                 enc_groups: Sequence[int] = (12, 24, 48, 64), enc_neighbours: Sequence[int] = (16, 16, 16, 16),
                 dec_depths: Sequence[int] = (1, 1, 1, 1), dec_channels: Sequence[int] = (48, 96, 192, 384),
                 dec_groups: Sequence[int] = (6, 12, 24, 48), dec_neighbours: Sequence[int] = (16, 16, 16, 16),
                 grid_sizes: Sequence[float] = (0.06, 0.12, 0.24, 0.48), qkv_bias: bool = True,
                 pe_multiplier: bool = False, pe_bias: bool = True, drop_path_rate: float = 0.3,
                 slot_divisors: Sequence[int] = (2, 4, 8, 16), pdnorm_conditions: int = 0, knn_impl: str = "auto"):
        super().__init__()
        if pdnorm_conditions:
            raise NotImplementedError("PT-v2: PDNorm (pdnorm_conditions > 0, PT-v2m3) is not ported yet")
        if knn_impl not in ("auto", "brute", "bucketed"):
            raise ValueError(f"PT-v2: knn_impl {knn_impl!r}")
        self.knn_impl, self.grid_sizes = knn_impl, tuple(grid_sizes)
        self.slot_divisors, stages = tuple(slot_divisors), len(enc_depths)
        self.embed_fc = PromotedDense(in_channels, patch_embed_channels, bias=False)
        self.embed_norm = _norm(patch_embed_channels)
        pe = (qkv_bias, pe_multiplier, pe_bias)
        self.patch_embed = BlockSequence(patch_embed_depth, patch_embed_channels, patch_embed_groups,
                                         patch_embed_neighbours, *pe)
        width = patch_embed_channels
        for s in range(stages):
            self.add_module(f"enc{s}_pool", GridPool(width, enc_channels[s], grid_sizes[s]))
            self.add_module(f"enc{s}", BlockSequence(enc_depths[s], enc_channels[s], enc_groups[s], enc_neighbours[s],
                                                     *pe, drop_path_rate * s / max(stages - 1, 1)))
            width = enc_channels[s]
        skip_widths = [patch_embed_channels] + list(enc_channels[:-1])
        for s in reversed(range(stages)):
            self.add_module(f"dec{s}_up", UnpoolWithSkip(width, skip_widths[s], dec_channels[s]))
            self.add_module(f"dec{s}", BlockSequence(dec_depths[s], dec_channels[s], dec_groups[s], dec_neighbours[s],
                                                     *pe))
            width = dec_channels[s]
        self.out_channels = dec_channels[0]

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        slot0 = point.slot_size
        bucketed = self.knn_impl == "bucketed" or (self.knn_impl == "auto" and slot0 >= 16384)

        def cell(stage: int) -> float:  # -1: the patch embedding, at the input's spacing
            return self.grid_sizes[max(stage, 0)] * (1.0 if stage < 0 else 2.5) if bucketed else 0.0

        point = point.replace(feat=F.relu(self.embed_norm(self.embed_fc(point.feat), point.valid)))
        x = self.patch_embed(point, cell(-1), generator)
        skips, sus = [], []
        for s in range(len(self.grid_sizes)):
            skips.append(x)
            x, su = getattr(self, f"enc{s}_pool")(x, max(slot0 // self.slot_divisors[s], 16))
            sus.append(su)
            x = getattr(self, f"enc{s}")(x, cell(s), generator)
        for s in reversed(range(len(self.grid_sizes))):
            x = getattr(self, f"dec{s}_up")(x, skips[s], sus[s])
            x = getattr(self, f"dec{s}")(x, cell(s - 1), generator)
        return x.feat
