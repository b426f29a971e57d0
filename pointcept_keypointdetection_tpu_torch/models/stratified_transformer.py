"""ST-v1m2: the Stratified Transformer's window attention with stratified keys.

Counterpart of ``pointcept_keypointdetection_tpu/models/stratified_transformer.py``.
The stem is the KPConv of the reference (``stem="kpconv"``, the default):
each point's 16 nearest valid points by ``knn_bucketed`` at a cell of
``kp_radius`` (cell cap 64), those within the radius weighted by their linear
correlation max(0, 1 - d / sigma) to 15 kernel points (the centre and a
Fibonacci sphere at 0.66 x radius; sigma 0.3 x radius) and mixed through one
[K, Cin, Cout] weight per kernel point.  Not ported: ``stem="subm"`` (a k=3
``SubMConv`` stem, which no config sets) raises.  Then a norm, gelu,
the z order, and per stage (from the second on) a ``MortonDown`` into
``slotted_unique`` parents and ``StratifiedBlock`` s; the decoder adds each
level's projected skip to its parent's projected features and normalizes.

``StratifiedAttention`` (`stratified_transformer.py:97-173`): over patches of
``patch_size`` rows of the z order, each query attends to its patch's keys
and to every ``super_ratio``-th key of the super-patch of ``super_ratio``
patches around it, with a learned relative position bias: per axis, the
``grid_coord`` offset clipped to +-``rpe_bound`` indexes a [3 x (2 bound +
1), heads] table, the three entries summed into the logits.  A masked
softmax in f32 (-1e9 on an invalid key), plain torch as JAX has it, so it
reaches no kernel.  Dense layers are flax ``nn.Dense`` without a dtype, norms
the JAX package's (``LayerNorm`` eps 1e-5, the stem's ``MaskedBatchNorm``),
gelu flax's tanh approximation.  Module names are the flax names
(``convert.py``); drop path draws from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.knn import knn_bucketed
from .builder import MODELS
from .keypoint import PromotedDense
from .norm import DropPath, LayerNorm, MaskedBatchNorm
from .octformer import MortonDown
from .point_transformer_v3 import gelu
from .structure import PointBatch

_DEPTH = 16


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1 - y * y, 0))
    return np.stack([np.cos(phi * i) * r, y, np.sin(phi * i) * r], 1)


class KPConvStem(nn.Module):
    """Rigid kernel-point convolution over each point's radius neighbourhood (`stratified_transformer.py:51-94`)."""

    def __init__(self, in_channels: int, channels: int, radius: float = 0.1, num_neighbors: int = 16,
                 num_kernel_points: int = 15):
        super().__init__()
        self.radius, self.num_neighbors = radius, num_neighbors
        kp = np.concatenate([np.zeros((1, 3)), fibonacci_sphere(num_kernel_points - 1) * 0.66 * radius], 0)
        self.register_buffer("kernel_points", torch.from_numpy(kp.astype(np.float32)), persistent=False)
        self.weight = nn.Parameter(torch.zeros(num_kernel_points, in_channels, channels))

    def forward(self, point: PointBatch) -> torch.Tensor:
        batch, coord = point.batch, point.coord
        nbr_idx, sqd = knn_bucketed(coord, coord, self.num_neighbors, self.radius, batch, batch, point.valid,
                                    cell_cap=64)
        nbr_idx = nbr_idx.long()
        nbr_ok = (sqd < torch.tensor(self.radius**2, dtype=torch.float32)) & point.valid[:, None]
        rel = coord[nbr_idx] - coord[:, None, :]  # [N, nbr, 3]
        d = (rel[:, :, None, :] - self.kernel_points).norm(dim=-1)
        infl = torch.clamp_min(1.0 - d / (0.3 * self.radius), 0.0) * nbr_ok[..., None]  # [N, nbr, K]
        agg = torch.einsum("nbk,nbc->nkc", infl, point.feat[nbr_idx].float())
        return torch.einsum("nkc,kcd->nd", agg, self.weight.float()).to(point.feat.dtype)


class StratifiedAttention(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, super_ratio: int = 4, enable_rpe: bool = True,
                 rpe_bound: int = 16):
        super().__init__()
        self.num_heads, self.patch_size = num_heads, patch_size
        self.super_ratio, self.rpe_bound = super_ratio, rpe_bound
        self.qkv = PromotedDense(channels, 3 * channels)
        self.rpe_table = nn.Parameter(torch.zeros(3 * (2 * rpe_bound + 1), num_heads)) if enable_rpe else None
        self.proj = PromotedDense(channels, channels)

    def forward(self, point: PointBatch) -> torch.Tensor:
        n, c = point.feat.shape[0], self.qkv.in_features
        h, k, r = self.num_heads, self.patch_size, self.super_ratio
        d = c // h
        order, inverse = point.serialized_order[0], point.serialized_inverse[0]
        p = n // k
        p2 = max(p // r, 1)
        qkv = self.qkv(point.feat)
        qkv_s = qkv[order].reshape(n, 3, h, d)
        valid_s = point.valid[order]
        qkv_p = qkv_s.reshape(p, k, 3, h, d)
        q, k_loc, v_loc = (qkv_p[:, :, i].transpose(1, 2) for i in range(3))  # [p, h, k, d]
        # the sparse distant keys: every r-th row of each super-patch, shared by its r patches
        kv_sp = qkv_s.reshape(p2, r * k, 3, h, d)[:, ::r].repeat_interleave(r, 0)[:p]  # [p, k, 3, h, d]
        sp_mask = valid_s.reshape(p2, r * k)[:, ::r].repeat_interleave(r, 0)[:p]
        keys = torch.cat([k_loc, kv_sp[:, :, 1].transpose(1, 2)], 2)  # [p, h, 2k, d]
        vals = torch.cat([v_loc, kv_sp[:, :, 2].transpose(1, 2)], 2)
        kmask = torch.cat([valid_s.reshape(p, k), sp_mask], 1)  # [p, 2k]
        logits = torch.einsum("phkd,phmd->phkm", (q * d**-0.5).float(), keys.float())
        if self.rpe_table is not None:
            bound = self.rpe_bound
            g_s = point.grid_coord[order].to(torch.int64)
            g_q = g_s.reshape(p, k, 3)
            g_sp = g_s.reshape(p2, r * k, 3)[:, ::r].repeat_interleave(r, 0)[:p]
            rel = g_q[:, :, None, :] - torch.cat([g_q, g_sp], 1)[:, None, :, :]  # [p, k, 2k, 3]
            idx = rel.clamp(-bound, bound) + bound + torch.arange(3, device=rel.device) * (2 * bound + 1)
            # an embedding lookup: its backward sorts the indices and sums each table row's gradient once,
            # where indexing's backward adds [p, k, 2k, 3] rows into 99 table rows with atomics
            logits = logits + F.embedding(idx, self.rpe_table).sum(-2).permute(0, 3, 1, 2)
        logits = torch.where(kmask[:, None, None, :], logits, torch.full((), -1e9, device=logits.device))
        attn = torch.softmax(logits, -1).to(vals.dtype)
        out = torch.einsum("phkm,phmd->phkd", attn.float(), vals.float())
        out = out.transpose(1, 2).reshape(n, c).to(qkv.dtype)
        return self.proj(out[inverse])


class StratifiedBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, super_ratio: int = 4, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, enable_rpe: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(channels)
        self.attn = StratifiedAttention(channels, num_heads, patch_size, super_ratio, enable_rpe)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(channels)
        self.mlp1 = PromotedDense(channels, int(channels * mlp_ratio))
        self.mlp2 = PromotedDense(int(channels * mlp_ratio), channels)
        self.dp2 = DropPath(drop_path)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator]) -> PointBatch:
        b = point.num_samples
        feat = point.feat + self.dp1(self.attn(point.replace(feat=self.norm1(point.feat))), b, generator)
        feat = feat + self.dp2(self.mlp2(gelu(self.mlp1(self.norm2(feat)))), b, generator)
        return point.replace(feat=feat)


@MODELS.register_module("ST-v1m2")
@MODELS.register_module("ST-v1m1")  # one implementation, both names (`stratified_transformer.py:204-207`)
class StratifiedTransformer(nn.Module):
    """Per-point features [N, channels[0]] of the last decoder level (logits where ``num_classes`` > 0)."""

    def __init__(self, in_channels: int = 6, channels: Sequence[int] = (48, 96, 192, 384),
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 patch_size: int = 32, super_ratio: int = 4, drop_path_rate: float = 0.3,
                 slot_divisors: Sequence[int] = (1, 2, 4, 8), num_classes: int = 0, stem: str = "kpconv",
                 kp_radius: float = 0.1, enable_rpe: bool = True):
        super().__init__()
        if stem != "kpconv":
            raise NotImplementedError(f"ST-v1m2: stem {stem!r} is not ported (the KPConv stem is)")
        self.channels, self.depths, self.slot_divisors = tuple(channels), tuple(depths), tuple(slot_divisors)
        self.window = patch_size * super_ratio
        self.stem = KPConvStem(in_channels, channels[0], kp_radius)
        self.stem_norm = MaskedBatchNorm(channels[0])
        total, blk = sum(depths), 0
        for s in range(len(depths)):
            if s > 0:
                self.add_module(f"down{s}", MortonDown(channels[s - 1], channels[s]))
            for i in range(depths[s]):
                self.add_module(f"stage{s}_block{i}", StratifiedBlock(
                    channels[s], num_heads[s], patch_size, super_ratio,
                    drop_path=drop_path_rate * blk / max(total - 1, 1), enable_rpe=enable_rpe))
                blk += 1
        for s in reversed(range(len(depths) - 1)):
            self.add_module(f"up{s}_proj", PromotedDense(channels[s + 1], channels[s]))
            self.add_module(f"up{s}_skip", PromotedDense(channels[s], channels[s]))
            self.add_module(f"up{s}_norm", LayerNorm(channels[s]))
        self.head = PromotedDense(channels[0], num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else channels[0]

    def stage_cap(self, slot0: int, s: int) -> int:
        """Rows per sample at stage ``s``: a multiple of the super-patch."""
        cap = max(slot0 // self.slot_divisors[s], self.window)
        return -(-cap // self.window) * self.window

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        slot0 = point.slot_size
        feat = self.stem_norm(self.stem(point), point.valid)
        x = point.replace(feat=gelu(feat)).serialize(orders=("z",), depth=_DEPTH)
        skips, sus = [], []
        for s in range(len(self.depths)):
            if s > 0:
                skips.append(x)
                x, su = getattr(self, f"down{s}")(x, self.stage_cap(slot0, s))
                sus.append(su)
            for i in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{i}")(x, generator)
        for s in reversed(range(len(self.depths) - 1)):
            skip = skips[s]
            f = getattr(self, f"up{s}_proj")(x.feat)
            pad = torch.cat([f, f.new_zeros((1, f.shape[1]))])
            up = pad[sus[s].parent_row.clamp(max=f.shape[0])]
            x = skip.replace(feat=getattr(self, f"up{s}_norm")(up + getattr(self, f"up{s}_skip")(skip.feat)))
        return self.head(x.feat) if self.head is not None else x.feat

