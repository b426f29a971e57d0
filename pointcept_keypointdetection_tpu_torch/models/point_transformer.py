"""PT-v1: the original Point Transformer's vector attention.

Counterpart of ``pointcept_keypointdetection_tpu/models/point_transformer.py``:
per encoder stage, a Dense projection (stride 1) or a ``TransitionDown``
(farthest point sampling of ``slot // stride`` rows per sample, each pick's
``nsample`` nearest valid points of the finer level max-pooled over a
projection of the features and coordinates), the stage's neighbourhoods
(``nsample`` nearest valid points), then ``Bottleneck`` s of
``VectorAttentionLayer``: q, k, v, a positional MLP of the coordinate
offsets, weights of k - q + pe per group of ``share_planes`` channels,
softmaxed over the neighbours with the missing ones masked, over v + pe.  Per
decoder level a ``TransitionUp`` (3-NN inverse-distance interpolation of the
coarse level's projected features onto the finer rows, plus their own
projection) and one ``Bottleneck``.

The neighbours come from the brute ``knn`` or, where ``knn_cell_sizes`` gives
the level a cell, ``knn_bucketed`` at cell cap 64; the picks from
``ops/sampling.py`` (plain torch, a loop of rounds).  Everything is plain
torch, as JAX computes it outside any Pallas kernel.  Norms are
``MaskedBatchNorm`` at momentum 0.1, eps 1e-5; the attention's two norms over
the [N x S] neighbour rows count every row, as JAX's do.  Module names follow
flax's (``convert.py``): the explicit ones keep their names; in a
``Bottleneck`` ``fc1``, ``norm1``, ``attn``, ``norm2``, ``fc3``, ``norm3``,
``proj`` are flax's ``Dense_0``, ``MaskedBatchNorm_0``,
``VectorAttentionLayer_0``, ``MaskedBatchNorm_1``, ``Dense_1``,
``MaskedBatchNorm_2``, ``Dense_2``; in a ``TransitionDown`` ``fc`` and ``norm``
are ``Dense_0`` and ``MaskedBatchNorm_0``; in a ``TransitionUp`` ``fc1``,
``norm1``, ``fc2``, ``norm2`` are ``Dense_0``, ``MaskedBatchNorm_0``,
``Dense_1``, ``MaskedBatchNorm_1``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.knn import knn, knn_bucketed, three_nn_interpolate
from ..ops.sampling import farthest_point_sampling_batched
from .builder import MODELS
from .keypoint import PromotedDense
from .norm import MaskedBatchNorm
from .point_transformer_v2 import norm_all_rows
from .structure import PointBatch


def _norm(channels: int) -> MaskedBatchNorm:
    return MaskedBatchNorm(channels, eps=1e-5, momentum=0.1)


def _search(query: torch.Tensor, base: PointBatch, k: int, cell_size: float, query_batch: torch.Tensor):
    batch = base.batch
    if cell_size > 0:
        return knn_bucketed(query, base.coord, k, cell_size, query_batch, batch, base.valid, cell_cap=64)
    return knn(query, base.coord, k, query_batch, batch, base.valid)


class VectorAttentionLayer(nn.Module):
    def __init__(self, channels: int, share_planes: int = 8):
        super().__init__()
        self.share_planes = share_planes
        self.linear_q = PromotedDense(channels, channels)
        self.linear_k = PromotedDense(channels, channels)
        self.linear_v = PromotedDense(channels, channels)
        self.pe1, self.pe_bn, self.pe2 = PromotedDense(3, 3), _norm(3), PromotedDense(3, channels)
        groups = channels // share_planes
        self.w1, self.w_bn, self.w2 = PromotedDense(channels, groups), _norm(groups), PromotedDense(groups, groups)

    def forward(self, feat: torch.Tensor, coord: torch.Tensor, nbr_idx: torch.Tensor,
                nbr_mask: torch.Tensor) -> torch.Tensor:
        q, k, v = self.linear_q(feat), self.linear_k(feat), self.linear_v(feat)
        key, value = k[nbr_idx], v[nbr_idx]  # [N, S, C]
        p = self.pe2(F.relu(norm_all_rows(self.pe1(coord[nbr_idx] - coord[:, None, :]), self.pe_bn)))
        w = self.w2(F.relu(norm_all_rows(self.w1(key - q[:, None, :] + p), self.w_bn)))  # [N, S, C / share]
        mask = nbr_mask[..., None]
        w = torch.softmax(torch.where(mask, w, torch.full((), -1e9, dtype=w.dtype, device=w.device)), 1) * mask
        n, s, c = value.shape
        out = torch.einsum("nsgi,nsg->ngi", (value + p).reshape(n, s, c // self.share_planes, self.share_planes), w)
        return out.reshape(n, c)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, share_planes: int = 8):
        super().__init__()
        self.fc1 = PromotedDense(in_channels, planes, bias=False)
        self.norm1 = _norm(planes)
        self.attn = VectorAttentionLayer(planes, share_planes)
        self.norm2 = _norm(planes)
        self.fc3 = PromotedDense(planes, planes, bias=False)
        self.norm3 = _norm(planes)
        if in_channels != planes:
            self.proj = PromotedDense(in_channels, planes, bias=False)

    def forward(self, point: PointBatch, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor) -> PointBatch:
        valid = point.valid
        feat = F.relu(self.norm1(self.fc1(point.feat), valid))
        feat = F.relu(self.norm2(self.attn(feat, point.coord, nbr_idx, nbr_mask), valid))
        feat = self.norm3(self.fc3(feat), valid)
        identity = self.proj(point.feat) if hasattr(self, "proj") else point.feat
        return point.replace(feat=F.relu(identity + feat))


class TransitionDown(nn.Module):
    """Farthest point sampling per sample, then a max over each pick's neighbours (`point_transformer.py:83-128`)."""

    def __init__(self, in_channels: int, out_planes: int, stride: int, nsample: int = 16):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        self.fc = PromotedDense(in_channels + 3, out_planes, bias=False)
        self.norm = _norm(out_planes)

    def forward(self, point: PointBatch, cell_size: float) -> PointBatch:
        b, s = point.num_samples, point.slot_size
        picks = farthest_point_sampling_batched(point.coord.reshape(b, s, 3), max(s // self.stride, 1),
                                                point.valid.reshape(b, s))
        rows = (picks + torch.arange(b, device=picks.device)[:, None] * s).reshape(-1)
        new_coord, batch = point.coord[rows], point.batch
        feat = F.relu(self.norm(self.fc(torch.cat([point.feat, point.coord], -1)), point.valid))
        nbr_idx, sqd = _search(new_coord, point, self.nsample, cell_size, batch[rows])
        gathered = feat[nbr_idx.long()]  # [M, k, C]
        gathered = torch.where((sqd < 1e9)[..., None], gathered,
                               torch.full((), float("-inf"), dtype=gathered.dtype, device=gathered.device))
        pooled = gathered.max(1).values
        pooled = torch.where(torch.isfinite(pooled), pooled, torch.zeros((), dtype=pooled.dtype, device=pooled.device))
        return PointBatch(coord=new_coord, feat=pooled, grid_coord=point.grid_coord[rows], valid=point.valid[rows],
                          num_samples=b)


class TransitionUp(nn.Module):
    """The coarse level's projected features interpolated onto the finer rows, plus their own projection."""

    def __init__(self, in_channels: int, skip_channels: int, out_planes: int):
        super().__init__()
        self.fc1, self.norm1 = PromotedDense(in_channels, out_planes, bias=False), _norm(out_planes)
        self.fc2, self.norm2 = PromotedDense(skip_channels, out_planes, bias=False), _norm(out_planes)

    def forward(self, pooled: PointBatch, skip: PointBatch, cell_size: float) -> PointBatch:
        f1 = F.relu(self.norm1(self.fc1(pooled.feat), pooled.valid))
        f2 = F.relu(self.norm2(self.fc2(skip.feat), skip.valid))
        interp = three_nn_interpolate(skip.coord, pooled.coord, f1, skip.batch, pooled.batch, pooled.valid,
                                      cell_size=cell_size)
        return skip.replace(feat=f2 + interp)


@MODELS.register_module("PT-v1")
class PointTransformerV1(nn.Module):
    """Per-point features [N, planes[0]] of the last decoder level."""

    def __init__(self, in_channels: int = 6, planes: Sequence[int] = (32, 64, 128, 256, 512),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3), strides: Sequence[int] = (1, 4, 4, 4, 4),
                 share_planes: int = 8, nsample: Sequence[int] = (8, 16, 16, 16, 16),
                 knn_cell_sizes: Sequence[float] = ()):
        super().__init__()
        self.planes, self.blocks, self.strides = tuple(planes), tuple(blocks), tuple(strides)
        self.nsample, self.knn_cell_sizes = tuple(nsample), tuple(knn_cell_sizes)
        width = in_channels
        for s, (c, depth, stride, ns) in enumerate(zip(planes, blocks, strides, nsample)):
            if stride == 1:
                self.add_module(f"enc{s}_proj", PromotedDense(width, c, bias=False))
                self.add_module(f"enc{s}_norm", _norm(c))
            else:
                self.add_module(f"enc{s}_down", TransitionDown(width, c, stride, ns))
            for i in range(depth):
                self.add_module(f"enc{s}_block{i}", Bottleneck(c, c, share_planes))
            width = c
        for s in reversed(range(len(planes) - 1)):
            self.add_module(f"dec{s}_up", TransitionUp(width, planes[s], planes[s]))
            self.add_module(f"dec{s}_block", Bottleneck(planes[s], planes[s], share_planes))
            width = planes[s]
        self.out_channels = planes[0]

    def _cell(self, s: int) -> float:
        return self.knn_cell_sizes[s] if len(self.knn_cell_sizes) > s else 0.0

    def _grouping(self, x: PointBatch, k: int, cell_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
        nbr_idx, sqd = _search(x.coord, x, k, cell_size, x.batch)
        return nbr_idx.long(), (sqd < 1e9) & x.valid[:, None]

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, skips = point, []
        for s, (depth, stride, ns) in enumerate(zip(self.blocks, self.strides, self.nsample)):
            if stride == 1:
                feat = getattr(self, f"enc{s}_proj")(x.feat)
                x = x.replace(feat=F.relu(getattr(self, f"enc{s}_norm")(feat, x.valid)))
            else:  # the down-transition queries the finer level: its cell
                x = getattr(self, f"enc{s}_down")(x, self._cell(s - 1))
            nbr_idx, nbr_mask = self._grouping(x, ns, self._cell(s))
            for i in range(depth):
                x = getattr(self, f"enc{s}_block{i}")(x, nbr_idx, nbr_mask)
            skips.append(x)
        x = skips[-1]
        for s in reversed(range(len(self.planes) - 1)):
            x = getattr(self, f"dec{s}_up")(x, skips[s], self._cell(s + 1))
            nbr_idx, nbr_mask = self._grouping(x, self.nsample[s], self._cell(s))
            x = getattr(self, f"dec{s}_block")(x, nbr_idx, nbr_mask)
        return x.feat
