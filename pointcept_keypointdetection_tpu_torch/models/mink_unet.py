"""MinkUNet: the MinkowskiEngine-style ResNet sparse U-Net.

Counterpart of ``pointcept_keypointdetection_tpu/models/mink_unet.py``
(`:46-187`), built from SpUNet's pieces (``models/sparse_unet.py``).  Where
it differs from SpUNet:

* the stem is a K = 125 ``SubMConv`` at full resolution (``conv0``, ``bn0``)
  and the four residual stages run after a stride-2 conv each, at strides
  2, 4, 8 and 16 (``slot_divisors`` (2, 4, 8, 16) by default);
* ``Bottleneck`` blocks (1x1 -> k=3 -> 1x1 at 4x the width, `:46-69`)
  carry MinkUNet50 and MinkUNet101;
* the last decoder stage concatenates the stem's features and runs over a
  K = 27 map of the stem's rows built for it (`:147`).

On the card every ``SubMConv`` is kernel B3 forward and for the input
gradient (not the stem's: its input needs none) and B4 for the weight
gradient, over the map's rulebook: one for the stem's K = 125 map, one per
stage's K = 27 map and one for the full-resolution K = 27 map.

Module names are the flax names: ``conv0``, ``bn0``, ``conv{s}s2``,
``bn{s}``, ``block{s}_{i}``, ``convtr{k}``, ``bntr{k}``, ``final``; in a
``BasicBlock`` ``conv1`` / ``conv2`` / ``proj`` are flax's ``SubMConv_0`` /
``SubMConv_1`` / ``Dense_0`` (``convert.py``), a ``Bottleneck`` keeps its
own (``conv1``-``conv3``, ``norm1``-``norm3``, ``proj``, ``norm_proj``).
The fifteen published plans are registered under their reference names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse import KernelMap
from .builder import MODELS
from .norm import MaskedBatchNorm
from .sparse_unet import BasicBlock, InverseConvUp, StridedConvDown, SubMConv, _dense, kernel_map
from .structure import PointBatch


class Bottleneck(nn.Module):
    """1x1 -> k=3 -> 1x1 (x ``expansion``) residual block, each conv followed by a norm; a bias-free
    1x1 + norm on the skip where the widths differ (`mink_unet.py:46-69`)."""

    def __init__(self, in_channels: int, planes: int, expansion: int = 4, bn_momentum: float = 0.01):
        super().__init__()
        out = planes * expansion
        self.conv1 = nn.Linear(in_channels, planes, bias=False)
        self.norm1 = MaskedBatchNorm(planes, momentum=bn_momentum)
        self.conv2 = SubMConv(planes, planes, 3)
        self.norm2 = MaskedBatchNorm(planes, momentum=bn_momentum)
        self.conv3 = nn.Linear(planes, out, bias=False)
        self.norm3 = MaskedBatchNorm(out, momentum=bn_momentum)
        if in_channels != out:
            self.proj = nn.Linear(in_channels, out, bias=False)
            self.norm_proj = MaskedBatchNorm(out, momentum=bn_momentum)

    def forward(self, feat: torch.Tensor, valid: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
        out = F.relu(self.norm1(_dense(feat, self.conv1), valid))
        out = F.relu(self.norm2(self.conv2(out, kmap), valid))
        out = self.norm3(_dense(out, self.conv3), valid)
        identity = feat
        if hasattr(self, "proj"):
            identity = self.norm_proj(_dense(feat, self.proj), valid)
        return F.relu(out + identity)


class MinkUNet(nn.Module):
    """MinkUNet over a ``PointBatch``: per-point logits [N, num_classes] (the last decoder stage's
    features where ``num_classes`` is 0), in the input's rows."""

    def __init__(self, in_channels: int, num_classes: int,
                 planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
                 layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2), block: str = "basic", init_dim: int = 32,
                 bn_momentum: float = 0.01, slot_divisors: Sequence[int] = (2, 4, 8, 16)):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"MinkUNet: block is 'basic' or 'bottleneck', got {block!r}")
        self.planes, self.layers, self.block = tuple(planes), tuple(layers), block
        self.slot_divisors = tuple(slot_divisors)
        exp = 4 if block == "bottleneck" else 1

        def make_block(cin: int, ch: int) -> nn.Module:
            return Bottleneck(cin, ch, bn_momentum=bn_momentum) if exp == 4 else BasicBlock(cin, ch, bn_momentum)

        self.conv0 = SubMConv(in_channels, init_dim, 5)
        self.bn0 = MaskedBatchNorm(init_dim, momentum=bn_momentum)
        width, skip_widths = init_dim, [init_dim]
        for s in range(4):
            down = init_dim if s == 0 else self.planes[s - 1] * exp
            self.add_module(f"conv{s + 1}s2", StridedConvDown(width, down))
            self.add_module(f"bn{s + 1}", MaskedBatchNorm(down, momentum=bn_momentum))
            width = down
            for i in range(self.layers[s]):
                self.add_module(f"block{s + 1}_{i}", make_block(width, self.planes[s]))
                width = self.planes[s] * exp
            skip_widths.append(width)
        for d in range(4):
            tr = self.planes[4 + d]
            self.add_module(f"convtr{4 + d}", InverseConvUp(width, tr))
            self.add_module(f"bntr{4 + d}", MaskedBatchNorm(tr, momentum=bn_momentum))
            width = tr + skip_widths[3 - d]
            for i in range(self.layers[4 + d]):
                self.add_module(f"block{5 + d}_{i}", make_block(width, tr))
                width = tr * exp
        self.final = nn.Linear(width, num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else width

    def _blocks(self, stage: int, point: PointBatch, kmap: KernelMap) -> PointBatch:
        for i in range(self.layers[stage]):
            point = point.replace(feat=getattr(self, f"block{stage + 1}_{i}")(point.feat, point.valid, kmap))
        return point

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feat = self.conv0(point.feat, kernel_map(point, 5))
        stem = point.replace(feat=F.relu(self.bn0(feat, point.valid)))
        skips, sus, kmaps, x = [stem], [], [], stem
        for s in range(4):
            cap = max(point.slot_size // self.slot_divisors[s], 1)
            pooled, su = getattr(self, f"conv{s + 1}s2")(x, cap)
            pooled = pooled.replace(feat=F.relu(getattr(self, f"bn{s + 1}")(pooled.feat, pooled.valid)))
            kmap = kernel_map(pooled)
            x = self._blocks(s, pooled, kmap)
            skips.append(x)
            sus.append(su)
            kmaps.append(kmap)
        for d in range(4):
            s = 3 - d  # the level restored: skips[0] is the stem
            skip = skips[s]
            up = getattr(self, f"convtr{4 + d}")(x.feat, skip, sus[s])
            up = F.relu(getattr(self, f"bntr{4 + d}")(up, skip.valid))
            x = skip.replace(feat=torch.cat([up, skip.feat], -1))
            x = self._blocks(4 + d, x, kmaps[s - 1] if s > 0 else kernel_map(stem))
        return _dense(x.feat, self.final) if self.final is not None else x.feat


def _variant(name: str, layers, block: str, planes=(32, 64, 128, 256, 256, 128, 96, 96)) -> None:
    def factory(**kwargs):
        kwargs.setdefault("layers", layers)
        kwargs.setdefault("planes", planes)
        kwargs.setdefault("block", block)
        return MinkUNet(**kwargs)

    factory.__name__ = name
    MODELS.register_module(name)(factory)


# the published plans (`mink_unet.py:172-187`)
_variant("MinkUNet14", (1,) * 8, "basic")
_variant("MinkUNet18", (2,) * 8, "basic")
_variant("MinkUNet34", (2, 3, 4, 6, 2, 2, 2, 2), "basic")
_variant("MinkUNet50", (2, 3, 4, 6, 2, 2, 2, 2), "bottleneck")
_variant("MinkUNet101", (2, 3, 4, 23, 2, 2, 2, 2), "bottleneck")
_variant("MinkUNet14A", (1,) * 8, "basic", (32, 64, 128, 256, 128, 128, 96, 96))
_variant("MinkUNet14B", (1,) * 8, "basic", (32, 64, 128, 256, 128, 128, 128, 128))
_variant("MinkUNet14C", (1,) * 8, "basic", (32, 64, 128, 256, 192, 192, 128, 128))
_variant("MinkUNet14D", (1,) * 8, "basic", (32, 64, 128, 256, 384, 384, 384, 384))
_variant("MinkUNet18A", (2,) * 8, "basic", (32, 64, 128, 256, 128, 128, 96, 96))
_variant("MinkUNet18B", (2,) * 8, "basic", (32, 64, 128, 256, 128, 128, 128, 128))
_variant("MinkUNet18D", (2,) * 8, "basic", (32, 64, 128, 256, 384, 384, 384, 384))
_variant("MinkUNet34A", (2, 3, 4, 6, 2, 2, 2, 2), "basic", (32, 64, 128, 256, 256, 128, 96, 96))
_variant("MinkUNet34B", (2, 3, 4, 6, 2, 2, 2, 2), "basic", (32, 64, 128, 256, 256, 128, 64, 32))
_variant("MinkUNet34C", (2, 3, 4, 6, 2, 2, 2, 2), "basic", (32, 64, 128, 256, 256, 128, 96, 96))
