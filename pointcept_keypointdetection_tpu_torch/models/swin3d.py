"""Swin3D-v1m1: windowed attention with the contextual relative signal embedding over fixed slots.

Counterpart of ``pointcept_keypointdetection_tpu/models/swin3d.py``.  A window
of ``window_size`` voxels (a power of 2) is an aligned cube, and the z order
of the (shifted, on odd Blocks) grid groups windows contiguously
(``window_order``); attention runs over serialized patches of
``patch_size`` rows with a same-window and valid-key mask.  The cRSE
(`swin3d.py:61-175`) adds, per signal group (``xyz``: the sub-window
position; ``rgb``: ``sig[:, 0:3]``; ``norm``: ``sig[:, 3:6]``, as ``crse``
selects) and per axis, ``q_i . Tq[rel_ij]`` and ``k_j . Tk[rel_ij]`` to the
logits and ``sum_j a_ij Tv[rel_ij]`` to the output, the last as a
scatter-histogram ``H`` over the table's slots (``scatter_add`` on its last
axis) times ``Tv``.  The U-Net: ``embed`` -> ``embed_norm`` (a
``MaskedBatchNorm`` with running statistics) -> gelu; per stage a
``GridDownsample`` (proj -> LayerNorm -> segment max into ``slotted_unique``
parents, the head rows carrying ``cont`` and ``sig``) and ``SwinBlock`` s;
per decoder level a ``KnnUpsample`` (3-NN inverse-distance interpolation,
``ops/knn.py``) and one ``dec{s}_block``.

``cont`` is each point's position in voxels from its sample's anchor at
``voxel_size`` (0.05 by default, as JAX; the configs do not set it) and
``sig`` the first 6 input channels, padded with zeros.  The anchor and the
pooled coordinates are means whose rows add in order on both devices
(``segment_mean_in_order``): the cRSE floors the positions measured from the
anchor and the up-sampling weighs by inverse squared distances to the pooled
coordinates, so their rounding must not depend on the device.  The
attention, the cRSE and the interpolation are plain torch, as JAX computes
them outside any Pallas kernel; on the card the histogram's ``scatter_add``
is atomic, so two runs need not agree bit for bit.  Dense layers are
flax ``nn.Dense`` without a dtype, norms the JAX package's, gelu flax's tanh
approximation; module and parameter names are the flax names
(``convert.py``).  Drop path draws from the caller's ``torch.Generator``.
``upsample_cell_sizes`` gives a decoder level the bucketed 3-NN
(``knn_bucketed`` at that cell, cell cap 64) in place of the brute one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.codes import code_lexsort, code_or_batch, code_shr
from ..ops.knn import three_nn_interpolate
from ..ops.segment import segment_mean_in_order
from ..ops.serialization import z_order_encode
from ..ops.voxelize import SlottedUniqueResult
from .builder import MODELS
from .keypoint import PromotedDense
from .norm import DropPath, LayerNorm, MaskedBatchNorm
from .octformer import inverse_of, pool_parents
from .point_transformer_v3 import gelu
from .structure import PointBatch, fill_invalid_keep_batch

_DEPTH = 16


def window_order(grid_coord: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor, shift: int,
                 depth: int = _DEPTH) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, inverse, code): the z order of the grid shifted by ``shift``, pads last in their slot."""
    code = code_or_batch(z_order_encode(grid_coord + shift, depth), batch, depth)
    code = fill_invalid_keep_batch(code, valid, depth)
    order = code_lexsort(code)
    return order, inverse_of(order), code


def crse_groups(crse: str, quant_size: int, window_size: int):
    """(name, scale, length) of each signal group ``crse`` selects (`swin3d.py:137-145`)."""
    groups = [("xyz", float(quant_size), window_size * quant_size)]
    if "RGB" in crse:  # colour in [-1, 1]: window 2, quantized at 2 x quant_size
        groups.append(("rgb", float(2 * quant_size), 2 * (2 * quant_size)))
    if "NORM" in crse:
        groups.append(("norm", float(2 * quant_size), 2 * (2 * quant_size)))
    return groups


class WindowAttention(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, window_size: int, shifted: bool = False,
                 crse: str = "XYZ_RGB", quant_size: int = 4):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = channels, num_heads, patch_size
        self.window_size, self.shifted = window_size, shifted
        self.groups = crse_groups(crse, quant_size, window_size)
        self.qkv = PromotedDense(channels, 3 * channels)
        d = channels // num_heads
        for name, _, length in self.groups:
            for kind in ("q", "k", "v"):
                self.register_parameter(f"{name}_{kind}_table",
                                        nn.Parameter(torch.zeros(3, 2 * length, num_heads, d)))
        self.proj = PromotedDense(channels, channels)

    def forward(self, point: PointBatch, sig: torch.Tensor, cont: torch.Tensor, stride: int = 1) -> torch.Tensor:
        n, c, h, k, w = point.num_points, self.channels, self.num_heads, self.patch_size, self.window_size
        d, p = c // h, n // k
        shift = w // 2 if self.shifted else 0
        order, inverse, code = window_order(point.grid_coord, point.batch, point.valid, shift)
        qkv = self.qkv(point.feat)
        qkv_p = qkv[order].reshape(p, k, 3, h, d)
        win = code_shr(code[order], 3 * (w - 1).bit_length()).reshape(p, k)
        q = qkv_p[:, :, 0].transpose(1, 2) * d**-0.5  # [p, h, k, d]
        kk = qkv_p[:, :, 1].transpose(1, 2)
        v = qkv_p[:, :, 2].transpose(1, 2)
        logits = torch.einsum("phkd,phmd->phkm", q.float(), kk.float())
        mask = (win[:, :, None] == win[:, None, :]) & point.valid[order].reshape(p, k)[:, None, :]

        cont_s = cont[order] / float(stride) + float(shift)
        signals = {"xyz": cont_s - torch.floor(cont_s / w) * w}  # the position inside the window, in [0, w)
        sig_s = sig[order]
        signals.update(rgb=sig_s[:, 0:3], norm=sig_s[:, 3:6])
        rels = []
        for name, scale, length in self.groups:
            si = torch.floor(signals[name].float() * scale).to(torch.int64).reshape(p, k, 3)
            rel = (si[:, :, None, :] - si[:, None, :, :] + length).clamp(0, 2 * length - 1)  # [p, k, k, 3]
            tq, tk = getattr(self, f"{name}_q_table"), getattr(self, f"{name}_k_table")
            bias = torch.zeros_like(logits)
            for a in range(3):
                rh = rel[..., a][:, None].expand(p, h, k, k)
                bias_q = torch.einsum("phkd,lhd->phkl", q.float(), tq[a])  # q_i . Tq[l]
                bias_k = torch.einsum("phkd,lhd->phkl", kk.float(), tk[a])  # k_j . Tk[l]
                bias = bias + bias_q.gather(-1, rh)
                bias = bias + bias_k.gather(-1, rh.transpose(2, 3)).transpose(2, 3)
            logits = logits + bias
            rels.append((getattr(self, f"{name}_v_table"), rel, length))

        logits = torch.where(mask[:, None], logits, torch.full((), -1e9, device=logits.device))
        attn = torch.softmax(logits, -1)
        out = torch.einsum("phkm,phmd->phkd", attn.to(v.dtype).float(), v.float())
        for tv, rel, length in rels:  # out_i += sum_l H[i, l] Tv[l], H[i, l] = sum_j a_ij [rel_ij == l]
            for a in range(3):
                rh = rel[..., a][:, None].expand(p, h, k, k)
                hist = attn.new_zeros((p, h, k, 2 * length)).scatter_add(-1, rh, attn)
                out = out + torch.einsum("phkl,lhd->phkd", hist, tv[a])
        out = out.transpose(1, 2).reshape(n, c).to(qkv.dtype)
        return self.proj(out[inverse])


class SwinBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, window_size: int, shifted: bool,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, crse: str = "XYZ_RGB", quant_size: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(channels)
        self.attn = WindowAttention(channels, num_heads, patch_size, window_size, shifted, crse, quant_size)
        self.norm2 = LayerNorm(channels)
        self.mlp1 = PromotedDense(channels, int(channels * mlp_ratio))
        self.mlp2 = PromotedDense(int(channels * mlp_ratio), channels)
        self.drop_path = DropPath(drop_path)

    def forward(self, point: PointBatch, sig: torch.Tensor, cont: torch.Tensor, stride: int,
                generator: Optional[torch.Generator] = None) -> PointBatch:
        b = point.num_samples
        x = self.attn(point.replace(feat=self.norm1(point.feat)), sig, cont, stride)
        feat = point.feat + self.drop_path(x, b, generator)
        feat = feat + self.drop_path(self.mlp2(gelu(self.mlp1(self.norm2(feat)))), b, generator)
        return point.replace(feat=feat)


class GridDownsample(nn.Module):
    """proj -> LayerNorm -> max over each stride-2 parent's valid children (`swin3d.py:208-231`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.proj = PromotedDense(in_channels, out_channels)
        self.norm = LayerNorm(out_channels)

    def forward(self, point: PointBatch, slot_capacity: int) -> Tuple[PointBatch, SlottedUniqueResult, torch.Tensor]:
        return pool_parents(point, self.norm(self.proj(point.feat)), slot_capacity)


class KnnUpsample(nn.Module):
    """3-NN interpolation of the projected coarse features onto the skip's rows, plus the projected skip,
    normalized (`swin3d.py:234-248`)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int, knn_cell_size: float = 0.0):
        super().__init__()
        self.knn_cell_size = knn_cell_size
        self.proj = PromotedDense(in_channels, out_channels)
        self.proj_skip = PromotedDense(skip_channels, out_channels)
        self.norm = LayerNorm(out_channels)

    def forward(self, pooled: PointBatch, skip: PointBatch) -> PointBatch:
        interp = three_nn_interpolate(skip.coord, pooled.coord, self.proj(pooled.feat), skip.batch, pooled.batch,
                                      pooled.valid, cell_size=self.knn_cell_size)
        return skip.replace(feat=self.norm(interp + self.proj_skip(skip.feat)))


@MODELS.register_module("Swin3D-v1m1")
class Swin3DUNet(nn.Module):
    """Per-point features [N, channels[0]] of the last decoder level (logits where ``num_classes`` > 0)."""

    def __init__(self, in_channels: int = 6, depths: Sequence[int] = (2, 2, 6, 2),
                 channels: Sequence[int] = (48, 96, 192, 384), upsample_cell_sizes: Sequence[float] = (),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_sizes: Sequence[int] = (4, 4, 4, 4),
                 patch_size: int = 128, mlp_ratio: float = 4.0, drop_path_rate: float = 0.3,
                 slot_divisors: Sequence[int] = (1, 2, 4, 8), num_classes: int = 0, crse: str = "XYZ_RGB",
                 quant_size: int = 4, voxel_size: float = 0.05):
        super().__init__()
        self.depths, self.channels = tuple(depths), tuple(channels)
        self.patch_size, self.slot_divisors, self.voxel_size = patch_size, tuple(slot_divisors), voxel_size
        self.embed = PromotedDense(in_channels, channels[0])
        self.embed_norm = MaskedBatchNorm(channels[0])
        total, blk = sum(depths), 0

        def block(s, shifted, rate):
            return SwinBlock(channels[s], num_heads[s], patch_size, window_sizes[s], shifted, mlp_ratio, rate, crse,
                             quant_size)

        for s in range(len(depths)):
            if s > 0:
                self.add_module(f"down{s}", GridDownsample(channels[s - 1], channels[s]))
            for i in range(depths[s]):
                self.add_module(f"stage{s}_block{i}", block(s, i % 2 == 1, drop_path_rate * blk / max(total - 1, 1)))
                blk += 1
        for s in reversed(range(len(depths) - 1)):
            cell = upsample_cell_sizes[s] if len(upsample_cell_sizes) > s else 0.0
            self.add_module(f"up{s}", KnnUpsample(channels[s + 1], channels[s], channels[s], cell))
            self.add_module(f"dec{s}_block", block(s, False, 0.0))
        self.head = PromotedDense(channels[0], num_classes) if num_classes > 0 else None
        self.out_channels = num_classes if num_classes > 0 else channels[0]

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        slot0, b, batch, valid = point.slot_size, point.num_samples, point.batch, point.valid
        feat = self.embed_norm(self.embed(point.feat), valid)
        # the signal carrier (the reference's coords_sp): the position in voxels from the sample's anchor,
        # and the raw colour / normal channels, head-row pooled per stage
        resid = point.coord - self.voxel_size * point.grid_coord.float()
        anchor = segment_mean_in_order(torch.where(valid[:, None], resid, torch.zeros((), device=resid.device)), batch,
                                       b)
        cont = (point.coord - anchor[batch]) / self.voxel_size
        cin = point.feat.shape[1]
        sig = point.feat[:, :min(cin, 6)].float()
        if cin < 6:
            sig = torch.cat([sig, sig.new_zeros((point.num_points, 6 - cin))], 1)
        x = point.replace(feat=gelu(feat))
        skips, conts, sigs = [], [], []
        for s in range(len(self.depths)):
            if s > 0:
                skips.append(x)
                conts.append(cont)
                sigs.append(sig)
                cap = max(slot0 // self.slot_divisors[s], self.patch_size)
                x, _, head = getattr(self, f"down{s}")(x, -(-cap // self.patch_size) * self.patch_size)
                cont, sig = cont[head], sig[head]
            for i in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{i}")(x, sig, cont, 1 << s, generator)
        for s in reversed(range(len(self.depths) - 1)):
            x = getattr(self, f"up{s}")(x, skips[s])
            x = getattr(self, f"dec{s}_block")(x, sigs[s], conts[s], 1 << s, generator)
        return self.head(x.feat) if self.head is not None else x.feat
