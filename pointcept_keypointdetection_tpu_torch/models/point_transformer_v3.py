"""PT-v3m1: serialized point transformer over fixed slots, eval and training.

Counterpart of ``pointcept_keypointdetection_tpu/models/
point_transformer_v3.py:439-721`` for the options the repo's PTv3 configs
take: ``kmap_mode="direct"``, a k=5 cell-packed stem (the ``stem_kernel > 3``
branch, `:509-532`) with a direct k=3 map for the stage-0 xCPE, a fresh k=3
map per pooled stage that the decoder reuses (`:603-611`, `:689`),
SerializedPooling / SerializedUnpooling, and per-block order cycling
(``order_index % 4``).  flax ``nn.gelu`` is the tanh approximation, so is
this one.  Module names follow the flax parameter tree, so ``convert.py``
maps a JAX checkpoint name by name; blocks are ``enc{s}_block{i}`` whether
or not JAX stacked them under ``nn.scan``.

Training (`:457-471`, `:569-570`): batch statistics in the stem and pooling
norms, per-Block drop-path rates drop_path * i / (blocks - 1) over the
encoder and then the decoder Blocks in the order they run, and, with
``shuffle_orders``, a fresh permutation of the order list at every
serialization, drawn from the generator passed to ``forward``; a shuffled
forward does not reuse the z sort for the kernel maps and pooling.

Not ported (raise): enc_mode, PDNorm, LoRA, RPE, the bottleneck and
large-kernel xCPE, chain kernel maps, the k=3 stem and the cell-select stem.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import patch_attention, take_permutation
from ..ops.codes import code_or_batch
from ..ops.segment import segment_mean, segment_reduce
from ..ops.serialization import z_order_encode
from ..ops.sparse import (
    KernelMap,
    SparseConvSpec,
    build_kernel_map,
    build_parent_index,
    build_voxel_index,
    cell_packed_apply,
    cell_packed_weight,
    sparse_conv,
)
from ..ops.voxelize import SlottedUniqueResult, slotted_unique
from .builder import MODELS
from .norm import DropPath, LayerNorm, MaskedBatchNorm
from .structure import PointBatch

_DEPTH = 16  # serialization code depth, as in the JAX package

# JAX options whose non-default values select paths this port does not have
_UNPORTED_DEFAULTS = dict(
    enc_mode=False,
    upcast_level=0,
    enc_return_point=False,
    pdnorm_conditions=0,
    lora_rank=0,
    cpe_kernel_size=3,
    cpe_bottleneck=0,
    enable_rpe=False,
    kmap_mode="direct",
    chain_cpe0="derive",
    stem_conv="cell_packed",
)
# JAX options that pick an implementation, not a result: accepted and ignored
_IMPLEMENTATION_ONLY = ("attn_impl", "scan_blocks")


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class SubMConvCPE(nn.Module):
    """xCPE: SubMConv3d(k=3, bias) + Linear + LayerNorm (`point_transformer_v3.py:55-92`)."""

    def __init__(self, in_channels: int, channels: int, kernel_volume: int = 27):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_volume, in_channels, channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.linear = nn.Linear(channels, channels)
        self.norm = LayerNorm(channels)

    def forward(self, feat: torch.Tensor, kmap: KernelMap) -> torch.Tensor:
        return self.norm(self.linear(sparse_conv(feat, kmap, self.weight, self.bias)))


class SerializedAttention(nn.Module):
    def __init__(self, channels: int, num_heads: int, patch_size: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.channels = channels
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.scale = qk_scale or (channels // num_heads) ** -0.5
        self.qkv = nn.Linear(channels, 3 * channels, bias=qkv_bias)
        self.proj = nn.Linear(channels, channels)

    def forward(self, point: PointBatch, order_index: int) -> torch.Tensor:
        i = order_index % point.serialized_order.shape[0]
        order, inverse = point.serialized_order[i], point.serialized_inverse[i]
        h = self.num_heads
        qkv = self.qkv(point.feat)
        qkv_sorted = take_permutation(qkv, order, inverse).reshape(-1, 3, h, self.channels // h)
        feat = patch_attention(qkv_sorted, point.valid[order], self.patch_size, self.scale)
        return self.proj(take_permutation(feat, inverse, order))


class MLP(nn.Module):
    def __init__(self, channels: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    """xCPE + residual, pre-norm attention + residual, pre-norm MLP + residual."""

    def __init__(self, channels: int, num_heads: int, patch_size: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.cpe = SubMConvCPE(channels, channels)
        self.norm1 = LayerNorm(channels)
        self.attn = SerializedAttention(channels, num_heads, patch_size, qkv_bias, qk_scale)
        self.norm2 = LayerNorm(channels)
        self.mlp = MLP(channels, mlp_ratio)
        self.drop_path = DropPath(drop_path)

    def forward(self, point: PointBatch, kmap: KernelMap, order_index: int,
                generator: Optional[torch.Generator] = None) -> PointBatch:
        b = point.num_samples
        feat = point.feat + self.cpe(point.feat, kmap)
        feat = feat + self.drop_path(self.attn(point.replace(feat=self.norm1(feat)), order_index), b, generator)
        feat = feat + self.drop_path(self.mlp(self.norm2(feat)), b, generator)
        return point.replace(feat=feat)


class SerializedPooling(nn.Module):
    """Grid pooling by z-code prefix (`point_transformer_v3.py:283-330`)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2, bn_momentum: float = 0.01):
        super().__init__()
        self.levels = max((stride - 1).bit_length(), 1)
        self.proj = nn.Linear(in_channels, out_channels)
        self.norm = MaskedBatchNorm(out_channels, momentum=bn_momentum)

    def forward(self, point: PointBatch, slot_capacity: int, orders: Sequence[str],
                precomputed_perm: Optional[torch.Tensor], generator: Optional[torch.Generator] = None):
        parent_grid = point.grid_coord >> self.levels
        batch = point.batch
        code = code_or_batch(z_order_encode(parent_grid, _DEPTH), batch, _DEPTH)
        su = slotted_unique(code, point.valid, batch, point.num_samples, slot_capacity,
                            precomputed_perm=precomputed_perm)
        m = point.num_samples * slot_capacity
        feat = self.proj(point.feat)
        feat = torch.where(point.valid[:, None], feat, torch.zeros((), dtype=feat.dtype, device=feat.device))
        pooled_feat = segment_reduce(feat, su.parent_row, m, "max")
        pooled_coord = segment_mean(point.coord * point.valid[:, None], su.parent_row, m)
        head = su.head_row.clamp(max=point.num_points - 1)
        pooled_grid = torch.where(su.out_valid[:, None], parent_grid[head], torch.zeros_like(parent_grid[head]))
        pooled = PointBatch(
            coord=pooled_coord,
            feat=gelu(self.norm(pooled_feat, su.out_valid)),
            grid_coord=pooled_grid,
            valid=su.out_valid,
            num_samples=point.num_samples,
        )
        return pooled.serialize(orders=tuple(orders), depth=_DEPTH, generator=generator), su


class SerializedUnpooling(nn.Module):
    """Broadcast pooled features back to their children + skip (`:333-358`)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int):
        super().__init__()
        self.proj = nn.Linear(in_channels, out_channels)
        self.proj_norm = LayerNorm(out_channels)
        self.proj_skip = nn.Linear(skip_channels, out_channels)
        self.skip_norm = LayerNorm(out_channels)

    def forward(self, pooled: PointBatch, skip: PointBatch, su: SlottedUniqueResult) -> PointBatch:
        feat = self.proj_norm(self.proj(pooled.feat))
        skip_feat = self.skip_norm(self.proj_skip(skip.feat))
        pad = torch.cat([feat, feat.new_zeros((1, feat.shape[1]))])
        gathered = pad[su.parent_row.clamp(max=feat.shape[0])]
        return skip.replace(feat=gathered + skip_feat)


@MODELS.register_module("PT-v3m1")
class PointTransformerV3(nn.Module):
    def __init__(
        self,
        in_channels: int = 6,
        order: Sequence[str] = ("z", "z-trans", "hilbert", "hilbert-trans"),
        stride: Sequence[int] = (2, 2, 2, 2),
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
        enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
        enc_patch_size: Sequence[int] = (48, 48, 48, 48, 48),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        dec_channels: Sequence[int] = (64, 64, 128, 256),
        dec_num_head: Sequence[int] = (4, 4, 8, 16),
        dec_patch_size: Sequence[int] = (48, 48, 48, 48),
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        drop_path: float = 0.3,
        shuffle_orders: bool = True,
        slot_divisors: Sequence[int] = (1, 2, 4, 8, 16),
        stem_kernel: int = 5,
        bn_momentum: float = 0.01,
        kmap_depth: int = 16,
        **options,
    ):
        super().__init__()
        for key, value in options.items():
            if key in _IMPLEMENTATION_ONLY:
                continue
            if key not in _UNPORTED_DEFAULTS:
                raise TypeError(f"PT-v3m1: unknown option {key!r}")
            if value != _UNPORTED_DEFAULTS[key]:
                raise NotImplementedError(f"PT-v3m1: {key}={value!r} is not ported yet")
        if stem_kernel <= 3:
            raise NotImplementedError("PT-v3m1: only the cell-packed stem (stem_kernel > 3) is ported")
        self.order = tuple(order)
        self.stride = tuple(stride)
        self.enc_depths = tuple(enc_depths)
        self.dec_depths = tuple(dec_depths)
        self.enc_patch_size = tuple(enc_patch_size)
        self.slot_divisors = tuple(slot_divisors)
        self.stem_kernel = stem_kernel
        self.kmap_depth = kmap_depth
        self.shuffle_orders = shuffle_orders
        num_stages = len(enc_depths)
        self.out_channels = dec_channels[0] if num_stages > 1 else enc_channels[0]

        stem_r = max(stem_kernel, 3) // 2
        self.stem_shift = max((stem_r - 1).bit_length(), 1)
        self.stem_weight = nn.Parameter(torch.zeros(stem_kernel**3, in_channels, enc_channels[0]))
        self.stem_norm = MaskedBatchNorm(enc_channels[0], momentum=bn_momentum)
        self._stem_packed = None  # (key of the weight's value, its cell_packed_weight)

        # one rate per Block, in the order the Blocks run: encoder, then decoder (`:569-570`)
        total_blocks = sum(enc_depths) + sum(dec_depths)
        rates = iter([drop_path * i / max(total_blocks - 1, 1) for i in range(total_blocks)])

        def blocks(prefix, depth, channels, heads, patch):
            names = [f"{prefix}_block{i}" for i in range(depth)]
            for name in names:
                self.add_module(name, Block(channels, heads, patch, mlp_ratio, next(rates), qkv_bias, qk_scale))
            return names

        self.enc_names: List[List[str]] = []
        for s in range(num_stages):
            if s > 0:
                self.add_module(
                    f"enc{s}_down",
                    SerializedPooling(enc_channels[s - 1], enc_channels[s], stride[s - 1], bn_momentum),
                )
            self.enc_names.append(
                blocks(f"enc{s}", enc_depths[s], enc_channels[s], enc_num_head[s], enc_patch_size[s])
            )
        self.dec_names: List[List[str]] = [[] for _ in range(num_stages - 1)]
        for s in reversed(range(num_stages - 1)):
            coarse = enc_channels[-1] if s == num_stages - 2 else dec_channels[s + 1]
            self.add_module(f"dec{s}_up", SerializedUnpooling(coarse, enc_channels[s], dec_channels[s]))
            self.dec_names[s] = blocks(f"dec{s}", dec_depths[s], dec_channels[s], dec_num_head[s], dec_patch_size[s])

    def _stage_cap(self, slot0: int, s: int) -> int:
        """Slot capacity at stage s, rounded up to a patch-size multiple."""
        k = self.enc_patch_size[s]
        cap = max(slot0 // self.slot_divisors[s], k)
        return -(-cap // k) * k

    def _reuse_perm(self, point: PointBatch, shuffled: bool) -> Optional[torch.Tensor]:
        # without shuffling, the z serialization's sort doubles as the
        # kernel-map and pooling sort (z(c >> s) = z(c) >> 3s); a shuffled
        # order list may put another curve first
        return point.serialized_order[0] if self.order[0] == "z" and not shuffled else None

    def _stem_packed_weight(self) -> torch.Tensor:
        """The stem weight parity-expanded for ``cell_packed_apply``; without
        autograd it is built once per weight value (``_version`` counts every
        in-place write to the parameter, ``load_state_dict`` included)."""
        w = self.stem_weight
        spec = SparseConvSpec.cube(self.stem_kernel)
        if torch.is_grad_enabled():
            return cell_packed_weight(w, self.stem_shift, spec)
        key = (w.device, w.data_ptr(), w._version)
        if self._stem_packed is None or self._stem_packed[0] != key:
            self._stem_packed = (key, cell_packed_weight(w, self.stem_shift, spec))
        return self._stem_packed[1]

    def _kernel_map(self, point: PointBatch, shuffled: bool) -> KernelMap:
        kd = self.kmap_depth
        batch = point.batch
        index = build_voxel_index(point.grid_coord, batch, point.valid, kd, self._reuse_perm(point, shuffled))
        return build_kernel_map(index, point.grid_coord, batch, point.valid, SparseConvSpec.cube(3), kd)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Features of the last decoder level.  ``generator`` (a CPU
        ``torch.Generator``) drives order shuffling and drop path in
        training; it is needed there unless both are off."""
        slot0 = point.slot_size
        if slot0 % self.enc_patch_size[0]:
            raise ValueError(f"slot size {slot0} is not a multiple of patch {self.enc_patch_size[0]}")
        shuffled = self.training and self.shuffle_orders
        if shuffled and generator is None:
            raise ValueError("PT-v3m1: training with shuffle_orders needs a generator")
        shuffle_gen = generator if shuffled else None
        point = point.serialize(orders=self.order, depth=_DEPTH, generator=shuffle_gen)

        # ---- embedding: k=5 stem on the coarse cells + BN + GELU ----------
        parent = build_parent_index(point.grid_coord, point.batch, point.valid, self.stem_shift,
                                    self.kmap_depth, precomputed_perm=self._reuse_perm(point, shuffled))
        kmap = self._kernel_map(point, shuffled)  # the stage-0 xCPE map
        feat = cell_packed_apply(point.feat, parent, point.valid, self._stem_packed_weight())
        x = point.replace(feat=gelu(self.stem_norm(feat, point.valid)))

        # ---- encoder ------------------------------------------------------
        skips, sus, kmaps = [], [], []
        for s, names in enumerate(self.enc_names):
            if s > 0:
                skips.append(x)
                x, su = getattr(self, f"enc{s}_down")(
                    x, self._stage_cap(slot0, s), self.order, self._reuse_perm(x, shuffled), shuffle_gen
                )
                sus.append(su)
                kmap = self._kernel_map(x, shuffled)
            kmaps.append(kmap)
            for i, name in enumerate(names):
                x = getattr(self, name)(x, kmap, i, generator)

        # ---- decoder ------------------------------------------------------
        for s in reversed(range(len(self.dec_names))):
            x = getattr(self, f"dec{s}_up")(x, skips[s], sus[s])
            for i, name in enumerate(self.dec_names[s]):
                x = getattr(self, name)(x, kmaps[s], i, generator)
        return x.feat
