"""Submanifold sparse convolution over exact kernel maps: the main-path subset.

Counterparts of ``pointcept_keypointdetection_tpu/ops/sparse.py``:

* ``build_voxel_index`` / ``build_kernel_map`` (`sparse.py:61-224`): the map
  ``int32[N, K]`` of neighbor rows, ``N`` where a neighbor is missing and in
  every column of an invalid row.  The JAX package joins by sort-merge; any
  exact join gives the same map for unique voxels, and here it is
  ``torch.searchsorted`` over the sorted int64 codes.
* ``build_parent_index`` (`:246-326`): the 2^shift-coarse cell structure that
  the k=5 stem runs on.
* ``cell_packed_conv`` (`:412-481`): the k=5 stem as a gather of 27
  neighbor cells and one contraction with a parity-expanded weight.  Plain
  XLA in JAX, so plain PyTorch here.
* ``sparse_conv`` (`:866-887`): every xCPE conv, through
  ``SubmConvFunction`` (``kernels/sparse_conv.py``): kernel B3 forward and
  for the input gradient, kernel B4 for the weight gradient on the card.
  Autograd differentiates the bias and the stem.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.sparse_conv import SubmConvFunction
from .codes import CODE_MAX, code_fill_invalid, code_or_batch
from .serialization import z_order_encode


class SparseConvSpec(NamedTuple):
    """Static description of a conv neighborhood."""

    offsets: Tuple[Tuple[int, int, int], ...]

    @staticmethod
    def cube(kernel_size: int) -> "SparseConvSpec":
        """Centered k^3 neighborhood in ``itertools.product`` order (spconv SubMConv3d)."""
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        r = kernel_size // 2
        return SparseConvSpec(offsets=tuple(itertools.product(range(-r, r + 1), repeat=3)))


class KernelMap(NamedTuple):
    neighbor_idx: torch.Tensor  # int32[N, K]; N = missing neighbor


class SortedVoxelIndex(NamedTuple):
    sorted_code: torch.Tensor  # int64[N]: codes in ``perm`` order, invalid = CODE_MAX
    perm: torch.Tensor  # int64[N]: sorted position -> voxel row


def build_voxel_index(
    grid_coord: torch.Tensor,
    batch: torch.Tensor,
    valid: torch.Tensor,
    depth: int = 16,
    precomputed_perm: Optional[torch.Tensor] = None,
) -> SortedVoxelIndex:
    """Batch-prefixed z-codes of the voxels, in ``precomputed_perm`` order
    (the serialization's z order) or sorted.  As in JAX, a reused order keeps
    each slot's invalid rows at that slot's end, so the codes need not be
    globally sorted; ``build_kernel_map`` sorts them."""
    code = code_fill_invalid(code_or_batch(z_order_encode(grid_coord, depth), batch, depth), valid)
    if precomputed_perm is not None:
        perm = precomputed_perm.to(torch.int64)
    else:
        perm = torch.sort(code, stable=True).indices
    return SortedVoxelIndex(sorted_code=code[perm], perm=perm)


def build_kernel_map(
    index: SortedVoxelIndex,
    grid_coord: torch.Tensor,
    batch: torch.Tensor,
    valid: torch.Tensor,
    spec: SparseConvSpec,
    depth: int = 16,
) -> KernelMap:
    """For each voxel and each offset, the neighbor's row, or N."""
    n = grid_coord.shape[0]
    sorted_code, order = torch.sort(index.sorted_code)
    rows = index.perm[order]
    offs = torch.as_tensor(np.asarray(spec.offsets, np.int64), device=grid_coord.device)
    qcoord = grid_coord.to(torch.int64)[:, None, :] + offs[None, :, :]  # [N, K, 3]
    in_range = (qcoord >= 0).all(-1) & valid[:, None]
    k = offs.shape[0]
    qcode = z_order_encode(qcoord.clamp_min(0).reshape(-1, 3), depth).reshape(n, k)
    qcode = code_or_batch(qcode, batch[:, None], depth)
    pos = torch.searchsorted(sorted_code, qcode).clamp(max=n - 1)
    hit = (sorted_code[pos] == qcode) & in_range
    neighbor = torch.where(hit, rows[pos], torch.full_like(pos, n))
    return KernelMap(neighbor_idx=neighbor.to(torch.int32))


class ParentCellIndex(NamedTuple):
    """Two-level lookup: 2^shift-coarse cells + per-cell subvoxel table."""

    shift: int  # cell = voxel >> shift
    cell_kmap: torch.Tensor  # int32[N, 27]: cell -> neighbor cell id (N = miss)
    cell_table: torch.Tensor  # int64[N + 1, 8**shift]: (cell, subposition) -> voxel row
    cell_of: torch.Tensor  # int64[N]: voxel row -> own cell id
    parity: torch.Tensor  # int64[N]: voxel row -> subposition within its cell


def build_parent_index(
    grid_coord: torch.Tensor,
    batch: torch.Tensor,
    valid: torch.Tensor,
    shift: int = 1,
    depth: int = 16,
    precomputed_perm: Optional[torch.Tensor] = None,
) -> ParentCellIndex:
    """The coarse-cell structure over the active voxels (`sparse.py:246-326`).

    ``precomputed_perm``: the fine z order (a coarse z-code is a bit prefix
    of the fine one, so the fine order is also a coarse order)."""
    n = grid_coord.shape[0]
    dev = grid_coord.device
    side = 1 << shift
    nsub = side**3
    grid = grid_coord.to(torch.int64)
    ccoord = grid >> shift
    sub = grid & (side - 1)
    parity = (sub[:, 0] * side + sub[:, 1]) * side + sub[:, 2]

    ccode = code_fill_invalid(code_or_batch(z_order_encode(ccoord, depth), batch, depth), valid)
    if precomputed_perm is not None:
        perm = precomputed_perm.to(torch.int64)
    else:
        perm = torch.sort(ccode, stable=True).indices
    sc = ccode[perm]
    invalid_sorted = sc == CODE_MAX
    prev = torch.cat([sc.new_full((1,), CODE_MAX), sc[:-1]])
    is_head = (sc != prev) & ~invalid_sorted
    is_head[0] = ~invalid_sorted[0]
    cell_id_sorted = torch.cumsum(is_head.to(torch.int64), 0) - 1

    # cells are found in ascending code order, so cell id order is sorted order
    heads = cell_id_sorted[is_head]
    cell_code = torch.full((n,), CODE_MAX, dtype=torch.int64, device=dev)
    cell_code[heads] = sc[is_head]
    head_row = torch.zeros((n,), dtype=torch.int64, device=dev)
    head_row[heads] = perm[is_head]
    cell_grid = ccoord[head_row]
    cell_batch = batch[head_row]
    cell_valid = torch.arange(n, device=dev) < heads.numel()

    cell_of = torch.empty((n,), dtype=torch.int64, device=dev)
    cell_of[perm] = torch.where(cell_id_sorted >= 0, cell_id_sorted, torch.full_like(cell_id_sorted, n))
    rows = torch.arange(n, device=dev)
    cell_table = torch.full(((n + 1) * nsub,), n, dtype=torch.int64, device=dev)
    cell_table[cell_of[valid] * nsub + parity[valid]] = rows[valid]

    cindex = SortedVoxelIndex(sorted_code=cell_code, perm=rows)
    ckmap = build_kernel_map(cindex, cell_grid, cell_batch, cell_valid, SparseConvSpec.cube(3), depth)
    return ParentCellIndex(
        shift=shift,
        cell_kmap=ckmap.neighbor_idx,
        cell_table=cell_table.reshape(n + 1, nsub),
        cell_of=cell_of,
        parity=parity,
    )


@functools.lru_cache(maxsize=None)
def _cell_packed_slots(shift: int, spec: SparseConvSpec) -> np.ndarray:
    """(parity, cell column, subposition) -> kernel offset slot, or K for zero."""
    side = 1 << shift
    nsub = side**3
    offs = np.asarray(spec.offsets, np.int64)
    r = int(np.abs(offs).max())
    if r > side:
        raise ValueError(f"kernel radius {r} exceeds the cell side {side}")
    ps = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(nsub, 3)
    cj = np.stack(np.meshgrid(*[[-1, 0, 1]] * 3, indexing="ij"), -1).reshape(27, 3)
    d = cj[None, :, None, :] * side + ps[None, None, :, :] - ps[:, None, None, :]  # [p, j, s, 3]
    in_range = np.all(np.abs(d) <= r, axis=-1)
    kdim = 2 * r + 1
    slot = ((d[..., 0] + r) * kdim + (d[..., 1] + r)) * kdim + (d[..., 2] + r)
    return np.where(in_range, slot, len(spec.offsets))  # [nsub, 27, nsub]


@functools.lru_cache(maxsize=None)
def _cell_packed_slots_on(shift: int, spec: SparseConvSpec, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode (a served request),
    # so that a later training step may index with it
    with torch.inference_mode(False):
        return torch.as_tensor(_cell_packed_slots(shift, spec), device=device)


def cell_packed_weight(weight: torch.Tensor, shift: int, spec: SparseConvSpec) -> torch.Tensor:
    """``weight`` [K, Cin, Cout] in spec.offsets order, parity-expanded into the
    [27*nsub*Cin, nsub*Cout] matrix that ``cell_packed_apply`` contracts with:
    column block p holds ``W'[p, j, s] = weight[d]`` for the fine offset d that
    (parity p, cell column j, subposition s) spells, zero where none does."""
    _, cin, cout = weight.shape
    nsub = (1 << shift) ** 3
    slot = _cell_packed_slots_on(shift, spec, weight.device)
    w_pad = torch.cat([weight, weight.new_zeros((1, cin, cout))])
    w_exp = w_pad[slot.reshape(nsub, -1)].reshape(nsub, 27 * nsub * cin, cout)
    return w_exp.permute(1, 0, 2).reshape(27 * nsub * cin, nsub * cout)


def cell_packed_apply(
    feat: torch.Tensor,  # [N, Cin]
    parent: ParentCellIndex,
    valid: torch.Tensor,  # bool[N]
    packed_weight: torch.Tensor,  # [27*nsub*Cin, nsub*Cout] from cell_packed_weight
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[i] = sum_{j<27, s<nsub} table[cell_nbr(i, j), s] . W'[parity_i, j, s]."""
    n, cin = feat.shape
    nsub = (1 << parent.shift) ** 3
    cout = packed_weight.shape[1] // nsub
    feat_pad = torch.cat([torch.where(valid[:, None], feat, 0), feat.new_zeros((1, cin))])
    table = feat_pad[parent.cell_table].reshape(n + 1, nsub * cin)
    nbr = parent.cell_kmap[parent.cell_of.clamp(max=n - 1)].to(torch.int64)
    nbr = torch.where(valid[:, None] & (parent.cell_of[:, None] < n), nbr, n)
    gathered = table[nbr].reshape(n, 27 * nsub * cin)
    out_all = (gathered.float() @ packed_weight.to(feat.dtype).float()).reshape(n, nsub, cout)
    out = out_all.gather(1, parent.parity[:, None, None].expand(n, 1, cout))[:, 0]
    out = out.to(feat.dtype)
    if bias is not None:
        out = out + bias.to(feat.dtype)
    return out


def cell_packed_conv(
    feat: torch.Tensor,  # [N, Cin]
    parent: ParentCellIndex,
    valid: torch.Tensor,  # bool[N]
    weight: torch.Tensor,  # [K, Cin, Cout] in spec.offsets order
    spec: SparseConvSpec,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Submanifold conv computed at the coarse-cell level (`sparse.py:412-481`).

    A module whose weight is fixed builds ``cell_packed_weight`` once and
    calls ``cell_packed_apply``."""
    return cell_packed_apply(feat, parent, valid, cell_packed_weight(weight, parent.shift, spec), bias)


def sparse_conv(
    feat: torch.Tensor,  # [N, Cin]
    kmap: KernelMap,
    weight: torch.Tensor,  # [K, Cin, Cout]
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[i] = sum_d feat[neighbor_idx[i, d]] @ weight[d] (+ bias); [N, Cout].

    A missing neighbor (index N) contributes zero.  The map must be a
    centered cube's in ``itertools.product`` order (every caller's), whose
    mirror identity the backward uses."""
    out = SubmConvFunction.apply(feat, kmap.neighbor_idx, weight.to(feat.dtype))
    if bias is not None:
        out = out + bias.to(feat.dtype)
    return out
