"""k-nearest neighbours: the port's ``knn`` (``pointcept_keypointdetection_tpu/ops/knn.py:38-92``).

Exact brute force with JAX's semantics: squared distances by JAX's own
formula ``|q|^2 - 2 q.b + |b|^2`` in f32, the k smallest per query, ties to
the lowest base index (JAX merges a running top-k with ``lax.top_k``, which
keeps the earlier of equal values), and ``(index 0, sqdist _BIG)`` in every
slot that no candidate fills: a query with fewer than k valid base points of
its own sample gets them, as JAX's initial top-k does.

JAX computes a ``Q x chunk`` block over the whole collated batch and sets
the other samples' and the invalid base rows' entries to ``_BIG``; those
entries never beat the initial ``_BIG`` fillers, so they never reach the
output.  The port computes per sample over its valid base rows only, and in
blocks of queries, and returns the same indices and distances: at the
ScanNet recipe's val batch (8 x 131,072 rows) JAX's block is 8 GiB per step.

The distances are rounded as the JAX package computes them on the CPU where
its callers (the tester, the evaluator) call ``knn`` outside ``jit``:
``|q|^2`` as ((x^2 + y^2) + z^2), each step rounded to f32; ``q.b`` and
``|b|^2`` as chains of fused multiply-adds (XLA's CPU code inside the
``lax.scan``); then (|q|^2 - 2 q.b) + |b|^2.  A fused multiply-add is
emulated in f64, which holds an f32 product exactly, and rounded once to
f32.  So the card and the CPU give the same bits, no TF32 matmul can move a
distance across ``radius^2``, and near-equal neighbours come in JAX's
order.  The tensors stay on the caller's device; each sample costs a host
read (its rows).

``knn_bucketed`` (`knn.py:466-495`; ``build_knn_index`` `:208-277`,
``knn_query_index`` `:305-463`) is the grid-bucketed search with JAX's
semantics, not its layout:

* cells are ``floor(coord / cell_size)`` rebased so that the smallest valid
  cell of the whole base is 1 on each axis; a base point outside the
  ``2^depth`` domain is dropped;
* the base is sorted stably by (sample, z code of its cell); a query looks
  at the cells of ``_ring_offsets`` (the 27 of the unit cube at radius 1),
  in that order, and in each only at the first ``cell_cap`` rows of the
  cell's run (a run is found by ``searchsorted``, where JAX joins by a sort
  and a scan); a row of another cell or sample counts as ``_BIG``;
* distances are the per-axis squared differences summed in f32, x then y
  then z, as JAX rounds them outside ``jit`` (under ``jit`` XLA's CPU code
  fuses two of the products into multiply-adds: the same indices,
  distances an ulp apart);
* the k nearest candidates, ties to the earlier candidate (ring order, then
  row within the cell: ``small_top_k``'s k argmax passes), not to the lower
  base index;
* a slot no candidate fills carries ``sqdist`` >= ``_BIG`` and the index of
  the nearest candidate found (0 where none is).

It stays plain torch and makes no host read: [Q, 27 x cell_cap] candidates,
in blocks of ``query_chunk`` queries.

``three_nn_interpolate`` (`knn.py:531-558`; Swin3D's up-sampling, PT-v1's
``TransitionUp``) takes ``knn`` or, with ``cell_size`` > 0, ``knn_bucketed``
at ``cell_cap`` 64: weights 1 / max(d^2, 1e-8), normalized.  Not ported:
``ball_query``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .codes import CODE_MAX, code_fill_invalid, code_or_batch
from .serialization import z_order_encode

_BIG = 1e10
BLOCK_ELEMS = 2**26  # distances per block of queries: 512 MiB in f64


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once to f32."""
    return (a.double() * b.double() + c.double()).float()


def _ordered(d: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as the f32 values ``d`` do."""
    bits = d.contiguous().view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)


def _smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, columns) of the k smallest entries of each row of ``d``, in order of (value, column).

    ``torch.topk`` promises no order among equal values, so it runs over int64 keys
    (ordered value << 32 | column), which are all distinct."""
    key = _ordered(d) * 2**32 + torch.arange(d.shape[1], device=d.device)
    cols = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    return d.gather(1, cols), cols


def knn(
    query: torch.Tensor,  # [Q, 3]
    base: torch.Tensor,  # [N, 3]
    k: int,
    query_batch: Optional[torch.Tensor] = None,
    base_batch: Optional[torch.Tensor] = None,
    base_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[Q, k], sqdist f32[Q, k]) of the k nearest valid base points of each query's
    sample (the sample ids only where ``base_batch`` is given, as in JAX)."""
    device, q, n = query.device, query.shape[0], base.shape[0]
    query, base = query.float(), base.float()
    idx = torch.zeros((q, k), dtype=torch.int32, device=device)
    sqd = torch.full((q, k), _BIG, dtype=torch.float32, device=device)
    candidate = torch.ones(n, dtype=torch.bool, device=device) if base_valid is None else base_valid.bool()
    if base_batch is None:
        groups = [(torch.arange(q, device=device), candidate.nonzero().squeeze(1))]
    else:
        groups = [((query_batch == s).nonzero().squeeze(1), ((base_batch == s) & candidate).nonzero().squeeze(1))
                  for s in torch.unique(query_batch).tolist()]
    for q_rows, b_rows in groups:
        m = b_rows.numel()
        if m == 0 or q_rows.numel() == 0:
            continue
        kk = min(k, m)
        b = base[b_rows]
        b_sq = _fma(b[:, 2], b[:, 2], _fma(b[:, 1], b[:, 1], b[:, 0] * b[:, 0]))
        step = max(1, BLOCK_ELEMS // m)
        for start in range(0, q_rows.numel(), step):
            rows = q_rows[start:start + step]
            p = query[rows]
            p_sq = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2]
            dot = p[:, 0:1] * b[:, 0]
            for axis in (1, 2):
                dot = _fma(p[:, axis:axis + 1], b[:, axis], dot)
            d = (p_sq[:, None] - 2.0 * dot) + b_sq[None, :]
            del dot
            vals, cols = _smallest(d, kk)
            del d
            # a distance of _BIG or more never beats JAX's initial fillers
            far = vals >= _BIG
            idx[rows, :kk] = torch.where(far, 0, b_rows[cols]).to(torch.int32)
            sqd[rows, :kk] = torch.where(far, torch.full_like(vals, _BIG), vals)
    return idx, sqd


def _ring_offsets(radius: int) -> np.ndarray:
    """The cell ring, in JAX's order (`knn.py:280-302`): the cube of ``radius`` cut to the cells within L2
    reach of the query's cell, |d|_2 <= r + sqrt(3) (all 27 at radius 1)."""
    g = np.arange(-radius, radius + 1)
    d = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    return d[np.sum(d * d, axis=1) <= (radius + np.sqrt(3.0)) ** 2].astype(np.int64)


class KnnIndex(NamedTuple):
    """The base sorted by cell code (``build_knn_index``): ``cell_cap`` rows of padding after the last."""

    code: torch.Tensor  # int64[N]: the sorted codes (sample and cell), CODE_MAX for a dropped point
    pos: torch.Tensor  # f32[N + cap, 3]: sorted positions, _BIG for a dropped point and the padding
    row: torch.Tensor  # int64[N + cap]: each sorted row's base index, 0 for the padding
    origin: torch.Tensor  # int64[3]: the cell origin (the cells are rebased to it)


def _cells(coord: torch.Tensor, cell_size: float) -> torch.Tensor:
    return torch.floor(coord * torch.tensor(1.0 / cell_size, dtype=torch.float32)).to(torch.int32).to(torch.int64)


def build_knn_index(base: torch.Tensor, cell_size: float, base_batch: Optional[torch.Tensor] = None,
                    base_valid: Optional[torch.Tensor] = None, cell_cap: int = 32, depth: int = 16) -> KnnIndex:
    """The sorted-cell index of ``base`` [N, 3] (`knn.py:208-277`)."""
    n, device = base.shape[0], base.device
    base = base.float()
    valid = torch.ones(n, dtype=torch.bool, device=device) if base_valid is None else base_valid.bool()
    batch = torch.zeros(n, dtype=torch.int64, device=device) if base_batch is None else base_batch.to(torch.int64)
    cell = _cells(base, cell_size)
    origin = torch.where(valid[:, None], cell, torch.full_like(cell, 2**20)).min(0).values - 1
    cell = cell - origin
    inside = valid & ((cell >= 0) & (cell < (1 << depth))).all(1)
    code = code_fill_invalid(code_or_batch(z_order_encode(cell.clamp(0, (1 << depth) - 1), depth), batch, depth),
                             inside)
    code, perm = torch.sort(code, stable=True)
    big = torch.full((cell_cap, 3), _BIG, dtype=torch.float32, device=device)
    pos = torch.cat([torch.where(inside[perm][:, None], base[perm], torch.full((), _BIG, device=device)), big])
    row = torch.cat([perm, torch.zeros(cell_cap, dtype=torch.int64, device=device)])
    return KnnIndex(code=code, pos=pos, row=row, origin=origin)


def knn_query_index(index: KnnIndex, query: torch.Tensor, k: int, cell_size: float,
                    query_batch: Optional[torch.Tensor] = None, cell_cap: int = 32, query_chunk: int = 8192,
                    depth: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int32[Q, k], sqdist f32[Q, k]) of each query's k nearest candidates in a built index
    (`knn.py:305-463`); ``cell_size``, ``cell_cap`` and ``depth`` as at the build.  JAX's options for the SLAM
    map (``lattice_origin``, ``ring_radius``, ``ring_corr_cells``, ``verify_codes=False``, ``single_lane``) are not
    ported: the ring is radius 1's."""
    n, q, device = index.code.shape[0], query.shape[0], query.device
    query = query.float()
    batch = torch.zeros(q, dtype=torch.int64, device=device) if query_batch is None else query_batch.to(torch.int64)
    offsets = torch.from_numpy(_ring_offsets(1)).to(device)
    ring = len(offsets)
    cell = (_cells(query, cell_size) - index.origin)[:, None, :] + offsets  # [Q, ring, 3]
    inside = ((cell >= 0) & (cell < (1 << depth))).all(-1)
    code = code_or_batch(z_order_encode(cell.clamp(0, (1 << depth) - 1).reshape(-1, 3), depth),
                         batch.repeat_interleave(ring), depth).reshape(q, ring)
    code = torch.where(inside, code, torch.full_like(code, CODE_MAX))  # out of the domain: never a live cell
    head = torch.searchsorted(index.code, code)  # the first row of the cell's run
    found = (head < n) & (index.code[head.clamp(max=max(n - 1, 0))] == code) & (code != CODE_MAX)
    head = torch.where(found, head, torch.full_like(head, n))
    steps = torch.arange(cell_cap, device=device)
    idx = torch.empty((q, k), dtype=torch.int32, device=device)
    sqd = torch.empty((q, k), dtype=torch.float32, device=device)
    codes = torch.cat([index.code, torch.full((cell_cap,), CODE_MAX, dtype=torch.int64, device=device)])
    for start in range(0, q, query_chunk):
        block = slice(start, start + query_chunk)
        rows = (head[block][:, :, None] + steps).reshape(head[block].shape[0], ring * cell_cap)
        diff = index.pos[rows] - query[block][:, None, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        same_cell = codes[rows] == code[block].repeat_interleave(cell_cap, 1)
        d = torch.where(same_cell, d, torch.full((), _BIG, device=device))
        vals, cols = _smallest(d, k)
        cand = index.row[rows].gather(1, cols)
        idx[block] = torch.where(vals < _BIG, cand, cand[:, :1]).to(torch.int32)
        sqd[block] = vals
    return idx, sqd


def knn_bucketed(query: torch.Tensor, base: torch.Tensor, k: int, cell_size: float,
                 query_batch: Optional[torch.Tensor] = None, base_batch: Optional[torch.Tensor] = None,
                 base_valid: Optional[torch.Tensor] = None, cell_cap: int = 32, query_chunk: int = 8192,
                 depth: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-bucketed k-NN, (idx int32[Q, k], sqdist f32[Q, k]): exact where each query's k-th neighbour lies
    within L-inf ``cell_size`` and no inspected cell holds more than ``cell_cap`` points; a missing slot has
    ``sqdist`` >= ``_BIG`` and the nearest candidate's index."""
    index = build_knn_index(base, cell_size, base_batch, base_valid, cell_cap, depth)
    return knn_query_index(index, query, k, cell_size, query_batch, cell_cap, query_chunk, depth)


def three_nn_interpolate(
    query: torch.Tensor,  # [Q, 3] target positions
    base: torch.Tensor,  # [N, 3] source positions
    feat: torch.Tensor,  # [N, C] source features
    query_batch: Optional[torch.Tensor] = None,
    base_batch: Optional[torch.Tensor] = None,
    base_valid: Optional[torch.Tensor] = None,
    cell_size: float = 0.0,
    cell_cap: int = 64,
) -> torch.Tensor:
    """Inverse-squared-distance weighted mean of the features of each query's 3 nearest valid base
    points of its sample, [Q, C] (by ``knn_bucketed`` where ``cell_size`` > 0).  A missing neighbour is
    the search's filler at a distance of at least 1e10, a weight of ~0."""
    if cell_size > 0:
        idx, sqdist = knn_bucketed(query, base, 3, cell_size, query_batch, base_batch, base_valid, cell_cap)
    else:
        idx, sqdist = knn(query, base, 3, query_batch, base_batch, base_valid)
    inv = 1.0 / sqdist.clamp_min(1e-8)
    w = inv / inv.sum(-1, keepdim=True)
    return (feat[idx.long()] * w[..., None]).sum(1)
