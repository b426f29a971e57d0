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

``three_nn_interpolate`` (`knn.py:531-558`, Swin3D's up-sampling) is the
brute-force path over ``knn``: weights 1 / max(d^2, 1e-8), normalized.  Not
ported: ``knn_bucketed`` (and so ``cell_size`` > 0), ``ball_query`` and the
index builders.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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


def three_nn_interpolate(
    query: torch.Tensor,  # [Q, 3] target positions
    base: torch.Tensor,  # [N, 3] source positions
    feat: torch.Tensor,  # [N, C] source features
    query_batch: Optional[torch.Tensor] = None,
    base_batch: Optional[torch.Tensor] = None,
    base_valid: Optional[torch.Tensor] = None,
    cell_size: float = 0.0,
) -> torch.Tensor:
    """Inverse-squared-distance weighted mean of the features of each query's 3 nearest valid base
    points of its sample, [Q, C].  A missing neighbour (a sample with fewer than 3 valid base points)
    is JAX's filler: row 0 at distance 1e10, a weight of ~0."""
    if cell_size > 0:
        raise NotImplementedError("three_nn_interpolate: cell_size > 0 needs knn_bucketed, not ported yet "
                                  "(ROADMAP.md queue A item 1, with PT-v2m2)")
    idx, sqdist = knn(query, base, 3, query_batch, base_batch, base_valid)
    inv = 1.0 / sqdist.clamp_min(1e-8)
    w = inv / inv.sum(-1, keepdim=True)
    return (feat[idx.long()] * w[..., None]).sum(1)
