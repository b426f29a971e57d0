"""Connected components over point neighbourhoods: the port's ``connected_components``
(``pointcept_keypointdetection_tpu/ops/cluster.py:21-61``).

Min-label propagation over the in-radius, same-class, valid kNN graph, with
pointer jumping, until no label changes or after ``max_iters`` + 1 rounds, as
JAX's ``lax.while_loop`` runs it: each round's test is one host read.  The
labels are JAX's exactly: the min point index of each component.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .knn import knn


def connected_components(
    coord: torch.Tensor,  # [N, 3]
    classes: torch.Tensor,  # int[N] semantic class per point
    valid: torch.Tensor,  # bool[N]
    radius: float,
    k: int = 16,
    batch: Optional[torch.Tensor] = None,
    ignore_classes: Tuple[int, ...] = (),
    max_iters: int = 64,
) -> torch.Tensor:
    """int32[N] component labels (min point index per component); invalid and ignored points get -1."""
    n, device = coord.shape[0], coord.device
    valid = valid.bool()
    # an invalid row connects to nothing, so only the valid rows' neighbourhoods are searched
    rows = valid.nonzero().squeeze(1)
    idx_v, sqd_v = knn(coord[rows], coord, k, query_batch=None if batch is None else batch[rows], base_batch=batch,
                       base_valid=valid)
    idx = torch.zeros((n, k), dtype=torch.int64, device=device)
    sqd = torch.full((n, k), float("inf"), dtype=torch.float32, device=device)
    idx[rows], sqd[rows] = idx_v.long(), sqd_v
    connect = (sqd <= radius * radius) & (classes[idx] == classes[:, None]) & valid[:, None] & valid[idx]
    active = valid.clone()
    for c in ignore_classes:
        active &= classes != c
    connect &= active[:, None]

    iota = torch.arange(n, dtype=torch.int32, device=device)
    labels = torch.where(active, iota, n)
    it = 0
    while True:
        nbr_labels = torch.where(connect, labels[idx], n)
        new = torch.minimum(labels, nbr_labels.min(1).values)
        # pointer jumping: label <- label[label]
        new = torch.where(new < n, new[new.clamp(max=n - 1).long()], new)
        changed = bool((new != labels).any()) and it < max_iters
        labels, it = new, it + 1
        if not changed:
            break
    return torch.where(labels < n, labels, -1).to(torch.int32)
