"""Farthest point sampling: the port's ``farthest_point_sampling``
(``pointcept_keypointdetection_tpu/ops/sampling.py:17-41``), PT-v1's down-sampling.

Round ``i`` takes the point whose squared distance to the nearest point
picked so far is the largest, ties to the first index (``jnp.argmax``).  The
distances are the per-axis squared differences summed in f32, x then y then
z.  An invalid point carries a -inf penalty, so it is never picked; where a
sample has fewer valid points than picks, the remaining rounds pick the
first valid point of largest distance 0 again and again, as JAX does.  The
first pick is ``start_idx`` whatever that row holds, a pad included.

``farthest_point_sampling_batched`` runs JAX's ``vmap`` of it over the
samples of a slotted batch (`point_transformer.py:101`) as one loop of
rounds over all samples at once.  It stays plain torch: each round is a few
small launches, so ``num_samples`` rounds are that many host round trips.
"""

from __future__ import annotations

from typing import Optional

import torch


def farthest_point_sampling_batched(coord: torch.Tensor, num_samples: int, valid: Optional[torch.Tensor] = None,
                                    start_idx: int = 0) -> torch.Tensor:
    """coord [B, N, 3], valid bool [B, N] -> int64 [B, num_samples]: each sample's picks, in pick order."""
    b, n, _ = coord.shape
    coord = coord.float()
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=coord.device)
    penalty = torch.where(valid, 0.0, float("-inf")).to(torch.float32)
    selected = torch.zeros((b, num_samples), dtype=torch.int64, device=coord.device)
    selected[:, 0] = start_idx
    min_d = torch.full((b, n), float("inf"), dtype=torch.float32, device=coord.device)
    rows = torch.arange(b, device=coord.device)
    for i in range(1, num_samples):
        diff = coord - coord[rows, selected[:, i - 1]][:, None, :]
        sq = diff * diff
        min_d = torch.minimum(min_d, (sq[..., 0] + sq[..., 1]) + sq[..., 2])
        selected[:, i] = torch.argmax(min_d + penalty, dim=1)
    return selected


def farthest_point_sampling(coord: torch.Tensor, num_samples: int, valid: Optional[torch.Tensor] = None,
                            start_idx: int = 0) -> torch.Tensor:
    """coord [N, 3] -> int32 [num_samples] indices of one cloud, as JAX returns them."""
    picks = farthest_point_sampling_batched(coord[None], num_samples, None if valid is None else valid[None],
                                            start_idx)
    return picks[0].to(torch.int32)
