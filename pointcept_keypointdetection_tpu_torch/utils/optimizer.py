"""Optimizer construction and gradient clipping.

Counterparts of ``pointcept_keypointdetection_tpu/utils/optimizer.py``
(optax) for the repo's training configs: AdamW over every parameter, and
``clip_grad`` as optax's ``clip_by_global_norm``.

``torch.optim.AdamW`` computes what ``optax.adamw(lr, b1, b2, eps=1e-8,
weight_decay)`` computes: with bias-corrected moments m^ and v^, the update
is -lr * (m^ / (sqrt(v^) + eps) + weight_decay * param), eps outside the
square root and the decay on every parameter (optax's default mask is none),
so one parameter group holds them all.  The learning rate of a step is the
schedule at the number of steps taken before it, set by the trainer.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch


def build_optimizer(cfg: Dict[str, Any], params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    cfg = dict(cfg)
    opt_type = cfg.pop("type")
    for key in ("param_dicts", "freeze_all_except"):
        if cfg.pop(key, None):
            raise NotImplementedError(f"optimizer {key} is not ported yet")
    lr = cfg.pop("lr", 1e-3)
    if opt_type != "AdamW":
        raise NotImplementedError(f"optimizer {opt_type} is not ported yet (AdamW is)")
    betas = tuple(cfg.pop("betas", (0.9, 0.999)))
    weight_decay = cfg.pop("weight_decay", 0.0)
    if cfg:
        raise TypeError(f"AdamW: unknown options {sorted(cfg)}")
    return torch.optim.AdamW(list(params), lr=lr, betas=betas, eps=1e-8, weight_decay=weight_decay)


@torch.no_grad()
def clip_grad(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as ``optax.clip_by_global_norm``: unchanged
    while the global norm is below ``max_norm``, else g / norm * max_norm (no
    1e-6 term, unlike ``torch.nn.utils.clip_grad_norm_``).  Returns the norm.
    The choice is made on the device, so the host does not wait for the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm
