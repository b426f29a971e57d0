"""Per-iteration learning-rate schedules.

Counterpart of ``pointcept_keypointdetection_tpu/utils/scheduler.py`` for the
repo's training configs: a schedule is a function of the step (the number of
optimizer steps taken before it) to the learning rate, built with the total
step count the trainer computes.
"""

from __future__ import annotations

import math
from typing import Callable

from .registry import Registry

SCHEDULERS = Registry("schedulers")


@SCHEDULERS.register_module()
def CosineAnnealingLR(total_steps: int, base_lr: float, eta_min: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(base_lr, total_steps, alpha=eta_min / base_lr)``
    (`scheduler.py:69-71`): step 0 takes the full rate, step >= total_steps eta_min."""
    if total_steps <= 0:
        raise ValueError(f"CosineAnnealingLR needs total_steps > 0, got {total_steps}")
    alpha = eta_min / max(base_lr, 1e-12)

    def schedule(step: int) -> float:
        frac = min(step, total_steps) / total_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def build_scheduler(cfg, total_steps: int, base_lr: float) -> Callable[[int], float]:
    cfg = dict(cfg)
    name = cfg.pop("type")
    fn = SCHEDULERS.get(name)
    if fn is None:
        raise NotImplementedError(f"scheduler {name} is not ported yet")
    return fn(total_steps=total_steps, base_lr=base_lr, **cfg)
