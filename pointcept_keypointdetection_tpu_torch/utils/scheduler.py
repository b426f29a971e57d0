"""Per-iteration learning-rate schedules.

Counterpart of ``pointcept_keypointdetection_tpu/utils/scheduler.py`` for the
repo's training configs: a schedule is a function of the step (the number of
optimizer steps taken before it) to the learning rate, built with the total
step count the trainer computes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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


@SCHEDULERS.register_module()
def PolyLR(total_steps: int, base_lr: float, power: float = 0.9) -> Callable[[int], float]:
    """base_lr * clip(1 - step / (total_steps + 1), 0, 1) ** power (`scheduler.py:51-61`: the
    reference's formula, not ``optax.polynomial_schedule``'s division by total_steps)."""

    def schedule(step: int) -> float:
        return base_lr * min(max(1.0 - step / (total_steps + 1), 0.0), 1.0) ** power

    return schedule


@SCHEDULERS.register_module()
def OneCycleLR(total_steps: int, base_lr: float, max_lr: Optional[float] = None, pct_start: float = 0.3,
               div_factor: float = 25.0, final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule(total_steps, max_lr, pct_start, div_factor,
    final_div_factor)`` (`scheduler.py:74-96`), ``max_lr`` defaulting to the optimizer's
    rate: from max_lr / div_factor up to max_lr over the first int(pct_start * total_steps)
    steps, then down to max_lr / (div_factor * final_div_factor) at total_steps, each
    phase a half cosine, and that last rate from then on.  Not
    ``torch.optim.lr_scheduler.OneCycleLR``, whose phases end a step apart from these
    and whose last rate is another.  Where either phase has no steps, optax's schedule
    is NaN at every step (0 / 0): this one raises."""
    peak = base_lr if max_lr is None else max_lr
    warmup = int(pct_start * total_steps)
    if not 0 < warmup < total_steps:
        raise ValueError(f"OneCycleLR needs 0 < int(pct_start * total_steps) < total_steps, got "
                         f"pct_start={pct_start}, total_steps={total_steps}")
    bounds = (0, warmup, total_steps)
    init = peak / div_factor
    values = (init, init * div_factor, init * div_factor * (1.0 / (div_factor * final_div_factor)))  # optax's cumprod

    def schedule(step: int) -> float:
        if step >= bounds[2]:
            return values[2]
        i = 0 if step < bounds[1] else 1
        pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
        start, end = values[i], values[i + 1]
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    return schedule


def build_scheduler(cfg, total_steps: int, base_lr: float) -> Callable[[int], float]:
    cfg = dict(cfg)
    name = cfg.pop("type")
    fn = SCHEDULERS.get(name)
    if fn is None:
        raise NotImplementedError(f"scheduler {name} is not ported yet")
    return fn(total_steps=total_steps, base_lr=base_lr, **cfg)
