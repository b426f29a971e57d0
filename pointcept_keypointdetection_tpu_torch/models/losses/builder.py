"""Criteria builder: a weighted sum of registered losses (the port's copy of
``pointcept_keypointdetection_tpu/models/losses/builder.py``).

``Criteria`` sums each configured loss applied to (pred, target); every loss
takes the ``valid`` mask of the padded slots.  A loss type that is not
ported raises at construction.
"""

from __future__ import annotations

from ...utils.registry import Registry

LOSSES = Registry("losses")


class Criteria:
    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        if not isinstance(self.cfg, (list, tuple)):
            self.cfg = [self.cfg]
        self.criteria = []
        for c in self.cfg:
            if c["type"] not in LOSSES:
                raise NotImplementedError(f"loss {c['type']} is not ported yet")
            self.criteria.append(LOSSES.build(dict(c)))

    def __call__(self, pred, target, valid=None):
        if not self.criteria:
            return pred
        total = 0.0
        for crit in self.criteria:
            total = total + crit(pred, target, valid=valid)
        return total


def build_criteria(cfg):
    return Criteria(cfg)
