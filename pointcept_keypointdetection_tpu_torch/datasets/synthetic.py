"""Seeded synthetic point clouds for smoke runs and tests."""

from __future__ import annotations

import numpy as np


def body_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """A pig-like closed surface in mm, float32 [n, 3]: ellipsoid trunk
    (1.2 x 0.5 x 0.6 m), head, four legs, 2 mm noise."""
    parts = []
    n_trunk, n_head = n * 6 // 10, n // 10
    th = np.arccos(rng.uniform(-1, 1, n_trunk))
    ph = rng.uniform(0, 2 * np.pi, n_trunk)
    parts.append(np.stack([600 * np.sin(th) * np.cos(ph), 250 * np.sin(th) * np.sin(ph), 300 * np.cos(th)], 1))
    th = np.arccos(rng.uniform(-1, 1, n_head))
    ph = rng.uniform(0, 2 * np.pi, n_head)
    parts.append(np.stack([700 + 150 * np.sin(th) * np.cos(ph), 120 * np.sin(th) * np.sin(ph),
                           100 + 130 * np.cos(th)], 1))
    rest = n - n_trunk - n_head
    for i, (x, y) in enumerate([(-350, -120), (-350, 120), (350, -120), (350, 120)]):
        m = rest // 4 if i < 3 else rest - 3 * (rest // 4)
        a = rng.uniform(0, 2 * np.pi, m)
        parts.append(np.stack([x + 60 * np.cos(a), y + 60 * np.sin(a), rng.uniform(-700, -250, m)], 1))
    return (np.concatenate(parts) + rng.normal(0, 2, (n, 3))).astype(np.float32)
