"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both the JAX package and
the port.  Torch runs on one thread: the suite runs several xdist workers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

torch.set_num_threads(1)


def slotted_scene(rng: np.random.Generator, num_samples: int, slot: int, n_valid: int, span: int) -> Dict:
    """``num_samples`` slots of ``n_valid`` unique voxels in [0, span)^3, pads last in each slot."""
    grid = np.zeros((num_samples * slot, 3), np.int32)
    valid = np.zeros(num_samples * slot, bool)
    for b in range(num_samples):
        cells = rng.choice(span**3, n_valid, replace=False)
        g = np.stack(np.unravel_index(cells, (span,) * 3), 1)
        grid[b * slot : b * slot + n_valid] = g
        valid[b * slot : b * slot + n_valid] = True
    coord = (grid + rng.uniform(0, 1, grid.shape)).astype(np.float32) * 0.05
    return dict(grid_coord=grid, valid=valid, coord=coord, batch=np.repeat(np.arange(num_samples), slot))


def jax_variables_like(shapes, rng: np.random.Generator) -> Dict:
    """Seeded numpy values for a flax variable tree of ``jax.eval_shape`` leaves."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, leaf in flatten_dict(tree).items():
            name = path[-1]
            if name == "var":
                a = rng.uniform(0.5, 1.5, leaf.shape)
            elif name == "mean":
                a = 0.1 * rng.normal(size=leaf.shape)
            elif name == "scale":
                a = 1.0 + 0.1 * rng.normal(size=leaf.shape)
            elif name == "bias":
                a = 0.05 * rng.normal(size=leaf.shape)
            elif name == "kernel":
                a = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-2])
            else:  # sparse-conv weights
                a = 0.05 * rng.normal(size=leaf.shape)
            flat[path] = a.astype(np.float32)
        out[col] = unflatten_dict(flat)
    return out
