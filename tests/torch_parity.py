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


def _seeded_leaf(name: str, shape, rng: np.random.Generator) -> np.ndarray:
    if name == "var":
        a = rng.uniform(0.5, 1.5, shape)
    elif name == "mean":
        a = 0.1 * rng.normal(size=shape)
    elif name == "scale":
        a = 1.0 + 0.1 * rng.normal(size=shape)
    elif name == "bias":
        a = 0.05 * rng.normal(size=shape)
    elif name == "kernel":
        a = rng.normal(size=shape) / np.sqrt(shape[-2])
    else:  # sparse-conv weights
        a = 0.05 * rng.normal(size=shape)
    return a.astype(np.float32)


def jax_variables_like(shapes, rng: np.random.Generator) -> Dict:
    """Seeded numpy values for a flax variable tree of ``jax.eval_shape`` leaves."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    return {col: unflatten_dict({path: _seeded_leaf(path[-1], leaf.shape, rng)
                                 for path, leaf in flatten_dict(tree).items()})
            for col, tree in shapes.items()}


_FLAX_PARENTS = {("cpe", "linear"): "Dense_0", ("cpe", "norm"): "LayerNorm_0", ("mlp", "fc1"): "Dense_0",
                 ("mlp", "fc2"): "Dense_1"}


def jax_variables_for(model: torch.nn.Module, rng: np.random.Generator) -> Dict:
    """Seeded flax variables for the port's OffsetKeypoint PT-v3m1 ``model``,
    named as the JAX model names them, without tracing it.  Only for
    configs whose stages have one Block each (no ``nn.scan`` stacks);
    ``convert.py`` maps the result back onto the model's names."""
    from flax.traverse_util import unflatten_dict

    linears = {name for name, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    flat = {}
    for name, tensor in list(model.named_parameters()) + list(model.named_buffers()):
        *parents, leaf = name.split(".")
        if parents[0] == "head":
            path = [f"Dense_{int(parents[1]) // 2}"]
        else:  # backbone.<...>
            path = ["PointTransformerV3_0"] + [_FLAX_PARENTS.get(pair, pair[1]) for pair in zip(parents, parents[1:])]
        shape = tuple(tensor.shape)
        if ".".join(parents) in linears and leaf == "weight":
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight" and tensor.dim() == 1:
            leaf = "scale"
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        flat[(col, *path, leaf)] = _seeded_leaf(leaf, shape, rng)
    return unflatten_dict(flat)
