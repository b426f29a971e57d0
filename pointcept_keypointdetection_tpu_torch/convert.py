"""JAX/flax variables -> the port's ``state_dict``.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (what ``flax`` holds, or a checkpoint reader returns).  The rules:

* a Dense ``kernel`` [in, out] becomes a Linear ``weight`` [out, in];
* a norm's ``scale`` becomes ``weight``; BN ``mean`` / ``var`` become the
  ``running_mean`` / ``running_var`` buffers;
* sparse-conv weights [K, Cin, Cout] (``weight``, ``stem_weight``) keep the
  JAX layout;
* ``nn.scan`` stacks (``enc{s}_blocks/blocks/...``, ``dec{s}_blocks/...``,
  `point_transformer_v3.py:266-279`) split along their leading depth axis
  into ``enc{s}_block{i}``;
* flax's automatic names map to the port's: the backbone
  ``PointTransformerV3_0`` is ``backbone``, the head's ``Dense_{i}`` is
  ``head.{2i}``, the xCPE's ``Dense_0`` / ``LayerNorm_0`` are ``linear`` /
  ``norm``, the MLP's ``Dense_0`` / ``Dense_1`` are ``fc1`` / ``fc2``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_SCAN = re.compile(r"^(enc|dec)(\d+)_blocks$")
_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_PARENT_RENAMES = {
    ("cpe", "Dense_0"): "linear",
    ("cpe", "LayerNorm_0"): "norm",
    ("mlp", "Dense_0"): "fc1",
    ("mlp", "Dense_1"): "fc2",
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _unstack(path: Tuple[str, ...], value: np.ndarray):
    """Split ``*_blocks/blocks/...`` stacks into one entry per block."""
    for i, part in enumerate(path):
        match = _SCAN.match(part)
        if match and i + 1 < len(path) and path[i + 1] == "blocks":
            head, rest = path[:i], path[i + 2:]
            for depth in range(value.shape[0]):
                yield head + (f"{match.group(1)}{match.group(2)}_block{depth}",) + rest, value[depth]
            return
    yield path, value


def _rename(path: Tuple[str, ...]) -> Tuple[str, ...]:
    out = []
    for i, part in enumerate(path):
        if part == "PointTransformerV3_0":
            part = "backbone"
        elif i == 0 and part.startswith("Dense_"):
            part = f"head.{2 * int(part.split('_')[1])}"
        elif i > 0 and (path[i - 1], part) in _PARENT_RENAMES:
            part = _PARENT_RENAMES[(path[i - 1], part)]
        out.append(part)
    out[-1] = _LEAF.get(out[-1], out[-1])
    return tuple(out)


def convert_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> a ``state_dict`` for the port's model."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            for split_path, leaf in _unstack(path, value):
                if split_path[-1] == "kernel":
                    leaf = leaf.T  # Dense [in, out] -> Linear [out, in]
                name = ".".join(_rename(split_path))
                state[name] = torch.from_numpy(np.ascontiguousarray(leaf, dtype=np.float32))
    return state
