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
  ``PointTransformerV3_0`` is ``backbone`` (in ``OffsetKeypointPTv3`` and
  in ``DefaultSegmentorV2``, whose ``seg_head`` keeps its name), the head's ``Dense_{i}`` is
  ``head.{2i}`` (the keypoint heads', ``PigBodyRegressor``'s beside its
  ``cls_head``), ``KeypointModel``'s ``MaskedBatchNorm_0`` (with its
  ``batch_stats``) is ``head.1``, the xCPE's ``Dense_0`` / ``LayerNorm_0`` are
  ``linear`` / ``norm`` (PT-v3plus's bottleneck ``down``, ``weight``, ``bias``
  and ``up`` keep their names), the MLP's ``Dense_0`` / ``Dense_1`` are
  ``fc1`` / ``fc2``;
* SpUNet (``models/sparse_unet.py``, in ``DefaultSegmentor``): ``SpUNet_0``
  is ``backbone``, and the names flax numbers in call order become list
  entries of the same number: its ``SubMConv_0`` is ``stem``,
  ``MaskedBatchNorm_{i}`` ``norms.{i}``, ``StridedConvDown_{i}``
  ``downs.{i}``, ``InverseConvUp_{i}`` ``ups.{i}``, ``BasicBlock_{i}``
  ``blocks.{i}`` and ``Dense_0`` ``head``; in a block ``SubMConv_0`` /
  ``SubMConv_1`` are ``conv1`` / ``conv2`` and ``Dense_0`` is ``proj``.

``load_jax_checkpoint`` reads a flax-msgpack checkpoint of the JAX package
(``utils/checkpoint.py``, no ``msgpack`` package needed) and converts its
``params`` and ``batch_stats``; ``load_weights`` takes that, a checkpoint of
the port's trainer or a bare ``state_dict``, and tells them apart by content.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from .utils.checkpoint import CheckpointError, load_checkpoint

_SCAN = re.compile(r"^(enc|dec)(\d+)_blocks$")
_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_PARENT_RENAMES = {
    ("cpe", "Dense_0"): "linear",
    ("cpe", "LayerNorm_0"): "norm",
    ("mlp", "Dense_0"): "fc1",
    ("mlp", "Dense_1"): "fc2",
}
_BACKBONES = ("PointTransformerV3_0", "SpUNet_0")
# (parent pattern, child pattern, the port's name): SpUNet's call-order names
_NUMBERED = tuple((re.compile(parent), re.compile(child), name) for parent, child, name in (
    (r"^SpUNet_0$", r"^SubMConv_0$", "stem"),
    (r"^SpUNet_0$", r"^MaskedBatchNorm_(\d+)$", r"norms.\1"),
    (r"^SpUNet_0$", r"^StridedConvDown_(\d+)$", r"downs.\1"),
    (r"^SpUNet_0$", r"^InverseConvUp_(\d+)$", r"ups.\1"),
    (r"^SpUNet_0$", r"^BasicBlock_(\d+)$", r"blocks.\1"),
    (r"^SpUNet_0$", r"^Dense_0$", "head"),
    (r"^BasicBlock_\d+$", r"^SubMConv_0$", "conv1"),
    (r"^BasicBlock_\d+$", r"^SubMConv_1$", "conv2"),
    (r"^BasicBlock_\d+$", r"^Dense_0$", "proj"),
))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            # a bfloat16 leaf reads as a torch tensor (utils/checkpoint.py); the state_dict is f32
            yield prefix + (str(key),), value.float().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


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
        parent = path[i - 1] if i > 0 else None
        numbered = [child.sub(name, part) for pattern, child, name in _NUMBERED
                    if parent is not None and pattern.match(parent) and child.match(part)]
        if part in _BACKBONES:
            part = "backbone"
        elif i == 0 and part.startswith("Dense_"):
            part = f"head.{2 * int(part.split('_')[1])}"
        elif i == 0 and part == "MaskedBatchNorm_0":  # KeypointModel's norm, between its Dense_0 and Dense_1
            part = "head.1"
        elif (parent, part) in _PARENT_RENAMES:
            part = _PARENT_RENAMES[(parent, part)]
        elif numbered:
            part = numbered[0]
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


def load_jax_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a JAX checkpoint (``*.ckpt``, flax msgpack): its ``params``
    and ``batch_stats``; other top-level entries (``epoch``, ``opt_state``, ...) are ignored."""
    tree = load_checkpoint(path)
    if not isinstance(tree, Mapping) or not isinstance(tree.get("params"), Mapping):
        raise CheckpointError(f"{path}: a flax checkpoint with no params map")
    return convert_variables({"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}})


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from ``path``, which holds one of: a JAX
    checkpoint (flax msgpack: ``tools/serve.py --weight``, ``CheckpointLoader``'s ``weight``),
    a checkpoint of the port's trainer (``torch.save`` of a dict whose ``model`` entry is the
    state_dict) or a bare state_dict saved with ``torch.save``.  Told apart by content, not by
    the file's name: ``torch.save`` writes a zip archive, flax one msgpack map."""
    with open(path, "rb") as f:
        zipped = f.read(4) == b"PK\x03\x04"
    if not zipped:
        return load_jax_checkpoint(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, Mapping) and isinstance(payload.get("model"), Mapping):
        payload = payload["model"]  # the port trainer's checkpoint (``CheckpointSaver``)
    if not (isinstance(payload, Mapping) and all(isinstance(v, torch.Tensor) for v in payload.values())):
        raise ValueError(f"{path}: neither a state_dict nor a checkpoint with a 'model' state_dict")
    return dict(payload)
