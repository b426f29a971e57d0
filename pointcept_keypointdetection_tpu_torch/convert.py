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
  ``SubMConv_1`` are ``conv1`` / ``conv2`` and ``Dense_0`` is ``proj``;
* OctFormer-v1m1 and Swin3D-v1m1 (``models/octformer.py``, ``models/swin3d.py``):
  ``OctFormer_0`` / ``Swin3DUNet_0`` is ``backbone`` and every module inside
  keeps its flax name: ``embed``, ``stage{s}_block{i}.{cpe, norm1, attn.qkv,
  attn.proj, norm2, mlp1, mlp2}``, ``down{s}.proj``, OctFormer's
  ``up{s}_{proj, skip, norm}``; Swin3D's ``embed_norm`` (with its
  ``batch_stats``), the cRSE tables ``attn.{xyz, rgb, norm}_{q, k, v}_table``,
  ``down{s}.norm``, ``up{s}.{proj, proj_skip, norm}`` and ``dec{s}_block``.
  The CPE's ``weight`` [27, C, C] keeps the JAX layout and its ``bias`` its name.
* OA-CNNs, PT-v2m2, PT-v1 and ST-v1m2 (``models/oacnns.py``,
  ``models/point_transformer_v2.py``, ``models/point_transformer.py``,
  ``models/stratified_transformer.py``): ``OACNNs_0``,
  ``PointTransformerV2_0``, ``PointTransformerV1_0`` and
  ``StratifiedTransformer_0`` are ``backbone``, and every explicit flax name
  stays.  flax's call-order names inside a block take the port's, by
  backbone: an OA-CNNs ``enc{s}_block{i}`` / ``dec{s}_block``'s
  ``SubMConv_0``, ``SubMConv_1``, ``Dense_0`` are ``conv1``, ``conv2``,
  ``proj``; a PT-v1 ``enc{s}_block{i}`` / ``dec{s}_block``'s ``Dense_0``,
  ``MaskedBatchNorm_0``, ``VectorAttentionLayer_0``, ``MaskedBatchNorm_1``,
  ``Dense_1``, ``MaskedBatchNorm_2``, ``Dense_2`` are ``fc1``, ``norm1``,
  ``attn``, ``norm2``, ``fc3``, ``norm3``, ``proj``, its ``enc{s}_down``'s
  ``Dense_0``, ``MaskedBatchNorm_0`` are ``fc``, ``norm`` and its
  ``dec{s}_up``'s ``Dense_0``, ``MaskedBatchNorm_0``, ``Dense_1``,
  ``MaskedBatchNorm_1`` are ``fc1``, ``norm1``, ``fc2``, ``norm2``.  The
  KPConv stem's ``weight`` [15, Cin, Cout] keeps the JAX layout.
* MinkUNet and SPVCNN (``models/mink_unet.py``, ``models/spvcnn.py``, in
  ``DefaultSegmentor``): ``MinkUNet_0`` and ``SPVCNN_0`` are ``backbone``,
  and every explicit flax name stays (MinkUNet's ``conv0``, ``bn0``,
  ``conv{s}s2``, ``bn{s}``, ``block{s}_{i}``, ``convtr{k}``, ``bntr{k}``,
  ``final``, a ``Bottleneck``'s ``conv1``-``conv3``, ``norm1``-``norm3``,
  ``proj``, ``norm_proj``; SPVCNN's ``point_stem``, ``voxel_stem``,
  ``down{s}``, ``enc{s}_block{i}``, ``up{s}``, ``dec{s}_block``,
  ``point_tf{i}``, ``head`` and their norms).  A ``BasicBlock``'s
  ``SubMConv_0``, ``SubMConv_1``, ``Dense_0`` (MinkUNet's ``block{s}_{i}``,
  SPVCNN's ``enc{s}_block{i}`` / ``dec{s}_block``) are ``conv1``, ``conv2``,
  ``proj``.

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
_BACKBONES = ("PointTransformerV3_0", "SpUNet_0", "OctFormer_0", "Swin3DUNet_0", "OACNNs_0", "PointTransformerV2_0",
              "PointTransformerV1_0", "StratifiedTransformer_0", "MinkUNet_0", "SPVCNN_0")
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
_BLOCK = r"^(enc\d+_block\d+|dec\d+_block)$"
# (backbone, parent pattern, {flax child name: the port's}): call-order names inside one backbone's blocks
_BASIC_BLOCK = {"SubMConv_0": "conv1", "SubMConv_1": "conv2", "Dense_0": "proj"}
_IN_BACKBONE = tuple((backbone, re.compile(parent), names) for backbone, parent, names in (
    ("OACNNs_0", _BLOCK, _BASIC_BLOCK),
    ("MinkUNet_0", r"^block\d+_\d+$", _BASIC_BLOCK),
    ("SPVCNN_0", _BLOCK, _BASIC_BLOCK),
    ("PointTransformerV1_0", _BLOCK, {"Dense_0": "fc1", "MaskedBatchNorm_0": "norm1", "VectorAttentionLayer_0": "attn",
                                      "MaskedBatchNorm_1": "norm2", "Dense_1": "fc3", "MaskedBatchNorm_2": "norm3",
                                      "Dense_2": "proj"}),
    ("PointTransformerV1_0", r"^enc\d+_down$", {"Dense_0": "fc", "MaskedBatchNorm_0": "norm"}),
    ("PointTransformerV1_0", r"^dec\d+_up$", {"Dense_0": "fc1", "MaskedBatchNorm_0": "norm1", "Dense_1": "fc2",
                                               "MaskedBatchNorm_1": "norm2"}),
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
    backbone = next((part for part in path if part in _BACKBONES), None)
    for i, part in enumerate(path):
        parent = path[i - 1] if i > 0 else None
        numbered = [child.sub(name, part) for pattern, child, name in _NUMBERED
                    if parent is not None and pattern.match(parent) and child.match(part)]
        numbered += [names[part] for owner, pattern, names in _IN_BACKBONE
                     if owner == backbone and parent is not None and pattern.match(parent) and part in names]
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
