"""Offset-keypoint inference on a raw cloud: preprocessing, forward, aggregation.

Counterpart of ``OffsetKeypointPredictor`` in ``pointcept_keypointdetection_
tpu/inference/keypoint.py:92-180``, with the same preprocessing: normalize
to the unit sphere, voxelize at ``grid_size`` keeping the first point of
each voxel, prefix normalized coords to the features when the backbone
expects ``in_channels = feat width + 3``, and subsample deterministically
above ``slot_size`` before padding, so that the rows of the returned coords
stay aligned with the model's per-row outputs.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from scipy.special import expit

from ..datasets.collate import collate
from ..engines.common import build_point_batch, sample_to_device
from ..models import build_model, init_weights
from ..ops.serialization import z_order_encode_np


def aggregate_keypoints(
    coord: np.ndarray,  # [N, 3] normalized coords of the valid rows
    offset_pred: np.ndarray,  # [N, K, 3]
    mask_prob: np.ndarray,  # [N, K]
    method: str = "argmax",
    threshold: float = 0.5,
) -> np.ndarray:
    """Per-keypoint candidate aggregation (`infer_offset.py:573-597`).

    argmax: the best-confidence point's candidate.  weighted: the
    confidence-weighted mean of the candidates above ``threshold`` (argmax
    when none passes)."""
    _, k, _ = offset_pred.shape
    candidates = coord[:, None, :] + offset_pred
    out = np.zeros((k, 3), np.float32)
    for ki in range(k):
        conf = mask_prob[:, ki]
        if method == "argmax":
            out[ki] = candidates[int(conf.argmax()), ki]
        elif method == "weighted":
            sel = conf > threshold
            if not sel.any():
                out[ki] = candidates[int(conf.argmax()), ki]
            else:
                w = conf[sel]
                out[ki] = (candidates[sel, ki] * w[:, None]).sum(0) / w.sum()
        else:
            raise ValueError(method)
    return out


def estimate_normals_curvature(coord: np.ndarray, k: int = 16) -> np.ndarray:
    """PCA normals + curvature over the k nearest neighbours -> [N, 4]."""
    from scipy.spatial import cKDTree

    tree = cKDTree(coord)
    _, idx = tree.query(coord, k=min(k, len(coord)))
    nbrs = coord[idx]
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / idx.shape[1]
    eigvals, eigvecs = np.linalg.eigh(cov)
    normals = eigvecs[:, :, 0]
    curvature = eigvals[:, 0] / np.maximum(eigvals.sum(axis=1), 1e-12)
    return np.concatenate([normals, curvature[:, None]], axis=1).astype(np.float32)


def normalize_cloud(coord: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    centroid = coord.mean(axis=0)
    coord = coord - centroid
    scale = float(np.sqrt((coord**2).sum(axis=1)).max())
    scale = scale if scale > 1e-6 else 1.0
    return (coord / scale).astype(np.float32), centroid.astype(np.float32), scale


class OffsetKeypointPredictor:
    """End-to-end offset-keypoint prediction on a raw cloud (mm or m units).

    ``state_dict``: weights in the port's layout (see ``convert.py``); without
    it the weights are seeded from ``generator`` (seed 0 by default).  The
    model runs on ``device``; the default, CUDA, raises where there is none.
    """

    def __init__(
        self,
        model_cfg: Dict,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        slot_size: int = 8192,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OffsetKeypointPredictor: device is cuda but no CUDA device is available")
        self._model_cfg = dict(model_cfg)
        model = build_model(dict(model_cfg))
        if state_dict is None:
            init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.slot_size = slot_size
        self._lock = threading.Lock()  # one forward at a time (the server is threaded)

    def _expects_coord_feat(self, feat_width: int) -> bool:
        bb = self._model_cfg.get("backbone_conf") or self._model_cfg.get("backbone") or {}
        cin = bb.get("in_channels")
        return cin is not None and cin == feat_width + 3

    def prepare(self, coord: np.ndarray, feat: np.ndarray, grid_size: float = 0.02):
        """Normalize, voxelize and subsample a cloud -> (model-input rows, centroid, scale)."""
        ncoord, centroid, scale = normalize_cloud(coord)
        grid = np.floor(ncoord / grid_size).astype(np.int64)
        grid -= grid.min(0)
        _, first = np.unique(z_order_encode_np(grid, depth=16), return_index=True)
        sel = np.sort(first)  # one point per voxel, in input order
        f = feat[sel].astype(np.float32)
        if self._expects_coord_feat(f.shape[1]):
            f = np.concatenate([ncoord[sel].astype(np.float32), f], axis=1)
        data = dict(coord=ncoord[sel], feat=f, grid_coord=grid[sel].astype(np.int32))
        n = data["coord"].shape[0]
        if n > self.slot_size:
            # subsample here, deterministically, so data rows stay aligned with
            # the per-row outputs; pad_sample then only pads
            keep = np.sort(np.random.default_rng(0).choice(n, self.slot_size, replace=False))
            data = {k: v[keep] for k, v in data.items()}
        return data, centroid, scale

    def forward(self, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Model outputs for the rows of ``data`` (at most slot_size of them)."""
        n = data["coord"].shape[0]
        batch = sample_to_device(collate([data], self.slot_size), self.device)
        with self._lock, torch.inference_mode():
            out = self.model(build_point_batch(batch, 1))
            return {key: value[:n].float().cpu().numpy() for key, value in out.items()}

    def infer(self, coord: np.ndarray, feat: Optional[np.ndarray] = None, grid_size: float = 0.02):
        """Prepared rows and raw outputs: coord, offset_pred, mask_logits, centroid, scale."""
        if feat is None:
            feat = estimate_normals_curvature(coord)
        data, centroid, scale = self.prepare(coord, feat, grid_size)
        return dict(coord=data["coord"], centroid=centroid, scale=scale, **self.forward(data))

    def predict(
        self,
        coord: np.ndarray,
        feat: Optional[np.ndarray] = None,
        grid_size: float = 0.02,
        method: str = "argmax",
        threshold: float = 0.5,
    ) -> np.ndarray:
        """Keypoints [K, 3] in the cloud's own units."""
        res = self.infer(coord, feat, grid_size)
        mask_prob = expit(res["mask_logits"])
        kp = aggregate_keypoints(res["coord"], res["offset_pred"], mask_prob, method, threshold)
        return kp * res["scale"] + res["centroid"]
