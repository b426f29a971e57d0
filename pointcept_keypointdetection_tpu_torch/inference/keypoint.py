"""Keypoint inference on a raw cloud: preprocessing, forward, aggregation.

Counterparts of ``OffsetKeypointPredictor`` and ``KeypointPredictor`` in
``pointcept_keypointdetection_tpu/inference/keypoint.py:92-199``, with the
same preprocessing (``_PredictorBase._prepare``, `:83-119`): normalize to the
unit sphere, voxelize at ``grid_size`` keeping the first point of each
voxel, and prefix normalized coords to the features when the backbone
expects ``in_channels = feat width + 3``.  Above ``slot_size`` voxels the
offset predictor subsamples deterministically before padding, so that the
rows of the returned coords stay aligned with the model's per-row outputs;
the global-regression predictor, whose output is per cloud, leaves it to
the padding, which draws from the global ``np.random`` as JAX's
``pad_sample`` does.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import numpy as np
import torch
from scipy.special import expit

from ..datasets.collate import collate
from ..datasets.keypoint_dataset import normalize_cloud
from ..engines.common import build_eval_model, build_point_batch, sample_to_device
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


class _PredictorBase:
    """A keypoint model of ``model_cfg`` in eval mode, and the shared preprocessing.

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
        self._model_cfg = dict(model_cfg)
        self.model = build_eval_model(model_cfg, state_dict, self.device, generator)
        self.slot_size = slot_size
        self._lock = threading.Lock()  # one forward at a time (the server is threaded)

    def _expects_coord_feat(self, feat_width: int) -> bool:
        bb = self._model_cfg.get("backbone_conf") or self._model_cfg.get("backbone") or {}
        cin = bb.get("in_channels")
        return cin is not None and cin == feat_width + 3

    def _prepare(self, coord: np.ndarray, feat: np.ndarray, grid_size: float):
        """Normalize and voxelize a cloud -> (model-input rows, centroid, scale)."""
        ncoord, centroid, scale = normalize_cloud(coord)
        grid = np.floor(ncoord / grid_size).astype(np.int64)
        grid -= grid.min(0)
        _, first = np.unique(z_order_encode_np(grid, depth=16), return_index=True)
        sel = np.sort(first)  # one point per voxel, in input order
        f = feat[sel].astype(np.float32)
        if self._expects_coord_feat(f.shape[1]):
            f = np.concatenate([ncoord[sel].astype(np.float32), f], axis=1)
        return dict(coord=ncoord[sel], feat=f, grid_coord=grid[sel].astype(np.int32)), centroid, scale


class OffsetKeypointPredictor(_PredictorBase):
    """End-to-end offset-keypoint prediction on a raw cloud (mm or m units)."""

    def prepare(self, coord: np.ndarray, feat: np.ndarray, grid_size: float = 0.02):
        """Normalize, voxelize and subsample a cloud -> (model-input rows, centroid, scale)."""
        data, centroid, scale = self._prepare(coord, feat, grid_size)
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


class KeypointPredictor(_PredictorBase):
    """End-to-end global-regression keypoint prediction on a raw cloud (``KeypointPTv3`` and its
    aliases, `keypoint.py:183-199`)."""

    def predict(self, coord: np.ndarray, feat: Optional[np.ndarray] = None, grid_size: float = 0.02) -> np.ndarray:
        """Keypoints [K, 3] in the cloud's own units."""
        if feat is None:
            feat = estimate_normals_curvature(coord)
        data, centroid, scale = self._prepare(coord, feat, grid_size)
        batch = sample_to_device(collate([data], self.slot_size, np.random), self.device)
        with self._lock, torch.inference_mode():
            kp = self.model(build_point_batch(batch, 1))["keypoint_pred"][0].float().cpu().numpy()
        return kp * scale + centroid
