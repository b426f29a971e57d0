"""Per-point semantic labels on a raw cloud: the counterpart of the ``pigseg``
task's ``_SegPredictor`` (``tools/serve.py:46-110``).

The same steps: normals and curvature from the request's columns, or
estimated when it has none; ``normalize_cloud``; a grid of ``grid_size`` in
normalized units, shifted to start at 0; one point per voxel, the first of
each z-order code (``np.unique``, codes of the grid clamped to 16 bits);
pad to the slot, forward, argmax; each input point answered with its
voxel's label.

Where ``tools/serve.py`` differs, this follows the intent: it unpacks
``np.unique``'s outputs as (uniques, inverse, index) where numpy returns
(uniques, index, inverse), so it fails on any cloud with two points in one
voxel and, on the others, answers point i with the label of point k, where k
is the rank of point i's code.  Here each point gets its own voxel's label.  A cloud with
more voxels than the slot raises (``tools/serve.py`` fails on it as well).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..datasets.collate import collate
from ..engines.common import build_eval_model, build_point_batch, sample_to_device
from ..ops.serialization import z_order_encode_np
from .keypoint import estimate_normals_curvature, normalize_cloud


class SegmentPredictor:
    """Semantic segmentation of a raw cloud by a ``DefaultSegmentorV2``.

    ``state_dict``: weights in the port's layout (see ``convert.py``); without
    it the weights are seeded from ``generator`` (seed 0 by default).  The
    model runs on ``device``; the default, CUDA, raises where there is none.
    """

    def __init__(
        self,
        model_cfg: Dict,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        slot_size: int = 32768,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        self.device = torch.device(device)
        self.model = build_eval_model(model_cfg, state_dict, self.device, generator)
        self.slot_size = slot_size
        self._lock = threading.Lock()  # one forward at a time (the server is threaded)

    def prepare(self, coord: np.ndarray, feat: np.ndarray, grid_size: float = 0.02
                ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """(the model-input rows, one per voxel in z order; each input point's row)."""
        ncoord, _, _ = normalize_cloud(coord)
        grid = np.floor(ncoord / grid_size).astype(np.int64)
        grid -= grid.min(0)
        key = z_order_encode_np(np.minimum(grid, 2**16 - 1), 16)
        _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
        if first.size > self.slot_size:
            raise ValueError(f"the cloud has {first.size} voxels at grid {grid_size}, more than the slot "
                             f"size {self.slot_size}")
        data = dict(coord=ncoord[first], feat=feat[first].astype(np.float32), grid_coord=grid[first].astype(np.int32))
        return data, inverse.reshape(-1)

    def forward(self, data: Dict[str, np.ndarray]) -> np.ndarray:
        """Logits f32 [n, classes] of the n rows of ``data``."""
        n = data["coord"].shape[0]
        batch = sample_to_device(collate([data], self.slot_size), self.device)
        with self._lock, torch.inference_mode():
            logits = self.model(build_point_batch(batch, 1))["seg_logits"]
            return logits[:n].float().cpu().numpy()

    def infer(self, coord: np.ndarray, feat: Optional[np.ndarray] = None, grid_size: float = 0.02
              ) -> Dict[str, np.ndarray]:
        """The voxels' logits (``seg_logits`` [n, classes]) and each input point's row (``inverse`` [N])."""
        if feat is None:
            feat = estimate_normals_curvature(coord)
        data, inverse = self.prepare(coord, feat, grid_size)
        return dict(seg_logits=self.forward(data), inverse=inverse)

    def predict(self, coord: np.ndarray, feat: Optional[np.ndarray] = None, grid_size: float = 0.02,
                method: Optional[str] = None) -> np.ndarray:
        """One label per input point, float32 [N].  ``method`` (the keypoint server's query option) is
        accepted and ignored, so the HTTP handler calls every predictor alike."""
        res = self.infer(coord, feat, grid_size)
        return res["seg_logits"].argmax(1)[res["inverse"]].astype(np.float32)
