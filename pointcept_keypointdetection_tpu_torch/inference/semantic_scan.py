"""Per-scan semantic labels and a scan embedding for the SLAM bridge: the
counterpart of ``tools/run_slam.py``'s ``_build_semseg`` (`:130-204`).

The same steps, one LiDAR scan (float32 [N, 4]: xyz, reflectance) at a
time: voxels of ``floor(coord / 0.05)``, shifted to a minimum of 0; the
z-order key of the grid clipped at 2^16 - 1; one point per voxel, the first
of each key (``np.unique`` with ``return_index`` and ``return_inverse``);
``feat`` = coord + strength; one sample padded to the slot; the model in
eval mode; the argmax of each row's logits, mapped back to every raw point
through the inverse; and the embedding, the mean of the segmentor's
``backbone_feat`` over the valid rows (``DefaultSegmentor``: its logits,
``DefaultSegmentorV2``: the features before its head), or of its logits
where the segmentor hands out no ``backbone_feat`` (its ``forward`` takes
no such argument), as JAX falls back where a model sows none.

As in JAX, a scan with more voxels than the slot is subsampled to the slot
from the global ``np.random`` by the padding, and then mapping the labels
back fails (an ``IndexError``): pick a slot that holds the scan.
"""

from __future__ import annotations

import inspect
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..convert import load_weights
from ..datasets.collate import collate, pad_sample
from ..engines.common import build_eval_model, build_point_batch, sample_to_device
from ..ops.serialization import z_order_encode_np
from ..utils.config import Config

GRID = 0.05  # the bridge's voxel, SemanticKITTI's GridSample grid


class SemanticScanPredictor:
    """A SemanticKITTI segmentor of ``config`` (a path) answering one scan at a time.

    ``weight``: a checkpoint ``convert.load_weights`` reads (a JAX ``.ckpt``, a port trainer's ``.pth``
    or a bare state_dict); without it the weights are seeded (seed 0).  The model runs on ``device``;
    the default, CUDA, raises where there is none."""

    def __init__(self, config: str, weight: Optional[str] = None, slot: int = 131072,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = Config.fromfile(config)
        self.device = torch.device(device)
        state = load_weights(weight) if weight else None
        self.model = build_eval_model(dict(self.cfg.model), state, self.device)
        self.slot = slot
        self._lock = threading.Lock()

    @staticmethod
    def voxelize(scan: np.ndarray):
        """(the model-input rows, one per voxel in key order; each raw point's row)."""
        coord = scan[:, :3]
        strength = scan[:, 3:4]
        grid = np.floor(coord / GRID).astype(np.int64)
        grid -= grid.min(0)
        key = z_order_encode_np(np.minimum(grid, 2**16 - 1), 16)
        _, sel, inv = np.unique(key, return_index=True, return_inverse=True)
        data = dict(coord=coord[sel].astype(np.float32), grid_coord=grid[sel].astype(np.int32),
                    feat=np.concatenate([coord[sel], strength[sel]], 1).astype(np.float32))
        return data, inv.reshape(-1)

    def infer(self, scan: np.ndarray, logits: bool = False) -> dict:
        """The label of every raw point (``labels`` [N]) and the scan's embedding (``embedding``, float32
        [C]); with ``logits`` also the voxels' logits (``seg_logits``, float32 [n, classes]) and each raw
        point's voxel (``inverse`` [N])."""
        data, inv = self.voxelize(scan)
        n = data["coord"].shape[0]
        batch = sample_to_device(collate([pad_sample(data, self.slot, np.random)], self.slot), self.device)
        with self._lock, torch.inference_mode():
            point = build_point_batch(batch, 1)
            takes = "backbone_feat" in inspect.signature(self.model.forward).parameters
            out = self.model(point, backbone_feat=True) if takes else self.model(point)
            feat = out.get("backbone_feat", out["seg_logits"])
            w = point.valid.to(feat.dtype)[:, None]
            emb = (feat * w).sum(0) / w.sum().clamp_min(1.0)
            pred = out["seg_logits"].argmax(-1).cpu().numpy()
            res = dict(labels=pred[:n][inv], embedding=emb.float().cpu().numpy())
            if logits:
                res.update(seg_logits=out["seg_logits"][:n].float().cpu().numpy(), inverse=inv)
        return res

    def __call__(self, scan: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(the label of every raw point, [N]; the scan's embedding, float32 [C])."""
        res = self.infer(scan)
        return res["labels"], res["embedding"]
