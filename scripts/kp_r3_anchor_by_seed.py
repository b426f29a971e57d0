"""The ``exp/kp_r3`` keypoint anchor per state of the global ``np.random``, in both packages, on the CPU.

``GridSample`` (train mode) and the slot subsample draw the val scenes of
``configs/synthetic/offset-keypoint-r3.py`` from the global ``np.random``, so
the anchor of ``tests/test_keypoint_checkpoint.py`` (which leaves it unseeded)
moves from run to run.  For each seed given, this seeds it, builds the 8 val
scenes in each package, and prints the mean keypoint distance (weighted and
argmax, mm) of the JAX package (a jitted forward with flax-loaded weights and
the JAX evaluator's reconstructions) and of the PyTorch port (the port's
reader, model and ``keypoint_distances``):

    JAX_PLATFORMS=cpu python scripts/kp_r3_anchor_by_seed.py 0 1 2 3 42
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.special import expit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate  # noqa: E402
from pointcept_keypointdetection_tpu.engines.common import build_point_batch as jax_build_point_batch  # noqa: E402
from pointcept_keypointdetection_tpu.engines.hooks.keypoint_evaluator import (  # noqa: E402
    reconstruct_keypoints_from_offsets,
    reconstruct_keypoints_weighted,
)
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from pointcept_keypointdetection_tpu_torch.convert import load_jax_checkpoint  # noqa: E402
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset  # noqa: E402
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate  # noqa: E402
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device  # noqa: E402
from pointcept_keypointdetection_tpu_torch.engines.hooks.keypoint_evaluator import keypoint_distances  # noqa: E402
from pointcept_keypointdetection_tpu_torch.models import build_model  # noqa: E402
from pointcept_keypointdetection_tpu_torch.utils.config import Config  # noqa: E402

CKPT = os.path.join(REPO, "exp", "kp_r3", "model_params.ckpt")
CONFIG = os.path.join(REPO, "configs", "synthetic", "offset-keypoint-r3.py")


def jax_anchor(cfg, variables, forward, seed):
    ds = jax_build_dataset(dict(cfg.data.val))
    np.random.seed(seed)
    dist = {"weighted": 0.0, "argmax": 0.0}
    for i in range(len(ds)):
        b = {k: jnp.asarray(v) for k, v in jax_collate([ds[i]], cfg.slot_size).items()
             if not isinstance(v, (str, list))}
        out = forward(variables, b)
        point = jax_build_point_batch(b, 1)
        prob = jax.nn.sigmoid(out["mask_logits"])
        s, k = out["mask_logits"].shape
        w = (b["keypoint_mask"] * point.valid[:, None].astype(jnp.float32)).reshape(1, s, k, 1)
        cand = (point.coord[:, None, :] + b["keypoint_offset"]).reshape(1, s, k, 3)
        gt = jnp.sum(cand * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1e-6)
        scale = float(np.asarray(b["scale"]).reshape(-1)[0])
        preds = {"weighted": reconstruct_keypoints_weighted(point.coord, out["offset_pred"], prob, point.valid, 1),
                 "argmax": reconstruct_keypoints_from_offsets(point.coord, out["offset_pred"], prob, None,
                                                              point.valid, 1)}
        for m, pred in preds.items():
            dist[m] = dist[m] + np.asarray(jnp.linalg.norm(pred - gt, axis=-1))[0] * scale
    return {m: float(np.mean(d) / len(ds)) for m, d in dist.items()}


def port_anchor(cfg, model, seed):
    ds = build_dataset(dict(cfg.data.val))
    np.random.seed(seed)
    dist = {"weighted": 0.0, "argmax": 0.0}
    for i in range(len(ds)):
        b = collate([ds[i]], cfg.slot_size, np.random)
        with torch.no_grad():
            out = {k: v.numpy() for k, v in model(build_point_batch(sample_to_device(b, "cpu"), 1)).items()}
        d = keypoint_distances(b["coord"], b["valid"], out["offset_pred"], expit(out["mask_logits"]),
                               b["keypoint_offset"], b["keypoint_mask"], b["scale"], 1, 0.5)
        for m in dist:
            dist[m] = dist[m] + d[m].sum(0)
    return {m: float(np.mean(d) / len(ds)) for m, d in dist.items()}


def main(seeds):
    cfg = Config.fromfile(CONFIG)
    jmodel = jax_build_model(dict(cfg.model))
    ck = jax_load_checkpoint(CKPT)
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    forward = jax.jit(lambda v, b: jmodel.apply(v, jax_build_point_batch(b, 1), b, train=False))
    model = build_model(dict(cfg.model))
    model.load_state_dict(load_jax_checkpoint(CKPT), strict=True)
    model.eval()
    for seed in seeds:
        ref, got = jax_anchor(cfg, variables, forward, seed), port_anchor(cfg, model, seed)
        print(f"seed {seed}: JAX weighted {ref['weighted']:.4f} argmax {ref['argmax']:.4f} mm; "
              f"port weighted {got['weighted']:.4f} argmax {got['argmax']:.4f} mm")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [42])
