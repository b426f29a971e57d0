"""The ``exp/semseg_r3`` mIoU anchor per state of the global ``np.random``, in both packages, on the CPU.

``GridSample`` (train mode) and the slot subsample draw the val scenes of
``configs/synthetic/semseg-spunet-r3.py`` from the global ``np.random``, so
the anchor of ``tests/test_semseg_checkpoint.py`` (which leaves it unseeded)
moves from run to run.  For each seed given, this seeds it, builds the 8 val
scenes in each package, and prints the mIoU over the valid rows (per-class
intersections and unions summed over the scenes, as that test sums them) of
the first 3 scenes (that test's) and of all 8, for the JAX package (a
jitted forward with flax-loaded weights) and for the PyTorch port (the
port's reader and model):

    JAX_PLATFORMS=cpu python scripts/semseg_r3_anchor_by_seed.py 123 0 1
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset  # noqa: E402
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate  # noqa: E402
from pointcept_keypointdetection_tpu.engines.common import build_point_batch as jax_build_point_batch  # noqa: E402
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from pointcept_keypointdetection_tpu.utils.misc import intersection_and_union as jax_iou  # noqa: E402
from pointcept_keypointdetection_tpu_torch.convert import load_jax_checkpoint  # noqa: E402
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset  # noqa: E402
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate  # noqa: E402
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device  # noqa: E402
from pointcept_keypointdetection_tpu_torch.models import build_model  # noqa: E402
from pointcept_keypointdetection_tpu_torch.utils.config import Config  # noqa: E402
from pointcept_keypointdetection_tpu_torch.utils.misc import intersection_and_union  # noqa: E402

CKPT = os.path.join(REPO, "exp", "semseg_r3", "model_params.ckpt")
CONFIG = os.path.join(REPO, "configs", "synthetic", "semseg-spunet-r3.py")
FIRST = 3  # the scenes tests/test_semseg_checkpoint.py evaluates


def miou(counts) -> float:
    inter, union = np.sum([c[0] for c in counts], 0), np.sum([c[1] for c in counts], 0)
    return float(np.mean(inter / np.maximum(union, 1)))


def jax_anchor(cfg, variables, forward, seed):
    ds = jax_build_dataset(dict(cfg.data.val))
    np.random.seed(seed)
    counts = []
    for i in range(len(ds)):
        b = {k: jnp.asarray(v) for k, v in jax_collate([ds[i]], cfg.slot_size).items()
             if not isinstance(v, (str, list))}
        pred = np.asarray(jnp.argmax(forward(variables, b)["seg_logits"], -1))
        valid = np.asarray(b["valid"])
        a, u, _ = jax_iou(pred[valid], np.asarray(b["segment"])[valid], cfg.data.num_classes, ignore_index=-1)
        counts.append((a, u))
    return miou(counts[:FIRST]), miou(counts)


def port_anchor(cfg, model, seed):
    ds = build_dataset(dict(cfg.data.val))
    np.random.seed(seed)
    counts = []
    for i in range(len(ds)):
        b = sample_to_device(collate([ds[i]], cfg.slot_size, np.random), "cpu")
        with torch.no_grad():
            pred = model(build_point_batch(b, 1), b)["seg_logits"].argmax(-1)
        a, u, _ = intersection_and_union(pred, b["segment"], cfg.data.num_classes, -1, b["valid"])
        counts.append((a.numpy(), u.numpy()))
    return miou(counts[:FIRST]), miou(counts)


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
        print(f"seed {seed}: JAX mIoU {ref[0]:.6f} over the first {FIRST} scenes, {ref[1]:.6f} over 8; "
              f"port {got[0]:.6f} over {FIRST}, {got[1]:.6f} over 8")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [123])
