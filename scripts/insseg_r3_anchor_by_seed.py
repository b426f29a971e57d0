"""The ``exp/insseg_r3`` AP anchor per state of the global ``np.random``, in both packages, on the CPU.

``GridSample`` (train mode) draws the val scenes of ``exp/insseg_r3/
config.py``'s test set from the global ``np.random``, so the anchor of
``tests/test_insseg_checkpoint.py`` (which leaves it unseeded) moves from run
to run.  For each seed given, this seeds it and runs each package's
``InsSegTester`` over the 6 scenes with the committed weights (JAX: its
checkpoint loader; the port: its reader and ``convert.py``), and prints
mAP, AP50 and AP25:

    JAX_PLATFORMS=cpu python scripts/insseg_r3_anchor_by_seed.py 7 0 1 2
"""

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from pointcept_keypointdetection_tpu.engines.test import InsSegTester as JaxInsSegTester  # noqa: E402
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from pointcept_keypointdetection_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_keypointdetection_tpu_torch.engines.test import InsSegTester  # noqa: E402
from pointcept_keypointdetection_tpu_torch.utils.config import Config  # noqa: E402

CONFIG = os.path.join(REPO, "exp", "insseg_r3", "config.py")
CKPT = os.path.join(REPO, "exp", "insseg_r3", "model_params.ckpt")


def tester_args(cfg) -> dict:
    t = cfg.test
    return dict(segment_ignore_index=tuple(t.segment_ignore_index), cluster_thresh=t.cluster_thresh,
                cluster_min_points=t.cluster_min_points, capacity=t.capacity)


def main(seeds):
    with tempfile.TemporaryDirectory() as tmp:
        jcfg = JaxConfig.fromfile(CONFIG)
        jcfg.save_path = tmp
        ck = jax_load_checkpoint(CKPT)
        jax_tester = JaxInsSegTester(jcfg, model=jax_build_model(dict(jcfg.model)),
                                     variables={"params": ck["params"], "batch_stats": ck["batch_stats"]},
                                     **tester_args(jcfg))
        cfg = Config.fromfile(CONFIG)
        cfg.merge_from_dict({"save_path": tmp, "weight": CKPT})
        tester = InsSegTester(cfg, device="cpu", **tester_args(cfg))
        for seed in seeds:
            np.random.seed(seed)
            ref = jax_tester.test()
            np.random.seed(seed)
            got = tester.test()
            print(f"seed {seed}: JAX mAP/AP50/AP25 {ref['mAP']:.6f}/{ref['AP50']:.6f}/{ref['AP25']:.6f}; "
                  f"port {got['mAP']:.6f}/{got['AP50']:.6f}/{got['AP25']:.6f}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [7])
