"""Offset-keypoint inference over a split's clouds, with error statistics: the counterpart of
``tools/infer_offset.py``.

    python -m pointcept_keypointdetection_tpu_torch.infer_offset \\
        --config-file configs/my_dataset/offset_keypoint_ptv3.py --data-root data/pig_keypoint \\
        [--split val] [--weight W] [--method argmax|weighted] \\
        [--threshold 0.5] [--grid-size 0.02] [--slot-size 8192] [--output out.txt] [--device cuda|cpu]

Every ``<data-root>/<split>/pointclouds/<name>.npy`` (N x 7: xyz, normal, curvature; N x 3 has its
normals estimated) goes through ``OffsetKeypointPredictor``; where
``keypoints/<name>_关键点坐标.npy`` (or ``<name>.npy``) exists, the distances of the K predicted
keypoints to it are kept.  Printed: the per-keypoint mean and std of those errors and their
overall mean; ``--output`` gets one line per cloud, its name and the K x 3 prediction.  ``--weight``
takes what ``convert.load_weights`` takes and defaults to the config's
``<save_path>/model/model_best.pth``.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np

from .convert import load_weights
from .inference.keypoint import OffsetKeypointPredictor
from .utils.config import Config


def main(argv: Optional[Sequence[str]] = None) -> Optional[np.ndarray]:
    """Returns the [num_clouds, K] errors of the clouds that have keypoints, or None."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None)
    parser.add_argument("--data-root", required=True, help="dir with <split>/pointclouds/ and <split>/keypoints/")
    parser.add_argument("--split", default="val")
    parser.add_argument("--method", default="argmax", choices=["argmax", "weighted"])
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--grid-size", type=float, default=0.02)
    parser.add_argument("--slot-size", type=int, default=8192)
    parser.add_argument("--output", default=None, help="txt output path")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    weight = args.weight or os.path.join(cfg.get("save_path") or ".", "model", "model_best.pth")
    predictor = OffsetKeypointPredictor(dict(cfg.model), load_weights(weight), args.slot_size, args.device)

    split_path = os.path.join(args.data_root, args.split)
    errors, lines = [], []
    for cloud_path in sorted(glob.glob(os.path.join(split_path, "pointclouds", "*.npy"))):
        name = os.path.splitext(os.path.basename(cloud_path))[0]
        raw = np.nan_to_num(np.load(cloud_path).astype(np.float32))
        coord, feat = raw[:, :3], raw[:, 3:]
        pred = predictor.predict(coord, feat if feat.shape[1] else None, args.grid_size, args.method, args.threshold)
        lines.append(name + " " + " ".join(f"{v:.3f}" for v in pred.reshape(-1)))
        for kp_file in (f"{name}_关键点坐标.npy", f"{name}.npy"):
            kp_path = os.path.join(split_path, "keypoints", kp_file)
            if os.path.exists(kp_path):
                gt = np.load(kp_path).astype(np.float32).reshape(-1, 3)
                errors.append(np.linalg.norm(pred - gt, axis=1))
                break

    result = None
    if errors:
        result = np.stack(errors)  # [num_clouds, K]
        mean, std = result.mean(0), result.std(0)
        print("Per-keypoint mean error:", " ".join(f"{v:.2f}" for v in mean))
        print("Per-keypoint std  error:", " ".join(f"{v:.2f}" for v in std))
        print(f"Overall mean error: {result.mean():.2f}")
    if args.output:
        with open(args.output, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.output}")
    return result


if __name__ == "__main__":
    main()
