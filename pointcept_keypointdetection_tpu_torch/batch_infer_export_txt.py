"""A directory of raw scans in, one keypoint txt per scan out: the counterpart of
``tools/batch_infer_export_txt.py``.

    python -m pointcept_keypointdetection_tpu_torch.batch_infer_export_txt \\
        --config-file configs/my_dataset/offset_keypoint_swin3d.py --scan-dir SCANS [--out-dir DIR] \\
        [--weight W] [--task auto|keypoint|offset_keypoint] [--method argmax|weighted] [--grid-size 0.02] \\
        [--tag model] [--slot-size 8192] [--device cuda|cpu]

Every ``*.npy`` (N x >= 3: xyz, then features) and ascii ``*.pcd`` (xyz) in ``--scan-dir``, in name
order: a scan with bare xyz has its normals and curvature estimated, then goes through
``OffsetKeypointPredictor`` (``--task offset_keypoint``, or ``auto`` where the model type contains
``Offset``; ``--method`` aggregates) or ``KeypointPredictor``, and its K x 3 keypoints, in the scan's
units, go to ``<out-dir>/<scan>_关键点坐标预测结果_<tag>.txt`` (``np.savetxt``, ``%.3f``; ``--out-dir``
defaults to the scan directory).  A binary PCD raises.  ``--weight`` takes what
``convert.load_weights`` takes; without it the weights are seeded (seed 0).  It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .convert import load_weights
from .inference.keypoint import KeypointPredictor, OffsetKeypointPredictor, estimate_normals_curvature
from .utils.config import Config


def load_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(xyz float32 [N, 3], the further columns or None) of a ``.npy`` or an ascii ``.pcd`` scan."""
    if path.endswith(".npy"):
        raw = np.load(path).astype(np.float32)
        coord = raw[:, :3]
        feat = raw[:, 3:] if raw.shape[1] > 3 else None
        return coord, feat
    if path.endswith(".pcd"):
        pts = []
        with open(path, errors="ignore") as f:
            data_started = False
            for line in f:
                if data_started:
                    parts = line.split()
                    if len(parts) >= 3:
                        pts.append([float(parts[0]), float(parts[1]), float(parts[2])])
                elif line.startswith("DATA"):
                    if "ascii" not in line:
                        raise ValueError(f"{path}: only ascii PCD supported")
                    data_started = True
        return np.asarray(pts, np.float32), None
    raise ValueError(f"unsupported cloud format: {path}")


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Returns the paths of the txts written, in scan order."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None)
    parser.add_argument("--scan-dir", required=True)
    parser.add_argument("--out-dir", default=None, help="default: alongside scans")
    parser.add_argument("--task", default="auto", choices=["auto", "keypoint", "offset_keypoint"])
    parser.add_argument("--method", default="argmax", choices=["argmax", "weighted"])
    parser.add_argument("--grid-size", type=float, default=0.02)
    parser.add_argument("--tag", default="model", help="suffix of the output txt name")
    parser.add_argument("--slot-size", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    task = args.task
    if task == "auto":
        task = "offset_keypoint" if "Offset" in cfg.model.type else "keypoint"
    cls = OffsetKeypointPredictor if task == "offset_keypoint" else KeypointPredictor
    state = load_weights(args.weight) if args.weight else None
    predictor = cls(dict(cfg.model), state, args.slot_size, args.device)

    scans = sorted(glob.glob(os.path.join(args.scan_dir, "*.npy")) + glob.glob(os.path.join(args.scan_dir, "*.pcd")))
    print(f"{len(scans)} scans in {args.scan_dir}")
    out_dir = args.out_dir or args.scan_dir
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for path in scans:
        coord, feat = load_cloud(path)
        if feat is None:
            feat = estimate_normals_curvature(coord)
        if task == "offset_keypoint":
            kp = predictor.predict(coord, feat, grid_size=args.grid_size, method=args.method)
        else:
            kp = predictor.predict(coord, feat, grid_size=args.grid_size)
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(out_dir, f"{stem}_关键点坐标预测结果_{args.tag}.txt")  # <scan>_keypoint-prediction_<tag>
        np.savetxt(out, np.asarray(kp), fmt="%.3f")
        print(f"  {stem}: wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
