"""One ``.npy`` pig scene through the pig segmentor: the counterpart of ``tools/infer_npy.py``.

    python -m pointcept_keypointdetection_tpu_torch.infer_npy SCENE.npy \\
        --config-file configs/pigseg/semseg-octformer-v1m1-0-base.py [--weight W] [--grid-size 0.02] \\
        [--slot-size 32768] [--out-dir DIR] [--device cuda|cpu]

The scene (N x >= 3, xyz in mm, then normal and curvature in columns 3:7) is cleaned as
``PigDataset`` cleans it (``preprocess``: rows with a NaN dropped, centred on the median, points
5,000 mm or farther from it dropped), labelled by ``SegmentPredictor`` (each point its own voxel's
label; estimated normals where the scene has fewer than 7 columns), and written to
``<out-dir>/<stem>_pred.ply`` (every point, pig blue, background red) and ``<stem>_pig_only.ply``
(the points labelled 1).  ``--out-dir`` defaults to the scene's directory.  ``--weight`` takes what
``convert.load_weights`` takes; without it the weights are seeded (seed 0).  It runs on the card unless
``--device cpu`` is given.

``tools/infer_npy.py`` labels through ``tools/serve.py``'s ``_SegPredictor``, which unpacks
``np.unique`` in the wrong order: it fails where two points share a voxel and otherwise permutes the
labels.  Here each point gets its own voxel's label (``inference/segment.py``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .convert import load_weights
from .inference.segment import SegmentPredictor
from .utils.config import Config
from .utils.visualization import save_point_cloud


def preprocess(raw: np.ndarray, outlier_mm: float = 5000.0) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(coord [M, 3], feat [M, 4] or None): ``PigDataset``'s cleaning (`pigseg.py:19-37`): NaN cull,
    median centre, distance cull."""
    finite = np.isfinite(raw).all(axis=1)
    raw = raw[finite]
    coord = raw[:, :3]
    coord = coord - np.median(coord, axis=0)
    keep = np.linalg.norm(coord, axis=1) < outlier_mm
    return coord[keep], raw[keep, 3:7] if raw.shape[1] >= 7 else None


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Returns the int32 label of each cleaned point."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("npy_path")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None)
    parser.add_argument("--grid-size", type=float, default=0.02, help="in normalized units")
    parser.add_argument("--slot-size", type=int, default=32768)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    raw = np.load(args.npy_path).astype(np.float32)
    coord, feat = preprocess(raw)
    print(f"{len(raw)} raw points -> {len(coord)} after cleanup")

    cfg = Config.fromfile(args.config_file)
    state = load_weights(args.weight) if args.weight else None
    predictor = SegmentPredictor(dict(cfg.model), state, args.slot_size, args.device)
    preds = predictor.predict(coord, feat, grid_size=args.grid_size).astype(np.int32)

    out_dir = args.out_dir or os.path.dirname(os.path.abspath(args.npy_path))
    stem = os.path.splitext(os.path.basename(args.npy_path))[0]
    color = np.where(preds[:, None] == 1, (60, 60, 255), (255, 60, 60)).astype(np.uint8)
    scene_path = os.path.join(out_dir, f"{stem}_pred.ply")
    save_point_cloud(scene_path, coord, color)
    pig = coord[preds == 1]
    pig_path = os.path.join(out_dir, f"{stem}_pig_only.ply")
    save_point_cloud(pig_path, pig, np.full((len(pig), 3), (60, 60, 255), np.uint8))
    print(f"wrote {scene_path} ({len(coord)} pts) and {pig_path} ({len(pig)} pts)")
    return preds


if __name__ == "__main__":
    main()
