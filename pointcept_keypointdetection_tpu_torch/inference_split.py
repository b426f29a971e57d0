"""Global-regression keypoint inference over a ``KeypointDataset`` split, with its error report: the
counterpart of ``tools/inference.py``.  The module is ``inference_split``, not ``inference``, because
the package's ``inference/`` subpackage holds that name.

    python -m pointcept_keypointdetection_tpu_torch.inference_split \\
        --config-file configs/my_dataset/keypoint_octformer.py [--weight W] [--split val|train|test|all] \\
        [--index 0] [--grid-size 0.02] [--out errors.txt] [--viz-dir DIR] [--slot-size 8192] [--device cuda|cpu]

Each cloud of the split (the config's ``data.<split>``, else ``data.train`` re-pointed at the split,
without transforms) goes through ``KeypointPredictor``; the distances of its K predicted keypoints to
the labelled ones are in the dataset's units (mm for the pig scans).  Printed per split: the sample
count and the per-keypoint mean and std; then the overall mean.  ``--out`` gets a tab-separated table,
one row per sample (``{e:.2f}``); ``--viz-dir`` one PLY per sample: the cloud grey, the labelled
keypoints green, the predicted ones red.  ``--weight`` takes what ``convert.load_weights`` takes;
without it the weights are seeded (seed 0).  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from .convert import load_weights
from .datasets import build_dataset
from .inference.keypoint import KeypointPredictor
from .utils.config import Config
from .utils.visualization import save_point_cloud


def run_split(predictor, dataset, grid_size: float, viz_dir: Optional[str] = None):
    """(names, errors [num_samples, K]) of the dataset's clouds that have K keypoints; PLYs to ``viz_dir``."""
    errors, names = [], []
    for info in dataset.data_list:
        coord, feat = dataset._load_cloud(info)
        gt = dataset._load_keypoints(info)
        if gt is None or coord.shape[0] == 0:
            continue
        pred = predictor.predict(coord, feat, grid_size=grid_size)  # dataset units
        errors.append(np.linalg.norm(pred - gt, axis=-1))
        names.append(info["name"])
        if viz_dir is not None:
            os.makedirs(viz_dir, exist_ok=True)
            pts = np.concatenate([coord, gt, pred], axis=0)
            color = np.zeros((len(pts), 3), np.uint8)
            color[: len(coord)] = (150, 150, 150)
            color[len(coord) : len(coord) + len(gt)] = (0, 255, 0)  # labelled: green
            color[len(coord) + len(gt) :] = (255, 0, 0)  # predicted: red
            save_point_cloud(os.path.join(viz_dir, f"{info['name']}.ply"), pts, color)
    return names, np.stack(errors) if errors else np.zeros((0, 0))


def main(argv: Optional[Sequence[str]] = None) -> Optional[np.ndarray]:
    """Returns the [num_samples, K] errors over the splits, or None where no sample had keypoints."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None)
    parser.add_argument("--split", default="val", help="val | train | test | all")
    parser.add_argument("--index", type=int, default=None, help="single-sample mode")
    parser.add_argument("--grid-size", type=float, default=0.02)
    parser.add_argument("--out", default=None, help="txt error table path")
    parser.add_argument("--viz-dir", default=None, help="dump labelled and predicted PLYs here")
    parser.add_argument("--slot-size", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    state = load_weights(args.weight) if args.weight else None
    predictor = KeypointPredictor(dict(cfg.model), state, args.slot_size, args.device)

    splits = ["train", "val", "test"] if args.split == "all" else [args.split]
    all_err = []
    lines = ["sample\t" + "\t".join(f"kp{i}" for i in range(cfg.model.get("num_keypoints", 6)))]
    for split in splits:
        data_cfg = dict(cfg.data.get(split) or cfg.data["train"])
        data_cfg["split"] = split
        data_cfg["transform"] = None
        dataset = build_dataset(data_cfg)
        if args.index is not None:
            dataset.data_list = dataset.data_list[args.index : args.index + 1]
        names, errors = run_split(predictor, dataset, args.grid_size, args.viz_dir)
        for name, err in zip(names, errors):
            lines.append(name + "\t" + "\t".join(f"{e:.2f}" for e in err))
        if len(errors):
            all_err.append(errors)
            print(f"[{split}] {len(errors)} samples")
            print("  per-KP mean:", np.round(errors.mean(0), 2))
            print("  per-KP std :", np.round(errors.std(0), 2))

    total = None
    if all_err:
        total = np.concatenate(all_err)
        print(f"[total] mean={total.mean():.2f}  per-KP mean={np.round(total.mean(0), 2)}")
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.out}")
    return total


if __name__ == "__main__":
    main()
