"""Run the SLAM bridge over a KITTI odometry sequence: the counterpart of ``tools/run_slam.py``.

    python -m pointcept_keypointdetection_tpu_torch.run_slam --config-file configs/slam/synth_loop.py \\
        [--sequence 00] [--max-frames N] [--options key=value ...] [--device cuda|cpu]

Reads ``<data_root>/dataset/sequences/<seq>/velodyne/*.bin`` in order; with
``semantic.enabled`` takes each scan's labels from ``labels/*.label``
(``labels_from="files"``) or from ``SemanticScanPredictor`` over
``semantic.config`` (``semantic.weight``, seeded weights without it;
``semantic.slot``, 131,072 by default), and drops ``dynamic_classes``;
runs ``LidarOdometry`` over ``odometry``, or ``SemanticSLAM`` where the
config has a ``slam`` section (``--options slam=None`` turns it off), with
the labeller's embedding in the keyframe descriptor; writes
``<save_path>/traj_<seq>.txt`` (a 3x4 pose a line, "%.6f") and prints the
throughput, the graph's counts and, where ``dataset/poses/<seq>.txt``
exists, ATE RMSE and RPE@10 after Umeyama alignment (and the live ATE with a
back end), the lines of ``tools/run_slam.py``.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np

from .datasets.semantic_kitti import read_label, read_scan
from .slam.evaluate import absolute_trajectory_error, load_kitti_poses, relative_pose_error
from .slam.pipeline import LidarOdometry, OdometryConfig, resolve_device
from .slam.semantic_slam import SemanticSLAM, SlamConfig
from .utils.config import Config, DictAction


def build_label_fn(cfg, device):
    """``path, scan -> (labels, embedding)`` for the config's ``semantic`` section, or None."""
    if not cfg.semantic.get("enabled"):
        return None
    if cfg.semantic.get("labels_from") == "files":
        def label_fn(path, scan):
            lbl = path.replace(os.sep + "velodyne" + os.sep, os.sep + "labels" + os.sep)
            return read_label(lbl[: -len(".bin")] + ".label"), None
        return label_fn
    from .inference.semantic_scan import SemanticScanPredictor

    predictor = SemanticScanPredictor(cfg.semantic.config, cfg.semantic.get("weight"),
                                      slot=int(cfg.semantic.get("slot", 131072)), device=device)
    return lambda path, scan: predictor(scan)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the engine, the trajectory, each scan's host ms (labels and step) and, with ground truth,
    the ATE, RPE@10 and live ATE."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", default="configs/slam/kitti_odometry.py")
    parser.add_argument("--sequence", default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--options", nargs="+", action=DictAction, help="config overrides key=value")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = Config.fromfile(args.config_file)
    if args.options:
        cfg.merge_from_dict(args.options)
    seq = args.sequence or cfg.sequence
    seq_dir = os.path.join(cfg.data_root, "dataset", "sequences", seq)
    scans = sorted(glob.glob(os.path.join(seq_dir, "velodyne", "*.bin")))
    max_frames = args.max_frames or cfg.get("max_frames")
    if max_frames:
        scans = scans[:max_frames]
    if not scans:
        raise FileNotFoundError(f"no scans under {seq_dir}")

    label_fn = build_label_fn(cfg, device)
    dynamic = tuple(cfg.semantic.get("dynamic_classes", ())) if label_fn else ()
    odo_cfg = OdometryConfig(dynamic_classes=dynamic, **dict(cfg.odometry))
    slam_opts = dict(cfg.get("slam") or {})
    engine = SemanticSLAM(SlamConfig(odometry=odo_cfg, **slam_opts), device) if slam_opts else \
        LidarOdometry(odo_cfg, device)

    label_ms, step_ms = [], []
    t0 = time.time()
    for i, path in enumerate(scans):
        scan = read_scan(path)
        t1 = time.perf_counter()
        labels, embedding = label_fn(path, scan) if label_fn else (None, None)
        t2 = time.perf_counter()
        if slam_opts:
            engine.process(scan, labels, embedding=embedding)
        else:
            engine.process(scan, labels)
        label_ms.append((t2 - t1) * 1e3)
        step_ms.append((time.perf_counter() - t2) * 1e3)
        if (i + 1) % 50 == 0:
            print(f"[{i + 1}/{len(scans)}] {(i + 1) / (time.time() - t0):.2f} scans/s")
    elapsed = time.time() - t0
    print(f"Processed {len(scans)} scans in {elapsed:.1f}s ({len(scans) / elapsed:.2f} scans/s)")

    os.makedirs(cfg.save_path, exist_ok=True)
    poses = engine.odo.poses if slam_opts else engine.poses
    positions = engine.positions
    if slam_opts:
        final = engine.final_trajectory()  # every frame re-based on its keyframe's optimized pose
        positions = final[:, :3, 3]
        poses = list(final)
        print(f"keyframes: {engine.keyframe_count}   edges: {engine.edge_count}   "
              f"loop closures: {engine.loop_count}")
    traj = np.stack([p[:3].reshape(-1) for p in poses])
    np.savetxt(os.path.join(cfg.save_path, f"traj_{seq}.txt"), traj, fmt="%.6f")
    result = dict(engine=engine, trajectory=traj, seconds=elapsed, label_ms=label_ms, step_ms=step_ms)

    gt_file = os.path.join(cfg.data_root, "dataset", "poses", f"{seq}.txt")
    if os.path.exists(gt_file):
        gt = load_kitti_poses(gt_file)[: len(poses), :3, 3]
        result["ate"], _ = absolute_trajectory_error(positions, gt, align=True)
        result["rpe"], _ = relative_pose_error(positions, gt, delta=10)
        print(f"ATE RMSE: {result['ate']:.3f} m   RPE@10: {result['rpe']:.3f} m")
        if slam_opts:
            result["ate_live"], _ = absolute_trajectory_error(engine.odo.positions, gt, align=True)
            print(f"ATE RMSE (live, no retro-correction): {result['ate_live']:.3f} m")
    return result


if __name__ == "__main__":
    main()
