"""Where one offset-keypoint request's time goes on the card.

    python -m pointcept_keypointdetection_tpu_torch.profile_request [--requests 5] [--out FILE]

Builds the full-width ``offset_keypoint_ptv3.py`` predictor with seeded
weights on CUDA and, over seeded 20k-point body clouds (7 columns):

* host clock around each stage of a request: ``prepare`` (normalize,
  voxelize, subsample; numpy), ``forward`` (collate, copy to the card, model,
  copy back; ends in a synchronize) and ``aggregate``;
* ``torch.profiler`` over the forwards: device time by kernel name, the
  kernels' share of it, and the device's idle share of the forward's wall
  time.

Prints a summary (beside the card's name and power limit) and, with
``--out``, writes it as JSON.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from scipy.special import expit

from .datasets.synthetic import body_cloud
from .inference.keypoint import OffsetKeypointPredictor, aggregate_keypoints, estimate_normals_curvature
from .utils.config import Config


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-file", default="configs/my_dataset/offset_keypoint_ptv3.py")
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_request measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    cfg = Config.fromfile(args.config_file)
    predictor = OffsetKeypointPredictor(dict(cfg.model), None, cfg.slot_size, "cuda", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    clouds = []
    for _ in range(args.requests):
        coord = body_cloud(rng, args.points)
        clouds.append((coord, estimate_normals_curvature(coord)))
    predictor.predict(*clouds[0])  # warm-up: kernel build, CUDA context, allocator

    stages = defaultdict(list)
    prepared = []
    for coord, feat in clouds:
        t0 = time.perf_counter()
        data, centroid, scale = predictor.prepare(coord, feat)
        t1 = time.perf_counter()
        out = predictor.forward(data)
        t2 = time.perf_counter()
        aggregate_keypoints(data["coord"], out["offset_pred"], expit(out["mask_logits"]), "argmax")
        t3 = time.perf_counter()
        stages["prepare"].append((t1 - t0) * 1e3)
        stages["forward"].append((t2 - t1) * 1e3)
        stages["aggregate"].append((t3 - t2) * 1e3)
        prepared.append(data)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for data in prepared:
            predictor.forward(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            by_kernel[evt.name][1] += 1
    device_ms = sum(v[0] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    n = len(prepared)
    result = dict(
        card=card,
        requests=n,
        points=args.points,
        host_ms_median={k: statistics.median(v) for k, v in stages.items()},
        forward_wall_ms=wall_ms / n,
        device_busy_ms=device_ms / n,
        device_idle_share=(1.0 - device_ms / wall_ms) if device_ms else None,
        kernel_launches=sum(v[1] for v in by_kernel.values()) / n,
        top_kernels=[dict(name=name[:120], ms=ms / n, launches=cnt / n) for name, (ms, cnt) in top],
    )
    print(f"[{card}] {n} requests of {args.points} points; medians (host clock, ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in result["host_ms_median"].items()))
    print(f"[{card}] under the profiler, per forward: wall {result['forward_wall_ms']:.2f} ms, device busy "
          f"{result['device_busy_ms']:.2f} ms, idle share {result['device_idle_share']}, "
          f"{result['kernel_launches']:.0f} kernels")
    for row in result["top_kernels"]:
        print(f"  {row['ms']:8.3f} ms  x{row['launches']:6.1f}  {row['name']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
