"""Benchmark: PTv3 semseg forward throughput on one card, the port's counterpart of ``bench.py``.

    python -m pointcept_keypointdetection_tpu_torch.bench

Prints ONE JSON line: {"metric", "value", "unit"}.

Workload, built as ``bench.py:88-188`` builds it: one synthetic scene of
102,400 padded points (numpy seed 0, uniform in an 8 m cube, a 0.02 m grid,
one valid point per voxel and at least 64 pads), 6 feature channels;
``DefaultSegmentorV2`` with 20 classes over full-width PT-v3m1 at patch 1024
on every level, slot divisors (1, 4, 16, 64, 128), ``kmap_depth`` 10 and the
k=5 cell-packed stem; bf16 features and float parameters, the BN running
statistics in f32.  The weights are seeded (torch seed 0).  A forward
covers serialization, kernel maps, rulebooks, the model and the head.

Timing, ``bench.py``'s steady-state rule: (t(31 forwards) - t(11)) / 20,
each window closed by ``torch.cuda.synchronize()``, after one warm-up
forward.  The unit names the card and its power limit.  Unlike
``bench.py`` there is no ``vs_baseline`` (its denominator is an estimate for
another card), no retry and no fallback: without a card it fails.
``--points`` and ``--device cpu`` exist for the tests on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models import PointBatch, build_model, cast_parameters, init_weights

METRIC = "ptv3_semseg_forward_scenes_per_sec"
POINTS = 102400
PATCH = 1024
WINDOWS = (11, 31)  # forwards in the short and the long timed window


def model_config() -> Dict:
    """``bench.py``'s model dict; ``attn_impl`` is accepted and ignored, ``chain_cpe0`` ignored under
    ``kmap_mode="direct"``."""
    backbone = dict(
        type="PT-v3m1",
        in_channels=6,
        stride=(2, 2, 2, 2),
        enc_depths=(2, 2, 2, 6, 2),
        enc_channels=(32, 64, 128, 256, 512),
        enc_num_head=(2, 4, 8, 16, 32),
        enc_patch_size=(PATCH,) * 5,
        dec_depths=(2, 2, 2, 2),
        dec_channels=(64, 64, 128, 256),
        dec_num_head=(4, 4, 8, 16),
        dec_patch_size=(PATCH,) * 4,
        drop_path=0.0,
        slot_divisors=(1, 4, 16, 64, 128),
        stem_kernel=5,
        kmap_depth=10,
        attn_impl="pallas",
        kmap_mode="direct",
        chain_cpe0="direct",
        stem_conv="cell_packed",
    )
    return dict(type="DefaultSegmentorV2", backbone=backbone, criteria=(), num_classes=20, backbone_out_channels=64)


def scene(points: int = POINTS) -> Dict[str, np.ndarray]:
    """``bench.py:99-112`` for one scene: coord f32 [S, 3], grid int32 [S, 3], valid bool [S], feat f32 [S, 6]."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 8.0, (1, points, 3)).astype(np.float32)
    grid = np.floor(coords / 0.02).astype(np.int32)
    valid = np.zeros((1, points), bool)
    _, first = np.unique(grid[0, :, 0].astype(np.int64) * 10**8 + grid[0, :, 1] * 10**4 + grid[0, :, 2],
                         return_index=True)
    valid[0, first[: min(len(first), points - 64)]] = True
    feat = rng.normal(size=(1, points, 6)).astype(np.float32)
    feat[~valid] = 0
    if int(grid.max()) >= 1 << 10:  # kmap_depth 10
        raise ValueError(f"grid coordinate {int(grid.max())} exceeds kmap_depth 10")
    return dict(coord=coords[0], grid_coord=grid[0], valid=valid[0], feat=feat[0])


def build_workload(points: int = POINTS, device: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                   model: Optional[torch.nn.Module] = None) -> Tuple[torch.nn.Module, PointBatch]:
    """(the model in eval mode on ``device`` with its float parameters in ``dtype``, the scene's
    PointBatch with ``dtype`` features).  Without ``model`` the weights are seeded (seed 0)."""
    if model is None:
        model = init_weights(build_model(model_config()), torch.Generator().manual_seed(0))
    model = cast_parameters(model, dtype).to(device).eval()
    s = {k: torch.from_numpy(v).to(device) for k, v in scene(points).items()}
    point = PointBatch(coord=s["coord"], feat=s["feat"].to(dtype), grid_coord=s["grid_coord"], valid=s["valid"],
                       num_samples=1)
    return model, point


def forward(model: torch.nn.Module, point: PointBatch) -> torch.Tensor:
    with torch.inference_mode():
        return model(point)["seg_logits"]


def measure(model: torch.nn.Module, point: PointBatch) -> float:
    """Scenes per second by the steady-state rule, after one warm-up forward."""
    dev = point.coord.device

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(n: int) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            forward(model, point)
        sync()
        return time.perf_counter() - t0

    window(1)
    short, long = WINDOWS
    t_short = window(short)
    t_long = window(long)
    return point.num_samples * (long - short) / (t_long - t_short)


def device_name(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or ``cpu``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[torch.device(device).index or 0]


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--points", type=int, default=POINTS, help="points per scene (a multiple of the patch)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card (--device cpu for the tests), and none is available")
    t0 = time.perf_counter()
    model, point = build_workload(args.points, args.device)
    print(f"# workload built in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    value = measure(model, point)
    unit = f"scenes/s ({args.points} pts/scene, patch {PATCH}, k=5 stem, bf16, 1 x {device_name(args.device)})"
    print(json.dumps({"metric": METRIC, "value": value, "unit": unit}), flush=True)


if __name__ == "__main__":
    main()
