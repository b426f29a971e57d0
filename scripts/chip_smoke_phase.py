#!/usr/bin/env python3
"""Run one phase of ``chip_smoke.py`` that takes the kernels line (``phase_backbones``,
``phase_last_backbones``, ``phase_kitti``, ``phase_keypoint_heads``'s kin) after the device and build
phases, on one CUDA card, and print the columns it adds to each kernel's row: a quick check of a slice's
phase without the whole script.

    python3 scripts/chip_smoke_phase.py phase_kitti
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "phase_last_backbones"
    t0 = time.perf_counter()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    kernels = [{"name": kernel} for kernel in chip_smoke.launch_counts()]
    getattr(chip_smoke, name)(kernels)
    print(json.dumps({"kernels": kernels}))
    print(f"{name} alone: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
