"""Point-cloud dumps as ascii PLY, the port's own copy of
``pointcept_keypointdetection_tpu/utils/visualization.py`` (numpy only).

The files are the JAX package's byte for byte: the same header, each
coordinate an ``np.float32`` formatted by ``f"{x}"``, colours as uint8.
``save_labeled_cloud`` colours by ``LABEL_PALETTE`` (a negative label grey 64),
``save_keypoints`` writes each keypoint as a 3 x 3 x 3 cluster of points
2 units apart (a sphere stand-in for the headless image).
"""

from __future__ import annotations

import os

import numpy as np


def save_point_cloud(path: str, coord: np.ndarray, color=None) -> None:
    """Write an ascii PLY of points (+ optional uint8 RGB colors)."""
    coord = np.asarray(coord, np.float32)
    n = len(coord)
    has_color = color is not None
    if has_color:
        color = np.asarray(color)
        if color.dtype != np.uint8:
            color = np.clip(color, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{coord[i, 0]} {coord[i, 1]} {coord[i, 2]}"
            if has_color:
                row += f" {color[i, 0]} {color[i, 1]} {color[i, 2]}"
            f.write(row + "\n")


LABEL_PALETTE = np.array(
    [
        [174, 199, 232], [152, 223, 138], [31, 119, 180], [255, 187, 120], [188, 189, 34],
        [140, 86, 75], [255, 152, 150], [214, 39, 40], [197, 176, 213], [148, 103, 189],
        [196, 156, 148], [23, 190, 207], [247, 182, 210], [219, 219, 141], [255, 127, 14],
        [158, 218, 229], [44, 160, 44], [112, 128, 144], [227, 119, 194], [82, 84, 163],
    ],
    np.uint8,
)


def save_labeled_cloud(path: str, coord: np.ndarray, labels: np.ndarray) -> None:
    labels = np.asarray(labels).astype(np.int64)
    colors = LABEL_PALETTE[np.maximum(labels, 0) % len(LABEL_PALETTE)]
    colors[labels < 0] = 64
    save_point_cloud(path, coord, colors)


def save_keypoints(path: str, keypoints: np.ndarray, color=(255, 0, 0)) -> None:
    """Dump keypoints as small colored point clusters (sphere stand-in)."""
    kp = np.asarray(keypoints, np.float32).reshape(-1, 3)
    offsets = np.stack(np.meshgrid(*([[-1, 0, 1]] * 3), indexing="ij"), -1).reshape(-1, 3) * 2.0
    pts = (kp[:, None, :] + offsets[None]).reshape(-1, 3)
    colors = np.tile(np.asarray(color, np.uint8), (len(pts), 1))
    save_point_cloud(path, pts, colors)
