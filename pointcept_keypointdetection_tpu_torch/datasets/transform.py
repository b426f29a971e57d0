"""Host-side (numpy) transforms of the repo's offset-keypoint and segmentation
training configs.

The port's copies of ``pointcept_keypointdetection_tpu/datasets/
transform.py``: ``Compose``, ``Collect``, ``Copy``, ``Update``,
``NormalizeColor``, ``CenterShift``, ``PointClip``, ``RandomDropout``, ``RandomRotate``,
``RandomScale`` (a fixed scale [s, s], as the test-time aug lists use it, is
one draw that returns s), ``RandomFlip``, ``RandomJitter``,
``ChromaticAutoContrast``, ``ChromaticTranslation``, ``ChromaticJitter``,
``ElasticDistortion`` (scipy's ``ndimage.convolve`` and
``RegularGridInterpolator``), ``GridSample`` (train and test mode,
``return_inverse``), ``SphereCrop``, ``ShufflePoint`` and
``InstanceParser``.  Their
random draws come from the global ``np.random`` stream in the JAX package's
order, and they keep its dtypes (a rotation or a scale turns f32
coordinates into f64), so the same seed gives the same arrays.  The other
transforms are not ported yet.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.interpolate
import scipy.ndimage

from ..ops.serialization import z_order_encode_np
from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")

# keys indexed per point by index-based transforms (`transform.py:29-45`)
VALID_INDEX_KEYS = (
    "coord",
    "origin_coord",
    "color",
    "feat",
    "normal",
    "strength",
    "segment",
    "instance",
    "displacement",
    "grid_coord",
    "keypoint_offset",
    "keypoint_mask",
    "correspondence",
)


def index_operator(data_dict, index, duplicate=False):
    """Index every per-point key in place, or with ``duplicate`` in a shallow copy of the dict."""
    out = dict(data_dict) if duplicate else data_dict
    for key in data_dict.get("index_valid_keys", VALID_INDEX_KEYS):
        if key in out:
            out[key] = out[key][index]
    return out


class Compose:
    def __init__(self, cfg=None):
        self.transforms = [TRANSFORMS.build(dict(t)) for t in (cfg or [])]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Select keys; concatenate ``feat_keys`` into 'feat'."""

    def __init__(self, keys, feat_keys=("coord",)):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.feat_keys = [feat_keys] if isinstance(feat_keys, str) else list(feat_keys)

    def __call__(self, data_dict):
        out = {key: data_dict[key] for key in self.keys}
        feats = [data_dict[k] for k in self.feat_keys]
        feats = [f.reshape(f.shape[0], -1) if f.ndim > 1 else f.reshape(-1, 1) for f in feats]
        out["feat"] = np.concatenate(feats, axis=1).astype(np.float32)
        return out


@TRANSFORMS.register_module()
class Copy:
    """Deep copies of the keys of ``keys_dict`` under its values (default: coord and segment as
    origin_coord and origin_segment)."""

    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or dict(coord="origin_coord", segment="origin_segment")

    def __call__(self, data_dict):
        for src, dst in self.keys_dict.items():
            if src in data_dict:
                data_dict[dst] = copy.deepcopy(data_dict[src])
        return data_dict


@TRANSFORMS.register_module()
class Update:
    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict or {}

    def __call__(self, data_dict):
        data_dict.update(self.keys_dict)
        return data_dict


@TRANSFORMS.register_module()
class NormalizeColor:
    """color / 255 (`transform.py:121`, this fork's convention)."""

    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 255
        return data_dict


@TRANSFORMS.register_module()
class CenterShift:
    """Centre x and y on their range's midpoint and, with ``apply_z``, put the lowest z at 0."""

    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        x_min, y_min, z_min = coord.min(axis=0)
        x_max, y_max, _ = coord.max(axis=0)
        shift = [(x_min + x_max) / 2, (y_min + y_max) / 2, z_min if self.apply_z else 0]
        data_dict["coord"] = coord - shift
        return data_dict


@TRANSFORMS.register_module()
class PointClip:
    """Clip the coordinates into ``point_cloud_range`` (x, y, z minima, then maxima); no point is dropped."""

    def __init__(self, point_cloud_range=(-80, -80, -3, 80, 80, 1)):
        self.range = point_cloud_range

    def __call__(self, data_dict):
        data_dict["coord"] = np.clip(data_dict["coord"], self.range[:3], self.range[3:])
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    """With probability ``dropout_application_ratio``, keep a random ``1 - dropout_ratio`` of the rows."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data_dict):
        if np.random.random() < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            idx = np.random.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            data_dict = index_operator(data_dict, idx)
        return data_dict


def _rotation_matrix(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


@TRANSFORMS.register_module()
class RandomRotate:
    """With probability ``p`` (1 with ``always_apply``), rotate about ``axis`` by
    uniform(angle) * pi around ``center`` (default: the middle of the cloud's
    bounding box); normals turn with it.  (JAX's ``keypoint_keys``, which no
    config sets, is not ported.)"""

    def __init__(self, angle=None, center=None, axis="z", always_apply=False, p=0.5):
        self.angle = [-1, 1] if angle is None else angle
        self.axis = axis
        self.p = p if not always_apply else 1.0
        self.center = center

    def __call__(self, data_dict):
        if np.random.random() > self.p:
            return data_dict
        angle = np.random.uniform(self.angle[0], self.angle[1]) * np.pi
        rot = _rotation_matrix(self.axis, angle)
        coord = data_dict["coord"]
        if self.center is None:
            center = (coord.min(0) + coord.max(0)) / 2
        else:
            center = self.center
        data_dict["coord"] = (coord - center) @ rot.T + center
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot.T
        return data_dict


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False):
        self.scale = scale if scale is not None else [0.95, 1.05]
        self.anisotropic = anisotropic

    def __call__(self, data_dict):
        s = np.random.uniform(self.scale[0], self.scale[1], 3 if self.anisotropic else 1)
        data_dict["coord"] = data_dict["coord"] * s
        return data_dict


@TRANSFORMS.register_module()
class RandomFlip:
    """Negate x, then y, each with probability ``p`` (one draw per axis), in place."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, data_dict):
        for axis in (0, 1):
            if np.random.random() < self.p:
                data_dict["coord"][:, axis] = -data_dict["coord"][:, axis]
                if "normal" in data_dict:
                    data_dict["normal"][:, axis] = -data_dict["normal"][:, axis]
        return data_dict


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data_dict):
        jitter = np.clip(self.sigma * np.random.randn(*data_dict["coord"].shape), -self.clip, self.clip)
        data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    """With probability ``p``, blend the colour with its per-channel stretch to [0, 255] (the blend
    factor drawn where ``blend_factor`` is None)."""

    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.random() < self.p:
            color = data_dict["color"]
            lo = np.min(color, axis=0, keepdims=True)
            hi = np.max(color, axis=0, keepdims=True)
            contrast = (color - lo) * (255 / np.maximum(hi - lo, 1e-6))
            blend = self.blend_factor if self.blend_factor is not None else np.random.random()
            data_dict["color"] = (1 - blend) * color + blend * contrast
        return data_dict


@TRANSFORMS.register_module()
class ChromaticTranslation:
    """With probability ``p``, shift the colour by one uniform draw per channel within +-255 ``ratio``."""

    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.random() < self.p:
            tr = (np.random.random((1, 3)) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"] = np.clip(data_dict["color"] + tr, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ChromaticJitter:
    """With probability ``p``, add normal noise of std 255 ``std`` to every colour value."""

    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.random() < self.p:
            noise = np.random.randn(data_dict["color"].shape[0], 3) * self.std * 255
            data_dict["color"] = np.clip(data_dict["color"] + noise, 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ElasticDistortion:
    """For each (granularity, magnitude): a grid of normal noise at ``granularity`` spacing, blurred
    twice by a 3-wide box along each axis, interpolated at every point and added times ``magnitude``."""

    def __init__(self, distortion_params=None):
        self.params = [[0.2, 0.4], [0.8, 1.6]] if distortion_params is None else distortion_params

    @staticmethod
    def _distort(coords, granularity, magnitude):
        blurs = [np.ones((3, 1, 1, 1)) / 3, np.ones((1, 3, 1, 1)) / 3, np.ones((1, 1, 3, 1)) / 3]
        coords_min = coords.min(0)
        dims = ((coords - coords_min).max(0) // granularity).astype(int) + 3
        noise = np.random.randn(*dims, 3).astype(np.float32)
        for _ in range(2):
            for blur in blurs:
                noise = scipy.ndimage.convolve(noise, blur, mode="constant", cval=0)
        ax = [np.linspace(d_min, d_max, d)
              for d_min, d_max, d in zip(coords_min - granularity, coords_min + granularity * (dims - 2), dims)]
        interp = scipy.interpolate.RegularGridInterpolator(ax, noise, bounds_error=False, fill_value=0)
        return coords + interp(coords) * magnitude

    def __call__(self, data_dict):
        if "coord" in data_dict and self.params is not None:
            for granularity, magnitude in self.params:
                data_dict["coord"] = self._distort(data_dict["coord"], granularity, magnitude)
        return data_dict


def _voxel_runs(grid_coord: np.ndarray):
    """(by_voxel, run_start, run_len, voxel_of_row): rows sorted voxel by voxel by their exact
    48-bit Morton key; voxel v owns sorted positions run_start[v] : +run_len[v], and row r lies in
    voxel voxel_of_row[r]."""
    if grid_coord.max() >= 2**16:
        raise ValueError("scene exceeds the 16-bit voxel extent")
    key = z_order_encode_np(grid_coord, depth=16)
    by_voxel = np.argsort(key, kind="stable")
    _, voxel_of_sorted, run_len = np.unique(key[by_voxel], return_inverse=True, return_counts=True)
    run_start = np.concatenate([[0], np.cumsum(run_len[:-1])])
    voxel_of_row = np.empty_like(voxel_of_sorted)
    voxel_of_row[by_voxel] = voxel_of_sorted
    return by_voxel, run_start, run_len, voxel_of_row


@TRANSFORMS.register_module()
class GridSample:
    """Voxel down-sampling over exact Morton-keyed runs (`transform.py:409-490`); ``grid_coord`` is
    shifted to start at 0 (``hash_type`` is accepted and unused, as in JAX).

    Train mode: one uniformly random row per voxel, drawn as one ``np.random.randint`` vector
    modulo the run lengths; with ``return_inverse``, ``inverse`` maps each input row to its voxel's
    row of the output.  Test mode: a list of parts, part i keeping each voxel's (i mod run
    length)-th row, with ``index`` (the input rows it keeps) and, with ``return_inverse``,
    ``inverse``; every row lies in at least one part.  Not ported: ``return_min_coord``,
    ``return_displacement`` and data-efficient ``sampled_index``."""

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train", return_inverse=False, return_grid_coord=True,
                 return_min_coord=False, return_displacement=False, project_displacement=False):
        if mode not in ("train", "test"):
            raise NotImplementedError(f"GridSample: mode {mode!r}")
        if return_min_coord or return_displacement or project_displacement:
            raise NotImplementedError("GridSample: min_coord and displacement outputs are not ported yet")
        self.grid_size = grid_size
        self.mode = mode
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord

    def __call__(self, data_dict):
        if "sampled_index" in data_dict:
            raise NotImplementedError("GridSample: sampled_index (data-efficient benchmarks) is not ported yet")
        grid_coord = np.floor(data_dict["coord"] / self.grid_size).astype(np.int64)
        grid_coord = grid_coord - grid_coord.min(0)
        by_voxel, run_start, run_len, voxel_of_row = _voxel_runs(grid_coord)
        if self.mode == "test":
            parts = []
            for i in range(run_len.max()):
                keep = by_voxel[run_start + i % run_len]
                data_dict["grid_coord"] = grid_coord
                part = index_operator(data_dict, keep, duplicate=True)
                part["index"] = keep
                if self.return_inverse:
                    part["inverse"] = voxel_of_row
                parts.append(part)
            return parts
        offsets = np.random.randint(0, run_len.max(), run_len.size) % run_len
        if self.return_inverse:
            data_dict["inverse"] = voxel_of_row
        data_dict["grid_coord"] = grid_coord
        data_dict = index_operator(data_dict, by_voxel[run_start + offsets])
        if not self.return_grid_coord:
            data_dict.pop("grid_coord")
        return data_dict


@TRANSFORMS.register_module()
class SphereCrop:
    """Keep the ``point_max`` rows (or ``sample_rate`` of them) nearest a centre: a random row's
    (``mode="random"``) or the middle row's."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        if mode not in ("random", "center", "all"):
            raise ValueError(f"SphereCrop: mode {mode!r}")
        self.point_max = point_max
        self.sample_rate = sample_rate
        self.mode = mode

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        point_max = int(self.sample_rate * coord.shape[0]) if self.sample_rate is not None else self.point_max
        if coord.shape[0] > point_max:
            if self.mode == "random":
                center = coord[np.random.randint(coord.shape[0])]
            else:
                center = coord[coord.shape[0] // 2]
            data_dict = index_operator(data_dict, np.argsort(np.sum((coord - center) ** 2, axis=1))[:point_max])
        return data_dict


@TRANSFORMS.register_module()
class ShufflePoint:
    def __call__(self, data_dict):
        return index_operator(data_dict, np.random.permutation(data_dict["coord"].shape[0]))


@TRANSFORMS.register_module()
class InstanceParser:
    """Instance targets (`transform.py:575-607`): instances of an ignored class get
    ``instance_ignore_index``, the rest are numbered 0.. in the order of their ids, and
    ``instance_centroid`` (f32 [N, 3]) holds each point's instance mean (its own coord where it has
    none); ``instance_centroid`` joins the keys that index-based transforms index."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        instance = data_dict["instance"].copy()
        instance[np.isin(data_dict["segment"], self.segment_ignore_index)] = self.instance_ignore_index
        uniq = np.unique(instance[instance != self.instance_ignore_index])
        out = np.full_like(instance, self.instance_ignore_index)
        centroid = coord.copy()
        for new, old in enumerate(uniq):
            sel = instance == old
            out[sel] = new
            centroid[sel] = coord[sel].mean(0)
        data_dict["instance"] = out
        data_dict["instance_centroid"] = centroid.astype(np.float32)
        if "instance_centroid" not in data_dict.get("index_valid_keys", ()):
            data_dict.setdefault("index_valid_keys", list(VALID_INDEX_KEYS)).append("instance_centroid")
        return data_dict
