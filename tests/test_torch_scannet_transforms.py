"""The ScanNet recipes' transforms in the port against the JAX package's on the CPU.

``RandomDropout``, ``ChromaticAutoContrast``, ``ChromaticTranslation``,
``ChromaticJitter``, ``ElasticDistortion`` (scipy's ``ndimage.convolve`` and
``RegularGridInterpolator``) and ``SphereCrop``, each with the arguments of
``configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py`` and with its
random branch always taken, then that recipe's whole train pipeline, on a
synthetic room with normals under one ``np.random`` seed per package: every
array equal, with its dtype, and the next draw of ``np.random`` equal (each
transform draws what JAX's draws, in its order).
"""

import os

import numpy as np
import pytest

from pointcept_keypointdetection_tpu.datasets.transform import TRANSFORMS as JAX_TRANSFORMS
from pointcept_keypointdetection_tpu.datasets.transform import Compose as JaxCompose
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import make_scene
from pointcept_keypointdetection_tpu_torch.datasets.transform import TRANSFORMS, Compose
from pointcept_keypointdetection_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "scannet", "insseg-pointgroup-v1m1-0-spunet-base.py")
CASES = {
    "RandomDropout": [dict(dropout_ratio=0.2, dropout_application_ratio=0.2),
                      dict(dropout_ratio=0.2, dropout_application_ratio=1.0)],
    "ChromaticAutoContrast": [dict(p=0.2, blend_factor=None), dict(p=1.0, blend_factor=None),
                              dict(p=1.0, blend_factor=0.3)],
    "ChromaticTranslation": [dict(p=0.95, ratio=0.05), dict(p=1.0, ratio=0.05)],
    "ChromaticJitter": [dict(p=0.95, std=0.05), dict(p=1.0, std=0.05)],
    "ElasticDistortion": [dict(distortion_params=[[0.2, 0.4], [0.8, 1.6]])],
    "SphereCrop": [dict(point_max=3000, mode="random"), dict(point_max=3000, mode="center"),
                   dict(sample_rate=0.5, mode="random")],
}


def _room(seed: int = 3, n: int = 5000) -> dict:
    rng = np.random.default_rng(seed)
    coord, color, segment, instance = make_scene(rng, n, 20)
    normal = rng.normal(size=(n, 3))
    normal = (normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(np.float32)
    return dict(coord=coord, color=color, normal=normal, segment=segment, instance=instance)


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("name,kwargs", [(name, kw) for name, kws in CASES.items() for kw in kws])
@pytest.mark.parametrize("seed", [0, 1])
def test_transform_matches_jax(name, kwargs, seed):
    data = _room()
    outs = []
    for registry in (TRANSFORMS, JAX_TRANSFORMS):
        t = registry.build(dict(type=name, **kwargs))
        np.random.seed(seed)
        out = t({k: v.copy() for k, v in data.items()})
        outs.append((out, np.random.random()))
    (got, after), (ref, ref_after) = outs
    _assert_same(got, ref)
    assert after == ref_after


def test_recipe_train_pipeline_matches_jax():
    """The ScanNet PG-v1m1 recipe's train transforms end to end (InstanceParser and Collect included)."""
    transform = Config.fromfile(RECIPE).data.train.transform
    outs = []
    for compose in (Compose, JaxCompose):
        pipeline = compose([dict(t) for t in transform])
        np.random.seed(11)
        outs.append(pipeline(_room(4, 20000)))
    got, ref = outs
    _assert_same(got, ref)
    assert got["feat"].shape[1] == 6 and got["instance_centroid"].shape == got["coord"].shape
