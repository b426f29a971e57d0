"""The port's PT-v1, ``farthest_point_sampling`` and ``KeypointPTv1`` against the JAX package on the CPU.

``farthest_point_sampling`` index for index against JAX's, jitted and
``vmap`` ped over samples as ``TransitionDown`` calls it, and eagerly one
cloud at a time: random clouds with pads and a sample with fewer valid
points than picks (the farthest valid point repeats), a pad in row 0 (picked
first all the same), ``start_idx`` > 0, and points on a coarse dyadic grid,
where many distances tie exactly (ties to the first index).

A small PT-v1 (4 input channels; planes 8 and 16, strides 1 and 4, one
Bottleneck in the first stage and none in the second, whose down- and
up-transitions still run; share planes 4, 6 neighbours) under
``KeypointPTv1`` (hidden 16) over 2 samples of 96 slots with 8 pad rows, one
point per voxel in [0, 16)^3 at grid 0.05.  With the same seeded weights (names from
``jax.eval_shape``, carried over by ``convert.py``): the backbone's features
on the valid rows in eval and in training mode, the eval prediction, and one
training step (JAX's Dropout mask read off its output): the prediction, the
loss, ``mean_dist``, every gradient and the running statistics after it.
JAX compiles all of it as one function, in a thread started by the file's
first test, with XLA's cheaper CPU passes.  JAX searches under ``jit``,
where XLA rounds a distance otherwise than the port: the tests assert that
every query's k-th and (k+1)-th nearest candidates lie clearly apart at
every search of the port's run (the groupings, the down-transition's and the
up-transition's 3-NN), so both packages keep the same neighbours.

Tolerance: f32 within 1e-4 x max(1, max|jax|) per tensor, losses 1e-4
relative; running statistics 1e-6; indices exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import (assert_clear_kth_neighbours, check_backbone_forward, check_training_step, keypoint_batch,
                          keypoint_reference, recorded_searches)

from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.models import point_transformer
from pointcept_keypointdetection_tpu_torch.ops.sampling import (farthest_point_sampling,
                                                                farthest_point_sampling_batched)
from pointcept_keypointdetection_tpu_torch.utils.config import Config

SLOT, SAMPLES, PADS, SPAN = 96, 2, 8, 16
BACKBONE = dict(type="PT-v1", in_channels=4, planes=(8, 16), blocks=(1, 0), strides=(1, 4), share_planes=4,
                nsample=(6, 6))
MODEL = dict(type="KeypointPTv1", num_keypoints=6, hidden_dim=16, backbone_conf=BACKBONE)
TOL = 1e-4
PICKS = 150


def _batch():
    return keypoint_batch(1, SAMPLES, SLOT, PADS, SPAN)


def _fps_cases():
    """name: (coord [B, N, 3], valid [B, N], start_idx)."""
    rng = np.random.default_rng(5)
    coord = (rng.uniform(-1, 1, (3, 600, 3)) * 0.37).astype(np.float32)
    valid = rng.uniform(size=(3, 600)) < 0.9
    valid[2, 100:] = False  # fewer valid points than picks
    pad_first = valid.copy()
    pad_first[:, 0] = False
    grid = (rng.integers(0, 6, (3, 600, 3)) * 0.25).astype(np.float32)
    return {"random": (coord, valid, 0), "pad_in_row_0": (coord, pad_first, 0), "start_idx": (coord, valid, 17),
            "ties": (grid, valid, 0)}


def _jax_fps():
    import jax
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.ops.sampling import farthest_point_sampling as jax_fps

    out = {}
    for name, (coord, valid, start) in _fps_cases().items():
        vmapped = jax.jit(jax.vmap(lambda c, v, s=start: jax_fps(c, PICKS, v, start_idx=s)))
        eager = jax_fps(jnp.asarray(coord[0]), PICKS, jnp.asarray(valid[0]), start_idx=start)
        out[name] = dict(jit=np.asarray(vmapped(coord, valid)), eager=np.asarray(eager))
    return out


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: dict(keypoint_reference(MODEL, _batch(), "PointTransformerV1", 50), fps=_jax_fps()))


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


@pytest.mark.parametrize("case", list(_fps_cases()))
def test_farthest_point_sampling_matches_jax(reference, case):
    coord, valid, start = _fps_cases()[case]
    ref = reference["fps"][case]
    picks = farthest_point_sampling_batched(torch.from_numpy(coord), PICKS, torch.from_numpy(valid), start)
    np.testing.assert_array_equal(picks.numpy(), ref["jit"])
    one = farthest_point_sampling(torch.from_numpy(coord[0]), PICKS, torch.from_numpy(valid[0]), start)
    assert one.dtype == torch.int32
    np.testing.assert_array_equal(one.numpy(), ref["eager"])
    assert picks[:, 0].tolist() == [start] * 3
    if case == "random":  # 100 valid points in the last sample: every one once, then the first valid one again
        last = picks[2].numpy()
        assert sorted(set(last[:100].tolist())) == np.flatnonzero(valid[2]).tolist()
        assert set(last[100:].tolist()) == {int(np.flatnonzero(valid[2])[0])}


def test_fork_config_builds():
    cfg = Config.fromfile("configs/my_dataset/keypoint_ptv1.py")
    model = build_model(dict(cfg.model))
    assert model.head[0].in_features == model.backbone.out_channels == 32
    assert len([m for m in model.modules() if isinstance(m, point_transformer.Bottleneck)]) == 18 + 4


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ptv1_forward_matches_jax(reference, monkeypatch, train):
    calls = recorded_searches(monkeypatch, point_transformer)
    check_backbone_forward(MODEL, reference, _batch(), train, TOL)
    # stage 0's and stage 1's groupings, the down-transition's search, the up-transition's 3-NN, the decoder's
    assert [a[2] for _, a, _ in calls] == [6, 6, 6, 3, 6]
    assert_clear_kth_neighbours(calls)


def test_keypoint_ptv1_training_step_matches_jax(reference):
    check_training_step(MODEL, reference, _batch(), TOL)
