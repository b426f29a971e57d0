"""The port's PT-v2m2 and ``KeypointPTv2`` against the JAX package on the CPU.

A small PT-v2m2 (4 input channels; a patch embedding of width 8 over 6
neighbours; one stage of width 16 and one Block over 6 neighbours, grid
pooling at 0.1; a decoder Block of width 8; drop path 0) under
``KeypointPTv2`` (hidden 16) over 2 samples of 96 slots with 8 pad rows, one
point per voxel in [0, 16)^3 at grid 0.05.  With the same seeded weights
(names from ``jax.eval_shape``, carried over by ``convert.py``): the
backbone's features on the valid rows in eval and in training mode, the eval
prediction, and one training step (JAX's Dropout mask read off its output):
the prediction, the loss, ``mean_dist``, every gradient and the running
statistics after it.  At this slot ``knn_impl="auto"`` takes the brute
``knn``, as at the fork's slot of 8192; the same backbone with
``knn_impl="bucketed"`` (the path of a slot of 16384 and more) and no Block
past the patch embedding's is held in its eval forward: its three searches
run bucketed, the patch embedding's Block reads one.  JAX compiles all of it as one function, in a thread
started by the file's first test, with XLA's cheaper CPU passes.

JAX searches under ``jit``, where XLA rounds a distance otherwise than the
port, which follows JAX outside ``jit``: the tests assert that every query's
k-th and (k+1)-th nearest candidates lie clearly apart at every search of the
port's run, so both packages keep the same neighbours.

Tolerance: f32 within 1e-4 x max(1, max|jax|) per tensor, losses 1e-4
relative; running statistics 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch_parity import (assert_clear_kth_neighbours, check_backbone_forward, check_training_step, keypoint_batch,
                          keypoint_reference, port_point, recorded_searches)

from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.models import point_transformer_v2
from pointcept_keypointdetection_tpu_torch.utils.config import Config

SLOT, SAMPLES, PADS, SPAN = 96, 2, 8, 16
BACKBONE = dict(type="PT-v2m2", in_channels=4, patch_embed_channels=8, patch_embed_groups=2, patch_embed_neighbours=6,
                enc_depths=(1,), enc_channels=(16,), enc_groups=(2,), enc_neighbours=(6,), dec_depths=(1,),
                dec_channels=(8,), dec_groups=(2,), dec_neighbours=(6,), grid_sizes=(0.1,), slot_divisors=(2,),
                drop_path_rate=0.0)
MODEL = dict(type="KeypointPTv2", num_keypoints=6, hidden_dim=16, backbone_conf=BACKBONE)
BUCKETED = dict(MODEL, backbone_conf=dict(BACKBONE, knn_impl="bucketed", enc_depths=(0,), dec_depths=(0,)))
TOL = 1e-4


def _batch():
    return keypoint_batch(1, SAMPLES, SLOT, PADS, SPAN)


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(keypoint_reference, MODEL, _batch(), "PointTransformerV2", 40, {"bucketed": BUCKETED})


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def test_fork_config_builds():
    cfg = Config.fromfile("configs/my_dataset/keypoint_ptv2.py")
    model = build_model(dict(cfg.model))
    assert model.head[0].in_features == model.backbone.out_channels == 48
    assert {name for name, _ in model.backbone.named_children()} >= {"embed_fc", "patch_embed", "enc3_pool", "dec0_up"}
    with pytest.raises(NotImplementedError, match="PDNorm"):
        build_model(dict(cfg.model.backbone_conf, pdnorm_conditions=2))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ptv2_forward_matches_jax(reference, monkeypatch, train):
    calls = recorded_searches(monkeypatch, point_transformer_v2)
    check_backbone_forward(MODEL, reference, _batch(), train, TOL)
    assert {fn.__name__ for fn, _, _ in calls} == {"knn"} and len(calls) == 3  # embed, encoder, decoder
    assert_clear_kth_neighbours(calls)


def test_ptv2_bucketed_forward_matches_jax(reference, monkeypatch):
    calls = recorded_searches(monkeypatch, point_transformer_v2)
    check_backbone_forward(BUCKETED, reference["extra"]["bucketed"], _batch(), False, TOL)
    assert {fn.__name__ for fn, _, _ in calls} == {"knn_bucketed"}
    assert [kw.get("cell_cap", a[7] if len(a) > 7 else None) for _, a, kw in calls] == [64] * 3
    assert [a[3] for _, a, _ in calls] == pytest.approx([0.1, 0.25, 0.1])
    assert_clear_kth_neighbours(calls)


def test_keypoint_ptv2_training_step_matches_jax(reference):
    check_training_step(MODEL, reference, _batch(), TOL)


def test_auto_search_turns_bucketed_at_slot_16384(monkeypatch):
    """``knn_impl="auto"``: brute below a first level of 16384 rows per sample, bucketed from there."""
    seen = []
    monkeypatch.setattr(point_transformer_v2, "find_neighbours", lambda point, k, cell: seen.append(cell) or (
        torch.zeros((point.num_points, k), dtype=torch.int64), torch.ones((point.num_points, k), dtype=torch.bool)))
    model = build_model(dict(BACKBONE, enc_depths=(1, 1), enc_channels=(16, 16), enc_groups=(2, 2),
                             enc_neighbours=(6, 6), dec_depths=(1, 1), dec_channels=(8, 16), dec_groups=(2, 2),
                             dec_neighbours=(6, 6), grid_sizes=(0.1, 0.2), slot_divisors=(2, 4))).eval()
    for slot in (96, 16384):
        with torch.no_grad():
            model(port_point(keypoint_batch(3, 1, slot, 0, 32)))
    assert seen[:5] == [0.0] * 5 and seen[5:] == pytest.approx([0.1, 0.25, 0.5, 0.25, 0.1])
