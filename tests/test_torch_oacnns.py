"""The port's OA-CNNs and ``KeypointOACNNs`` against the JAX package on the CPU.

A small OA-CNNs (4 input channels, base 8, two stages of widths 8 and 16: a
BasicBlock in the first, none in the second, whose down-sampling, norm and
aggregation still run; an ``AdaptiveAggregation`` per stage; the decoder's
Cin = 2C block with its projection) under ``KeypointOACNNs`` (hidden 16) over 2
samples of 96 slots with 8 pad rows, one point per voxel in [0, 16)^3 at grid
0.05.  With the same seeded weights (names from ``jax.eval_shape``, carried
over by ``convert.py``): the backbone's features on the valid rows in eval
mode (running statistics) and in training mode (the batch's statistics), the
eval prediction, and one training step (JAX's Dropout mask read off its
output): the prediction, the loss, ``mean_dist``, every gradient by
``convert.py`` name and the running statistics after it.  JAX compiles its
eval forward and its value-and-grad as one function, in a thread started by
the file's first test, with XLA's cheaper CPU passes.  The fork's config
(``configs/my_dataset/keypoint_oa_cnns.py``) builds at its widths, and a
request over it runs 23 sparse convs (one per ``SubMConv``: the stem, 16 in
the encoder's blocks, 6 in the decoder's) over 4 kernel maps, one per stage.

Tolerance: f32 within 1e-4 x max(1, max|jax|) per tensor, losses 1e-4
relative; running statistics 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import check_backbone_forward, check_training_step, keypoint_batch, keypoint_reference, port_point

from pointcept_keypointdetection_tpu_torch.models import build_model, init_weights
from pointcept_keypointdetection_tpu_torch.models import oacnns
from pointcept_keypointdetection_tpu_torch.utils.config import Config

SLOT, SAMPLES, PADS, SPAN = 96, 2, 8, 16
BACKBONE = dict(type="OA-CNNs", in_channels=4, base_channels=8, channels=(8, 16), layers=(1, 0), slot_divisors=(1, 2))
MODEL = dict(type="KeypointOACNNs", num_keypoints=6, hidden_dim=16, backbone_conf=BACKBONE)
TOL = 1e-4


def _batch():
    return keypoint_batch(1, SAMPLES, SLOT, PADS, SPAN)


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(keypoint_reference, MODEL, _batch(), "OACNNs", 30)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def test_fork_config_builds_and_runs_23_convs_over_4_maps(monkeypatch):
    """The fork's KeypointOACNNs at its widths: the head over 32 channels; a forward runs the stem, 2 x 8
    encoder and 2 x 3 decoder convs, over one k=3 map per stage."""
    cfg = Config.fromfile("configs/my_dataset/keypoint_oa_cnns.py")
    model = init_weights(build_model(dict(cfg.model)), torch.Generator().manual_seed(0)).eval()
    assert model.head[0].in_features == model.backbone.out_channels == 32
    convs, maps = [], []
    plain_conv, plain_map = oacnns.SubMConv.forward, oacnns.level_kernel_map
    monkeypatch.setattr(oacnns.SubMConv, "forward",
                        lambda self, feat, kmap: convs.append(self.weight.shape) or plain_conv(self, feat, kmap))
    monkeypatch.setattr(oacnns, "level_kernel_map", lambda point: maps.append(point.num_points) or plain_map(point))
    batch = keypoint_batch(2, 1, 64, 4, 8)
    with torch.no_grad():
        out = model(port_point(batch))
    assert out["keypoint_pred"].shape == (1, 6, 3) and torch.isfinite(out["keypoint_pred"]).all()
    assert len(convs) == 23 and len(maps) == 4
    assert {tuple(s[1:]) for s in convs} == {(4, 32), (32, 32), (64, 64), (128, 128), (64, 32), (128, 64),
                                             (256, 128)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_oacnns_forward_matches_jax(reference, train):
    check_backbone_forward(MODEL, reference, _batch(), train, TOL)


def test_keypoint_oacnns_training_step_matches_jax(reference):
    check_training_step(MODEL, reference, _batch(), TOL)


def test_adaptive_aggregation_gates_three_branches():
    agg = oacnns.AdaptiveAggregation(8)
    assert agg.shifts == [1, 2] and agg.gate.out_features == 3
    assert {name for name, _ in agg.named_children()} == {"branch_id", "branch_s0", "branch_s1", "gate", "norm"}
    assert np.isclose(agg.norm.momentum, 0.01)
