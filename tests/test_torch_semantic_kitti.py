"""The port's SemanticKITTI path against the JAX package on the CPU.

The reader (``datasets/semantic_kitti.py``): its tables, and its arrays and
labels on frames that ``tools/make_synthetic_kitti.py`` writes (a train and a
val sequence), raw and through the PT-v3m1 recipe's val transforms (np.random
seeded alike); ``PointClip``; test mode raising.  The SLAM bridge's labeller
(``SemanticScanPredictor``) over a small ``DefaultSegmentorV2`` (PT-v3m1, two
stages of depth 1, channels 16-32, patch 64) at slot 4096 with seeded
weights saved as a port checkpoint, against the steps of
``tools/run_slam.py::_build_semseg`` composed from JAX's ``z_order_encode_np``,
``pad_sample``, ``collate``, ``build_point_batch`` and ``apply(...,
mutable=["intermediates"])`` on one synthetic frame: labels equal, the
embedding and the sown ``backbone_feat`` within 1e-4 x max(1, max|jax|).
JAX compiles that forward once, in a thread started by the file's first test.
The seven SemanticKITTI configs the port runs build at full width.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import FAST_COMPILE, assert_close, jax_variables_for

from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets import semantic_kitti as port_kitti
from pointcept_keypointdetection_tpu_torch.datasets.transform import PointClip
from pointcept_keypointdetection_tpu_torch.inference.semantic_scan import SemanticScanPredictor
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.utils.config import Config

PTV3_CONFIG = "configs/semantic_kitti/semseg-ptv3-base.py"
SLOT = 4096
POINTS = 3000  # per synthetic frame: its voxels fit the slot
BACKBONE = dict(type="PT-v3m1", in_channels=4, order=("z", "hilbert"), stride=(2,), enc_depths=(1, 1),
                enc_channels=(16, 32), enc_num_head=(1, 2), enc_patch_size=(64, 64), dec_depths=(1,),
                dec_channels=(16,), dec_num_head=(1,), dec_patch_size=(64,), slot_divisors=(1, 4), drop_path=0.0)
MODEL = dict(type="DefaultSegmentorV2", num_classes=19, backbone_out_channels=16, backbone=BACKBONE)
TOL = 1e-4
CONFIGS = ("semseg-ptv3-base", "semseg-minkunet34c-0-base", "semseg-spvcnn-v1m1-0-base", "semseg-spunet-v1m1-0-base",
           "semseg-pt-v2m2-0-base", "semseg-pt-v2m2-1-benchmark-submit", "semseg-swin3d-mini")


def _write_frames(root) -> None:
    for seq, seed in (("00", 0), ("08", 1)):
        subprocess.run([sys.executable, "tools/make_synthetic_kitti.py", "--out", str(root), "--seq", seq,
                        "--frames", "2", "--points-per-scan", str(POINTS), "--seed", str(seed)], check=True,
                       capture_output=True)


def _jax_bridge(scan, variables):
    """``tools/run_slam.py::_build_semseg``'s steps on one scan in JAX: (labels, embedding, the valid rows'
    backbone_feat)."""
    import jax
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.datasets.collate import collate, pad_sample
    from pointcept_keypointdetection_tpu.engines.common import build_point_batch
    from pointcept_keypointdetection_tpu.engines.test import sample_to_device
    from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
    from pointcept_keypointdetection_tpu.ops.serialization import z_order_encode_np

    model = jax_build_model(dict(MODEL))
    coord, strength = scan[:, :3], scan[:, 3:4]
    grid = np.floor(coord / 0.05).astype(np.int64)
    grid -= grid.min(0)
    key = z_order_encode_np(np.minimum(grid, 2**16 - 1), 16)
    _, sel, inv = np.unique(key, return_index=True, return_inverse=True)
    data = dict(coord=coord[sel].astype(np.float32), grid_coord=grid[sel].astype(np.int32),
                feat=np.concatenate([coord[sel], strength[sel]], 1).astype(np.float32))
    n = len(sel)
    dev = sample_to_device(collate([pad_sample(data, SLOT)], SLOT))

    def fwd(v, b):
        point = build_point_batch(b, 1)
        out, mods = model.apply(v, point, b, train=False, mutable=["intermediates"])
        feat = mods["intermediates"]["backbone_feat"][0]
        w = point.valid.astype(feat.dtype)[:, None]
        emb = (feat * w).sum(0) / jnp.maximum(w.sum(), 1.0)
        return jnp.argmax(out["seg_logits"], -1), emb.astype(jnp.float32), feat

    pred, emb, feat = jax.jit(fwd).lower(variables, dev).compile(FAST_COMPILE)(variables, dev)
    return np.asarray(pred)[:n][inv], np.asarray(emb), np.asarray(feat)[:n]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    _write_frames(root)
    return root


@pytest.fixture(scope="module")
def bridge_future(frames):
    scan = port_kitti.read_scan(str(frames / "dataset" / "sequences" / "08" / "velodyne" / "000000.bin"))
    variables = jax_variables_for(build_model(dict(MODEL)), np.random.default_rng(3))
    with ThreadPoolExecutor(1) as pool:
        yield scan, variables, pool.submit(_jax_bridge, scan, variables)


def test_tables_match_jax(bridge_future):
    from pointcept_keypointdetection_tpu.datasets import semantic_kitti as jax_kitti

    for name in ("SPLIT_SEQUENCES", "LEARNING_MAP", "LEARNING_MAP_INV", "DYNAMIC_CLASSES"):
        assert getattr(port_kitti, name) == getattr(jax_kitti, name), name
    np.testing.assert_array_equal(port_kitti._LEARNING_LUT, jax_kitti._LEARNING_LUT)
    ids = np.arange(-1, 19)
    np.testing.assert_array_equal(port_kitti.map_to_raw_labels(ids), jax_kitti.map_to_raw_labels(ids))


@pytest.mark.parametrize("kind,split", [("SemanticKITTIDataset", "train"), ("SemanticKITTIDataset", "val"),
                                        ("SemanticKITTIColorNormalDataset", "val")])
def test_reader_matches_jax(frames, kind, split):
    from pointcept_keypointdetection_tpu.datasets.builder import DATASETS as JAX_DATASETS

    cfg = dict(type=kind, split=split, data_root=str(frames), transform=None)
    ours, theirs = build_dataset(dict(cfg)), JAX_DATASETS.build(dict(cfg))
    assert len(ours) == len(theirs) == 2
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys() and a["name"] == b["name"]
        for key in a:
            if key != "name":
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert set(np.unique(ours[0]["segment"])) <= {0, 8, 12, 17}  # car, road, building, pole


def test_recipe_val_transforms_match_jax(frames):
    """PointClip, GridSample and Collect of the PT-v3m1 recipe's val split, np.random seeded alike."""
    from pointcept_keypointdetection_tpu.datasets.builder import DATASETS as JAX_DATASETS

    val = dict(Config.fromfile(PTV3_CONFIG).data.val, data_root=str(frames))
    outs = []
    for build in (build_dataset, JAX_DATASETS.build):
        np.random.seed(11)
        outs.append(build(dict(val))[1])
    assert outs[0].keys() == outs[1].keys() == {"coord", "grid_coord", "segment", "feat"}
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)


def test_point_clip_matches_jax_and_drops_no_point():
    from pointcept_keypointdetection_tpu.datasets.transform import PointClip as JaxPointClip

    coord = np.random.default_rng(5).uniform(-90, 90, (500, 3)).astype(np.float32)
    box = (-75.2, -75.2, -4, 75.2, 75.2, 2)
    ours = PointClip(box)(dict(coord=coord.copy()))["coord"]
    np.testing.assert_array_equal(ours, JaxPointClip(box)(dict(coord=coord.copy()))["coord"])
    assert ours.shape == coord.shape and ours.min(0).tolist() == [-75.2, -75.2, -4] and ours[:, 2].max() == 2


def test_test_mode_raises(frames):
    with pytest.raises(NotImplementedError):
        build_dataset(dict(type="SemanticKITTIDataset", split="val", data_root=str(frames), test_mode=True))


def test_semantic_scan_predictor_matches_jax_bridge(bridge_future, tmp_path):
    scan, variables, future = bridge_future
    config = tmp_path / "tiny_kitti_ptv3.py"
    config.write_text(f"model = {MODEL!r}\n")
    weight = tmp_path / "model.pth"
    torch.save(convert_variables(variables), weight)
    predictor = SemanticScanPredictor(str(config), str(weight), slot=SLOT, device="cpu")
    res = predictor.infer(scan, logits=True)
    labels, emb = predictor(scan)
    ref_labels, ref_emb, ref_feat = future.result()
    assert 1000 < res["seg_logits"].shape[0] <= SLOT and labels.shape == (scan.shape[0],)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(res["labels"], labels)
    assert_close(torch.from_numpy(emb), ref_emb, "embedding", TOL)
    data, _ = predictor.voxelize(scan)
    batch = {k: torch.from_numpy(np.pad(v, [(0, SLOT - len(v))] + [(0, 0)] * (v.ndim - 1))) for k, v in data.items()}
    from pointcept_keypointdetection_tpu_torch.models import PointBatch

    point = PointBatch(coord=batch["coord"], feat=batch["feat"], grid_coord=batch["grid_coord"],
                       valid=torch.arange(SLOT) < len(data["coord"]), num_samples=1)
    with torch.inference_mode():
        out = predictor.model(point, backbone_feat=True)
        plain = predictor.model(point)
    assert_close(out["backbone_feat"][: len(data["coord"])], ref_feat, "DefaultSegmentorV2 backbone_feat", TOL)
    assert "backbone_feat" not in plain and torch.equal(plain["seg_logits"], out["seg_logits"])


@pytest.mark.parametrize("name", CONFIGS)
def test_kitti_configs_build_at_full_width(name):
    cfg = Config.fromfile(f"configs/semantic_kitti/{name}.py")
    model = build_model(dict(cfg.model))
    assert cfg.slot_size in (131072, 32768) and sum(p.numel() for p in model.parameters()) > 1_000_000


def test_semantic_scan_predictor_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    config = tmp_path / "tiny_kitti_ptv3.py"
    config.write_text(f"model = {MODEL!r}\n")
    with pytest.raises(RuntimeError, match="cuda"):
        SemanticScanPredictor(str(config))
