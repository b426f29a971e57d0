"""The port's pig keypoint and body-measure readers, the global-regression predictor and server,
the ``KeypointEvaluator`` hook and ``infer_offset`` against the JAX package on the CPU, on files the
test writes in the readers' on-disk layout (seeded pig clouds, N x 7).

* ``KeypointDataset``, ``OffsetKeypointDataset`` (online offsets and precomputed targets) and
  ``PigWeightDataset`` through their recipes' transforms, with ``np.random`` seeded alike: every
  array equal, NaNs zeroed, the keypoints read from both file names and from a flat file, a
  file of the wrong shape replaced by a draw of ``np.random`` as JAX's is; their loader batches.
* ``KeypointPredictor`` (a small KeypointPTv3Plus whose 7 input channels take the normalized
  coords ahead of the 4 features) on a cloud under its slot and on one whose voxels exceed it
  (subsampled by the padding from ``np.random``, seeded alike), and ``serve --task keypoint``
  through HTTP: K x 3 float32 in the cloud's units within 1e-4 x the cloud's scale of JAX's
  ``KeypointPredictor`` on the same checkpoint (a JAX flax-msgpack file ``load_weights`` reads).
* ``KeypointEvaluator`` over two val batches: its metric within 1e-5 relative of JAX's hook's,
  the logged per-keypoint distances within their two printed decimals.
* ``infer_offset`` against ``tools/infer_offset.py`` over the same split and checkpoint: the
  per-keypoint mean and std errors and the overall mean as printed (two decimals) within 0.011,
  and the txt file's names equal, its coordinates within 1e-4 x the cloud's scale.
* ``serve --task keypoint`` and ``KeypointPredictor`` default to CUDA.

JAX builds its predictors (their checkpoint's variables and their forward, compiled with XLA's
cheaper CPU passes) and its evaluator step in a thread started by the file's first test (none of
that draws from ``np.random``).
"""

import collections
import importlib.util
import logging
import os
import re
import sys
import threading
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_for

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate
from pointcept_keypointdetection_tpu.datasets.collate import pad_sample as jax_pad_sample
from pointcept_keypointdetection_tpu.datasets.dataloader import Dataloader as JaxDataloader
from pointcept_keypointdetection_tpu.engines.common import build_point_batch as jax_build_point_batch
from pointcept_keypointdetection_tpu.engines.hooks.keypoint_evaluator import KeypointEvaluator as JaxEvaluator
from pointcept_keypointdetection_tpu.engines.test import sample_to_device as jax_sample_to_device
from pointcept_keypointdetection_tpu.inference import KeypointPredictor as JaxKeypointPredictor
from pointcept_keypointdetection_tpu.inference import OffsetKeypointPredictor as JaxOffsetPredictor
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.parallel.mesh import create_mesh
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from pointcept_keypointdetection_tpu.utils.events import EventStorage as JaxEventStorage
from pointcept_keypointdetection_tpu.utils.logger import get_root_logger as jax_logger
from pointcept_keypointdetection_tpu_torch import infer_offset, serve
from pointcept_keypointdetection_tpu_torch.convert import load_weights
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.datasets.dataloader import Dataloader
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import make_pig
from pointcept_keypointdetection_tpu_torch.engines.hooks.keypoint_evaluator import KeypointEvaluator
from pointcept_keypointdetection_tpu_torch.inference import KeypointPredictor
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.utils.config import Config
from pointcept_keypointdetection_tpu_torch.utils.events import EventStorage
from pointcept_keypointdetection_tpu_torch.utils.logger import get_root_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT, K, POINTS = 256, 6, 1500
ONE_STAGE = dict(stride=(), enc_depths=(1,), enc_channels=(16,), enc_num_head=(1,), enc_patch_size=(32,),
                 dec_depths=(), dec_channels=(), dec_num_head=(), dec_patch_size=(), slot_divisors=(1,),
                 drop_path=0.0, shuffle_orders=False)
KEYPOINT = dict(type="KeypointPTv3Plus", num_keypoints=K, hidden_dim=32,
                backbone_conf=dict(type="PT-v3plus", in_channels=7, cpe_kernel_size=5, cpe_bottleneck=16, **ONE_STAGE))
EVAL_KEYPOINT = dict(KEYPOINT, backbone_conf=dict(KEYPOINT["backbone_conf"], in_channels=4))
OFFSET = dict(type="OffsetKeypointPTv3", num_keypoints=K, hidden_dim=32,
              backbone_conf=dict(type="PT-v3m1", in_channels=4, **ONE_STAGE))
RECIPE = os.path.join(REPO, "configs/my_dataset/keypoint_ptv3_plus.py")
OFFSET_RECIPE = os.path.join(REPO, "configs/my_dataset/offset_keypoint_ptv3.py")
WEIGHT_RECIPE = os.path.join(REPO, "configs/my_dataset/ptv3_weight.py")
CLOUDS = 5
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
_State = collections.namedtuple("_State", "params batch_stats")  # a pytree, as the JAX trainer's state is


def _write_split(root, split, seed, faults=True):
    """Pig clouds (mm) in both readers' layouts; cloud 0 has NaNs, cloud 1 a flat keypoint file, cloud
    2 the ``<ts>.npy`` name; with ``faults`` cloud 3 has keypoints of the wrong shape and a target of
    the wrong length.  A last cloud has no labels."""
    rng = np.random.default_rng(seed)
    for sub in ("pointclouds", "keypoints", "labels"):
        os.makedirs(os.path.join(root, split, sub))
    for i in range(CLOUDS):
        coord, feat, kp = make_pig(rng, POINTS)
        cloud = np.concatenate([coord, feat], 1).astype(np.float32)
        if i == 0:
            cloud[3, 1] = cloud[7, 4] = np.nan
        ts = f"17000000{i:02d}"
        np.save(os.path.join(root, split, "pointclouds", f"{ts}.npy"), cloud)
        kp_out = {1: kp.reshape(-1), 3: kp[:5] if faults else kp}.get(i, kp)
        kp_name = f"{ts}.npy" if i == 2 else f"{ts}_关键点坐标.npy"
        np.save(os.path.join(root, split, "keypoints", kp_name), kp_out)
        offsets = kp[None] - coord[:, None]
        mask = (np.linalg.norm(offsets, axis=-1) <= 300.0).astype(np.float32)
        target = np.concatenate([offsets * mask[..., None], mask[..., None]], -1).astype(np.float32)
        np.save(os.path.join(root, split, "keypoints", f"{ts}_keypoint_offset.npy"), target[:-1] if i == 3 and faults else target)
        np.save(os.path.join(root, split, "labels", f"{ts}.npy"), rng.normal(80, 20, 7).astype(np.float32))
    np.save(os.path.join(root, split, "pointclouds", "1700000099.npy"), cloud)  # no labels: skipped


def _reader_cfgs(root):
    kp, off, wt = (Config.fromfile(p) for p in (RECIPE, OFFSET_RECIPE, WEIGHT_RECIPE))
    out = []
    for cfg, extra in ((kp, {}), (off, {}), (off, dict(offset_radius=None)), (wt, {})):
        for split in ("train", "val"):
            out.append(dict(cfg.data[split], data_root=root, **extra))
    return out


def _jax_checkpoint(path, model_cfg, seed):
    variables = jax_variables_for(build_model(dict(model_cfg)), np.random.default_rng(seed))
    save_checkpoint(path, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    return variables


def _built(predictor, checkpoint):
    """A JAX predictor with what its ``_ensure_built`` makes: the checkpoint's variables and its jitted
    forward, here compiled with XLA's cheaper CPU passes and without the init trace (a slot's batch has
    the same shapes whatever the cloud)."""
    model = predictor.model
    predictor._variables = load_checkpoint(checkpoint)

    def forward(variables, batch):
        return model.apply(variables, jax_build_point_batch(batch, 1), batch, train=False)

    data = dict(coord=np.zeros((1, 3), np.float32), feat=np.zeros((1, predictor._model_cfg["backbone_conf"][
        "in_channels"]), np.float32), grid_coord=np.zeros((1, 3), np.int32))
    batch = jax_sample_to_device(jax_collate([jax_pad_sample(data, SLOT)], SLOT))
    predictor._forward = jax.jit(forward).lower(predictor._variables, batch).compile(FAST_COMPILE)
    return predictor


def _warm(state):
    """JAX's predictors and evaluator step built and compiled (their first calls), off the main thread."""
    kp = _built(JaxKeypointPredictor(dict(KEYPOINT), checkpoint=state["kp_ckpt"], slot_size=SLOT), state["kp_ckpt"])
    off = _built(JaxOffsetPredictor(dict(OFFSET), checkpoint=state["off_ckpt"], slot_size=SLOT), state["off_ckpt"])
    variables = state["eval_vars"]
    trainer = types.SimpleNamespace(
        model=jax_build_model(dict(EVAL_KEYPOINT)), mesh=create_mesh(),
        state=_State(variables["params"], variables["batch_stats"]),
        val_loader=state["val_batches"], storage=JaxEventStorage(), comm_info={})
    hook = JaxEvaluator()
    hook.trainer = trainer
    hook._build()
    from pointcept_keypointdetection_tpu.parallel.mesh import shard_batch

    batch = shard_batch(state["val_batches"][0], trainer.mesh)
    batch.pop("num_samples", None)
    # its jitted step compiled with XLA's cheaper CPU passes, for the val batches' one shape and sample count
    step = hook._eval_step.lower(trainer.state, batch, 2).compile(FAST_COMPILE)
    hook._eval_step = lambda st, b, num_samples: step(st, b)
    return dict(kp=kp, off=off, hook=hook)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pig_keypoint"))
    for split, seed in (("train", 1), ("val", 2)):
        _write_split(root, split, seed)
    _write_split(root, "test", 9, faults=False)
    kp_ckpt, off_ckpt = os.path.join(root, "kp.ckpt"), os.path.join(root, "off.ckpt")
    _jax_checkpoint(kp_ckpt, KEYPOINT, 3)
    _jax_checkpoint(off_ckpt, OFFSET, 4)
    eval_vars = jax_variables_for(build_model(dict(EVAL_KEYPOINT)), np.random.default_rng(5))
    val = Config.fromfile(RECIPE).data.val
    ds = build_dataset(dict(val, data_root=root))
    np.random.seed(6)
    val_batches = [collate([ds[i], ds[i + 1]], SLOT, np.random) for i in (0, 2)]
    return dict(root=root, kp_ckpt=kp_ckpt, off_ckpt=off_ckpt, eval_vars=eval_vars, val_batches=val_batches)


@pytest.fixture(scope="module")
def warm_future(data):
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_warm, data)


@pytest.fixture(scope="module", autouse=True)
def _start(warm_future):
    yield


@pytest.fixture(scope="module")
def warm(warm_future):
    return warm_future.result()


@pytest.mark.parametrize("which", range(8))
def test_readers_match_jax(data, which):
    cfg = _reader_cfgs(data["root"])[which]
    ours, ref = build_dataset(dict(cfg)), jax_build_dataset(dict(cfg))
    assert len(ours) == len(ref) == CLOUDS  # the cloud without labels is left out
    resampled = []
    if cfg["type"] != "PigWeightDataset":
        real = ours._resample
        ours._resample = lambda: resampled.append(1) or real()
    for i in range(len(ours)):
        np.random.seed(10 + i)
        a = ours[i]
        after = np.random.randint(1 << 30)
        np.random.seed(10 + i)
        b = ref[i]
        assert np.random.randint(1 << 30) == after  # the same draws
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{cfg['type']} {i} {key}")
        assert np.isfinite(a["coord"]).all() and np.isfinite(a["feat"]).all()
    if cfg["type"] != "PigWeightDataset":
        assert len(resampled) == 1  # cloud 3's keypoints (its target) have the wrong shape


def test_loader_batches_match_jax(data):
    for recipe in (RECIPE, WEIGHT_RECIPE):
        cfg = dict(Config.fromfile(recipe).data.train, data_root=data["root"])
        kw = dict(batch_size=2, slot_size=SLOT, shuffle=True, drop_last=True, seed=3)
        np.random.seed(7)
        ref = list(JaxDataloader(jax_build_dataset(dict(cfg)), prefetch=0, **kw))
        np.random.seed(7)
        got = list(Dataloader(build_dataset(dict(cfg)), prefetch=0, **kw))
        assert len(got) == len(ref) == 2
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        key = "keypoint" if recipe == RECIPE else "weight_label"
        assert got[0][key].shape == ((2, K, 3) if recipe == RECIPE else (2, 7))


def _cloud(data, i):
    return np.nan_to_num(np.load(os.path.join(data["root"], "val", "pointclouds", f"17000000{i:02d}.npy")))


def test_keypoint_predictor_and_server_match_jax(data, warm):
    predictor = KeypointPredictor(dict(KEYPOINT), load_weights(data["kp_ckpt"]), SLOT, device="cpu")
    server = serve.make_server(predictor, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for i, grid in ((1, 0.2), (2, 0.02)):  # under the slot; over it (the padding subsamples)
            cloud = _cloud(data, i)
            scale = np.linalg.norm(cloud[:, :3] - cloud[:, :3].mean(0), axis=1).max()
            np.random.seed(8)
            ref = warm["kp"].predict(cloud[:, :3], cloud[:, 3:], grid_size=grid)
            np.random.seed(8)
            got = predictor.predict(cloud[:, :3], cloud[:, 3:], grid_size=grid)
            assert got.shape == (K, 3) and got.dtype == np.float32
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)
            if grid == 0.02:
                data_rows, _, _ = predictor._prepare(cloud[:, :3], cloud[:, 3:], grid)
                assert data_rows["coord"].shape[0] > SLOT and data_rows["feat"].shape[1] == 7
                url = f"http://127.0.0.1:{server.server_address[1]}/predict?cols=7&method=weighted"
                np.random.seed(8)
                with urllib.request.urlopen(urllib.request.Request(url, data=cloud.astype(np.float32).tobytes(),
                                                                   method="POST"), timeout=60) as r:
                    reply = np.frombuffer(r.read(), np.float32).reshape(-1, 3)
                np.testing.assert_allclose(reply, ref, rtol=0, atol=1e-4 * scale)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logged(logger, run):
    records = _Records()
    logger.addHandler(records)
    try:
        run()
    finally:
        logger.removeHandler(records)
    per_kp = [float(m.group(1)) for line in records.lines if (m := re.match(r"Keypoint_\d+ mean distance: (\S+)", line))]
    return np.array(per_kp)


def test_keypoint_evaluator_matches_jax(data, warm):
    model = build_model(dict(EVAL_KEYPOINT))
    from pointcept_keypointdetection_tpu_torch.convert import convert_variables

    model.load_state_dict(convert_variables(data["eval_vars"]))
    trainer = types.SimpleNamespace(model=model.train(), val_loader=data["val_batches"], device=torch.device("cpu"),
                                    storage=EventStorage(), comm_info={})
    hook = KeypointEvaluator()
    hook.trainer = trainer
    ours = _logged(get_root_logger(), hook.after_epoch)
    ref = _logged(jax_logger(), warm["hook"].after_epoch)
    jax_trainer = warm["hook"].trainer
    assert len(ours) == len(ref) == K and model.training
    np.testing.assert_allclose(ours, ref, rtol=0, atol=0.011)
    np.testing.assert_allclose(trainer.comm_info["current_metric_value"],
                               jax_trainer.comm_info["current_metric_value"], rtol=1e-5)
    assert trainer.comm_info["current_metric_name"] == jax_trainer.comm_info["current_metric_name"]
    assert trainer.comm_info["current_metric_value"] < 0


def _numbers(text, prefix):
    line = next(line for line in text.splitlines() if line.startswith(prefix))
    return np.array([float(v) for v in line[len(prefix):].split()])


def test_infer_offset_matches_the_jax_tool(data, warm, monkeypatch, capsys, tmp_path):
    spec = importlib.util.spec_from_file_location("jax_infer_offset", os.path.join(REPO, "tools/infer_offset.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    import pointcept_keypointdetection_tpu.inference as jax_inference

    def prebuilt(model_cfg, checkpoint, slot_size):  # the warmed predictor, on the same arguments
        assert model_cfg["type"] == OFFSET["type"] and checkpoint == data["off_ckpt"] and slot_size == SLOT
        return warm["off"]

    monkeypatch.setattr(jax_inference, "OffsetKeypointPredictor", prebuilt)
    cfg_path = tmp_path / "offset_tiny.py"
    cfg_path.write_text(f"model = {OFFSET!r}\nsave_path = None\n")
    args = ["--config-file", str(cfg_path), "--weight", data["off_ckpt"], "--data-root", data["root"],
            "--split", "test", "--method", "weighted", "--slot-size", str(SLOT)]
    monkeypatch.setattr(sys, "argv", ["infer_offset.py", *args, "--output", str(tmp_path / "jax.txt")])
    tool.main()
    ref_out = capsys.readouterr().out
    errors = infer_offset.main([*args, "--output", str(tmp_path / "torch.txt"), "--device", "cpu"])
    out = capsys.readouterr().out
    for prefix in ("Per-keypoint mean error:", "Per-keypoint std  error:", "Overall mean error:"):
        np.testing.assert_allclose(_numbers(out, prefix), _numbers(ref_out, prefix), rtol=0, atol=0.011,
                                   err_msg=prefix)
    assert errors.shape == (CLOUDS, K)
    rows = [line.split() for line in (tmp_path / "torch.txt").read_text().splitlines()]
    ref_rows = [line.split() for line in (tmp_path / "jax.txt").read_text().splitlines()]
    assert [r[0] for r in rows] == [r[0] for r in ref_rows] and len(rows) == CLOUDS + 1
    np.testing.assert_allclose(np.array([r[1:] for r in rows], float), np.array([r[1:] for r in ref_rows], float),
                               rtol=0, atol=1e-4 * 800)


def test_keypoint_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--task", "keypoint", "--config-file", RECIPE])
    with pytest.raises(RuntimeError, match="cuda"):
        KeypointPredictor(dict(KEYPOINT), slot_size=SLOT)
