"""The port's pig users' tools against the JAX package's (``tools/inference.py``,
``tools/batch_infer_export_txt.py``, ``tools/infer_npy.py``, ``tools/evaluate_all_splits.py``,
``utils/visualization.py``) on the CPU, on files the test writes.

* ``utils/visualization.py``: the PLYs byte for byte.
* ``run_split``, ``load_cloud``, ``preprocess`` and the split loop against the JAX tools' own, and
  the ``inference_split``, ``batch_infer_export_txt`` and ``evaluate_all_splits`` CLIs against the
  JAX tools' ``main`` with one stand-in predictor (or tester) on both sides: a fixed function of the
  cloud, so that the predictions agree exactly and the printed report, the txt tables, the keypoint
  txts and the PLYs must agree byte for byte.
* ``infer_npy`` against ``tools/infer_npy.py`` with the same seeded weights of a small
  ``DefaultSegmentorV2`` over OctFormer, on a scene with one point per voxel (the only scenes the
  JAX tool answers, ``inference/segment.py``) plus a NaN row and an outlier: the JAX tool labels
  point i with the label of point k, k the rank of point i's voxel code, so its labels are the
  port's through that permutation (apart only on a tie closer than twice 1e-4 x max(1, max|logit|)),
  and its PLYs are the port's writer's on those labels.  JAX compiles its predictor in a thread
  started by the file's first test.
* Each port CLI's ``main`` end to end on the CPU with its real predictor over small models
  (``KeypointOctFormer``, ``OffsetKeypointSwin3D``, the OctFormer segmentor) and, for
  ``evaluate_all_splits``, ``exp/semseg_r3`` over one small synthetic val scene.
"""

import argparse
import functools
import importlib.util
import io
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import jax_variables_like

from pointcept_keypointdetection_tpu.datasets.keypoint_dataset import KeypointDataset as JaxKeypointDataset
from pointcept_keypointdetection_tpu.engines import test as jax_engines_test
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.utils import visualization as jax_vis
from pointcept_keypointdetection_tpu.utils.checkpoint import save_checkpoint
from pointcept_keypointdetection_tpu_torch import batch_infer_export_txt, evaluate_all_splits, infer_npy, inference_split
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets.keypoint_dataset import KeypointDataset
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import make_pig
from pointcept_keypointdetection_tpu_torch.engines import test as engines_test
from pointcept_keypointdetection_tpu_torch.inference.segment import SegmentPredictor
from pointcept_keypointdetection_tpu_torch.models import build_model, init_weights
from pointcept_keypointdetection_tpu_torch.utils import visualization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OCT = dict(type="OctFormer-v1m1", in_channels=4, channels=(16, 32), num_blocks=(2, 1), num_heads=(2, 4),
                patch_size=16, dilation=2, slot_divisors=(1, 2), drop_path_rate=0.0)
TINY_SWIN = dict(type="Swin3D-v1m1", in_channels=4, depths=(2, 1), channels=(16, 32), num_heads=(2, 4),
                 window_sizes=(4, 4), patch_size=32, slot_divisors=(1, 2), drop_path_rate=0.0)
SEG = dict(type="DefaultSegmentorV2", num_classes=2, backbone_out_channels=16,
           backbone=dict(TINY_OCT, num_blocks=(1, 1)))
SEG_SLOT = 512


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_config(path, base, **overrides):
    """A config file over ``base`` (an absolute path), ``overrides`` as Python literals."""
    lines = [f"_base_ = [{os.path.join(REPO, base)!r}]"] + [f"{k} = {v!r}" for k, v in overrides.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _write_pig_split(root, split, count, seed, bad=False):
    """Pig clouds in the readers' layout (N x 7 mm, keypoints 6 x 3 mm); with ``bad`` one more cloud
    whose label has 5 keypoints, which the tools skip."""
    rng = np.random.default_rng(seed)
    for sub in ("pointclouds", "keypoints"):
        os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    for i in range(count + int(bad)):
        coord, feat, kp = make_pig(rng, 900)
        ts = str(1_700_000_000 + i)
        np.save(os.path.join(root, split, "pointclouds", f"{ts}.npy"), np.concatenate([coord, feat], 1))
        np.save(os.path.join(root, split, "keypoints", f"{ts}_关键点坐标.npy"), kp[:5] if i == count else kp)


@pytest.fixture(scope="module")
def pig_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pig")
    _write_pig_split(str(root), "val", 3, 1, bad=True)
    _write_pig_split(str(root), "train", 2, 2)
    _write_pig_split(str(root), "test", 1, 3)
    return str(root)


class StandIn:
    """A fixed function of the cloud in place of a predictor, the same on both sides."""

    calls = []

    def __init__(self, *args, **kwargs):
        StandIn.calls.append(type(self).__name__)

    def predict(self, coord, feat=None, grid_size=0.02, method="argmax", threshold=0.5):
        shift = 1.0 if method == "argmax" else -1.0
        return (coord[:6] * 0.75 + feat[:6, :3] * (100 * grid_size) + shift).astype(np.float32)


class OffsetStandIn(StandIn):
    pass


def _run(module, argv):
    """(what ``module.main`` prints, its return value) with ``argv`` for its arguments.  The tool's own
    ``print`` and ``argparse`` are swapped in its module only: the JAX tools read ``sys.argv``, and the
    file's thread runs one while the tests run others."""
    out = io.StringIO()

    class Parser(argparse.ArgumentParser):
        def parse_args(self, args=None, namespace=None):
            return super().parse_args(argv if args is None else args, namespace)

    saved = module.argparse
    module.print = functools.partial(print, file=out)
    module.argparse = types.SimpleNamespace(ArgumentParser=Parser,
                                            RawDescriptionHelpFormatter=argparse.RawDescriptionHelpFormatter)
    try:
        result = module.main()
    finally:
        del module.print
        module.argparse = saved
    return out.getvalue(), result


def _lattice_scene(seed):
    """216 points on a 100 mm lattice (one per voxel at the grid of 0.05 normalized units), with
    normals and curvature, one NaN row and one point 9 m out, N x 7."""
    rng = np.random.default_rng(seed)
    lattice = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coord = lattice * 100.0 + rng.normal(0, 5, lattice.shape) + 1000.0
    raw = np.concatenate([coord, rng.normal(size=(len(coord), 4))], 1).astype(np.float32)
    extra = np.array([[np.nan] * 7, [9000.0, 1000.0, 1000.0, 0, 0, 1, 0.1]], np.float32)
    return np.concatenate([raw[:100], extra, raw[100:]])


def _jax_infer_npy(root):
    """``tools/infer_npy.py`` on the lattice scene with seeded weights of ``SEG`` in a flax checkpoint."""
    import jax

    tool = _jax_tool("infer_npy")
    model = jax_build_model(dict(SEG))
    n = SEG_SLOT
    dummy = JaxPointBatch(coord=np.zeros((n, 3), np.float32), feat=np.zeros((n, 4), np.float32),
                       grid_coord=np.zeros((n, 3), np.int32), valid=np.ones(n, bool), num_samples=1)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, dummy, {}, train=False))
    variables = jax_variables_like(shapes, np.random.default_rng(5))
    weight = os.path.join(root, "seg.ckpt")
    save_checkpoint(weight, {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    config = _write_config(os.path.join(root, "seg.py"), "configs/pigseg/semseg-octformer-v1m1-0-base.py",
                           model=dict(SEG, _delete_=True))
    scene = os.path.join(root, "scene.npy")
    np.save(scene, _lattice_scene(3))
    out_dir = os.path.join(root, "jax")
    os.makedirs(out_dir)
    stdout, _ = _run(tool, [scene, "--config-file", config, "--weight", weight, "--slot-size", str(SEG_SLOT),
                            "--grid-size", "0.05", "--out-dir", out_dir])
    return dict(variables=variables, weight=weight, config=config, scene=scene, out_dir=out_dir, stdout=stdout)


@pytest.fixture(scope="module", autouse=True)
def jax_infer_npy_future(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("infer_npy"))
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_infer_npy, root)


def test_visualization_writes_jax_plys_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    coord = rng.normal(0, 300, (50, 3)).astype(np.float32)
    colors = rng.uniform(-20, 300, (50, 3))  # float colours: clipped and cast to uint8 on both sides
    labels = rng.integers(-1, 25, 50)
    kp = rng.normal(0, 300, (6, 3))
    writers = [("cloud", lambda m, p: m.save_point_cloud(p, coord)),
               ("colored", lambda m, p: m.save_point_cloud(p, coord, colors)),
               ("labels", lambda m, p: m.save_labeled_cloud(p, coord, labels)),
               ("keypoints", lambda m, p: m.save_keypoints(p, kp, color=(0, 200, 10)))]
    for name, write in writers:
        paths = [str(tmp_path / side / f"{name}.ply") for side in ("jax", "port")]
        write(jax_vis, paths[0])
        write(visualization, paths[1])
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read(), name
    np.testing.assert_array_equal(visualization.LABEL_PALETTE, jax_vis.LABEL_PALETTE)


def test_run_split_matches_jax(pig_root, tmp_path):
    datasets = [cls(split="val", data_root=pig_root) for cls in (JaxKeypointDataset, KeypointDataset)]
    tool = _jax_tool("inference")
    ref_names, ref_err = tool.run_split(StandIn(), datasets[0], 0.02, str(tmp_path / "jax"))
    names, err = inference_split.run_split(StandIn(), datasets[1], 0.02, str(tmp_path / "port"))
    assert names == ref_names and len(names) == 3  # the cloud with 5 keypoints is skipped
    np.testing.assert_array_equal(err, ref_err)
    for name in names:
        assert (tmp_path / "jax" / f"{name}.ply").read_bytes() == (tmp_path / "port" / f"{name}.ply").read_bytes()


def test_inference_cli_matches_jax_tool(pig_root, tmp_path, monkeypatch):
    config = _write_config(tmp_path / "kp.py", "configs/my_dataset/keypoint_octformer.py",
                           data=dict(train=dict(data_root=pig_root), val=dict(data_root=pig_root)))
    tool = _jax_tool("inference")
    monkeypatch.setattr(tool, "KeypointPredictor", StandIn)
    monkeypatch.setattr(inference_split, "KeypointPredictor", StandIn)
    outputs = {}
    for side in ("jax", "port"):
        args = ["--config-file", config, "--split", "all", "--out", str(tmp_path / f"{side}.txt"),
                "--viz-dir", str(tmp_path / side)]
        if side == "jax":
            outputs[side] = _run(tool, args)[0]
        else:
            outputs[side], total = _run(inference_split, args + ["--device", "cpu"])
    assert outputs["port"].replace(str(tmp_path / "port"), "X") == outputs["jax"].replace(str(tmp_path / "jax"), "X")
    assert (tmp_path / "jax.txt").read_bytes() == (tmp_path / "port.txt").read_bytes()
    assert total.shape == (6, 6) and "[train] 2 samples" in outputs["port"] and "[val] 3 samples" in outputs["port"]
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))


def test_inference_cli_runs_keypoint_octformer(pig_root, tmp_path):
    config = _write_config(tmp_path / "kp.py", "configs/my_dataset/keypoint_octformer.py",
                           model=dict(type="KeypointOctFormer", num_keypoints=6, hidden_dim=32, backbone_conf=TINY_OCT,
                                      _delete_=True),
                           data=dict(train=dict(data_root=pig_root), val=dict(data_root=pig_root)))
    stdout, total = _run(inference_split, ["--config-file", config, "--index", "1", "--out",
                                                str(tmp_path / "err.txt"), "--viz-dir", str(tmp_path / "viz"),
                                                "--slot-size", "1024", "--device", "cpu"])
    lines = (tmp_path / "err.txt").read_text().splitlines()
    assert total.shape == (1, 6) and np.isfinite(total).all() and len(lines) == 2
    assert lines[0] == "sample\t" + "\t".join(f"kp{i}" for i in range(6)) and "[val] 1 samples" in stdout
    assert len(os.listdir(tmp_path / "viz")) == 1


def _pcd(path, points, data="ascii"):
    with open(path, "w") as f:
        f.write("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {len(points)}\nHEIGHT 1\nPOINTS {len(points)}\nDATA {data}\n")
        for p in points:
            f.write(" ".join(f"{v:.4f}" for v in p) + "\n")


def _scan_dir(root):
    rng = np.random.default_rng(8)
    os.makedirs(root, exist_ok=True)
    coord, feat, _ = make_pig(rng, 700)
    np.save(os.path.join(root, "a_full.npy"), np.concatenate([coord, feat], 1))
    np.save(os.path.join(root, "b_bare.npy"), make_pig(rng, 700)[0])
    _pcd(os.path.join(root, "c_scan.pcd"), make_pig(rng, 700)[0])
    return root


def test_load_cloud_matches_jax(tmp_path):
    tool = _jax_tool("batch_infer_export_txt")
    root = _scan_dir(str(tmp_path / "scans"))
    for name in sorted(os.listdir(root)):
        (c1, f1), (c2, f2) = tool.load_cloud(os.path.join(root, name)), batch_infer_export_txt.load_cloud(
            os.path.join(root, name))
        np.testing.assert_array_equal(c1, c2)
        assert (f1 is None) == (f2 is None) and (f1 is None or np.array_equal(f1, f2))
    _pcd(str(tmp_path / "binary.pcd"), np.zeros((2, 3)), data="binary")
    (tmp_path / "scan.ply").write_text("ply\n")
    for bad, match in (("binary.pcd", "only ascii PCD"), ("scan.ply", "unsupported cloud format")):
        for load in (tool.load_cloud, batch_infer_export_txt.load_cloud):
            with pytest.raises(ValueError, match=match):
                load(str(tmp_path / bad))


def test_batch_export_cli_matches_jax_tool(tmp_path, monkeypatch):
    root = _scan_dir(str(tmp_path / "scans"))
    tool = _jax_tool("batch_infer_export_txt")
    for module in (tool, batch_infer_export_txt):
        monkeypatch.setattr(module, "KeypointPredictor", StandIn)
        monkeypatch.setattr(module, "OffsetKeypointPredictor", OffsetStandIn)
    for config, task, method in (("configs/my_dataset/offset_keypoint_swin3d.py", "auto", "weighted"),
                                 ("configs/my_dataset/keypoint_octformer.py", "auto", "argmax"),
                                 ("configs/my_dataset/keypoint_octformer.py", "offset_keypoint", "argmax")):
        StandIn.calls = []
        outputs = {}
        for side in ("jax", "port"):
            args = ["--config-file", os.path.join(REPO, config), "--scan-dir", root, "--out-dir",
                    str(tmp_path / f"{side}side_{task}_{method}"), "--task", task, "--method", method, "--tag", "t"]
            if side == "jax":
                outputs[side] = _run(tool, args)[0]
            else:
                outputs[side], written = _run(batch_infer_export_txt, args + ["--device", "cpu"])
        # auto: the offset predictor where the model type holds "Offset"
        assert StandIn.calls == [("OffsetStandIn" if "offset" in config or task == "offset_keypoint"
                                  else "StandIn")] * 2, (config, task, StandIn.calls)
        assert outputs["port"].replace("portside_", "X_") == outputs["jax"].replace("jaxside_", "X_")
        assert [os.path.basename(p) for p in written] == [f"{s}_关键点坐标预测结果_t.txt"
                                                          for s in ("a_full", "b_bare", "c_scan")]
        for path in written:
            ref = path.replace("portside_", "jaxside_")
            assert open(ref, "rb").read() == open(path, "rb").read()


def test_batch_export_cli_runs_offset_keypoint_swin3d(tmp_path):
    root = _scan_dir(str(tmp_path / "scans"))
    config = _write_config(tmp_path / "off.py", "configs/my_dataset/offset_keypoint_swin3d.py",
                           model=dict(type="OffsetKeypointSwin3D", num_keypoints=6, hidden_dim=32,
                                      backbone_conf=TINY_SWIN, _delete_=True))
    _, written = _run(batch_infer_export_txt, ["--config-file", config, "--scan-dir", root, "--method", "weighted",
                                                    "--slot-size", "1024", "--device", "cpu"])
    assert len(written) == 3
    for path in written:
        kp = np.loadtxt(path)
        assert kp.shape == (6, 3) and np.isfinite(kp).all() and os.path.dirname(path) == root


def test_preprocess_matches_jax():
    rng = np.random.default_rng(6)
    raw = rng.normal(0, 1500, (400, 8)).astype(np.float32)
    raw[::37, 2] = np.nan
    raw[5] = 20000.0
    tool = _jax_tool("infer_npy")
    for cols in (8, 7, 3):
        (c1, f1), (c2, f2) = tool.preprocess(raw[:, :cols]), infer_npy.preprocess(raw[:, :cols])
        np.testing.assert_array_equal(c1, c2)
        assert (f1 is None) == (f2 is None) == (cols < 7) and (f1 is None or np.array_equal(f1, f2))
    assert len(c1) < 400 - 11  # the NaN rows and the far row are gone


def _ply_rows(path):
    lines = open(path).read().splitlines()
    return lines[: lines.index("end_header") + 1], lines[lines.index("end_header") + 1 :]


def test_evaluate_split_loop_matches_jax_tool(tmp_path, monkeypatch):
    """The split loop, with one stand-in tester on both sides: each split's config re-points
    ``data.test`` at it, and the summary prints alike."""
    seen = {"jax": [], "port": []}

    def stand_in(side):
        def build(cfg):
            test = cfg["cfg"].data.test
            seen[side].append((cfg["type"], test["split"], test["type"], cfg["cfg"].get("weight")))
            score = 0.5 + 0.01 * len(test["split"])
            return type("Tester", (), {"test": lambda self: dict(mIoU=score, mAcc=score / 2, allAcc=1 - score)})()
        return build

    monkeypatch.setattr(jax_engines_test.TESTERS, "build", stand_in("jax"))
    monkeypatch.setattr(engines_test.TESTERS, "build", stand_in("port"))
    monkeypatch.chdir(tmp_path)  # both write the parsed config under exp/<dataset>/<name>
    config = os.path.join(REPO, "configs/synthetic/semseg-spunet-r3-test.py")
    args = ["--config-file", config, "--weight", "w.ckpt", "--splits", "train", "val", "test"]
    ref, _ = _run(_jax_tool("evaluate_all_splits"), args)
    got, results = _run(evaluate_all_splits, args + ["--device", "cpu"])
    assert got == ref and got.endswith("test mIoU=0.5400 mAcc=0.2700 allAcc=0.4600\n")
    assert seen["port"] == seen["jax"] == [("SemSegTester", s, "SyntheticSemSegDataset", "w.ckpt")
                                           for s in ("train", "val", "test")]
    assert set(results) == {"train", "val", "test"}


def test_evaluate_all_splits_cli_runs_semseg_r3(tmp_path):
    config = _write_config(tmp_path / "r3.py", "configs/synthetic/semseg-spunet-r3-test.py", save_path=str(tmp_path),
                           data=dict(test=dict(num_scenes=1, num_points=3000)), test=dict(fragment_capacity=4096))
    stdout, results = _run(evaluate_all_splits, [
        "--config-file", config, "--weight", os.path.join(REPO, "exp/semseg_r3/model_params.ckpt"), "--splits", "val",
        "--device", "cpu"])
    assert list(results) == ["val"] and "=== All-split summary ===" in stdout
    for split, r in results.items():
        # one small scene holds some of the 6 classes: the absent ones read IoU 0, so mIoU is no anchor here
        assert set(r) == {"mIoU", "mAcc", "allAcc"} and r["allAcc"] > 0.95, (split, r)
        assert f"{split} mIoU={r['mIoU']:.4f} mAcc={r['mAcc']:.4f} allAcc={r['allAcc']:.4f}" in stdout


def test_infer_npy_cli_labels_a_pig_scene(tmp_path):
    scene = tmp_path / "pig.npy"
    rng = np.random.default_rng(12)
    coord, feat, _ = make_pig(rng, 1500)
    np.save(scene, np.concatenate([coord + 2000.0, feat], 1))
    model = init_weights(build_model(dict(SEG)), torch.Generator().manual_seed(1))
    weight = tmp_path / "seg.pth"
    torch.save(model.state_dict(), weight)
    config = _write_config(tmp_path / "seg.py", "configs/pigseg/semseg-octformer-v1m1-0-base.py",
                           model=dict(SEG, _delete_=True))
    _, preds = _run(infer_npy, [str(scene), "--config-file", config, "--weight", str(weight), "--slot-size",
                                     "2048", "--device", "cpu"])
    assert preds.shape == (1500,) and set(np.unique(preds)) <= {0, 1}
    header, rows = _ply_rows(str(tmp_path / "pig_pred.ply"))
    assert len(rows) == 1500 and header[2] == "element vertex 1500"
    assert len(_ply_rows(str(tmp_path / "pig_pig_only.ply"))[1]) == int((preds == 1).sum())


def test_infer_npy_matches_jax_tool(jax_infer_npy_future, tmp_path):
    ref = jax_infer_npy_future.result()
    stdout, preds = _run(infer_npy, [ref["scene"], "--config-file", ref["config"], "--weight", ref["weight"],
                                          "--slot-size", str(SEG_SLOT), "--grid-size", "0.05", "--out-dir",
                                          str(tmp_path), "--device", "cpu"])
    assert stdout.replace(str(tmp_path), "X") == ref["stdout"].replace(ref["out_dir"], "X")
    coord, feat = infer_npy.preprocess(np.load(ref["scene"]))
    assert len(coord) == 216
    predictor = SegmentPredictor(SEG, convert_variables(ref["variables"]), SEG_SLOT, "cpu")
    data, inverse = predictor.prepare(coord, feat, 0.05)
    assert data["coord"].shape[0] == len(coord)  # one point per voxel
    logits = predictor.forward(data)[inverse]  # each point's voxel's logits
    np.testing.assert_array_equal(preds, logits.argmax(1))
    header, rows = _ply_rows(os.path.join(ref["out_dir"], "scene_pred.ply"))
    own_header, own_rows = _ply_rows(str(tmp_path / "scene_pred.ply"))
    assert header == own_header and [r.rsplit(" ", 3)[0] for r in rows] == [r.rsplit(" ", 3)[0] for r in own_rows]
    jax_labels = np.array([int(r.split()[-1] == "255") for r in rows])  # blue 255: pig
    # the JAX tool's label of point i is the port's label of point inverse[i], up to ties of the logits
    tie = 2e-4 * max(1.0, float(np.abs(logits).max()))
    moved = logits[inverse]
    gap = np.abs(moved[:, 1] - moved[:, 0])
    assert np.array_equal(jax_labels[gap > tie], moved.argmax(1)[gap > tie])
    expected = tmp_path / "expected_pig_only.ply"
    visualization.save_point_cloud(str(expected), coord[jax_labels == 1],
                                   np.full((int(jax_labels.sum()), 3), (60, 60, 255), np.uint8))
    assert expected.read_bytes() == open(os.path.join(ref["out_dir"], "scene_pig_only.ply"), "rb").read()
    _, own_pig = _ply_rows(str(tmp_path / "scene_pig_only.ply"))
    assert len(own_pig) == int((preds == 1).sum())
