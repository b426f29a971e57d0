"""The committed semseg checkpoint and the tester in the port, against the JAX package on the CPU.

``exp/semseg_r3/model_params.ckpt`` read by the port's reader, bit for bit
with ``flax.serialization.msgpack_restore``; its ``DefaultSegmentor`` over
SpUNet-v1m1 (``configs/synthetic/semseg-spunet-r3.py``: base 24, k=3 stem)
against JAX's ``model.apply`` on a val scene; the port's mIoU over the 3 val
scenes ``tests/test_semseg_checkpoint.py`` evaluates, against JAX's reading
on the same scenes; ``SemSegTester`` of both packages on a small SpUNet with
seeded weights over 2 synthetic test scenes with 2 TTA variants, the
ScanNet recipe's test_cfg shape, then over the same scenes with a
full-resolution ``origin_segment`` and ``inverse`` to project onto.

The val scenes: ``GridSample`` (train mode) and the slot subsample draw from
the global ``np.random``, so they are made after ``np.random.seed`` of the
recipe's seed, 123, in both packages, in the main thread before the JAX
thread starts; JAX's mIoU on them is the reading of
``scripts/semseg_r3_anchor_by_seed.py 123`` (its 3-scene evaluation is not
repeated here).  The test scenes are made the same way (seed 4) and handed
to each package's tester as they are.  JAX compiles the r3 forward (with
XLA's cheaper CPU passes) and runs its tester in a thread started by the
file's first test.

Tolerances: the reader bit for bit; the r3 logits on valid rows 1e-4 x
max(1, max|jax|) (f32 sums in other orders through 16 blocks: 4.8e-6 of
15.4 read here), labels equal but on a tie (the two JAX logits closer than
twice the logit error); the mIoU > 0.95 (``test_semseg_checkpoint.py``'s
bound) and within 0.005 of JAX's; the testers' per-fragment probabilities
1e-5, every scene's labels equal but on a tie of the accumulated
probabilities, the mIoU equal.
"""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_like

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate
from pointcept_keypointdetection_tpu.engines.common import build_point_batch as jax_build_point_batch
from pointcept_keypointdetection_tpu.engines.test import SemSegTester as JaxSemSegTester
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from pointcept_keypointdetection_tpu.utils.config import Config as JaxConfig
from pointcept_keypointdetection_tpu_torch import test as test_cli
from pointcept_keypointdetection_tpu_torch.convert import convert_variables, load_jax_checkpoint
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device
from pointcept_keypointdetection_tpu_torch.engines.test import SemSegTester
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.utils.checkpoint import load_checkpoint
from pointcept_keypointdetection_tpu_torch.utils.config import Config
from pointcept_keypointdetection_tpu_torch.utils.misc import intersection_and_union

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "exp", "semseg_r3", "model_params.ckpt")
R3 = os.path.join(REPO, "configs", "synthetic", "semseg-spunet-r3.py")
MINI = os.path.join(REPO, "configs", "synthetic", "semseg-spunet-mini.py")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
ANCHOR_SCENES = 3  # tests/test_semseg_checkpoint.py's
# JAX's mIoU over the first 3 val scenes (np.random seeded 123): scripts/semseg_r3_anchor_by_seed.py 123
JAX_ANCHOR_MIOU = 0.999323
MIOU_TOL = 0.005
CAPACITY = 1024  # the testers' fragment capacity: some fragments hold more and are truncated
# the testers' model: the mini recipe's DefaultSegmentor over a one-stage SpUNet (k=3 stem): the testers'
# fragments, augmentations and projection do not depend on its depth
SMALL = {"model.backbone.base_channels": 8, "model.backbone.channels": (8, 8), "model.backbone.layers": (1, 1)}
TEST_DATA = dict(
    type="SyntheticSemSegDataset", split="val", num_scenes=2, num_points=1500, num_classes=6, test_mode=True,
    transform=[dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor"),
               dict(type="Copy", keys_dict=dict(segment="origin_segment")),
               dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train", return_inverse=True,
                    return_grid_coord=True)],
    test_cfg=dict(voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="test",
                                return_grid_coord=True),
                  crop=None,
                  post_transform=[dict(type="CenterShift", apply_z=False),
                                  dict(type="Collect", keys=("coord", "grid_coord", "index"),
                                       feat_keys=("coord", "color"))],
                  aug_transform=[[dict(type="RandomScale", scale=[0.9, 0.9])],
                                 [dict(type="RandomScale", scale=[1.1, 1.1])]]))


class Scenes:
    """Test scenes made beforehand, handed out as fresh copies (the testers pop their keys)."""

    test_mode = True

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return copy.deepcopy(self.scenes[i])


def _projected(scenes: Scenes) -> Scenes:
    """The scenes with a full-resolution ``origin_segment`` and ``inverse`` (seeded: 3 rows per voxel row
    on average), which a ScanNet-like dataset returns and the synthetic one drops."""
    rng = np.random.default_rng(9)
    out = []
    for scene in scenes.scenes:
        n = scene["segment"].size
        inverse = rng.integers(0, n, 3 * n)
        out.append(dict(scene, inverse=inverse, origin_segment=np.where(
            rng.random(3 * n) < 0.9, scene["segment"][inverse], rng.integers(0, 6, 3 * n)).astype(np.int32)))
    return Scenes(out)


def _test_scenes(builder):
    ds = builder(dict(TEST_DATA))
    np.random.seed(4)
    return Scenes([ds[i] for i in range(len(ds))])


def _jax_reference(val_batch, scenes, tmp):
    """In a thread: JAX's r3 forward on one val batch (flax-loaded weights), then JAX's SemSegTester on
    a small SpUNet of the mini recipe with seeded weights (eval_shape), each fragment's probabilities
    recorded."""
    cfg = JaxConfig.fromfile(R3)
    model = jax_build_model(dict(cfg.model))
    ck = jax_load_checkpoint(CKPT)
    b = {k: jnp.asarray(v) for k, v in val_batch.items() if not isinstance(v, (str, list))}
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    forward = jax.jit(lambda v, b: model.apply(v, jax_build_point_batch(b, 1), b, train=False)["seg_logits"])
    logits = np.asarray(forward.lower(variables, b).compile(FAST_COMPILE)(variables, b))

    mini = JaxConfig.fromfile(MINI)
    mini.merge_from_dict({"save_path": tmp, "data.test": dict(TEST_DATA), **SMALL})
    small = jax_build_model(dict(mini.model))
    probe = jax_collate([{"coord": np.zeros((4, 3), np.float32), "grid_coord": np.zeros((4, 3), np.int32),
                          "feat": np.zeros((4, 6), np.float32)}], CAPACITY)
    pb = {k: jnp.asarray(v) for k, v in probe.items() if k != "num_samples"}  # a fragment batch's keys
    shapes = jax.eval_shape(lambda: small.init({"params": jax.random.PRNGKey(0)}, jax_build_point_batch(pb, 1), pb))
    small_vars = jax_variables_like(shapes, np.random.default_rng(21))
    tester = JaxSemSegTester(mini, fragment_capacity=CAPACITY, model=small, variables=small_vars, test_loader=scenes)
    tester._build_forward()  # JAX's own forward, compiled here with the cheaper passes (one fragment shape)
    run, probs = tester._forward.lower(small_vars, pb).compile(FAST_COMPILE), []
    tester._forward = lambda v, batch: probs.append(np.asarray(run(v, batch))) or probs[-1]
    result = tester.test()
    labels = {name: np.load(os.path.join(tmp, "result", name)) for name in os.listdir(os.path.join(tmp, "result"))}
    first = list(probs)
    tester.test_dataset = _projected(scenes)  # the same scenes with origin_segment and inverse
    projected = tester.test()
    return dict(r3_logits=logits, small_vars=small_vars, probs=first, result=result, labels=labels,
                projected=projected, projected_labels=np.load(os.path.join(tmp, "result", "scene0_pred.npy")))


@pytest.fixture(scope="module", autouse=True)
def reference_future(tmp_path_factory):
    """Both packages' val batches (seeded, one after the other) and test scenes, then JAX's thread:
    (cfg, the port's val batches, JAX's first val batch, the port's test scenes, the future)."""
    cfg = Config.fromfile(R3)
    jds, ds = jax_build_dataset(dict(cfg.data.val)), build_dataset(dict(cfg.data.val))
    np.random.seed(cfg.seed)
    jax_batches = [jax_collate([jds[i]], cfg.slot_size) for i in range(ANCHOR_SCENES)]
    np.random.seed(cfg.seed)
    port_batches = [collate([ds[i]], cfg.slot_size, np.random) for i in range(ANCHOR_SCENES)]
    jax_scenes, port_scenes = _test_scenes(jax_build_dataset), _test_scenes(build_dataset)
    with ThreadPoolExecutor(1) as pool:
        yield cfg, port_batches, jax_batches[0], port_scenes, pool.submit(
            _jax_reference, jax_batches[0], jax_scenes, str(tmp_path_factory.mktemp("jax_tester")))


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future[-1].result()


@pytest.fixture(scope="module")
def r3_model():
    model = build_model(dict(Config.fromfile(R3).model))
    model.load_state_dict(load_jax_checkpoint(CKPT), strict=True)
    return model.eval()


def _logits(model, batch):
    b = sample_to_device(batch, "cpu")
    with torch.no_grad():
        return model(build_point_batch(b, 1), b)["seg_logits"].numpy()


# ---- the reader --------------------------------------------------------------------------------------


def _assert_same_leaves(got, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for key in ref:
            _assert_same_leaves(got[key], ref[key], f"{path}/{key}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref) and got == ref, path


def test_reader_matches_flax_on_the_semseg_checkpoint():
    with open(CKPT, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    got = load_checkpoint(CKPT)
    _assert_same_leaves(got, ref)
    assert got["params"]["SpUNet_0"]["SubMConv_0"]["weight"].shape == (27, 6, 24)
    state = load_jax_checkpoint(CKPT)
    model = build_model(dict(Config.fromfile(R3).model))
    model.load_state_dict(state, strict=True)  # no key missing or unexpected
    np.testing.assert_array_equal(state["backbone.head.weight"].numpy(), ref["params"]["SpUNet_0"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(state["backbone.norms.8.running_var"].numpy(),
                                  ref["batch_stats"]["SpUNet_0"]["MaskedBatchNorm_8"]["var"])


# ---- the anchor ----------------------------------------------------------------------------------------


def test_val_scenes_are_the_same_in_both_packages(reference_future):
    _, port_batches, jax_batch, _, _ = reference_future
    for key, value in jax_batch.items():
        np.testing.assert_array_equal(port_batches[0][key], value, err_msg=key)


def test_r3_miou_over_the_checkpoint_tests_scenes(reference_future, r3_model):
    cfg, batches, *_ = reference_future
    k = cfg.data.num_classes
    inter, union = np.zeros(k), np.zeros(k)
    for b in batches:
        a, u, _ = intersection_and_union(torch.from_numpy(_logits(r3_model, b).argmax(-1)), torch.from_numpy(b["segment"]),
                                         k, -1, torch.from_numpy(b["valid"]))
        inter, union = inter + a.numpy(), union + u.numpy()
    miou = float(np.mean(inter / np.maximum(union, 1)))
    print(f"semseg_r3 mIoU over {len(batches)} val scenes (np.random seed {cfg.seed}): port {miou:.6f}, "
          f"JAX {JAX_ANCHOR_MIOU:.6f}")
    assert miou > 0.95 and abs(miou - JAX_ANCHOR_MIOU) < MIOU_TOL, miou


def test_r3_logits_match_jax_on_a_val_scene(reference_future, reference, r3_model):
    batch = reference_future[1][0]
    v = batch["valid"]
    got, ref = _logits(r3_model, batch)[v], reference["r3_logits"][v]
    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))
    top2 = np.sort(ref, 1)[:, -2:]
    differ = got.argmax(1) != ref.argmax(1)
    assert not (differ & (top2[:, 1] - top2[:, 0] > 2 * err)).any()


# ---- the tester --------------------------------------------------------------------------------------


def test_test_cli_defaults_to_the_card_and_finds_the_weight(tmp_path):
    """``test`` runs on the card unless told otherwise; without ``weight`` it takes the save path's
    model_best, then model_last (.pth, then .ckpt)."""
    with pytest.raises(RuntimeError, match="cuda"):
        test_cli.main(["--config-file", os.path.join(REPO, "configs", "synthetic", "semseg-spunet-r3-test.py"),
                       "--options", f"save_path={tmp_path}"])
    cfg = Config.fromfile(MINI)
    cfg.merge_from_dict({"save_path": str(tmp_path), "data.test": dict(TEST_DATA, num_scenes=1), **SMALL})
    os.makedirs(tmp_path / "model")
    state = build_model(dict(cfg.model)).state_dict()
    torch.save(dict(model=state), tmp_path / "model" / "model_last.pth")
    tester = SemSegTester(cfg, device="cpu")
    assert tester.weight_path().endswith("model_last.pth")
    torch.save(state, tmp_path / "model" / "model_best.pth")
    assert tester.weight_path().endswith("model_best.pth")
    np.random.seed(0)
    assert 0.0 <= tester.test()["mIoU"] <= 1.0


def test_semseg_tester_matches_jax(reference_future, reference, tmp_path):
    """Each fragment's probabilities, every scene's labels (saved as ``<name>_pred.npy``) and the mIoU,
    port against JAX, on the same scenes and seeded weights."""
    cfg = Config.fromfile(MINI)
    cfg.merge_from_dict({"save_path": str(tmp_path), "data.test": dict(TEST_DATA), **SMALL})
    model = build_model(dict(cfg.model))
    model.load_state_dict(convert_variables(reference["small_vars"]), strict=True)
    tester = SemSegTester(cfg, fragment_capacity=CAPACITY, model=model, test_loader=reference_future[3], device="cpu")
    run, probs = tester.forward, []
    tester.forward = lambda batch: probs.append(run(batch)) or probs[-1]
    result = tester.test()
    assert len(probs) == len(reference["probs"]) > 4
    for got, ref in zip(probs, reference["probs"]):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    labels = {name: np.load(os.path.join(tmp_path, "result", name)) for name in os.listdir(tmp_path / "result")}
    assert set(labels) == set(reference["labels"]) == {"scene0_pred.npy", "scene1_pred.npy"}
    for name, ref in reference["labels"].items():
        np.testing.assert_array_equal(labels[name], ref, err_msg=name)
    assert result == pytest.approx(reference["result"], abs=1e-12)
    # projected through inverse onto origin_segment, where a scene has both
    tester.test_dataset = _projected(reference_future[3])
    assert tester.test() == pytest.approx(reference["projected"], abs=1e-12)
    got = np.load(os.path.join(tmp_path, "result", "scene0_pred.npy"))
    assert got.size == 3 * reference_future[3].scenes[0]["segment"].size
    np.testing.assert_array_equal(got, reference["projected_labels"])
