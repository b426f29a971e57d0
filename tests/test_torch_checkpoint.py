"""The committed keypoint checkpoint in the port, against the JAX package on the CPU.

The port's pure-Python flax-msgpack reader against ``flax.serialization.
msgpack_restore`` (``exp/kp_r3/model_params.ckpt``, and a file the test
writes with the JAX package's ``save_checkpoint``: every dtype flax writes,
npscalars, tuples, an empty dict and a chunked leaf); ``load_jax_checkpoint``
into the r3 model with ``strict=True``; that model against JAX's
``model.apply`` with flax-loaded weights on a val scene of
``configs/synthetic/offset-keypoint-r3.py``; the port's keypoint anchor over
its 8 val scenes against JAX's there; one training step of a small k=3 stem, patch 32, 7-channel
PT-v3m1 (one serialization order) against JAX's value-and-grad; the 7-channel stem conv's padding; the
weight loading of the server and of ``CheckpointLoader``.

The val scenes: ``GridSample`` (train mode) and the slot subsample draw from
the global ``np.random``, so the anchor depends on its state
(``scripts/kp_r3_anchor_by_seed.py`` prints it per seed in both packages);
both packages' scenes are made here after ``np.random.seed`` of the config's
seed, 42, and JAX's anchor there is the script's reading (its 8-scene
evaluation is not repeated here).  JAX compiles the r3 forward and the small
model's value-and-grad as one function, in a thread started by the file's
first test, with XLA's cheaper CPU passes.

Tolerances: the reader bit for bit; the r3 model's ``offset_pred`` and
``mask_logits`` on valid rows 1e-4 x max(1, max|jax|) (f32 sums in other
orders through 5 Blocks), where an argmax pick may differ only on a tie: the
two points' JAX logits closer than twice the scene's logit error; the anchor
< 6.0 mm weighted and < 11.0 mm argmax (``tests/test_keypoint_checkpoint.py``'s
bounds), each within 0.05 mm of JAX's on the same scenes; the
training step as ``tests/test_torch_train.py``: loss 1e-5 relative, gradients
2e-5 x max(1, max|g|) per tensor, running statistics 1e-6.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from scipy.special import expit
from torch_parity import jax_variables_for, slotted_scene

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate
from pointcept_keypointdetection_tpu.engines.common import build_point_batch as jax_build_point_batch
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from pointcept_keypointdetection_tpu.utils.checkpoint import save_checkpoint
from pointcept_keypointdetection_tpu_torch import serve
from pointcept_keypointdetection_tpu_torch.convert import convert_variables, load_jax_checkpoint, load_weights
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device
from pointcept_keypointdetection_tpu_torch.engines.hooks.keypoint_evaluator import keypoint_distances
from pointcept_keypointdetection_tpu_torch.engines.train import Trainer
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc
from pointcept_keypointdetection_tpu_torch.models import PointBatch, build_model
from pointcept_keypointdetection_tpu_torch.models import point_transformer_v3 as ptv3
from pointcept_keypointdetection_tpu_torch.ops import sparse as sp
from pointcept_keypointdetection_tpu_torch.utils.checkpoint import CheckpointError, load_checkpoint, restore
from pointcept_keypointdetection_tpu_torch.utils.config import Config
from pointcept_keypointdetection_tpu_torch.utils.optimizer import build_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "exp", "kp_r3", "model_params.ckpt")
R3 = os.path.join(REPO, "configs", "synthetic", "offset-keypoint-r3.py")
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
ANCHOR_MM = 0.05
# JAX's keypoint error on the same 8 val scenes (np.random seeded 42): scripts/kp_r3_anchor_by_seed.py 42
JAX_ANCHOR_MM = {"weighted": 3.3400, "argmax": 8.3052}
SLOT, SAMPLES, K = 128, 2, 6
# the training step: a small model with the r3 recipe's stem (k=3, 7 input channels) and patch 32
STEP_CFG = dict(
    type="OffsetKeypointPTv3", num_keypoints=K, hidden_dim=32,
    backbone_conf=dict(
        type="PT-v3m1", in_channels=7, order=("z",), stride=(2,), enc_depths=(1, 1), enc_channels=(16, 24),
        enc_num_head=(1, 2),
        enc_patch_size=(32, 32), dec_depths=(1,), dec_channels=(16,), dec_num_head=(1,), dec_patch_size=(32,),
        slot_divisors=(1, 2), drop_path=0.0, shuffle_orders=False, stem_kernel=3,
    ),
)


def _val_batches(cfg, dataset_builder, collate_fn):
    """The r3 recipe's 8 val scenes, one per batch at its slot, after seeding np.random with its seed."""
    ds = dataset_builder(dict(cfg.data.val))
    np.random.seed(cfg.seed)
    return [collate_fn(ds[i]) for i in range(len(ds))]


def _step_batch():
    rng = np.random.default_rng(1)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=100, span=8)
    n = SAMPLES * SLOT
    mask = (rng.random((n, K)) < 0.3).astype(np.float32)
    return dict(coord=scene["coord"], feat=rng.normal(size=(n, 7)).astype(np.float32),
                grid_coord=scene["grid_coord"], valid=scene["valid"],
                keypoint_offset=(rng.normal(size=(n, K, 3)) * 0.3).astype(np.float32) * mask[..., None],
                keypoint_mask=mask)


def _jax_reference(batch):
    """In one compile: JAX's r3 forward (flax-loaded weights) on one val batch, and one training step
    of the small k=3 model (loss, gradients and new batch statistics)."""
    model, step_model = jax_build_model(dict(Config.fromfile(R3).model)), jax_build_model(STEP_CFG)
    ck = jax_load_checkpoint(CKPT)
    step_vars = jax_variables_for(build_model(STEP_CFG), np.random.default_rng(0))

    def loss_fn(params, batch_stats, b):
        point = JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                              num_samples=SAMPLES)
        out, mutated = step_model.apply({"params": params, "batch_stats": batch_stats}, point, b, train=True,
                                        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return out["loss"], mutated["batch_stats"]

    def both(r3_vars, b, params, batch_stats, sb):
        return (model.apply(r3_vars, jax_build_point_batch(b, 1), b, train=False),
                jax.value_and_grad(loss_fn, has_aux=True)(params, batch_stats, sb))

    args = ({"params": ck["params"], "batch_stats": ck["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, (str, list))},
            step_vars["params"], step_vars["batch_stats"], {k: jnp.asarray(v) for k, v in _step_batch().items()})
    out, ((loss, stats), grads) = jax.jit(both).lower(*args).compile(FAST_COMPILE)(*args)
    return dict(r3={k: np.asarray(v) for k, v in out.items()},
                step=dict(variables=step_vars, loss=float(loss), grads=jax.tree.map(np.array, grads),
                          stats=jax.tree.map(np.array, stats)))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    """The val scenes of both packages (made here, one after the other: the global np.random is
    the thread's too), then JAX's compile and run in a thread from the file's first test on:
    (cfg, JAX's batches, the port's batches, the future)."""
    cfg = Config.fromfile(R3)
    jax_batches = _val_batches(cfg, jax_build_dataset, lambda s: jax_collate([s], cfg.slot_size))
    port_batches = _val_batches(cfg, build_dataset, lambda s: collate([s], cfg.slot_size, np.random))
    with ThreadPoolExecutor(1) as pool:
        yield cfg, jax_batches, port_batches, pool.submit(_jax_reference, jax_batches[0])


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future[3].result()["r3"]


@pytest.fixture(scope="module")
def jax_step(reference_future):
    return reference_future[3].result()["step"]


@pytest.fixture(scope="module")
def r3_outputs(reference_future):
    """The port's r3 model with the checkpoint's weights on its own val batches: (batches, outputs)."""
    cfg, _, batches, _ = reference_future
    model = build_model(dict(cfg.model))
    model.load_state_dict(load_jax_checkpoint(CKPT), strict=True)
    model.eval()
    with torch.no_grad():
        outs = [{k: v.numpy() for k, v in model(build_point_batch(sample_to_device(b, "cpu"), 1)).items()}
                for b in batches]
    return batches, outs


# ---- the reader ------------------------------------------------------------------------------------


def _assert_same_tree(got, ref, path=""):
    """Equal trees: dicts with the same keys, lists, scalars of one type and value, and arrays of
    one dtype, shape and bits (a bfloat16 leaf: a torch.bfloat16 tensor with ml_dtypes' bits)."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (path, got, ref)
        for key in ref:
            _assert_same_tree(got[key], ref[key], f"{path}/{key}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), np.asarray(ref).view(np.uint16))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref) and got.dtype == ref.dtype and got.shape == ref.shape, (path, got, ref)
        assert np.asarray(got).tobytes() == np.asarray(ref).tobytes(), path
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


def test_reader_matches_flax_on_the_committed_checkpoint():
    with open(CKPT, "rb") as f:
        data = f.read()
    got = load_checkpoint(CKPT)
    _assert_same_tree(got, flax.serialization.msgpack_restore(data))
    assert got["epoch"] == 61 and got["params"]["PointTransformerV3_0"]["stem_weight"].shape == (27, 7, 32)
    leaf = got["params"]["Dense_0"]["kernel"]
    assert leaf.base is None and leaf.flags.writeable  # its own copy, not a view of the file's bytes


def test_reader_matches_flax_on_a_written_file(tmp_path, monkeypatch):
    """Every dtype the reader takes, npscalars, tuples (flax writes dicts keyed "0", "1", ...),
    an empty dict, None, text, bytes and a complex, and leaves over a lowered MAX_CHUNK_SIZE
    split into chunks (f32 and bf16)."""
    rng = np.random.default_rng(0)
    payload = {
        "params": {
            "f32": rng.normal(size=(3, 5)).astype(np.float32),
            "bf16": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16),
            "f16": rng.normal(size=(2, 2)).astype(np.float16),
            "f64": rng.normal(size=(3,)),
            "ints": {str(np.dtype(t)): rng.integers(-100, 100, size=(2, 3)).astype(t)
                     for t in (np.int8, np.int16, np.int32, np.int64)},
            "uints": {str(np.dtype(t)): rng.integers(0, 200, size=(4,)).astype(t)
                      for t in (np.uint8, np.uint16, np.uint32, np.uint64)},
            "mask": rng.random(7) > 0.5,
            "empty": np.zeros((0, 4), np.float32),
        },
        "chunked": {"f32": rng.normal(size=(10, 10)).astype(np.float32),
                    "bf16": jnp.asarray(rng.normal(size=(40,)), jnp.bfloat16)},
        "opt_state": (np.float32(2.5), {"count": np.int32(3), "nested": (1, -2.5, "x", None)}, {}),
        "epoch": 61, "neg": -100000, "big": 2**40, "flag": True, "name": "kp_r3", "raw": b"\x00\xff",
        "z": 1 + 2j, "nothing": {},
    }
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / "t.ckpt")
    save_checkpoint(path, payload)
    with open(path, "rb") as f:
        data = f.read()
    assert data.count(b"__msgpack_chunked_array__") == 2
    _assert_same_tree(load_checkpoint(path), flax.serialization.msgpack_restore(data))
    # npscalars (ext type 3): save_checkpoint writes numpy scalars as 0-d arrays, msgpack_serialize does not
    scalars = {"f": np.float32(1.5), "i": np.int64(-7), "b": np.bool_(True), "h": jnp.bfloat16(0.75)}
    blob = flax.serialization.msgpack_serialize(scalars)
    _assert_same_tree(restore(blob), flax.serialization.msgpack_restore(blob))


def test_reader_refuses_other_ext_types_and_dtypes():
    bad_dtype = flax.serialization.msgpack_serialize({"a": {"b": np.ones(2, np.complex64)}})
    with pytest.raises(CheckpointError, match="a/b.*complex64"):
        restore(bad_dtype)
    with pytest.raises(CheckpointError, match="k: msgpack ext type 5"):
        restore(b"\x81\xa1k\xd4\x05\x00")  # {"k": fixext1 of type 5}
    with pytest.raises(CheckpointError, match="truncated"):
        restore(flax.serialization.msgpack_serialize({"a": np.ones(3, np.float32)})[:-2])


def test_load_jax_checkpoint_into_the_r3_model():
    """Unscanned names kept, the head's Dense_0..2 as head.0/2/4, BN statistics as running
    buffers, the stem weight in JAX's [27, 7, 32]; strict: no key missing or unexpected."""
    state = load_jax_checkpoint(CKPT)
    model = build_model(dict(Config.fromfile(R3).model))
    model.load_state_dict(state, strict=True)
    assert state["backbone.stem_weight"].shape == (27, 7, 32)
    assert {"head.0.weight", "head.2.weight", "head.4.weight", "backbone.enc0_block0.cpe.linear.weight",
            "backbone.stem_norm.running_mean", "backbone.enc2_down.norm.running_var"} <= set(state)
    ck = load_checkpoint(CKPT)
    np.testing.assert_array_equal(state["head.4.weight"].numpy(), ck["params"]["Dense_2"]["kernel"].T)


# ---- the 7-channel stem and the shared k=3 map ----------------------------------------------------------


def test_stem_conv_pads_seven_channels_exactly(monkeypatch):
    """The Function pads Cin 7 to 8 on the CPU as on the card: its output and W's gradient equal the
    unpadded plain conv's (1e-5 x max(1, max|ref|): f32 sums in another order), W's gradient is
    [27, 7, 32], and with features that need no gradient (the stem's input) B3 runs once, for the
    forward only."""
    rng = np.random.default_rng(2)
    scene = slotted_scene(rng, 2, 96, n_valid=70, span=6)
    grid, valid, batch = (torch.from_numpy(scene[k]) for k in ("grid_coord", "valid", "batch"))
    kmap = sp.build_kernel_map(sp.build_voxel_index(grid, batch, valid), grid, batch, valid, sp.SparseConvSpec.cube(3))
    idx = kmap.neighbor_idx
    feat = torch.from_numpy(rng.normal(size=(192, 7)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(27, 7, 32)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(192, 32)).astype(np.float32))
    calls = []
    conv = sc.subm_conv
    monkeypatch.setattr(sc, "subm_conv", lambda *a: calls.append(a[0].shape) or conv(*a))
    w = w0.clone().requires_grad_()
    out = sp.sparse_conv(feat, kmap, w)
    out.backward(g)
    assert calls == [(192, 8)]  # one B3, on the padded features; no dfeat
    ref_out, ref_dw = sc.subm_conv_plain(feat, idx, w0), sc.subm_conv_dw_plain(feat, idx, g)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-5 * max(1.0, ref_out.abs().max().item()))
    assert w.grad.shape == (27, 7, 32) and w.grad.is_contiguous()
    torch.testing.assert_close(w.grad, ref_dw, rtol=0, atol=1e-5 * max(1.0, ref_dw.abs().max().item()))
    # with a gradient for the features, dfeat is B3 on the mirrored padded W, cut back to 7 channels
    f = feat.clone().requires_grad_()
    sp.sparse_conv(f, kmap, w0).backward(g)
    ref = feat.clone().requires_grad_()
    sc.subm_conv_plain(ref, idx, w0).backward(g)
    assert calls[1:] == [(192, 8), (192, 32)] and f.grad.shape == (192, 7)
    torch.testing.assert_close(f.grad, ref.grad, rtol=0, atol=1e-5 * max(1.0, ref.grad.abs().max().item()))


def test_k3_stem_shares_the_stage0_map(monkeypatch, reference_future):
    """A forward of the r3 model builds one kernel map per level (3), the stem's being stage 0's; a k=1
    stem builds its own; an even stem size raises, as JAX's ``SparseConvSpec.cube`` does."""
    cfg, _, batches, _ = reference_future
    model = build_model(dict(cfg.model)).eval()
    built, used = [], []
    make, conv = sp.build_kernel_map, ptv3.sparse_conv
    monkeypatch.setattr(ptv3, "build_kernel_map", lambda *a, **k: built.append(make(*a, **k)) or built[-1])
    monkeypatch.setattr(ptv3, "sparse_conv", lambda feat, kmap, *a: used.append(kmap) or conv(feat, kmap, *a))
    with torch.no_grad():
        model(build_point_batch(sample_to_device(batches[0], "cpu"), 1))
    assert len(built) == 3 and used[0] is built[0] and used[1] is built[0]  # the stem, then enc0's xCPE
    assert [b.neighbor_idx.shape[1] for b in built] == [27, 27, 27]
    # a k=1 stem (JAX: a cube(1) map of its own, stage 0 its k=3 map) builds one map more
    built.clear()
    k1 = build_model(dict(cfg.model, backbone_conf=dict(cfg.model.backbone_conf, stem_kernel=1))).eval()
    with torch.no_grad():
        out = k1(build_point_batch(sample_to_device(batches[0], "cpu"), 1))
    assert [b.neighbor_idx.shape[1] for b in built] == [27, 1, 27, 27] and torch.isfinite(out["mask_logits"]).all()
    with pytest.raises(ValueError, match="odd"):
        build_model(dict(cfg.model, backbone_conf=dict(cfg.model.backbone_conf, stem_kernel=4)))


# ---- weights into the entry points -----------------------------------------------------------------


def test_serve_loads_weights_from_a_ckpt_a_trainer_pth_and_a_state_dict(tmp_path):
    state = load_jax_checkpoint(CKPT)
    torch.save(state, tmp_path / "state.pt")
    torch.save(dict(epoch=3, step=9, model=state, optimizer={"state": {}, "param_groups": []}, best_metric_value=-3.3),
               tmp_path / "model_best.pth")
    loaded = [load_weights(p) for p in (CKPT, str(tmp_path / "model_best.pth"), str(tmp_path / "state.pt"))]
    for got in loaded:
        assert set(got) == set(state)
        assert all(torch.equal(got[k], state[k]) for k in state)
    cfg = Config.fromfile(R3)
    predictor = serve.build_predictor("offset_keypoint", cfg, loaded[1], cfg.slot_size, "cpu")
    assert all(torch.equal(v, state[k]) for k, v in predictor.model.state_dict().items())
    (tmp_path / "junk.bin").write_bytes(b"\x81\xa1k")
    with pytest.raises(CheckpointError):
        load_weights(str(tmp_path / "junk.bin"))


def test_r3_recipe_trainer_starts_from_the_ckpt(tmp_path):
    """The r3 recipe builds the port's trainer as written (batch 4, slot 4096, 128 scenes of 6,000
    points, AdamW 1.5e-3 + cosine, the weighted evaluator), and ``CheckpointLoader`` with
    ``weight=<.ckpt>`` loads the params and batch statistics; one step then trains."""
    cfg = Config.fromfile(R3)
    cfg.merge_from_dict({"save_path": str(tmp_path), "weight": CKPT, "num_worker": 0})
    trainer = Trainer(cfg, device="cpu")
    assert (cfg.batch_size, cfg.slot_size, len(trainer.train_loader)) == (4, 4096, 32)
    assert trainer.train_loader.dataset.num_points == 6000 and trainer.optimizer.param_groups[0]["lr"] == 1.5e-3
    assert [type(h).__name__ for h in trainer.hooks][3] == "OffsetKeypointEvaluator"
    assert trainer.hooks[3].aggregate == "weighted"
    trainer.hooks[0].before_train()  # CheckpointLoader
    state = load_jax_checkpoint(CKPT)
    assert all(torch.equal(v, state[k]) for k, v in trainer.model.state_dict().items())
    trainer.comm_info["input_dict"] = next(iter(trainer.train_loader))
    trainer.run_step()
    assert np.isfinite(trainer.comm_info["metrics"]["loss"])
    assert not torch.equal(trainer.model.backbone.stem_weight.detach(), state["backbone.stem_weight"])


# ---- the model, the anchor and a training step against JAX (these wait for JAX's threads) ----------


def test_val_scenes_are_the_same_in_both_packages(reference_future):
    _, jax_batches, port_batches, _ = reference_future
    for a, b in zip(port_batches, jax_batches):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_r3_model_matches_jax_on_a_val_scene(reference, r3_outputs):
    """The port's outputs against JAX's on the first val scene; its argmax picks are JAX's, or sit
    on a tie: the two points' JAX logits closer than twice the logit error (``PERF.md`` §2)."""
    batches, outs = r3_outputs
    v, got = batches[0]["valid"], outs[0]
    for key in ("offset_pred", "mask_logits"):
        tol = 1e-4 * max(1.0, float(np.abs(reference[key][v]).max()))
        np.testing.assert_allclose(got[key][v], reference[key][v], rtol=0, atol=tol, err_msg=key)
    logits, ref_logits = got["mask_logits"][v], reference["mask_logits"][v]
    tie = 2 * float(np.abs(logits - ref_logits).max())
    pick, ref_pick = expit(logits).argmax(0), np.asarray(jax.nn.sigmoid(jnp.asarray(ref_logits))).argmax(0)
    for k in np.nonzero(pick != ref_pick)[0]:
        gap = abs(float(ref_logits[ref_pick[k], k] - ref_logits[pick[k], k]))
        print(f"keypoint {k}: argmax picks differ on a logit gap of {gap} (tie below {tie})")
        assert gap <= tie, f"keypoint {k}: argmax picks differ away from a tie ({gap} > {tie})"


def test_r3_anchor_matches_jax(r3_outputs):
    """The port's keypoint error over the 8 val scenes, through its evaluator's ``keypoint_distances``,
    against JAX's on the same scenes (``JAX_ANCHOR_MM``)."""
    batches, outs = r3_outputs
    sums = {"weighted": 0.0, "argmax": 0.0}
    for b, out in zip(batches, outs):
        d = keypoint_distances(b["coord"], b["valid"], out["offset_pred"], expit(out["mask_logits"]),
                               b["keypoint_offset"], b["keypoint_mask"], b["scale"], 1, 0.5)
        for m in sums:
            sums[m] = sums[m] + d[m].sum(0)
    got = {m: float(np.mean(s / len(batches))) for m, s in sums.items()}
    print(f"r3 anchor: port {got} mm, JAX {JAX_ANCHOR_MM} mm")
    assert got["weighted"] < 6.0 and got["argmax"] < 11.0, got
    for m, ref in JAX_ANCHOR_MM.items():
        assert abs(got[m] - ref) < ANCHOR_MM, (m, got[m], ref)


def test_k3_training_step_matches_jax(jax_step):
    step = jax_step
    model = build_model(STEP_CFG)
    model.load_state_dict(convert_variables(step["variables"]))
    model.train()
    batch = {k: torch.from_numpy(v) for k, v in _step_batch().items()}
    point = PointBatch(coord=batch["coord"], feat=batch["feat"], grid_coord=batch["grid_coord"],
                       valid=batch["valid"], num_samples=SAMPLES)
    out = model(point, batch)
    np.testing.assert_allclose(out["loss"].item(), step["loss"], rtol=1e-5)
    out["loss"].backward()
    grads = convert_variables({"params": step["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params) and params["backbone.stem_weight"].grad.shape == (27, 7, 16)
    for name, ref in grads.items():
        tol = 2e-5 * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(params[name].grad, ref, rtol=0, atol=tol, msg=lambda m, name=name: f"{name}: {m}")
    stats = convert_variables({"batch_stats": step["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) and len(stats) == 4  # stem + the pooling norm, mean and var
    for name, ref in stats.items():
        torch.testing.assert_close(buffers[name], ref, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")
    # AdamW sees the stem's 7 input channels only
    optimizer = build_optimizer(dict(type="AdamW", lr=1e-3, weight_decay=0.01), model.parameters())
    optimizer.step()
    assert optimizer.state[params["backbone.stem_weight"]]["exp_avg"].shape == (27, 7, 16)
