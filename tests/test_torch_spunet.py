"""SpUNet-v1m1 and its recipe's parts in the port, against the JAX package on the CPU.

The k=5 (125 offsets) and k=3 kernel maps, exact; the conv rulebook at
K = 125 (hit masks in four words) and B3's and B4's walk over it against the
plain product; ``StridedConvDown`` / ``InverseConvUp`` at a pooled level that
overflows its capacity (integers exact, features within a tolerance); a small
``DefaultSegmentor`` over SpUNet-v1m1 with stem 5 and stem 3 (logits and
loss: stem 3 in eval mode, stem 5 as the training step's forward), and one
training step with stem 5 (logits, loss, every gradient, the running
statistics), through ``convert.py`` on seeded flax params whose names come
from ``jax.eval_shape``; ``PolyLR`` and ``SGD`` against JAX's optax over
several steps; Mix3D collation, GridSample's test mode and
``SyntheticSemSegDataset``'s ``fragment_list`` under the same ``np.random``
seed, exact.  JAX runs as its own tests run it on the CPU (the XLA conv
path); its maps, pooling, forward and value-and-grad compile as one function, in
a thread started by the file's first test, with XLA's cheaper CPU passes.

Tolerances: integer outputs exact; pooled and unpooled f32 features 1e-5 x
max(1, max|jax|) (f32 sums of 8 products and of a segment in other orders);
logits 1e-4 x max(1, max|jax|) and the loss 1e-5 relative (f32 through 5
convs, a strided and an inverse conv and their norms); the training step as
``tests/test_torch_train.py``: gradients 2e-5 x max(1, max|g|) per tensor,
running statistics 1e-6; PolyLR 1e-6 relative (JAX computes it in f32), SGD's
parameters 1e-6 relative after each step.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_variables_like, slotted_scene

from pointcept_keypointdetection_tpu.datasets import build_dataset as jax_build_dataset
from pointcept_keypointdetection_tpu.datasets.collate import collate as jax_collate
from pointcept_keypointdetection_tpu.datasets.transform import GridSample as JaxGridSample
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models import sparse_unet as jax_spunet
from pointcept_keypointdetection_tpu.ops import sparse as jax_sparse
from pointcept_keypointdetection_tpu.utils.optimizer import build_optimizer as jax_build_optimizer
from pointcept_keypointdetection_tpu.utils.scheduler import build_scheduler as jax_build_scheduler
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.datasets.transform import GridSample
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc
from pointcept_keypointdetection_tpu_torch.models import PointBatch, build_model
from pointcept_keypointdetection_tpu_torch.models import sparse_unet
from pointcept_keypointdetection_tpu_torch.ops import sparse as sp
from pointcept_keypointdetection_tpu_torch.utils.optimizer import build_optimizer
from pointcept_keypointdetection_tpu_torch.utils.scheduler import build_scheduler

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SLOT, SAMPLES, CLASSES = 256, 2, 5
# one stage (a strided conv, a block, the inverse conv and the decoder's block over the skip): slot_divisors
# (2,) make its pooled level (128 rows a sample) overflow: ~180 parents
MODEL = dict(type="DefaultSegmentor", criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
             backbone=dict(type="SpUNet-v1m1", in_channels=6, num_classes=CLASSES, base_channels=8,
                           channels=(16, 8), layers=(1, 1), bn_momentum=0.1, slot_divisors=(2,)))


def model_cfg(stem: int) -> dict:
    return dict(MODEL, backbone=dict(MODEL["backbone"], stem_kernel=stem))


def _batch() -> dict:
    rng = np.random.default_rng(3)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=230, span=14)
    n = SAMPLES * SLOT
    segment = np.where(scene["valid"], rng.integers(-1, CLASSES, n), -1).astype(np.int32)
    return dict(coord=scene["coord"], feat=rng.normal(size=(n, 6)).astype(np.float32),
                grid_coord=scene["grid_coord"], valid=scene["valid"], segment=segment)


def _jax_point(b):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES)


def _port_point(b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    return PointBatch(coord=t["coord"], feat=t["feat"], grid_coord=t["grid_coord"], valid=t["valid"],
                      num_samples=SAMPLES), t


POOL_CAP = 96  # a sample's ~180 parent voxels overflow 96 rows: the highest codes are dropped


def _pool_weights():
    rng = np.random.default_rng(5)
    return (0.3 * rng.normal(size=(8, 6, 16))).astype(np.float32), (0.3 * rng.normal(size=(8, 16, 8))).astype(np.float32)


def _jax_reference():
    """In one compile: the stem-3 and stem-5 models' eval outputs (logits, loss) and one training step of
    the stem-5 model (loss, gradients, new batch statistics), on seeded variables named by eval_shape."""
    batch = _batch()
    models = {k: jax_build_model(model_cfg(k)) for k in (3, 5)}
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: models[5].init({"params": jax.random.PRNGKey(0)}, _jax_point(dev), dev))
    variables = {5: jax_variables_like(shapes, np.random.default_rng(15))}
    # the stem-3 model: the same tree but for the stem's [27, 6, 8] weight
    variables[3] = jax.tree.map(lambda x: x, variables[5])
    variables[3]["params"]["SpUNet_0"]["SubMConv_0"]["weight"] = variables[5]["params"]["SpUNet_0"]["SubMConv_0"][
        "weight"][:27].copy()

    def loss_fn(params, batch_stats, b):
        out, mutated = models[5].apply({"params": params, "batch_stats": batch_stats}, _jax_point(b), b, train=True,
                                       mutable=["batch_stats"])
        return out["loss"], (mutated["batch_stats"], out["seg_logits"])

    def maps(b):
        grid, bt, valid = b["grid_coord"], jnp.arange(SAMPLES * SLOT, dtype=jnp.int32) // SLOT, b["valid"]
        index = jax_sparse.build_voxel_index(grid, bt, valid, 16)
        return {k: jax_sparse.build_kernel_map(index, grid, bt, valid, jax_sparse.SparseConvSpec.cube(k), 16)
                .neighbor_idx for k in (5, 3)}

    def pooling(b, w_down, w_up):
        pooled, su = jax_spunet.StridedConvDown(16).apply({"params": {"weight": w_down}}, _jax_point(b), POOL_CAP)
        up = jax_spunet.InverseConvUp(8).apply({"params": {"weight": w_up}}, pooled.feat, _jax_point(b), su)
        return dict(parent_row=su.parent_row, head_row=su.head_row, out_valid=su.out_valid,
                    grid_coord=pooled.grid_coord, valid=pooled.valid, feat=pooled.feat, coord=pooled.coord, up=up)

    def run(v3, v5, b, w_down, w_up):
        return (maps(b), pooling(b, w_down, w_up), models[3].apply(v3, _jax_point(b), b, train=False),
                jax.value_and_grad(loss_fn, has_aux=True)(v5["params"], v5["batch_stats"], b))

    args = (variables[3], variables[5], dev, *map(jnp.asarray, _pool_weights()))
    kmaps, pooled, eval3, ((loss, (stats, logits)), grads) = jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args)
    return dict(variables=variables, maps=jax.tree.map(np.asarray, kmaps), pooling=jax.tree.map(np.asarray, pooled),
                eval3=jax.tree.map(np.asarray, eval3),
                step=dict(loss=float(loss), logits=np.asarray(logits), grads=jax.tree.map(np.array, grads),
                          stats=jax.tree.map(np.array, stats)))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


# ---- kernel maps and the rulebook at K = 125 ------------------------------------------------------------


def _port_map(kernel: int) -> torch.Tensor:
    b = _batch()
    grid, valid = torch.from_numpy(b["grid_coord"]), torch.from_numpy(b["valid"])
    bt = torch.arange(SAMPLES * SLOT) // SLOT
    return sp.build_kernel_map(sp.build_voxel_index(grid, bt, valid), grid, bt, valid,
                               sp.SparseConvSpec.cube(kernel)).neighbor_idx


def test_rulebook_and_kernel_walks_at_125_offsets():
    """The rulebook of the k=5 map: hit masks in 4 words of 32 offsets, rows sorted by them (highest word
    first), every tile's words the union of its rows'; B3's walk (busy tiles x the offsets their words set,
    in the offset splits the wrapper picks) and B4's (each offset's hit pairs in its row splits) equal
    the plain versions: one launch at any K, no group of offsets."""
    idx = _port_map(5)
    n, k = idx.shape
    rb = sc.build_rulebook(idx)
    tiles = -(-n // sc.TILE)
    assert rb.tile_mask.shape == (4 * tiles,) and rb.nbr.shape == (125, tiles * sc.TILE)
    hit = (idx < n).numpy()[rb.perm.numpy()]
    keys = [tuple(h[::-1]) for h in hit]
    assert all(a >= b for a, b in zip(keys, keys[1:]))  # descending, offset 124 most significant
    words = rb.tile_mask.numpy().astype(np.int64).reshape(4, tiles) & 0xFFFFFFFF
    padded = np.concatenate([hit, np.zeros((tiles * sc.TILE - n, k), bool)]).reshape(tiles, sc.TILE, k).any(1)
    for d in range(k):
        np.testing.assert_array_equal((words[d // 32] >> (d % 32)) & 1, padded[:, d].astype(np.int64))
    assert int(words[3].max()) < 2**29 and int(words[0].max()) >= 2**31  # 29 offsets in the last word

    rng = np.random.default_rng(4)
    feat = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.normal(size=(k, 8, 16))).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    for sms in (132, 1):  # several offset splits (a small map), and one
        splits = sc.offset_splits(rb.busy_tiles, k, 16, sms)
        per = -(-k // splits)
        out = torch.zeros(rb.busy_tiles * sc.TILE, 16)
        feat_pad = torch.cat([feat, torch.zeros(1, 8)])
        for t in range(rb.busy_tiles):
            rows = slice(t * sc.TILE, (t + 1) * sc.TILE)
            for z in range(splits):
                for d in range(z * per, min(k, (z + 1) * per)):
                    if words[d // 32, t] >> (d % 32) & 1:
                        out[rows] += feat_pad[rb.nbr[d, rows].long()] @ w[d]
        got = torch.zeros(n, 16)
        got[rb.perm.long()] = out[:n] if out.shape[0] >= n else torch.cat([out, torch.zeros(n - out.shape[0], 16)])
        ref = sc.subm_conv_plain(feat, idx, w)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * max(1.0, ref.abs().max().item()))
    dw = torch.zeros(k, 8, 16)
    starts = rb.pair_start.tolist()
    for d in range(k):
        dw[d] = feat[rb.pair_in[starts[d]:starts[d + 1]].long()].t() @ g[rb.pair_out[starts[d]:starts[d + 1]].long()]
    ref = sc.subm_conv_dw_plain(feat, idx, g)
    torch.testing.assert_close(dw, ref, rtol=0, atol=1e-5 * max(1.0, ref.abs().max().item()))
    assert sc.MAX_OFFSETS >= 125
    # the Function's backward at K = 125: dfeat by the mirrored W over the same map, dW by the pairs
    f = feat[:, :6].clone().requires_grad_()
    wp = w[:, :6].clone().requires_grad_()
    sc.SubmConvFunction.apply(f, idx, wp, None).backward(g)
    fr, wr = feat[:, :6].clone().requires_grad_(), w[:, :6].clone().requires_grad_()
    sc.subm_conv_plain(fr, idx, wr).backward(g)
    for a, b in ((f.grad, fr.grad), (wp.grad, wr.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, b.abs().max().item()))


def test_spunet_v1m3_with_pdnorm_raises():
    with pytest.raises(NotImplementedError, match="PDNorm"):
        build_model(dict(MODEL["backbone"], type="SpUNet-v1m3", pdnorm_conditions=2))
    assert isinstance(build_model(dict(MODEL["backbone"], type="SpUNet-v1m2")), sparse_unet.SpUNet)


# ---- PolyLR, SGD ---------------------------------------------------------------------------------------


def test_polylr_and_sgd_match_optax():
    """The ScanNet SpUNet recipe's SGD (0.05, momentum 0.9, nesterov, decay 1e-4) under PolyLR over 6
    steps of seeded gradients, and without nesterov, against JAX's ``build_optimizer`` (optax)."""
    total = 10
    schedule, jax_schedule = (f(dict(type="PolyLR", power=0.9), total, 0.05)
                              for f in (build_scheduler, jax_build_scheduler))
    for s in range(total + 3):
        np.testing.assert_allclose(schedule(s), float(jax_schedule(s)), rtol=1e-6)
    assert schedule(total + 1) == 0.0
    rng = np.random.default_rng(6)
    for nesterov in (True, False):
        cfg = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-4, nesterov=nesterov)
        p0 = rng.normal(size=(4, 3)).astype(np.float32)
        grads = rng.normal(size=(6, 4, 3)).astype(np.float32)
        opt = jax_build_optimizer(dict(cfg), jax_schedule)
        jp = {"w": jnp.asarray(p0)}
        state = opt.init(jp)
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        torch_opt = build_optimizer(dict(cfg), [param])
        for s, g in enumerate(grads):
            updates, state = opt.update({"w": jnp.asarray(g)}, state, jp)
            jp = optax.apply_updates(jp, updates)
            for group in torch_opt.param_groups:
                group["lr"] = schedule(s)
            param.grad = torch.from_numpy(g.copy())
            torch_opt.step()
            np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)


# ---- data: Mix3D, GridSample's test mode, the dataset's fragments ---------------------------------------


def _room_samples(dataset_builder, seed):
    cfg = dict(type="SyntheticSemSegDataset", split="train", num_scenes=4, num_points=1200, num_classes=6,
               transform=[dict(type="CenterShift", apply_z=True), dict(type="RandomScale", scale=[0.9, 1.1]),
                          dict(type="GridSample", grid_size=0.1, mode="train", return_grid_coord=True),
                          dict(type="NormalizeColor"),
                          dict(type="Collect", keys=("coord", "grid_coord", "segment"), feat_keys=("coord", "color"))])
    ds = dataset_builder(cfg)
    np.random.seed(seed)
    return [ds[i] for i in range(4)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix3d_collate_matches_jax(seed):
    """Under one np.random seed both packages mix (or not) the same batches and draw the same subsamples;
    the next draw after the batch is the same too."""
    slot = 512
    batches = []
    for builder, fn in ((jax_build_dataset, lambda s: jax_collate(s, slot, mix_prob=0.8)),
                        (build_dataset, lambda s: collate(s, slot, np.random, mix_prob=0.8))):
        samples = _room_samples(builder, seed)
        batches.append((fn(samples), np.random.random()))
    (got, after), (ref, ref_after) = batches[1], batches[0]
    assert after == ref_after and set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    mixed = not got["valid"][slot:2 * slot].any()
    print(f"seed {seed}: mixed {mixed}")


def test_mix3d_pairs_two_samples_in_one_slot():
    np.random.seed(0)
    samples = _room_samples(build_dataset, 0)
    np.random.seed(1)  # np.random.random() < 0.8 on this seed's first draw
    batch = collate(samples, 512, np.random, mix_prob=0.8)
    v = batch["valid"].reshape(4, 512)
    assert v[0].sum() == min(256, len(samples[0]["coord"])) + min(256, len(samples[1]["coord"]))
    assert not v[1].any() and not v[3].any() and (batch["segment"].reshape(4, 512)[1] == -1).all()
    np.random.seed(1)
    unmixed = collate(samples, 512, np.random)  # mix_prob 0 draws nothing for the mix
    assert unmixed["valid"].reshape(4, 512)[1].any()


def test_grid_sample_test_mode_matches_jax():
    rng = np.random.default_rng(7)
    coord = rng.uniform(0, 1, (2000, 3)).astype(np.float32)
    data = dict(coord=coord, color=rng.uniform(0, 255, (2000, 3)).astype(np.float32),
                segment=rng.integers(0, 6, 2000).astype(np.int32))
    kwargs = dict(grid_size=0.08, hash_type="fnv", mode="test", return_inverse=True, return_grid_coord=True)
    got = GridSample(**kwargs)({k: v.copy() for k, v in data.items()})
    ref = JaxGridSample(**kwargs)({k: v.copy() for k, v in data.items()})
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    covered = np.zeros(2000, bool)
    for part in got:
        covered[part["index"]] = True
    assert covered.all()
    np.random.seed(3)
    train = GridSample(grid_size=0.08, return_inverse=True)({k: v.copy() for k, v in data.items()})
    np.random.seed(3)
    jtrain = JaxGridSample(grid_size=0.08, return_inverse=True)({k: v.copy() for k, v in data.items()})
    for key in jtrain:
        np.testing.assert_array_equal(train[key], jtrain[key], err_msg=key)
    np.testing.assert_array_equal(train["segment"][train["inverse"]].shape, data["segment"].shape)


def test_synthetic_semseg_test_mode_fragments_match_jax():
    """The ScanNet recipe's test_cfg shape on synthetic rooms (Copy, GridSample with inverse, test-mode
    voxelize, 2 RandomScale variants, the synthetic features), both packages, exact."""
    cfg = dict(type="SyntheticSemSegDataset", split="val", num_scenes=2, num_points=1500, num_classes=6,
               test_mode=True,
               transform=[dict(type="CenterShift", apply_z=True), dict(type="NormalizeColor"),
                          dict(type="Copy", keys_dict=dict(segment="origin_segment")),
                          dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
                               return_inverse=True, return_grid_coord=True)],
               test_cfg=dict(voxelize=dict(type="GridSample", grid_size=0.05, mode="test", return_grid_coord=True),
                             crop=None,
                             post_transform=[dict(type="CenterShift", apply_z=False),
                                             dict(type="Collect", keys=("coord", "grid_coord", "index"),
                                                  feat_keys=("coord", "color"))],
                             aug_transform=[[dict(type="RandomScale", scale=[0.9, 0.9])],
                                            [dict(type="RandomScale", scale=[1.1, 1.1])]]))
    scenes = []
    for builder in (jax_build_dataset, build_dataset):
        ds = builder(dict(cfg))
        np.random.seed(11)
        scenes.append([ds[i] for i in range(len(ds))])
    for got, ref in zip(scenes[1], scenes[0]):
        assert set(got) == set(ref) == {"segment", "name", "fragment_list"}
        np.testing.assert_array_equal(got["segment"], ref["segment"])
        assert got["name"] == ref["name"] and len(got["fragment_list"]) == len(ref["fragment_list"]) > 2
        for a, b in zip(got["fragment_list"], ref["fragment_list"]):
            assert set(a) == set(b) == {"coord", "grid_coord", "index", "feat"}
            for key in b:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---- against JAX's reference (these wait for its thread) ------------------------------------------


@pytest.mark.parametrize("kernel", [5, 3])
def test_kernel_maps_match_jax(reference, kernel):
    ref, got = reference["maps"][kernel], _port_map(kernel)
    assert got.dtype == torch.int32 and got.shape == (SAMPLES * SLOT, kernel**3)
    np.testing.assert_array_equal(got.numpy(), ref)
    n = ref.shape[0]
    assert (ref < n).sum() > 2 * (ref[:, kernel**3 // 2] < n).sum()  # more neighbours than centres


# ---- pooling and unpooling -------------------------------------------------------------------------------


def test_strided_down_and_inverse_up_match_jax_at_an_overflowing_level(reference):
    b = _batch()
    ref = reference["pooling"]
    w_down, w_up = _pool_weights()
    point, _ = _port_point(b)
    down = sparse_unet.StridedConvDown(6, 16)
    down.weight.data = torch.from_numpy(w_down)
    pooled, su = down(point, POOL_CAP)
    inv = sparse_unet.InverseConvUp(16, 8)
    inv.weight.data = torch.from_numpy(w_up)
    got = dict(parent_row=su.parent_row, head_row=su.head_row, out_valid=su.out_valid, grid_coord=pooled.grid_coord,
               valid=pooled.valid, feat=pooled.feat, coord=pooled.coord, up=inv(pooled.feat, point, su))
    m = SAMPLES * POOL_CAP
    parents = ref["parent_row"]
    assert (parents[b["valid"]] == m).sum() > 0  # some valid children lost their parent
    for name in ("parent_row", "head_row", "out_valid", "grid_coord", "valid"):
        np.testing.assert_array_equal(got[name].numpy(), ref[name], err_msg=name)
    for name in ("feat", "coord", "up"):
        r = ref[name]
        np.testing.assert_allclose(got[name].detach().numpy(), r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()),
                                   err_msg=name)
    assert not ref["up"][b["valid"] & (parents == m)].any()  # the dropped children read zeros


# ---- the model and a training step against JAX -------------------------------------------------------


def _port_model(stem: int, variables) -> torch.nn.Module:
    model = build_model(model_cfg(stem))
    model.load_state_dict(convert_variables(variables), strict=True)
    return model


def test_flax_names_map_onto_the_port_by_convert(reference):
    """Every flax leaf of both models (named by ``jax.eval_shape``) lands on one port tensor of its shape."""
    for k, variables in reference["variables"].items():
        state = convert_variables(variables)
        model = build_model(model_cfg(k))
        assert set(state) == set(model.state_dict())
        assert all(model.state_dict()[name].shape == t.shape for name, t in state.items())
        assert state["backbone.stem.weight"].shape == (k**3, 6, 8)
        assert state["backbone.blocks.1.proj.weight"].shape == (16, 24)  # the decoder's block: 16 + 8 in


def test_spunet_stem3_forward_and_loss_match_jax(reference):
    """Eval mode (running statistics) with the k=3 stem; the k=5 stem's forward is the training step's."""
    ref = reference["eval3"]
    model = _port_model(3, reference["variables"][3]).eval()
    point, batch = _port_point(_batch())
    with torch.no_grad():
        out = model(point, batch)
    v = point.valid.numpy()
    logits, ref_logits = out["seg_logits"].numpy(), ref["seg_logits"]
    np.testing.assert_allclose(logits[v], ref_logits[v], rtol=0, atol=1e-4 * max(1.0, np.abs(ref_logits[v]).max()))
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-5)


def test_spunet_training_step_matches_jax(reference):
    step = reference["step"]
    model = _port_model(5, reference["variables"][5]).train()
    point, batch = _port_point(_batch())
    out = model(point, batch)
    v = point.valid.numpy()
    logits = out["seg_logits"].detach().numpy()
    np.testing.assert_allclose(logits[v], step["logits"][v], rtol=0,
                               atol=1e-4 * max(1.0, np.abs(step["logits"][v]).max()))
    np.testing.assert_allclose(out["loss"].item(), step["loss"], rtol=1e-5)
    out["loss"].backward()
    grads = convert_variables({"params": step["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params) and params["backbone.stem.weight"].grad.shape == (125, 6, 8)
    for name, ref in grads.items():
        tol = 2e-5 * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(params[name].grad, ref, rtol=0, atol=tol, msg=lambda m, name=name: f"{name}: {m}")
    stats = convert_variables({"batch_stats": step["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, ref in stats.items():
        torch.testing.assert_close(buffers[name], ref, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")
