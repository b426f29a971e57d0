"""The port's instance-segmentation modules against the JAX package on the CPU.

``knn`` (two samples, invalid base rows, a sample with fewer valid points than
k, and coordinates on a grid of quarters, where every distance is exact and
equal distances abound, beside seeded floats; JAX's running top-k over
chunks of 16), ``connected_components`` (batches, ignored classes, an
iteration cap that stops a chain half-way), ``cluster_proposals`` and
``proposals_from_labels``, ``associate_batch``, ``evaluate_matches`` and
``summarize_ap``, ``InstanceParser``, and ``PointGroup``: PG-v1m1 over a
small SpUNet (one training step: logits, shifts, the three losses, every
gradient, the running statistics) and PG-v1m2 over a small PTv3 (eval
forward), through ``convert.py`` on seeded flax params.  JAX compiles the
PointGroup references as one function, in a thread started by the file's
first test, with XLA's cheaper CPU passes; the other JAX functions run eagerly.

Tolerances: integer outputs (indices, labels, masks, classes) exact; knn's
squared distances 1e-6 relative and 1e-6 absolute on seeded floats (f32
rounding of |q|^2 - 2 q.b + |b|^2 at coordinates of order 1), exact on the
grid; proposal scores, the association structures and the AP table equal
(the same numpy arithmetic on equal inputs); PointGroup as
``tests/test_torch_spunet.py``: outputs 1e-4 x max(1, max|jax|), losses 1e-5
relative, gradients 2e-5 x max(1, max|g|), running statistics 1e-6; the
shifts of rows whose ``offset_fc`` output has a variance near 1e-6 within
1e-4 x max(1, max|jax|), where an eps of 1e-5 in ``offset_norm`` errs by
more than 100 times that.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_for, jax_variables_like, slotted_scene

from pointcept_keypointdetection_tpu.datasets.transform import InstanceParser as JaxInstanceParser
from pointcept_keypointdetection_tpu.engines.hooks import insseg_evaluator as jax_eval
from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.models import point_group as jax_pg
from pointcept_keypointdetection_tpu.ops.cluster import connected_components as jax_cc
from pointcept_keypointdetection_tpu.ops.knn import knn as jax_knn
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import make_scene
from pointcept_keypointdetection_tpu_torch.datasets.transform import InstanceParser
from pointcept_keypointdetection_tpu_torch.engines.hooks import insseg_evaluator as port_eval
from pointcept_keypointdetection_tpu_torch.models import PointBatch, build_model
from pointcept_keypointdetection_tpu_torch.models import point_group as port_pg
from pointcept_keypointdetection_tpu_torch.ops.cluster import connected_components
from pointcept_keypointdetection_tpu_torch.ops.knn import knn

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SLOT, SAMPLES, CLASSES = 256, 2, 5
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
PG_SPUNET = dict(type="PG-v1m1", criteria=CRITERIA, backbone_out_channels=16, semantic_num_classes=CLASSES,
                 backbone=dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                               channels=(8, 16, 16, 8), layers=(1, 1, 1, 1), bn_momentum=0.1, slot_divisors=(2, 4),
                               stem_kernel=3))
PG_PTV3 = dict(type="PG-v1m2", criteria=CRITERIA, backbone_out_channels=16, semantic_num_classes=CLASSES,
               backbone=dict(type="PT-v3m1", in_channels=6, order=("z", "hilbert"), stride=(2, 2),
                             enc_depths=(1, 1, 1), enc_channels=(16, 32, 48), enc_num_head=(1, 2, 3),
                             enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 32),
                             dec_num_head=(1, 2), dec_patch_size=(16, 16), slot_divisors=(1, 4, 16), kmap_depth=10,
                             drop_path=0.0, shuffle_orders=False))


# ---- knn ------------------------------------------------------------------------------------------------


def _knn_case(seed: int, grid: bool):
    """Base rows of two samples (45 and 15 rows; the second with 3 valid), invalid rows among both, and
    40 queries of either sample."""
    rng = np.random.default_rng(seed)
    n, q = 60, 40
    if grid:  # quarters in [0, 1): every product and sum exact in f32, many equal distances
        base, query = (rng.integers(0, 4, (m, 3)) * 0.25 for m in (n, q))
    else:
        base, query = rng.normal(size=(n, 3)), rng.normal(size=(q, 3))
    base_batch = np.repeat([0, 1], [45, 15]).astype(np.int32)
    valid = rng.random(n) < 0.8
    valid[45:] = False
    valid[[47, 50, 58]] = True
    return dict(query=query.astype(np.float32), base=base.astype(np.float32), base_batch=base_batch,
                query_batch=rng.integers(0, 2, q).astype(np.int32), valid=valid)


@pytest.mark.parametrize("grid", [False, True], ids=["floats", "quarters"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "one-sample"])
def test_knn_matches_jax(grid, batched):
    c = _knn_case(4, grid)
    k = 5
    kwargs = dict(base_valid=c["valid"])
    if batched:
        kwargs.update(query_batch=c["query_batch"], base_batch=c["base_batch"])
    ref_i, ref_d = jax_knn(jnp.asarray(c["query"]), jnp.asarray(c["base"]), k, chunk=16,
                           **{key: jnp.asarray(v) for key, v in kwargs.items()})
    got_i, got_d = knn(torch.from_numpy(c["query"]), torch.from_numpy(c["base"]), k,
                       **{key: torch.from_numpy(v) for key, v in kwargs.items()})
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    if grid:
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    else:
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-6, atol=1e-6)
    if batched:  # the second sample's queries: 3 neighbours, then the (0, 1e10) fillers
        short = c["query_batch"] == 1
        assert (got_d.numpy()[short, 3:] == np.float32(1e10)).all() and (got_i.numpy()[short, 3:] == 0).all()
    if grid:  # ties were there to break
        d = got_d.numpy()
        assert (np.diff(d, axis=1) == 0).sum() > 20


def test_knn_breaks_ties_by_the_lowest_index():
    """Duplicated base points at equal distances: the lowest indices come first, in index order."""
    base = np.zeros((12, 3), np.float32)
    base[::2] = 1.0
    got_i, got_d = knn(torch.zeros(1, 3), torch.from_numpy(base), 4)
    np.testing.assert_array_equal(got_i.numpy(), [[1, 3, 5, 7]])
    ref_i, _ = jax_knn(jnp.zeros((1, 3)), jnp.asarray(base), 4, chunk=4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


# ---- connected components and proposals -----------------------------------------------------------------


def _blob_scene(seed: int, slot: int = 600, blobs: int = 3, per_blob: int = 150):
    """Two samples of ``slot`` rows: per sample a floor (class 0) and ``blobs`` Gaussian blobs of
    ``per_blob`` points, each one instance of class 2-4; pads last.  GT shifts to the centres, and
    seeded predictions: classes right on 95% of the points, shifts the GT's plus noise."""
    rng = np.random.default_rng(seed)
    n = SAMPLES * slot
    coord = np.zeros((n, 3), np.float32)
    segment = np.full(n, -1, np.int32)
    instance = np.full(n, -1, np.int32)
    valid = np.zeros(n, bool)
    for s in range(SAMPLES):
        rows = s * slot
        floor = slot - 60 - blobs * per_blob
        coord[rows:rows + floor] = np.c_[rng.uniform(0, 2, (floor, 2)), np.zeros(floor)]
        segment[rows:rows + floor] = 0
        at = rows + floor
        for b in range(blobs):
            center = np.array([0.3 + 0.6 * b, rng.uniform(0.5, 1.5), 0.5])
            coord[at:at + per_blob] = center + 0.05 * rng.normal(size=(per_blob, 3))
            segment[at:at + per_blob] = 2 + b
            instance[at:at + per_blob] = b
            at += per_blob
        valid[rows:at] = True
    centroid = coord.copy()
    for s in range(SAMPLES):
        for b in range(blobs):
            sel = (np.arange(n) // slot == s) & (instance == b)
            centroid[sel] = coord[sel].mean(0)
    seg_pred = np.where(rng.random(n) < 0.95, segment, rng.integers(0, CLASSES, n)).astype(np.int32)
    seg_pred[~valid] = 0
    bias = (centroid - coord + 0.01 * rng.normal(size=coord.shape)).astype(np.float32)
    probs = rng.dirichlet(np.ones(CLASSES), n).astype(np.float32)
    return dict(coord=coord, segment=segment, instance=instance, valid=valid, seg_pred=seg_pred, bias=bias,
                probs=probs, batch=(np.arange(n) // slot).astype(np.int32), slot=slot)


@pytest.mark.parametrize("case", ["batched", "one-sample", "capped"])
def test_connected_components_match_jax(case):
    s = _blob_scene(5)
    kwargs = dict(radius=0.06, k=8, ignore_classes=(0, 1))
    if case != "one-sample":
        kwargs["batch"] = s["batch"]
    if case == "capped":  # a chain along x, one point apart per radius: 2 + 1 rounds leave it in pieces
        s["coord"][:40] = np.c_[np.arange(40) * 0.05, np.zeros((40, 2))]
        s["seg_pred"][:40] = 3
        kwargs["max_iters"] = 2
    coord = s["coord"] + s["bias"]
    ref = np.asarray(jax_cc(jnp.asarray(coord), jnp.asarray(s["seg_pred"]), jnp.asarray(s["valid"]),
                            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}))
    got = connected_components(torch.from_numpy(coord), torch.from_numpy(s["seg_pred"]), torch.from_numpy(s["valid"]),
                               **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                  for k, v in kwargs.items()})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref[ref >= 0])) >= 3 and (ref[~s["valid"]] == -1).all()


@pytest.mark.parametrize("dual", [False, True])
def test_cluster_proposals_and_proposals_from_labels_match_jax(dual):
    s = _blob_scene(6)
    args = (s["coord"], s["seg_pred"], s["bias"], s["valid"], s["batch"])
    kwargs = dict(cluster_thresh=0.06, segment_ignore_index=(-1, 0, 1), min_points=50, dual=dual)
    ref = jax_pg.cluster_proposals(*map(jnp.asarray, args), **kwargs)
    got = port_pg.cluster_proposals(*map(torch.from_numpy, args), **kwargs)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got[got >= 0])) >= 2 * 3
    for probs, propose in ((s["probs"], 100), (None, 0)):
        ref_p = jax_pg.proposals_from_labels(ref, s["seg_pred"], probs, propose_points=propose)
        got_p = port_pg.proposals_from_labels(got, s["seg_pred"], probs, propose_points=propose)
        for a, b in zip(got_p, ref_p):
            np.testing.assert_array_equal(a, b)


def _flat(scenes):
    """The association structures without their cycles (a gt's matched predictions hold the gt's lists)."""
    def pred(m):
        return (m["uid"], m["confidence"], m["vert_count"], m["void_intersection"], m.get("intersection"))

    def gt(g):
        return (g["instance_id"], g["vert_count"], g.get("intersection"))

    return [{c: ([(gt(g), [pred(m) for m in g["matched_pred"]]) for g in s["gt"][c]],
                 [(pred(m), [gt(g) for g in m["matched_gt"]]) for m in s["pr"][c]]) for c in s["gt"]}
            for s in scenes]


def test_association_and_ap_match_jax():
    """Per-sample association of a collated batch, AP over its scenes and the summary, port against JAX."""
    s = _blob_scene(7)
    labels = port_pg.cluster_proposals(*map(torch.from_numpy, (s["coord"], s["seg_pred"], s["bias"], s["valid"],
                                                               s["batch"])), cluster_thresh=0.06, min_points=50)
    masks, classes, scores = port_pg.proposals_from_labels(labels, s["seg_pred"], s["probs"])
    args = (masks, classes, scores, s["valid"], s["batch"], s["segment"], s["instance"], SAMPLES, CLASSES,
            (-1, 0, 1), -1)
    got, ref = port_eval.associate_batch(*args), jax_eval.associate_batch(*args)
    assert len(got) == SAMPLES and _flat(got) == _flat(ref)
    class_ids = [2, 3, 4]
    ap, ref_ap = port_eval.evaluate_matches(got, class_ids), jax_eval.evaluate_matches(ref, class_ids)
    np.testing.assert_array_equal(ap, ref_ap)
    summary = port_eval.summarize_ap(ap)
    assert summary == jax_eval.summarize_ap(ref_ap) and summary[1] > 0.5
    empty = (np.zeros((0, len(labels)), bool), np.zeros(0, int), np.zeros(0))
    args = (*empty, *args[3:])
    assert _flat(port_eval.associate_batch(*args)) == _flat(jax_eval.associate_batch(*args))


# ---- InstanceParser ---------------------------------------------------------------------------------------


def test_instance_parser_matches_jax():
    coord, color, segment, instance = make_scene(np.random.default_rng(3), 3000, 6)
    instance = np.where(instance >= 0, instance * 3 + 5, instance)  # sparse ids, compacted by the parser
    data = dict(coord=coord, color=color, segment=segment, instance=instance)
    kwargs = dict(segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1)
    got = InstanceParser(**kwargs)({k: v.copy() for k, v in data.items()})
    ref = JaxInstanceParser(**kwargs)({k: v.copy() for k, v in data.items()})
    assert set(got) == set(ref)
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            assert got[key] == ref[key], key
    assert got["instance"].max() == len(np.unique(instance[segment > 1])) - 1
    assert "instance_centroid" in got["index_valid_keys"]


# ---- PointGroup -------------------------------------------------------------------------------------------


def _pg_batch() -> dict:
    rng = np.random.default_rng(3)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=230, span=14)
    n = SAMPLES * SLOT
    valid = scene["valid"]
    instance = np.where(valid, scene["grid_coord"][:, 0] // 4 + 4 * (scene["grid_coord"][:, 1] // 7), -1)
    instance = np.where(rng.random(n) < 0.15, -1, instance).astype(np.int32)
    centroid = (scene["coord"] + 0.1 * rng.normal(size=(n, 3))).astype(np.float32)
    return dict(coord=scene["coord"], feat=rng.normal(size=(n, 6)).astype(np.float32),
                grid_coord=scene["grid_coord"], valid=valid,
                segment=np.where(valid, rng.integers(-1, CLASSES, n), -1).astype(np.int32), instance=instance,
                instance_centroid=centroid)


def _jax_point(b):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES)


def _port_point(b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    return PointBatch(coord=t["coord"], feat=t["feat"], grid_coord=t["grid_coord"], valid=t["valid"],
                      num_samples=SAMPLES), t


def _low_variance(variables):
    """The variables with ``offset_fc`` scaled by 6e-3: its outputs' rows have variances near 1e-6."""
    out = jax.tree.map(np.copy, variables)
    for leaf in ("kernel", "bias"):
        out["params"]["offset_fc"][leaf] = out["params"]["offset_fc"][leaf] * np.float32(6e-3)
    return out


def _jax_reference():
    """In one compile: a PG-v1m1 (small SpUNet) training step (outputs, losses, gradients, new batch
    statistics), its eval shifts at low offset_fc variance, and a PG-v1m2 (small PTv3) eval forward."""
    batch = _pg_batch()
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    sp_model, pt_model = jax_build_model(PG_SPUNET), jax_build_model(PG_PTV3)
    shapes = jax.eval_shape(lambda: sp_model.init({"params": jax.random.PRNGKey(0)}, _jax_point(dev), dev))
    sp_vars = jax_variables_like(shapes, np.random.default_rng(15))
    low = _low_variance(sp_vars)
    pt_vars = jax_variables_for(build_model(PG_PTV3), np.random.default_rng(16))

    def loss_fn(params, batch_stats, b):
        out, mutated = sp_model.apply({"params": params, "batch_stats": batch_stats}, _jax_point(b), b, train=True,
                                      mutable=["batch_stats"])
        return out["loss"], (mutated["batch_stats"], out)

    def run(sp, low, pt, b):
        step = jax.value_and_grad(loss_fn, has_aux=True)(sp["params"], sp["batch_stats"], b)
        return (step, sp_model.apply(low, _jax_point(b), b, train=False)["bias_pred"],
                pt_model.apply(pt, _jax_point(b), b, train=False))

    args = (sp_vars, low, pt_vars, dev)
    ((loss, (stats, out)), grads), low_bias, pt_out = jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args)
    return dict(sp_vars=sp_vars, low=low, pt_vars=pt_vars, loss=float(loss), out=jax.tree.map(np.asarray, out),
                grads=jax.tree.map(np.array, grads), stats=jax.tree.map(np.array, stats),
                low_bias=np.asarray(low_bias), pt_out=jax.tree.map(np.asarray, pt_out))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


def _port_model(cfg, variables):
    model = build_model(dict(cfg))
    model.load_state_dict(convert_variables(variables), strict=True)
    return model


def _close(got, ref, rel=1e-4, rows=None):
    got, ref = got.detach().float().numpy(), np.asarray(ref, np.float32)
    if rows is not None:
        got, ref = got[rows], ref[rows]
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def test_point_group_training_step_matches_jax(reference):
    model = _port_model(PG_SPUNET, reference["sp_vars"]).train()
    assert model.offset_norm.eps == 1e-6 and model.offset_norm.fast_variance
    point, batch = _port_point(_pg_batch())
    out = model(point, batch)
    v = point.valid.numpy()
    ref = reference["out"]
    _close(out["seg_logits"], ref["seg_logits"], rows=v)
    _close(out["bias_pred"], ref["bias_pred"], rows=v)
    for key in ("loss", "loss_seg", "loss_bias", "loss_dir"):
        assert out[key].dtype == torch.float32 and out[key].dim() == 0
        np.testing.assert_allclose(out[key].item(), float(ref[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(out["loss"].item(), reference["loss"], rtol=1e-5)
    out["loss"].backward()
    grads = convert_variables({"params": reference["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params) and "offset_norm.weight" in grads
    for name, g in grads.items():
        tol = 2e-5 * max(1.0, g.abs().max().item())
        torch.testing.assert_close(params[name].grad, g, rtol=0, atol=tol, msg=lambda m, name=name: f"{name}: {m}")
    stats = convert_variables({"batch_stats": reference["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, s in stats.items():
        torch.testing.assert_close(buffers[name], s, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def test_offset_norm_takes_flax_epsilon(reference):
    """Rows of offset_fc output with variances near 1e-6: the port's shifts are JAX's, and PTv3's eps 1e-5
    in offset_norm would move them far past the tolerance."""
    model = _port_model(PG_SPUNET, reference["low"]).eval()
    point, batch = _port_point(_pg_batch())
    v = point.valid.numpy()
    with torch.no_grad():
        x = model.offset_fc(model.backbone(point)).float()
        var = x[torch.from_numpy(v)].var(-1, unbiased=False)
        assert 1e-7 < var.median().item() < 1e-5
        _close(model(point, batch)["bias_pred"], reference["low_bias"], rows=v)
        model.offset_norm.eps = 1e-5
        err = np.abs(model(point, batch)["bias_pred"].numpy()[v] - reference["low_bias"][v]).max()
    assert err > 100 * 1e-4 * max(1.0, float(np.abs(reference["low_bias"][v]).max()))


def test_point_group_ptv3_forward_matches_jax(reference):
    model = _port_model(PG_PTV3, reference["pt_vars"]).eval()
    point, batch = _port_point(_pg_batch())
    v = point.valid.numpy()
    with torch.no_grad():
        out = model(point, batch)
    ref = reference["pt_out"]
    _close(out["seg_logits"], ref["seg_logits"], rows=v)
    _close(out["bias_pred"], ref["bias_pred"], rows=v)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), rtol=1e-5)
