"""The port's ST-v1m2, ``knn_bucketed`` and ``KeypointStratifiedTransformer`` against the JAX package on the CPU.

``knn_bucketed`` index for index against JAX's (jitted) on one search that
holds every case: 2 samples of points on a dyadic grid (so distances tie
exactly: ties go to the earlier candidate of the ring, not to the lower base
index) with pad rows; a cell cap of 3 at cells of ~5 points, where runs
overflow; a second sample of 6 valid points, whose queries find fewer than k
(the missing slots at ``sqdist`` >= 1e10 with the nearest candidate's
index); queries far outside the base's cells, whose ring leaves the code
domain.  The port rounds a distance as JAX does outside ``jit``; under
``jit`` XLA fuses two products into multiply-adds, so the distances are held
to 1e-6 relative, and exactly where they are found (on the grid every one is
exact).  Swin3D's ``KnnUpsample`` with a cell (its ``upsample_cell_sizes``:
``three_nn_interpolate`` with ``cell_size`` > 0), from the skip's points to
every 4th of them (a clear 3rd neighbour asserted), against JAX's in the same
function.

A small ST-v1m2 (4 input channels; widths 8 and 16, one Block in the first
stage and none in the second, whose pooling and decoder still run; heads 2,
patches of 8 rows in super-patches of 2, the KPConv stem at radius 0.2, the
relative position bias clipped at +-16 on a [0, 24)^3 grid; drop path 0)
under ``KeypointStratifiedTransformer`` (hidden 16) over 2 samples of 96
slots with 8 pad rows, one point per voxel at grid 0.05.  With the same
seeded weights (names from ``jax.eval_shape``, carried over by
``convert.py``): the backbone's features on the valid rows in eval and in
training mode, the eval prediction, and one training step (JAX's Dropout mask
read off its output): the prediction, the loss, ``mean_dist``, every gradient
and the running statistics after it.  JAX compiles it as one function, in a
thread started by the file's first test, with XLA's cheaper CPU passes.  The
stem's ``knn_bucketed`` runs under ``jit`` in JAX: the tests assert that every
query's 16th and 17th candidates lie clearly apart.

Tolerance: f32 within 1e-4 x max(1, max|jax|) per tensor, losses 1e-4
relative; running statistics 1e-6; the interpolation 1e-6 x max(1,
max|jax|); indices exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch_parity import (FAST_COMPILE, assert_clear_kth_neighbours, assert_close, check_backbone_forward,
                          check_training_step, jax_variables_like, keypoint_batch, keypoint_reference,
                          recorded_searches)

from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.models import build_model, stratified_transformer, swin3d
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch
from pointcept_keypointdetection_tpu_torch.ops.knn import knn_bucketed
from pointcept_keypointdetection_tpu_torch.utils.config import Config

SLOT, SAMPLES, PADS, SPAN = 96, 2, 8, 24
UP_CELL = 0.4  # the bucketed 3-NN's cell
BACKBONE = dict(type="ST-v1m2", in_channels=4, channels=(8, 16), depths=(1, 0), num_heads=(2, 2), patch_size=8,
                super_ratio=2, slot_divisors=(1, 2), drop_path_rate=0.0, kp_radius=0.2)
MODEL = dict(type="KeypointStratifiedTransformer", num_keypoints=6, hidden_dim=16, backbone_conf=BACKBONE)
TOL = 1e-4


def _batch():
    return keypoint_batch(1, SAMPLES, SLOT, PADS, SPAN)


KNN_K, KNN_CELL, KNN_CAP = 8, 0.25, 3


def _knn_case():
    """(query, base, query_batch, base_batch, base_valid): 2 samples of 300 base rows on a grid of eighths in
    [0, 1)^3, a tenth of the first's and all but 6 of the second's pads; queries at every base row and 40
    more of the first sample moved 5 away."""
    rng = np.random.default_rng(8)
    base = (rng.integers(0, 8, (600, 3)) * 0.125).astype(np.float32)
    batch = np.repeat(np.arange(2), 300).astype(np.int32)
    valid = rng.uniform(size=600) < 0.9
    valid[306:] = False
    query = np.concatenate([base, base[:40] + 5.0]).astype(np.float32)
    return query, base, np.concatenate([batch, batch[:40]]), batch, valid


def _upsample_case():
    """(pooled, skip) point dicts: the skip ``_batch()``'s points with 16 features, the bases every 4th row of
    each sample's with 32."""
    b = _batch()
    feat = np.random.default_rng(6).normal(size=(SAMPLES * SLOT, 32)).astype(np.float32)
    rows = np.arange(0, SAMPLES * SLOT, 4)
    skip = dict(coord=b["coord"], feat=feat[:, :16], grid_coord=b["grid_coord"], valid=b["valid"])
    pooled = dict(coord=b["coord"][rows], feat=feat[rows], grid_coord=b["grid_coord"][rows], valid=b["valid"][rows])
    return pooled, skip


def _jax_knn():
    """The search of ``_knn_case`` and ``KnnUpsample`` with a cell, in one compile."""
    import jax
    import jax.numpy as jnp

    from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
    from pointcept_keypointdetection_tpu.models.swin3d import KnnUpsample as JaxKnnUpsample
    from pointcept_keypointdetection_tpu.ops.knn import knn_bucketed as jax_knn_bucketed

    pooled, skip = (JaxPointBatch(num_samples=SAMPLES, **{k: jnp.asarray(v) for k, v in part.items()})
                    for part in _upsample_case())
    upsample = JaxKnnUpsample(16, knn_cell_size=UP_CELL)
    up_vars = jax_variables_like(jax.eval_shape(lambda: upsample.init(jax.random.PRNGKey(0), pooled, skip, False)),
                                 np.random.default_rng(19))

    def run(case, v):
        query, base, qb, bb, valid = case
        return (jax_knn_bucketed(query, base, KNN_K, KNN_CELL, qb, bb, valid, cell_cap=KNN_CAP),
                upsample.apply(v, pooled, skip, False).feat)

    args = (_knn_case(), up_vars)
    knn, up = jax.tree.map(np.asarray, jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args))
    return dict(knn=knn, upsample=dict(variables=up_vars, out=up))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: dict(keypoint_reference(MODEL, _batch(), "StratifiedTransformer", 60),
                                       searches=_jax_knn()))


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


@pytest.mark.parametrize("case", ["batched", "overflow", "misses", "ties"])
def test_knn_bucketed_matches_jax(reference, case):
    query, base, qb, bb, valid = _knn_case()
    idx, sqd = knn_bucketed(torch.from_numpy(query), torch.from_numpy(base), KNN_K, KNN_CELL, torch.from_numpy(qb),
                            torch.from_numpy(bb), torch.from_numpy(valid), cell_cap=KNN_CAP)
    ref_idx, ref_sqd = reference["searches"]["knn"]
    assert idx.dtype == torch.int32 and sqd.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(sqd.numpy(), ref_sqd, rtol=1e-6, atol=0)
    d, missing = sqd.numpy(), ref_sqd >= 1e10
    if case == "batched":  # queries of both samples find neighbours of their own sample only
        found = ~missing
        assert (bb[ref_idx[found]] == np.broadcast_to(qb[:, None], ref_idx.shape)[found]).all()
    if case == "overflow":  # some inspected cell holds more points of one sample than the cap
        cells = np.floor(base / KNN_CELL).astype(np.int64)[valid]
        _, counts = np.unique(np.concatenate([bb[valid, None], cells], 1), axis=0, return_counts=True)
        assert counts.max() > KNN_CAP
    if case == "misses":  # the far queries find nothing; a short sample's miss takes its nearest candidate
        assert missing[600:].all() and (~missing[:600]).any()
        rows = np.flatnonzero(missing.any(1) & ~missing.all(1))
        assert len(rows) and set(qb[rows]) == {1}
        np.testing.assert_array_equal(idx.numpy()[rows][missing[rows]], np.repeat(idx.numpy()[rows, 0],
                                                                                  missing[rows].sum(1)))
    if case == "ties":  # found distances are exact on the grid, and many tie
        np.testing.assert_array_equal(d[~missing], ref_sqd[~missing])
        assert (d[:, 1:] == d[:, :-1])[~missing[:, 1:]].sum() > 100


def test_knn_upsample_with_a_cell_matches_jax(reference):
    """Swin3D's ``upsample_cell_sizes``: ``KnnUpsample``'s 3-NN by ``knn_bucketed`` at the cell."""
    pooled, skip = (PointBatch(num_samples=SAMPLES, **{k: torch.from_numpy(v) for k, v in part.items()})
                    for part in _upsample_case())
    model = swin3d.KnnUpsample(32, 16, 16, UP_CELL)
    model.load_state_dict(convert_variables(reference["searches"]["upsample"]["variables"]))
    _, sqd = knn_bucketed(skip.coord, pooled.coord, 4, UP_CELL, skip.batch, pooled.batch, pooled.valid, cell_cap=64)
    assert bool((sqd[:, 3] - sqd[:, 2] > 1e-5 * sqd[:, 2]).all())  # the same three picks under jit's rounding
    with torch.no_grad():
        got = model(pooled, skip).feat
    assert_close(got, reference["searches"]["upsample"]["out"], "KnnUpsample with a cell", 1e-4)


def test_fork_config_builds():
    cfg = Config.fromfile("configs/my_dataset/keypoint_stratified_transformer.py")
    model = build_model(dict(cfg.model))
    assert model.head[0].in_features == model.backbone.out_channels == 48
    assert isinstance(model.backbone.stem, stratified_transformer.KPConvStem)
    assert model.backbone.stem.weight.shape == (15, 4, 48)
    assert model.backbone.stage_cap(8192, 3) == 1024
    assert tuple(model.backbone.stage2_block0.attn.rpe_table.shape) == (99, 12)
    with pytest.raises(NotImplementedError, match="subm"):
        build_model(dict(cfg.model.backbone_conf, stem="subm"))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_stratified_forward_matches_jax(reference, monkeypatch, train):
    calls = recorded_searches(monkeypatch, stratified_transformer)
    check_backbone_forward(MODEL, reference, _batch(), train, TOL)
    assert [(fn.__name__, a[2], a[3]) for fn, a, _ in calls] == [("knn_bucketed", 16, 0.2)]
    assert_clear_kth_neighbours(calls)


def test_keypoint_stratified_training_step_matches_jax(reference):
    check_training_step(MODEL, reference, _batch(), TOL)
