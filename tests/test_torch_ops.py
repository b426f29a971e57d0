"""PyTorch port's ops against the JAX package on the CPU.

Integer outputs (codes, orders, inverses, pooling maps, kernel maps, cell
structures) must match exactly; float outputs within f32 rounding (1e-5).
The scenes hold two samples of a few hundred slots with pads.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import slotted_scene

from pointcept_keypointdetection_tpu.models.structure import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.ops import segment as jseg
from pointcept_keypointdetection_tpu.ops import serialization as jser
from pointcept_keypointdetection_tpu.ops import sparse as jsparse
from pointcept_keypointdetection_tpu.ops.codes import code_or_batch as j_code_or_batch
from pointcept_keypointdetection_tpu.ops.codes import code_to_u64
from pointcept_keypointdetection_tpu.ops.voxelize import slotted_unique as j_slotted_unique
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch
from pointcept_keypointdetection_tpu_torch.ops import segment as tseg
from pointcept_keypointdetection_tpu_torch.ops import serialization as tser
from pointcept_keypointdetection_tpu_torch.ops import sparse as tsparse
from pointcept_keypointdetection_tpu_torch.ops.codes import CODE_MAX, code_or_batch
from pointcept_keypointdetection_tpu_torch.ops.voxelize import slotted_unique

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ORDERS = ["z", "z-trans", "hilbert", "hilbert-trans"]
SLOT, SAMPLES = 192, 2


@pytest.fixture(scope="module")
def scene():
    return slotted_scene(np.random.default_rng(0), SAMPLES, SLOT, n_valid=150, span=9)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _u64(code: torch.Tensor) -> np.ndarray:
    """Port int64 codes as the JAX package's uint64, CODE_MAX -> all ones."""
    c = code.numpy().view(np.uint64).copy()
    c[code.numpy() == CODE_MAX] = np.iinfo(np.uint64).max
    return c


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("order", ORDERS)
def test_codes_match_goldens_and_jax(depth, order):
    data = np.load(os.path.join(GOLDEN, f"serialization_d{depth}.npz"))
    code = tser.encode(_t(data["coords"]), _t(data["batch"]), depth=depth, order=order)
    np.testing.assert_array_equal(code.numpy().view(np.uint64), data[f"code_{order}"])

    rng = np.random.default_rng(depth)
    grid = rng.integers(0, 1 << depth, size=(300, 3)).astype(np.int32)
    batch = rng.integers(0, 4, size=300).astype(np.int32)
    ref = code_to_u64(jser.encode(jnp.asarray(grid), jnp.asarray(batch), depth=depth, order=order))
    got = tser.encode(_t(grid), _t(batch), depth=depth, order=order)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ref)


def test_serialize_order_and_inverse_match_jax(scene):
    n = SAMPLES * SLOT
    kw = dict(coord=scene["coord"], feat=np.zeros((n, 1), np.float32), grid_coord=scene["grid_coord"],
              valid=scene["valid"])
    ref = JaxPointBatch(**{k: jnp.asarray(v) for k, v in kw.items()}, num_samples=SAMPLES).serialize(tuple(ORDERS))
    got = PointBatch(**{k: _t(v) for k, v in kw.items()}, num_samples=SAMPLES).serialize(tuple(ORDERS))
    np.testing.assert_array_equal(got.serialized_order.numpy(), np.asarray(ref.serialized_order))
    np.testing.assert_array_equal(got.serialized_inverse.numpy(), np.asarray(ref.serialized_inverse))


def _z_order(scene):
    """The scene's batch-major z serialization order (the model's reused sort)."""
    n = SAMPLES * SLOT
    pb = PointBatch(coord=_t(scene["coord"]), feat=torch.zeros(n, 1), grid_coord=_t(scene["grid_coord"]),
                    valid=_t(scene["valid"]), num_samples=SAMPLES)
    return pb.serialize(("z",)).serialized_order[0]


@pytest.mark.parametrize("reuse", [False, True])
def test_slotted_unique_matches_jax(scene, reuse):
    parent = scene["grid_coord"] >> 1
    batch, valid = scene["batch"], scene["valid"]
    perm = _z_order(scene) if reuse else None
    cap = 48  # below the ~60 parent cells per sample: the overflow drop is exercised
    jcode = j_code_or_batch(jser.z_order_encode(jnp.asarray(parent), 16), jnp.asarray(batch), 16)
    ref = j_slotted_unique(jcode, jnp.asarray(valid), jnp.asarray(batch), SAMPLES, cap,
                           precomputed_perm=None if perm is None else jnp.asarray(perm.numpy()))
    code = code_or_batch(tser.z_order_encode(_t(parent), 16), _t(batch), 16)
    got = slotted_unique(code, _t(valid), _t(batch), SAMPLES, cap, precomputed_perm=perm)
    assert int(got.num_unique) == int(ref.num_unique) > SAMPLES * cap
    for field in ("parent_row", "head_row", "out_valid", "counts"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), err_msg=field)


def _jax_index(scene, perm):
    return jsparse.build_voxel_index(
        jnp.asarray(scene["grid_coord"]), jnp.asarray(scene["batch"]), jnp.asarray(scene["valid"]),
        16, precomputed_perm=None if perm is None else jnp.asarray(perm.numpy()),
    )


def _port_index(scene, perm):
    return tsparse.build_voxel_index(_t(scene["grid_coord"]), _t(scene["batch"]), _t(scene["valid"]), 16,
                                     precomputed_perm=perm)


@pytest.mark.parametrize("reuse", [False, True])
def test_voxel_index_matches_jax(scene, reuse):
    perm = _z_order(scene) if reuse else None
    ref, got = _jax_index(scene, perm), _port_index(scene, perm)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_array_equal(_u64(got.sorted_code), code_to_u64(ref.sorted_code))


@pytest.mark.parametrize("kernel", [3, 5])
def test_kernel_map_matches_jax(scene, kernel):
    perm = _z_order(scene)
    spec = tsparse.SparseConvSpec.cube(kernel)
    ref = jsparse.build_kernel_map(
        _jax_index(scene, perm), jnp.asarray(scene["grid_coord"]), jnp.asarray(scene["batch"]),
        jnp.asarray(scene["valid"]), jsparse.SparseConvSpec.cube(kernel), 16,
    )
    got = tsparse.build_kernel_map(_port_index(scene, perm), _t(scene["grid_coord"]), _t(scene["batch"]),
                                   _t(scene["valid"]), spec, 16)
    assert got.neighbor_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.neighbor_idx.numpy(), np.asarray(ref.neighbor_idx))
    n = SAMPLES * SLOT
    assert (got.neighbor_idx.numpy()[~scene["valid"]] == n).all()  # the sentinel in every pad column
    assert (got.neighbor_idx.numpy()[scene["valid"]] < n).sum() > 2 * scene["valid"].sum()  # real neighbors


def _parent_pair(scene):
    perm = _z_order(scene)
    ref = jsparse.build_parent_index(
        jnp.asarray(scene["grid_coord"]), jnp.asarray(scene["batch"]), jnp.asarray(scene["valid"]), 1, 16,
        precomputed_perm=jnp.asarray(perm.numpy()),
    )
    got = tsparse.build_parent_index(_t(scene["grid_coord"]), _t(scene["batch"]), _t(scene["valid"]), 1, 16,
                                     precomputed_perm=perm)
    return ref, got


def test_parent_index_matches_jax(scene):
    ref, got = _parent_pair(scene)
    for field in ("cell_kmap", "cell_table", "cell_of", "parity"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), err_msg=field)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_segment_reductions_match_jax(reduce):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(300, 5)).astype(np.float32) - 3.0  # all negative: an empty max must give 0
    ids = rng.integers(0, 40, size=300)
    ids[rng.random(300) < 0.2] = 50  # the drop sentinel (= num_segments)
    ids[ids == 7] = 8  # segment 7 stays empty
    ref = jseg.segment_reduce(jnp.asarray(data), jnp.asarray(ids.astype(np.int32)), 50, reduce)
    got = tseg.segment_reduce(_t(data), _t(ids), 50, reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert (got[7] == 0).all()


def test_cell_packed_conv_matches_jax(scene):
    ref_parent, parent = _parent_pair(scene)
    rng = np.random.default_rng(2)
    n = SAMPLES * SLOT
    feat = rng.normal(size=(n, 4)).astype(np.float32)
    w = (0.1 * rng.normal(size=(125, 4, 8))).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    spec = tsparse.SparseConvSpec.cube(5)
    ref = jsparse.cell_packed_conv(jnp.asarray(feat), ref_parent, jnp.asarray(scene["valid"]), jnp.asarray(w),
                                   jsparse.SparseConvSpec.cube(5), jnp.asarray(b))
    got = tsparse.cell_packed_conv(_t(feat), parent, _t(scene["valid"]), _t(w), spec, _t(b))
    v = scene["valid"]
    np.testing.assert_allclose(got.numpy()[v], np.asarray(ref)[v], rtol=1e-5, atol=1e-5)


def test_sparse_conv_matches_jax(scene):
    """The plain CPU path of sparse_conv, over a real k=3 map."""
    rng = np.random.default_rng(3)
    n = SAMPLES * SLOT
    kmap = tsparse.build_kernel_map(_port_index(scene, None), _t(scene["grid_coord"]), _t(scene["batch"]),
                                    _t(scene["valid"]), tsparse.SparseConvSpec.cube(3), 16)
    feat = rng.normal(size=(n, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(27, 16, 24))).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    ref = jsparse.sparse_conv(jnp.asarray(feat), jsparse.KernelMap(jnp.asarray(kmap.neighbor_idx.numpy())),
                              jnp.asarray(w), jnp.asarray(b))
    got = tsparse.sparse_conv(_t(feat), kmap, _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
