"""PyTorch port's ops against the JAX package on the CPU.

Integer outputs (codes, orders, inverses, pooling maps, kernel maps, cell
structures) must match exactly; float outputs within f32 rounding (1e-5).
The scenes hold two samples of a few hundred slots with pads.  JAX computes
the scene's references (the serialization, the pooling maps, the voxel
indices, the kernel maps, the cell structure and the cell-packed conv) as
one jitted function, in a thread started by the file's first test, with
XLA's cheaper CPU passes: called op by op, each of its ops would compile on
its own.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import FAST_COMPILE, slotted_scene

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
CAP = 48  # slotted_unique's capacity: below the ~60 parent cells per sample, so the overflow drop is exercised
SU_FIELDS = ("parent_row", "head_row", "out_valid", "counts", "num_unique")
PARENT_FIELDS = ("cell_kmap", "cell_table", "cell_of", "parity")


def _scene():
    return slotted_scene(np.random.default_rng(0), SAMPLES, SLOT, n_valid=150, span=9)


def _conv_case():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(SAMPLES * SLOT, 4)).astype(np.float32)
    w = (0.1 * rng.normal(size=(125, 4, 8))).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    return feat, w, b


def _jax_reference(scene, perm):
    """The scene's JAX references, one jitted function: with ``perm`` (the port's z order, which the JAX
    model would reuse) and without it where the op takes one."""
    import jax

    n = SAMPLES * SLOT
    feat, w, bias = _conv_case()

    def run(grid, batch, valid, coord, perm, feat, w, bias):
        out = {}
        pb = JaxPointBatch(coord=coord, feat=jnp.zeros((n, 1), jnp.float32), grid_coord=grid, valid=valid,
                           num_samples=SAMPLES).serialize(tuple(ORDERS))
        out["order"], out["inverse"] = pb.serialized_order, pb.serialized_inverse
        parent = grid >> 1
        pcode = j_code_or_batch(jser.z_order_encode(parent, 16), batch, 16)
        for reuse, p in ((False, None), (True, perm)):
            su = j_slotted_unique(pcode, valid, batch, SAMPLES, CAP, precomputed_perm=p)
            out[f"unique_{reuse}"] = {field: getattr(su, field) for field in SU_FIELDS}
            index = jsparse.build_voxel_index(grid, batch, valid, 16, precomputed_perm=p)
            out[f"index_{reuse}"] = (index.perm, index.sorted_code)
        for kernel in (3, 5):
            out[f"kmap_{kernel}"] = jsparse.build_kernel_map(index, grid, batch, valid,
                                                             jsparse.SparseConvSpec.cube(kernel), 16).neighbor_idx
        cells = jsparse.build_parent_index(grid, batch, valid, 1, 16, precomputed_perm=perm)
        out["parent"] = {field: getattr(cells, field) for field in PARENT_FIELDS}
        out["cell_packed"] = jsparse.cell_packed_conv(feat, cells, valid, w, jsparse.SparseConvSpec.cube(5), bias)
        return out

    args = [jnp.asarray(a) for a in (scene["grid_coord"], scene["batch"], scene["valid"], scene["coord"],
                                     perm.numpy(), feat, w, bias)]
    out = jax.jit(run).lower(*args).compile(FAST_COMPILE)(*args)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    scene = _scene()
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference, scene, _z_order(scene))


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


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


def test_serialize_order_and_inverse_match_jax(scene, reference):
    n = SAMPLES * SLOT
    kw = dict(coord=scene["coord"], feat=np.zeros((n, 1), np.float32), grid_coord=scene["grid_coord"],
              valid=scene["valid"])
    got = PointBatch(**{k: _t(v) for k, v in kw.items()}, num_samples=SAMPLES).serialize(tuple(ORDERS))
    np.testing.assert_array_equal(got.serialized_order.numpy(), reference["order"])
    np.testing.assert_array_equal(got.serialized_inverse.numpy(), reference["inverse"])


def _z_order(scene):
    """The scene's batch-major z serialization order (the model's reused sort)."""
    n = SAMPLES * SLOT
    pb = PointBatch(coord=_t(scene["coord"]), feat=torch.zeros(n, 1), grid_coord=_t(scene["grid_coord"]),
                    valid=_t(scene["valid"]), num_samples=SAMPLES)
    return pb.serialize(("z",)).serialized_order[0]


@pytest.mark.parametrize("reuse", [False, True])
def test_slotted_unique_matches_jax(scene, reference, reuse):
    parent = scene["grid_coord"] >> 1
    batch, valid = scene["batch"], scene["valid"]
    perm = _z_order(scene) if reuse else None
    ref = reference[f"unique_{reuse}"]
    code = code_or_batch(tser.z_order_encode(_t(parent), 16), _t(batch), 16)
    got = slotted_unique(code, _t(valid), _t(batch), SAMPLES, CAP, precomputed_perm=perm)
    assert int(got.num_unique) == int(ref["num_unique"]) > SAMPLES * CAP
    for field in SU_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(got, field).numpy(), ref[field], err_msg=field)


def _port_index(scene, perm):
    return tsparse.build_voxel_index(_t(scene["grid_coord"]), _t(scene["batch"]), _t(scene["valid"]), 16,
                                     precomputed_perm=perm)


@pytest.mark.parametrize("reuse", [False, True])
def test_voxel_index_matches_jax(scene, reference, reuse):
    perm = _z_order(scene) if reuse else None
    ref_perm, ref_code = reference[f"index_{reuse}"]
    got = _port_index(scene, perm)
    np.testing.assert_array_equal(got.perm.numpy(), ref_perm)
    np.testing.assert_array_equal(_u64(got.sorted_code), code_to_u64(ref_code))


@pytest.mark.parametrize("kernel", [3, 5])
def test_kernel_map_matches_jax(scene, reference, kernel):
    perm = _z_order(scene)
    spec = tsparse.SparseConvSpec.cube(kernel)
    got = tsparse.build_kernel_map(_port_index(scene, perm), _t(scene["grid_coord"]), _t(scene["batch"]),
                                   _t(scene["valid"]), spec, 16)
    assert got.neighbor_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.neighbor_idx.numpy(), reference[f"kmap_{kernel}"])
    n = SAMPLES * SLOT
    assert (got.neighbor_idx.numpy()[~scene["valid"]] == n).all()  # the sentinel in every pad column
    assert (got.neighbor_idx.numpy()[scene["valid"]] < n).sum() > 2 * scene["valid"].sum()  # real neighbors


def _port_parent(scene):
    return tsparse.build_parent_index(_t(scene["grid_coord"]), _t(scene["batch"]), _t(scene["valid"]), 1, 16,
                                      precomputed_perm=_z_order(scene))


def test_parent_index_matches_jax(scene, reference):
    got = _port_parent(scene)
    for field in PARENT_FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(), reference["parent"][field], err_msg=field)


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


def test_cell_packed_conv_matches_jax(scene, reference):
    feat, w, b = _conv_case()
    spec = tsparse.SparseConvSpec.cube(5)
    got = tsparse.cell_packed_conv(_t(feat), _port_parent(scene), _t(scene["valid"]), _t(w), spec, _t(b))
    v = scene["valid"]
    np.testing.assert_allclose(got.numpy()[v], reference["cell_packed"][v], rtol=1e-5, atol=1e-5)


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
