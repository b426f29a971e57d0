"""The port's PT-v3plus against the JAX package on the CPU.

``derive_kernel_map`` (the K = 125 stage-0 map read off the k=5 stem's coarse
cells) integer-equal to JAX's on the same parent cells, and to the port's
own direct ``build_kernel_map`` of ``cube(5)``; a small PT-v3plus
(``cpe_kernel_size=5``, ``cpe_bottleneck=16``, two stages, one serialization
order, patch 32, 2
samples of 128 slots with pads, ``drop_path`` 0, ``shuffle_orders`` False) in
training mode with the same seeded weights: its features, the gradient of
a seeded weighted sum of them with respect to every parameter (by
``convert.py`` name) and to the input features, and the running
statistics.  JAX compiles its value-and-grad once, in a thread started by
the file's first test, with XLA's cheaper CPU passes.

Tolerances, as ``tests/test_torch_train.py``'s: features 5e-5 x max(1,
max|jax|) (f32 sums in other orders through three Blocks); gradients 2e-5 x
max(1, max|g|) per tensor; running statistics 1e-6.  Kernel maps exact.  The
pooling projection's bias feeds a training-mode BatchNorm, which takes any
shift of its input out, so its gradient is 0 up to rounding on both sides
(1e-5 here, beside gradients of 100): each side's is held within 2e-5 x the
largest gradient of that norm's bias, the size of the terms that cancel.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_variables_for, slotted_scene

from pointcept_keypointdetection_tpu.models import PointBatch as JaxPointBatch
from pointcept_keypointdetection_tpu.models import build_model as jax_build_model
from pointcept_keypointdetection_tpu.ops import sparse as jax_sparse
from pointcept_keypointdetection_tpu_torch.convert import convert_variables
from pointcept_keypointdetection_tpu_torch.models import build_model
from pointcept_keypointdetection_tpu_torch.models.structure import PointBatch
from pointcept_keypointdetection_tpu_torch.ops import sparse

SLOT, SAMPLES = 128, 2
BACKBONE = dict(
    type="PT-v3plus", in_channels=4, order=("z",), stride=(2,), enc_depths=(1, 1), enc_channels=(16, 24),
    enc_num_head=(1, 2),
    enc_patch_size=(32, 32), dec_depths=(1,), dec_channels=(16,), dec_num_head=(1,), dec_patch_size=(32,),
    slot_divisors=(1, 2), drop_path=0.0, shuffle_orders=False, cpe_kernel_size=5, cpe_bottleneck=16,
)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _batch(seed):
    rng = np.random.default_rng(seed)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=100, span=8)
    n = SAMPLES * SLOT
    return dict(coord=scene["coord"], feat=rng.normal(size=(n, 4)).astype(np.float32),
                grid_coord=scene["grid_coord"], valid=scene["valid"],
                weight=rng.normal(size=(n, 16)).astype(np.float32))


def _jax_point(b, feat=None):
    return JaxPointBatch(coord=b["coord"], feat=b["feat"] if feat is None else feat, grid_coord=b["grid_coord"],
                         valid=b["valid"], num_samples=SAMPLES)


def _port_wrapper():
    """The backbone under ``backbone``: the names ``jax_variables_for`` and ``convert.py`` map."""
    return torch.nn.ModuleDict({"backbone": build_model(dict(BACKBONE))})


def _jax_reference():
    """Features, the gradients of sum(features * weight) and the new batch statistics, in one compile."""
    model = jax_build_model(dict(BACKBONE))
    variables = jax_variables_for(_port_wrapper(), np.random.default_rng(0))
    inner = {col: tree["PointTransformerV3_0"] for col, tree in variables.items()}
    b = {k: jnp.asarray(v) for k, v in _batch(1).items()}

    def loss_fn(params, feat, batch_stats):
        out, mutated = model.apply({"params": params, "batch_stats": batch_stats}, _jax_point(b, feat), train=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return jnp.sum(out * b["weight"]), (out, mutated["batch_stats"])

    args = (inner["params"], b["feat"], inner["batch_stats"])
    (_, (out, stats)), (grads, dfeat) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)).lower(
        *args).compile(FAST_COMPILE)(*args)
    wrap = lambda tree: {"PointTransformerV3_0": jax.tree.map(np.array, tree)}  # noqa: E731
    return dict(variables=variables, out=np.asarray(out), grads=wrap(grads), dfeat=np.asarray(dfeat),
                stats=wrap(stats))


@pytest.fixture(scope="module", autouse=True)
def reference_future():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def reference(reference_future):
    return reference_future.result()


@pytest.mark.parametrize("seed,span,shift", [(3, 8, 1), (4, 5, 1), (5, 12, 2)])
def test_derive_kernel_map_matches_jax(seed, span, shift):
    """Two slots with pads at their ends; a dense block (span 5) and a sparse one; cells of side 2 and 4."""
    rng = np.random.default_rng(seed)
    scene = slotted_scene(rng, SAMPLES, SLOT, n_valid=100, span=span)
    grid, valid, batch = scene["grid_coord"], scene["valid"], scene["batch"].astype(np.int32)
    spec = sparse.SparseConvSpec.cube(5)

    def derive(g, b, v):  # jitted: one compile, where eager dispatch compiles every op on its own
        return jax_sparse.derive_kernel_map(jax_sparse.build_parent_index(g, b, v, shift), v,
                                            jax_sparse.SparseConvSpec.cube(5)).neighbor_idx

    args = tuple(map(jnp.asarray, (grid, batch, valid)))
    ref_idx = jax.jit(derive).lower(*args).compile(FAST_COMPILE)(*args)
    grid_t, valid_t, batch_t = torch.from_numpy(grid), torch.from_numpy(valid), torch.from_numpy(batch).long()
    got = sparse.derive_kernel_map(sparse.build_parent_index(grid_t, batch_t, valid_t, shift), valid_t, spec)
    assert got.neighbor_idx.dtype == torch.int32 and got.neighbor_idx.shape == (SAMPLES * SLOT, 125)
    np.testing.assert_array_equal(got.neighbor_idx.numpy(), np.asarray(ref_idx))
    direct = sparse.build_kernel_map(sparse.build_voxel_index(grid_t, batch_t, valid_t), grid_t, batch_t, valid_t,
                                     spec)
    assert torch.equal(got.neighbor_idx, direct.neighbor_idx)
    outer = [i for i, d in enumerate(spec.offsets) if max(map(abs, d)) == 2]
    assert bool((got.neighbor_idx[:, outer] < SAMPLES * SLOT).any())  # neighbours beyond the k=3 cube


def test_ptv3plus_forward_and_gradients_match_jax(reference):
    model = _port_wrapper()
    model.load_state_dict(convert_variables(reference["variables"]))
    model.train()
    b = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    feat = b["feat"].clone().requires_grad_()
    point = PointBatch(coord=b["coord"], feat=feat, grid_coord=b["grid_coord"], valid=b["valid"],
                       num_samples=SAMPLES)
    out = model["backbone"](point)
    ref = reference["out"]
    torch.testing.assert_close(out.detach(), torch.tensor(ref), rtol=0,
                               atol=5e-5 * max(1.0, float(np.abs(ref).max())))
    (out * b["weight"]).sum().backward()

    grads = convert_variables({"params": reference["grads"]})
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    assert params["backbone.enc0_block0.cpe.weight"].shape == (125, 16, 16)
    assert params["backbone.enc1_block0.cpe.down.weight"].shape == (16, 24)
    for name, ref_g in grads.items():
        if name.endswith("_down.proj.bias"):  # 0 up to rounding (the docstring)
            scale = grads[name.replace("proj.bias", "norm.bias")].abs().max().item()
            for side in (params[name].grad, ref_g):
                assert side.abs().max().item() <= 2e-5 * scale, name
            continue
        tol = 2e-5 * max(1.0, ref_g.abs().max().item())
        torch.testing.assert_close(params[name].grad, ref_g, rtol=0, atol=tol, msg=lambda m, name=name: f"{name}: {m}")
    dfeat = reference["dfeat"]
    torch.testing.assert_close(feat.grad, torch.tensor(dfeat), rtol=0,
                               atol=2e-5 * max(1.0, float(np.abs(dfeat).max())))

    stats = convert_variables({"batch_stats": reference["stats"]})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, ref_s in stats.items():
        torch.testing.assert_close(buffers[name], ref_s, rtol=0, atol=1e-6, msg=lambda m, name=name: f"{name}: {m}")


def test_ptv3plus_builds_its_maps_from_the_stem_cells(monkeypatch):
    """Stage 0's K = 125 map comes from the stem's parent cells (one direct join fewer); the pooled
    stage joins its own k=5 map; the decoder reuses stage 0's."""
    from pointcept_keypointdetection_tpu_torch.models import point_transformer_v3 as ptv3

    calls = []
    for name in ("derive_kernel_map", "build_kernel_map"):
        real = getattr(ptv3, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            kmap = _real(*args, **kwargs)
            calls.append((_name, tuple(kmap.neighbor_idx.shape)))
            return kmap

        monkeypatch.setattr(ptv3, name, spy)
    model = build_model(dict(BACKBONE)).eval()
    b = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    with torch.no_grad():
        model(PointBatch(coord=b["coord"], feat=b["feat"], grid_coord=b["grid_coord"], valid=b["valid"],
                         num_samples=SAMPLES))
    assert calls == [("derive_kernel_map", (256, 125)), ("build_kernel_map", (128, 125))]
    with pytest.raises(ValueError, match="cpe_kernel_size"):
        build_model(dict(BACKBONE, cpe_kernel_size=4))
    with pytest.raises(NotImplementedError, match="kmap_mode"):
        build_model(dict(BACKBONE, kmap_mode="chain"))
