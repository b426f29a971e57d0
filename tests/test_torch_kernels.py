"""The kernels' plain versions against the Pallas kernels (interpret mode),
the autograd Functions against autograd of the plain forwards, and the
wrappers' CPU dispatch and argument checks.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.  Tolerances: 2e-4 for attention
forward and backward on valid rows (as ``tests/test_pallas_attention.py``),
1e-5 for the conv forward, 1e-5 x max(1, max|dW|) for the conv's dW (f32
sums over 300 rows in another order), 1e-5 for the Functions' gradients.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one torch thread)

from pointcept_keypointdetection_tpu.ops.pallas.sparse_conv import fused_subm_conv, fused_subm_conv_dw
from pointcept_keypointdetection_tpu_torch.kernels import patch_attention as pa
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc
from pointcept_keypointdetection_tpu_torch.ops import sparse as sp


def _pallas_attention(qkv, valid, patch, scale, grad=None):
    """``_pallas_forward``, or with ``grad`` ``_pallas_backward``, in interpret mode."""
    from jax.experimental import pallas as pl

    import pointcept_keypointdetection_tpu.ops.pallas.patch_attention as m

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        if grad is None:
            return np.asarray(m._pallas_forward(jnp.asarray(qkv), jnp.asarray(valid), patch, scale))
        return np.asarray(m._pallas_backward(jnp.asarray(qkv), jnp.asarray(valid), jnp.asarray(grad), patch, scale))
    finally:
        pl.pallas_call = orig


def _attention_case(patch, heads, seed):
    rng = np.random.default_rng(seed)
    n = patch * 4
    qkv = rng.normal(size=(n, 3, heads, 16)).astype(np.float32)
    valid = rng.random(n) > 0.2
    valid[patch : 2 * patch] = False  # one patch with no valid key
    return qkv, valid


@pytest.mark.parametrize("patch,heads", [(16, 2), (128, 4)])
def test_plain_attention_matches_pallas(patch, heads):
    qkv, valid = _attention_case(patch, heads, seed=patch)
    scale = 16**-0.5
    ref = _pallas_attention(qkv, valid, patch, scale)
    got = pa.patch_attention_plain(torch.from_numpy(qkv), torch.from_numpy(valid), patch, scale).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-4, atol=2e-4)
    # the all-invalid patch: every query gets the mean of v, finite, in both
    v_mean = qkv[patch : 2 * patch, 2].mean(0).reshape(-1)
    for out in (got, ref):
        np.testing.assert_allclose(out[patch : 2 * patch], np.broadcast_to(v_mean, (patch, v_mean.size)),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("patch,heads", [(16, 2), (128, 4)])
def test_plain_attention_backward_matches_pallas(patch, heads):
    qkv, valid = _attention_case(patch, heads, seed=patch + 1)
    grad = np.random.default_rng(patch).normal(size=(qkv.shape[0], heads * 16)).astype(np.float32)
    scale = 16**-0.5
    ref = _pallas_attention(qkv, valid, patch, scale, grad)
    got = pa.patch_attention_backward_plain(torch.from_numpy(qkv), torch.from_numpy(valid), torch.from_numpy(grad),
                                            patch, scale).numpy()
    assert got.shape == ref.shape == qkv.shape
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-4, atol=2e-4)


def _conv_case(seed, n=300, k=27, cin=16, cout=24):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, cin)).astype(np.float32)
    idx = rng.integers(0, n + 1, size=(n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.5] = n  # the missing-neighbor sentinel
    return feat, idx, rng


def test_plain_conv_dw_matches_pallas():
    feat, idx, rng = _conv_case(2)
    grad = rng.normal(size=(feat.shape[0], 24)).astype(np.float32)
    ref = np.asarray(fused_subm_conv_dw(jnp.asarray(feat), jnp.asarray(idx), jnp.asarray(grad), interpret=True))
    got = sc.subm_conv_dw_plain(torch.from_numpy(feat), torch.from_numpy(idx), torch.from_numpy(grad)).numpy()
    assert got.shape == ref.shape == (27, 16, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_patch_attention_function_matches_autograd_of_plain():
    """Valid rows only: the Pallas-style backward does not gate dS by the mask, which
    changes only the rows of a patch without a valid key (pads)."""
    qkv, valid = _attention_case(32, 2, seed=3)
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(qkv.shape[0], 32)).astype(np.float32))
    v = torch.from_numpy(valid)
    grads = []
    for fn in (pa.PatchAttentionFunction.apply, pa.patch_attention_plain):
        x = torch.from_numpy(qkv).requires_grad_()
        (fn(x, v, 32, 0.25) * w).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0][v], grads[1][v], rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # no gradient recorded: the plain forward, no Function
        assert pa.attention(torch.from_numpy(qkv).requires_grad_(), v, 32, 0.25).grad_fn is None


def test_subm_conv_function_matches_scatter_add_gradient():
    """dfeat from the mirrored weight (a gather) equals autograd's scatter-add of the
    plain forward's gather, on a real two-slot port kernel map with pads."""
    from torch_parity import slotted_scene

    scene = slotted_scene(np.random.default_rng(4), 2, 96, n_valid=70, span=6)
    grid, valid = torch.from_numpy(scene["grid_coord"]), torch.from_numpy(scene["valid"])
    batch = torch.from_numpy(scene["batch"])
    index = sp.build_voxel_index(grid, batch, valid)
    idx = sp.build_kernel_map(index, grid, batch, valid, sp.SparseConvSpec.cube(3)).neighbor_idx
    assert (idx[~valid] == idx.shape[0]).all() and (idx[valid] < idx.shape[0]).any()
    rng = np.random.default_rng(5)
    feat0 = torch.from_numpy(rng.normal(size=(192, 8)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(27, 8, 12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(192, 12)).astype(np.float32))
    grads = []
    for fn in (sc.SubmConvFunction.apply, sc.subm_conv_plain):
        feat, w = feat0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(feat, idx, w) * g).sum().backward()
        grads.append((feat.grad, w.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_plain_conv_matches_pallas():
    rng = np.random.default_rng(0)
    n, k, cin, cout = 300, 27, 16, 24
    feat = rng.normal(size=(n, cin)).astype(np.float32)
    idx = rng.integers(0, n + 1, size=(n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.5] = n  # the missing-neighbor sentinel
    w = (0.1 * rng.normal(size=(k, cin, cout))).astype(np.float32)
    ref = np.asarray(fused_subm_conv(jnp.asarray(feat), jnp.asarray(idx), jnp.asarray(w), interpret=True))
    got = sc.subm_conv_plain(torch.from_numpy(feat), torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_run_plain_on_cpu(dtype):
    qkv, valid = _attention_case(32, 2, seed=1)
    q, v = torch.from_numpy(qkv).to(dtype), torch.from_numpy(valid)
    rng = np.random.default_rng(1)
    feat = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 65, size=(64, 27)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(27, 8, 4)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(128, 32)).astype(np.float32)).to(dtype)
    before = (pa.launches, pa.bwd_launches, sc.launches, sc.dw_launches)

    out = pa.patch_attention(q, v, 32, 0.25)
    assert out.dtype == dtype and out.shape == (128, 32)
    torch.testing.assert_close(out, pa.patch_attention_plain(q, v, 32, 0.25), rtol=0, atol=0)
    conv = sc.subm_conv(feat, idx, w)
    assert conv.dtype == dtype and conv.shape == (64, 4)
    torch.testing.assert_close(conv, sc.subm_conv_plain(feat, idx, w), rtol=0, atol=0)
    dqkv = pa.patch_attention_backward(q, v, None, None, g, 32, 0.25)
    assert dqkv.dtype == dtype and dqkv.shape == q.shape
    torch.testing.assert_close(dqkv, pa.patch_attention_backward_plain(q, v, g, 32, 0.25), rtol=0, atol=0)
    dw = sc.subm_conv_dw(feat, idx, conv)
    assert dw.dtype == torch.float32 and dw.shape == (27, 8, 4)
    torch.testing.assert_close(dw, sc.subm_conv_dw_plain(feat, idx, conv), rtol=0, atol=0)
    assert (pa.launches, pa.bwd_launches, sc.launches, sc.dw_launches) == before  # kernel launches only
    if dtype == torch.bfloat16:  # computed in f32, rounded once
        ref = pa.patch_attention_plain(q.float(), v, 32, 0.25)
        torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)


def test_conv_offset_splits_at_the_slice_shapes():
    """Few output tiles (deep stages) spread the 27 offsets over more blocks; many tiles keep one group."""
    shapes = [(8192, 32), (8192, 64), (4096, 64), (2048, 128), (1024, 256), (512, 512)]
    got = [sc.offset_splits(n, 27, c, sms=132) for n, c in shapes]
    assert got == [5, 5, 9, 9, 9, 9]
    assert sc.offset_splits(102400, 27, 64, sms=132) == 1
    for n, c in shapes:  # every group holds at least one offset
        splits = sc.offset_splits(n, 27, c, sms=132)
        assert (splits - 1) * -(-27 // splits) < 27


def test_conv_dw_row_splits_at_the_training_shapes():
    """The dW kernel's N rows split so that ~4 blocks run per SM, in whole chunks, none empty."""
    shapes = [(65536, 32), (65536, 64), (32768, 64), (16384, 128), (8192, 256), (4096, 512)]
    got = [sc.row_splits(n, 27, c, c, sms=132) for n, c in shapes]
    assert [s for s, _ in got] == [20, 20, 19, 5, 2, 1]
    for (n, _), (splits, rows) in zip(shapes, got):
        assert rows % sc.DW_CHUNK == 0 and (splits - 1) * rows < n <= splits * rows
    assert sc.row_splits(100, 27, 8, 8, sms=132) == (1, 256)


def test_wrappers_reject_what_the_kernels_do_not_take():
    qkv = torch.zeros(64, 3, 2, 16)
    valid = torch.ones(64, dtype=torch.bool)
    with pytest.raises(TypeError):
        pa.patch_attention(qkv.double(), valid, 32, 0.25)
    with pytest.raises(ValueError):
        pa.patch_attention(qkv, valid, 48, 0.25)  # 64 rows are not whole patches of 48
    with pytest.raises(ValueError):
        pa.patch_attention(qkv, valid.int(), 32, 0.25)
    feat, w = torch.zeros(64, 8), torch.zeros(27, 8, 4)
    idx = torch.zeros(64, 27, dtype=torch.int32)
    with pytest.raises(ValueError):
        sc.subm_conv(feat, idx.long(), w)
    with pytest.raises(ValueError):
        sc.subm_conv(feat, idx, w.bfloat16())
    with pytest.raises(ValueError):
        sc.subm_conv(feat, idx, torch.zeros(27, 4, 4))
    with pytest.raises(ValueError):
        sc.subm_conv_dw(feat, idx, torch.zeros(64, 4).bfloat16())  # grad of another dtype
    with pytest.raises(ValueError):
        pa.patch_attention_backward(qkv, valid, None, None, torch.zeros(64, 16), 32, 0.25)  # [N, H*D] is 32 wide
