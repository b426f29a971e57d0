"""The kernels' plain versions against the Pallas kernels (interpret mode), and
the wrappers' CPU dispatch and argument checks.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.  Tolerances: 2e-4 for attention on
valid rows (as ``tests/test_pallas_attention.py``), 1e-5 for the conv (f32
sums in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one torch thread)

from pointcept_keypointdetection_tpu.ops.pallas.sparse_conv import fused_subm_conv
from pointcept_keypointdetection_tpu_torch.kernels import patch_attention as pa
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc


def _pallas_attention(qkv, valid, patch, scale):
    from jax.experimental import pallas as pl

    import pointcept_keypointdetection_tpu.ops.pallas.patch_attention as m

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(m._pallas_forward(jnp.asarray(qkv), jnp.asarray(valid), patch, scale))
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
    before = (pa.launches, sc.launches)

    out = pa.patch_attention(q, v, 32, 0.25)
    assert out.dtype == dtype and out.shape == (128, 32)
    torch.testing.assert_close(out, pa.patch_attention_plain(q, v, 32, 0.25), rtol=0, atol=0)
    conv = sc.subm_conv(feat, idx, w)
    assert conv.dtype == dtype and conv.shape == (64, 4)
    torch.testing.assert_close(conv, sc.subm_conv_plain(feat, idx, w), rtol=0, atol=0)
    assert (pa.launches, sc.launches) == before  # the counters count kernel launches only
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
