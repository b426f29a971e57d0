"""The kernels' plain versions against the Pallas kernels (interpret mode),
the autograd Functions against autograd of the plain forwards, the sparse
conv's rulebook and a plain emulation of the conv kernels' traversal of it,
a plain emulation of the attention kernels' tile walk, and the wrappers'
CPU dispatch, split policies and argument checks.

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

from pointcept_keypointdetection_tpu.ops import sparse as jsparse
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


# The attention kernels' constants (csrc/patch_attention.cu): streamed tile rows, base-2 units.
_KT = 64
_LOG2E = np.float32(1.4426950408889634)
_MASKED2 = np.float32(-1e9) * _LOG2E
_ALL_MASKED = -5e8


def _tf32(x):
    """cvt.rna.tf32.f32: the mantissa rounded to 10 bits, ties away from zero."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mma(a, b, bf16):
    """a @ b as the tensor cores compute it: bf16 operands exactly (the kernels round them first),
    f32 ones as 3xTF32, small x big + big x small + big x big."""
    if bf16:
        return a @ b
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _split_bf16(x):
    """x as the kernels feed P and dS to bf16 tensor cores: a bf16 high part plus a bf16 low part."""
    high = x.bfloat16().float()
    return high + (x - high).bfloat16().float()


def _heads(x, patch):
    """[N, ..., H, D] -> [P, H, K, D]."""
    n, h, d = x.shape[0], x.shape[-2], x.shape[-1]
    return x.float().reshape(n // patch, patch, h, d).permute(0, 2, 1, 3)


def _attention_by_tiles(qkv, valid, patch, scale, bf16):
    """B1's walk in plain torch: the keys in tiles of 64 with an online softmax in base 2 (log2(e)
    folded into the scale, an invalid key at -1e9 * log2(e)), each tile's P V in fresh registers
    joined by acc * corr + tile; in bf16 P split into bf16 high and low parts.  A query's math does
    not depend on the 16-row warp slab, the 128-row block or the other patches its block walks, so
    all rows go at once.  Returns (out [N, H*D], lse [N, H])."""
    n, _, h, d = qkv.shape
    q, k, v = (_heads(qkv[:, i], patch) for i in range(3))
    key_valid = valid.reshape(-1, 1, 1, patch)
    scale2 = torch.tensor(scale, dtype=torch.float32) * _LOG2E
    m = torch.full(q.shape[:3], -torch.inf)
    l, acc = torch.zeros(q.shape[:3]), torch.zeros(q.shape)
    for k0 in range(0, patch, _KT):
        s = _mma(q, k[:, :, k0 : k0 + _KT].transpose(-1, -2), bf16) * scale2
        s = torch.where(key_valid[..., k0 : k0 + _KT], s, _MASKED2)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mma(_split_bf16(p) if bf16 else p, v[:, :, k0 : k0 + _KT], bf16)
        m = m_new
    out = (acc / l[..., None]).permute(0, 2, 1, 3).reshape(n, h * d)
    lse = ((m + torch.log2(l)) * np.float32(np.log(2))).permute(0, 2, 1).reshape(n, h)
    return out, lse


def _attention_backward_by_tiles(qkv, valid, out32, lse, grad, patch, scale, bf16):
    """B2's one-pass walk in plain torch.  delta = rowsum(dO * O) in four quarters, once per row;
    P = exp2(S2 - lse * log2(e)) with S2 the base-2 score (-1e9 * log2(e) on an invalid key); a row
    whose lse is below -5e8 (its patch has no valid key, every S2 = -1e9 * log2(e)) takes
    exp2(S2 + 1e9 * log2(e)) = 1 and has its gradients divided by K at the end, so P = 1/K.
    dk, dv: the queries in tiles of 64, each tile's dS^T Q and P^T dO in fresh registers; dq: each
    query's dS K over runs of 64 keys, each run in fresh registers (the same sums as the two-kernel
    shape's key tiles); in bf16 P and dS split into bf16 high and low parts.
    Returns dqkv [N, 3, H, D]."""
    n, _, h, d = qkv.shape
    q, k, v = (_heads(qkv[:, i], patch) for i in range(3))
    g, o = _heads(grad.reshape(n, h, d), patch), _heads(out32.reshape(n, h, d), patch)
    rnd = _split_bf16 if bf16 else (lambda x: x)
    quarters = (g * o).reshape(*g.shape[:-1], 4, 4).sum(-1)  # four threads a row, four columns each
    delta = (quarters[..., 0] + quarters[..., 1]) + (quarters[..., 2] + quarters[..., 3])  # [P, H, K]
    lse = lse.reshape(-1, patch, h).permute(0, 2, 1)  # [P, H, K]
    dead = lse < _ALL_MASKED
    nl2 = torch.where(dead, -_MASKED2, -lse * _LOG2E)
    inv = torch.where(dead, np.float32(1.0 / patch), np.float32(1.0))
    key_valid = valid.reshape(-1, 1, patch)
    scale2 = torch.tensor(scale, dtype=torch.float32) * _LOG2E

    dq = torch.zeros(q.shape)
    for k0 in range(0, patch, _KT):
        keys = slice(k0, k0 + _KT)
        s = torch.where(key_valid[..., None, keys], _mma(q, k[:, :, keys].transpose(-1, -2), bf16) * scale2, _MASKED2)
        p = torch.exp2(s + nl2[..., None])
        ds = p * (_mma(g, v[:, :, keys].transpose(-1, -2), bf16) - delta[..., None])
        dq = dq + _mma(rnd(ds), k[:, :, keys], bf16)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, patch, _KT):
        rows = slice(q0, q0 + _KT)
        st = torch.where(key_valid[..., :, None], _mma(k, q[:, :, rows].transpose(-1, -2), bf16) * scale2, _MASKED2)
        pt = torch.exp2(st + nl2[..., None, rows])  # [P, H, keys, queries]
        dst = pt * (_mma(v, g[:, :, rows].transpose(-1, -2), bf16) - delta[..., None, rows])
        dv = dv + _mma(rnd(pt), g[:, :, rows], bf16)
        dk = dk + _mma(rnd(dst), q[:, :, rows], bf16)
    patch_inv = inv[..., :1, None]  # a patch's rows are all dead or none
    dqkv = torch.stack([dq * scale * inv[..., None], dk * scale * patch_inv, dv * patch_inv])  # [3, P, H, K, D]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, 3, h, d)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("patch", [32, 128, 256])
def test_attention_tile_walk_matches_plain_and_pallas(patch, mode):
    """B1's and B2's traversal (64-row tiles, base-2 online softmax, 3xTF32 or bf16 operands, P and
    dS as bf16 high and low parts, delta once per row) against the plain versions on every row, an all-invalid
    patch included, and in f32 against the Pallas kernels (interpret mode) on valid rows, at 2e-4.
    Patch 32 is the r3 recipe's: one tile holds 32 keys, and the 32 rows past the patch count as
    missing keys (P = 0), not as -1e9 ones (B2 in one pass on the card, two of a block's eight warps
    busy).  Patch 128 is the trainer's (two 64-row tiles; B2 in one pass on the card); 256 streams four and
    takes B2's two-kernel shape on the card, whose sums the walk shares (dq per run of 64 keys, dk
    and dv per tile of 64 queries; delta there in halves, not quarters).  In
    bf16 the inputs are bf16 and the results, rounded to bf16 as the kernels round them, are held at
    chip_smoke.py's bf16 tolerance (5e-3 + 8e-3 |x|: one ulp) against the plain version."""
    bf16 = mode == "bf16"
    qkv, valid = _attention_case(patch, 2, seed=patch + 7)
    qkv = qkv[: 3 * patch]  # patches 0 and 2 with pads, patch 1 without a valid key
    valid = valid[: 3 * patch]
    grad = np.random.default_rng(patch).normal(size=(qkv.shape[0], 32)).astype(np.float32)
    q_t, v_t, g_t = torch.from_numpy(qkv), torch.from_numpy(valid), torch.from_numpy(grad)
    if bf16:
        q_t, g_t = q_t.bfloat16(), g_t.bfloat16()
    scale = 16**-0.5
    out, lse = _attention_by_tiles(q_t, v_t, patch, scale, bf16)
    dqkv = _attention_backward_by_tiles(q_t, v_t, out, lse, g_t, patch, scale, bf16)
    ref_out = pa.patch_attention_plain(q_t, v_t, patch, scale)
    ref_dqkv = pa.patch_attention_backward_plain(q_t, v_t, g_t, patch, scale)
    assert torch.isfinite(out).all() and torch.isfinite(dqkv).all()
    assert (lse[patch : 2 * patch] < _ALL_MASKED).all() and (lse[valid] > _ALL_MASKED).all()
    if bf16:
        for got, ref in ((out, ref_out), (dqkv, ref_dqkv)):
            torch.testing.assert_close(got.bfloat16().float(), ref.float(), rtol=8e-3, atol=5e-3)
        return
    torch.testing.assert_close(out, ref_out, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(dqkv, ref_dqkv, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy()[valid], _pallas_attention(qkv, valid, patch, scale)[valid],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dqkv.numpy()[valid], _pallas_attention(qkv, valid, patch, scale, grad)[valid],
                               rtol=2e-4, atol=2e-4)


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


# The trainer's kernel maps, one per level (batch 8): rows, valid rows (all hit their centre), hits, channels.
TRAINING_MAPS = [(65536, 65536, 554472, 32), (65536, 65536, 554472, 64), (32768, 26265, 331137, 64),
                 (16384, 7100, 95788, 128), (8192, 1771, 23813, 256), (4096, 414, 5374, 512)]


def test_conv_offset_splits_at_the_slice_shapes():
    """Few busy tiles (deep stages) spread the 27 offsets over more blocks; many keep one group.
    The split count follows the busy tiles, not N: enc4's 414 valid rows fill 7 of its 64 tiles."""
    busy = [-(-valid // sc.TILE) for _, valid, _, _ in TRAINING_MAPS]
    assert busy == [1024, 1024, 411, 111, 28, 7]
    got = [sc.offset_splits(b, 27, c, sms=132) for b, (_, _, _, c) in zip(busy, TRAINING_MAPS)]
    assert got == [1, 1, 2, 3, 5, 9]
    assert [sc.conv_tile_cols(c) for *_, c in TRAINING_MAPS] == [32, 64, 64, 64, 64, 64]
    assert sc.offset_splits(0, 27, 64, sms=132) == 1  # no busy tile: only the zero rows
    for b, (*_, c) in zip(busy, TRAINING_MAPS):  # every group holds at least one offset
        splits = sc.offset_splits(b, 27, c, sms=132)
        assert (splits - 1) * -(-27 // splits) < 27


def test_conv_dw_row_splits_at_the_training_shapes():
    """Each offset's hit pairs split so that ~4 blocks run per SM, with at least DW_MIN_HITS pairs in
    a run of the busiest offset; dW tiles are 32 wide at C = 32."""
    got = []
    for _, valid, hits, c in TRAINING_MAPS:
        per_offset = [valid] + [(hits - valid) // 26] * 26  # the centre hits every valid row
        got.append(sc.row_splits(per_offset, c, c, sms=132))
    assert got == [20, 20, 20, 5, 2, 1]
    assert [sc.dw_tile(c, c) for *_, c in TRAINING_MAPS] == [32, 64, 64, 64, 64, 64]
    assert sc.row_splits([300] + [20] * 26, 8, 8, sms=132) == 2  # capped by the hits: 300 pairs
    assert sc.row_splits([0] * 27, 8, 8, sms=132) == 1


@functools.cache
def _jax_kernel_map():
    """A kernel map built by the JAX package over three slots of 70 rows (N = 210, not a multiple of
    the 64-row tile), pads last in each slot: 50 voxels, one voxel, 40 voxels, all at even z, so the 18
    offsets with dz = +-1 hit no row.  Built once for the file's two tests."""
    rng = np.random.default_rng(7)
    slot, counts = 70, (50, 1, 40)
    grid = np.zeros((3 * slot, 3), np.int32)
    valid = np.zeros(3 * slot, bool)
    for b, nv in enumerate(counts):
        cells = rng.choice(6 * 6 * 3, nv, replace=False)
        g = np.stack(np.unravel_index(cells, (6, 6, 3)), 1)
        g[:, 2] *= 2
        grid[b * slot : b * slot + nv] = g
        valid[b * slot : b * slot + nv] = True
    batch = np.repeat(np.arange(3), slot).astype(np.int32)
    index = jsparse.build_voxel_index(jnp.asarray(grid), jnp.asarray(batch), jnp.asarray(valid), 16)
    kmap = jsparse.build_kernel_map(index, jnp.asarray(grid), jnp.asarray(batch), jnp.asarray(valid),
                                    jsparse.SparseConvSpec.cube(3), 16)
    return torch.from_numpy(np.asarray(kmap.neighbor_idx).astype(np.int32)), valid, slot


def test_rulebook_of_a_jax_kernel_map():
    idx, valid, slot = _jax_kernel_map()
    n, k = idx.shape
    before = sc.rulebook_builds
    rb = sc.build_rulebook(idx)
    assert sc.rulebook_builds == before + 1
    idx_np = idx.numpy()
    hit = idx_np < n
    # the pairs are exactly the map's hits, offset by offset
    starts = rb.pair_start.tolist()
    assert starts[0] == 0 and starts[-1] == rb.pair_in.numel() == hit.sum()
    assert list(rb.hits) == np.diff(starts).tolist() == hit.sum(0).tolist()
    got = {(int(o), d, int(i)) for d in range(k)
           for i, o in zip(rb.pair_in[starts[d] : starts[d + 1]], rb.pair_out[starts[d] : starts[d + 1]])}
    assert got == {(i, d, int(idx_np[i, d])) for i, d in zip(*np.nonzero(hit))}
    dz = np.asarray(sp.SparseConvSpec.cube(3).offsets)[:, 2]
    assert all((rb.hits[d] == 0) == (dz[d] != 0) for d in range(k))
    # the order: a permutation, rows with a hit first, rows of one hit mask together
    perm = rb.perm.numpy()
    assert rb.perm.dtype == torch.int32 and sorted(perm.tolist()) == list(range(n))
    mask = (hit.astype(np.int64) << np.arange(k)).sum(1)[perm]
    rows_hit = int((mask != 0).sum())
    assert rows_hit == valid.sum() and (mask[:rows_hit] != 0).all() and (mask[rows_hit:] == 0).all()
    change = np.flatnonzero(mask[1:] != mask[:-1]) + 1
    groups = np.split(mask, change)
    assert len({int(g[0]) for g in groups}) == len(groups)  # each mask in one run
    assert mask[perm.tolist().index(slot)] == 1 << 13  # the slot of one valid row: only its centre
    # offset-major neighbours, tiles and their masks
    tiles = -(-n // sc.TILE)
    assert rb.busy_tiles == -(-rows_hit // sc.TILE) and rb.nbr.shape == (k, tiles * sc.TILE)
    np.testing.assert_array_equal(rb.nbr.numpy()[:, :n], idx_np[perm].T)
    assert (rb.nbr.numpy()[:, n:] == n).all()
    padded = np.concatenate([mask, np.zeros(tiles * sc.TILE - n, np.int64)]).reshape(tiles, sc.TILE)
    np.testing.assert_array_equal(rb.tile_mask.numpy(), np.bitwise_or.reduce(padded, axis=1))
    assert (rb.tile_mask.numpy()[rb.busy_tiles :] == 0).all()  # an all-pad tile
    # a KernelMap builds its rulebook once; the CPU path of sparse_conv builds none
    kmap = sp.KernelMap(idx)
    assert kmap.rulebook() is kmap.rulebook() and sc.rulebook_builds == before + 2
    sp.sparse_conv(torch.zeros(n, 8), kmap, torch.zeros(k, 8, 8))
    assert sc.rulebook_builds == before + 2


def _conv_by_rulebook(feat, rb, weight, sms=132):
    """B3's traversal in plain torch: busy tiles x their offsets in groups of offset_splits, each
    group's f32 sum of the busy rows added in group order, rows written through the permutation."""
    n, cin = feat.shape
    k, _, cout = weight.shape
    splits = sc.offset_splits(rb.busy_tiles, k, cout, sms)
    per = -(-k // splits)
    feat_pad = torch.cat([feat.float(), torch.zeros(1, cin)])
    partial = torch.zeros(splits, rb.busy_tiles * sc.TILE, cout)
    for t in range(rb.busy_tiles):
        rows = slice(t * sc.TILE, (t + 1) * sc.TILE)
        for d in range(k):
            if int(rb.tile_mask[t]) >> d & 1:
                partial[d // per, rows] += feat_pad[rb.nbr[d, rows].long()] @ weight[d].float()
    total = torch.zeros(n, cout)
    for z in range(splits):
        total[: rb.busy_tiles * sc.TILE] += partial[z, :n] if rb.busy_tiles * sc.TILE > n else partial[z]
    out = torch.empty(n, cout)
    out[rb.perm.long()] = total[:n]
    return out


def _conv_dw_by_rulebook(feat, rb, grad, sms=132):
    """B4's traversal in plain torch: each offset's hit pairs cut into row_splits runs, a run's
    A^T G summed, the runs added in order."""
    cin, cout = feat.shape[1], grad.shape[1]
    splits = sc.row_splits(rb.hits, cin, cout, sms)
    start = rb.pair_start.tolist()
    dw = torch.zeros(len(rb.hits), cin, cout)
    for d in range(len(rb.hits)):
        count = start[d + 1] - start[d]
        per = -(-count // splits)
        for r in range(splits):
            lo, hi = start[d] + min(count, r * per), start[d] + min(count, (r + 1) * per)
            dw[d] += feat[rb.pair_in[lo:hi].long()].float().t() @ grad[rb.pair_out[lo:hi].long()].float()
    return dw


def test_rulebook_traversal_matches_plain_and_pallas():
    """The kernels' walk over the rulebook (busy tiles and their offsets; per-offset hit pairs, in the
    splits the wrappers choose) equals the plain versions and the Pallas kernels (interpret mode) on a
    JAX-built map with pads, an all-pad tile and offsets no row hits."""
    idx, _, _ = _jax_kernel_map()
    n = idx.shape[0]
    rb = sc.build_rulebook(idx)
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(n, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(27, 16, 24))).astype(np.float32)
    g = rng.normal(size=(n, 24)).astype(np.float32)
    f_t, w_t, g_t = torch.from_numpy(feat), torch.from_numpy(w), torch.from_numpy(g)
    assert sc.offset_splits(rb.busy_tiles, 27, 24, 132) > 1 and sc.row_splits(rb.hits, 16, 24, 132) == 1
    got = _conv_by_rulebook(f_t, rb, w_t)
    torch.testing.assert_close(got, sc.subm_conv_plain(f_t, idx, w_t), rtol=1e-5, atol=1e-5)
    ref = np.asarray(fused_subm_conv(jnp.asarray(feat), jnp.asarray(idx.numpy()), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    for sms in (132, 1):  # one run per offset, and more runs than a small map needs
        got = _conv_dw_by_rulebook(f_t, rb, g_t, sms)
        ref = sc.subm_conv_dw_plain(f_t, idx, g_t)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * max(1.0, ref.abs().max().item()))
    ref = np.asarray(fused_subm_conv_dw(jnp.asarray(feat), jnp.asarray(idx.numpy()), jnp.asarray(g), interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


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
