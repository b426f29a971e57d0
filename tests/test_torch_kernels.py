"""The kernels' plain versions against the Pallas kernels (interpret mode),
the autograd Functions against autograd of the plain forwards, the sparse
conv's rulebook and a plain emulation of the conv kernels' traversal of it,
and the wrappers' CPU dispatch, split policies and argument checks.

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


def _jax_kernel_map():
    """A kernel map built by the JAX package over three slots of 70 rows (N = 210, not a multiple of
    the 64-row tile), pads last in each slot: 50 voxels, one voxel, 40 voxels, all at even z, so the 18
    offsets with dz = +-1 hit no row."""
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
