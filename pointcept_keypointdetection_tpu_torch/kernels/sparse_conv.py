"""Submanifold sparse conv: kernels B3 (forward) and B4 (weight gradient),
each beside its plain version, the rulebook that sizes their work, and the
autograd Function that joins them.

``subm_conv`` replaces the Pallas TPU kernel
``pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py::_conv_kernel``
(via ``fused_subm_conv``, reached from ``ops/sparse.py::_conv_apply``):
out[i] = sum_d feat_pad[idx[i, d]] @ W[d], where index N selects a zero row.
On a CUDA tensor it launches the hand-written gather-GEMM kernel of
``csrc/sparse_conv.cu`` over the map's ``Rulebook``: rows sorted by their hit
mask (in words of 32 offsets, so one launch takes any K up to MAX_OFFSETS:
the k=5 stem's 125 as the k=3 convs' 27), only the busy row tiles and, per
tile, only the offsets it hits; the
gathered rows and W tiles stream through a ``cp.async`` ring in shared
memory into tensor-core products (bf16 ``mma.sync``; f32 as 3xTF32).  Where
the busy tiles are too few to fill the card, the offsets are split across
blocks into an f32 workspace and summed by a second kernel.  On a CPU tensor
it runs ``subm_conv_plain``, the gather plus matmul of ``_conv_apply``.

``subm_conv_dw`` replaces ``_dw_kernel`` (via ``fused_subm_conv_dw``, from
``ops/sparse.py::_subm_conv_sym_bwd``): dW[d] = sum_i feat_pad[idx[i, d]]^T
g[i] in f32.  On a CUDA tensor it launches the second kernel of
``csrc/sparse_conv.cu``, which walks the rulebook's per-offset hit pairs
(split across blocks by hits, the splits summed in a fixed order); on a CPU
tensor ``subm_conv_dw_plain``.

``SubmConvFunction`` is ``_subm_conv_sym``'s ``custom_vjp``: the forward is
B3, dfeat is B3 again with the mirrored weight flip(W, 0)^T over the same
map and rulebook (for a centered cube in ``itertools.product`` order offset
d's opposite is K-1-d, so map[i][d] = j exactly when map[j][K-1-d] = i), and
dW is B4.  The kernels read rows of 16 bytes, so a Cin that is not a multiple
of 8 (the k=3 stem's 7 input channels) is zero-padded up to one, in the
features and in W, once per call on either device; each padded product is
0 * 0, and dfeat and dW are cut back to Cin.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

# Launches of the CUDA kernels in this process (B3, B4); the plain versions do not count.
launches = 0
dw_launches = 0
# Rulebooks built in this process (one per kernel map that reached a kernel).
rulebook_builds = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # rows of a rulebook tile: B3's output rows per block
CHANNELS = 8  # the kernels take channels in multiples of this (16-byte rows of f32 and bf16 alike)
MAX_OFFSETS = 343  # offsets B3 takes (a 7^3 cube): its per-block offset list and index slab fit shared memory
MASK_BITS = 32  # offsets per word of a tile's hit mask
BLOCKS_PER_SM = 4  # blocks in flight per SM that the offset and row splits aim for
DW_MIN_HITS = 256  # B4: hit pairs a row split holds at least (eight of the kernel's 32-pair steps)


class Rulebook(NamedTuple):
    """What the kernels need to know of a kernel map ``idx`` int32 [N, K]
    (N = no neighbour), built once per map by ``build_rulebook``.

    Rows are sorted by their K-bit hit mask (bit d: the row has a neighbour
    at offset d), descending and stable, so rows with the same mask sit
    together and rows with no hit come last; the mask is held in W =
    ceil(K / 32) words of 32 bits, word w holding offsets [32w, 32w + 32),
    and compared with the highest word first.  ``perm[p]`` is the row at
    sorted position p.  ``nbr[d, p] = idx[perm[p], d]``, offset-major so
    that a tile's neighbours at one offset are contiguous; positions past N
    hold N.  A tile is TILE sorted positions; the first ``busy_tiles`` hold
    every row with a hit, and ``tile_mask[w * T + t]`` (T tiles; word-major,
    so ``tile_mask[t]`` where K <= 32) has bit d set when a row of tile t
    hits offset 32w + d.
    ``pair_in``/``pair_out`` list the hits offset by offset (feature row,
    output row), offset d's in ``[pair_start[d], pair_start[d + 1])``;
    ``hits`` holds each offset's count on the host."""

    perm: torch.Tensor  # int32 [N]
    nbr: torch.Tensor  # int32 [K, ceil(N / TILE) * TILE]
    tile_mask: torch.Tensor  # int32 [ceil(K / 32) * ceil(N / TILE)]
    pair_in: torch.Tensor  # int32 [H]
    pair_out: torch.Tensor  # int32 [H]
    pair_start: torch.Tensor  # int32 [K + 1]
    busy_tiles: int
    hits: Tuple[int, ...]


def _mask_words(hit: torch.Tensor) -> torch.Tensor:
    """int64 [R, ceil(K / 32)]: bit d of word w is ``hit[:, 32w + d]``."""
    r, k = hit.shape
    words = -(-k // MASK_BITS)
    bits = torch.arange(MASK_BITS, device=hit.device, dtype=torch.int64)
    padded = torch.nn.functional.pad(hit.to(torch.int64), (0, words * MASK_BITS - k)).reshape(r, words, MASK_BITS)
    return (padded << bits).sum(2)


def build_rulebook(idx: torch.Tensor) -> Rulebook:
    """The ``Rulebook`` of ``idx`` int32 [N, K], with plain torch ops on its device.

    Reads one small tensor back to the host (the busy tiles and the hits per
    offset, which size the kernels' grids)."""
    global rulebook_builds
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be int32 [N, K], got {idx.dtype} {tuple(idx.shape)}")
    n, k = idx.shape
    if k > MAX_OFFSETS:
        raise ValueError(f"a rulebook holds at most {MAX_OFFSETS} offsets, got {k}")
    dev = idx.device
    tiles = -(-n // TILE)
    hit = idx < n
    mask = _mask_words(hit)  # [N, W]
    # descending by the mask, highest word first: stable sorts from the lowest word up compose into that order
    perm = torch.sort(mask[:, 0], descending=True, stable=True).indices
    for w in range(1, mask.shape[1]):
        perm = perm[torch.sort(mask[perm, w], descending=True, stable=True).indices]
    pad = tiles * TILE - n
    nbr = torch.cat([idx[perm].t(), idx.new_full((k, pad), n)], 1)
    hit_sorted = torch.cat([hit[perm], hit.new_zeros((pad, k))]).reshape(tiles, TILE, k).any(1)
    words = _mask_words(hit_sorted).t().reshape(-1)  # word-major
    tile_mask = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)  # the bits as int32
    d, rows = hit.t().nonzero(as_tuple=True)  # offset-major, rows ascending within an offset
    counts = torch.bincount(d, minlength=k)
    host = torch.cat([hit.any(1).sum().reshape(1), counts]).tolist()
    rulebook_builds += 1
    return Rulebook(
        perm=perm.to(torch.int32),
        nbr=nbr,
        tile_mask=tile_mask,
        pair_in=idx[rows, d],
        pair_out=rows.to(torch.int32),
        pair_start=torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32),
        busy_tiles=-(-host[0] // TILE),
        hits=tuple(host[1:]),
    )


def conv_tile_cols(cout: int) -> int:
    """B3's output columns per block: 32 at Cout <= 32, else 64."""
    return 32 if cout <= 32 else 64


def offset_splits(busy_tiles: int, k: int, cout: int, sms: int) -> int:
    """Groups of offsets to spread over blocks so that ~BLOCKS_PER_SM blocks run per SM,
    counted over the busy tiles only."""
    blocks = busy_tiles * -(-cout // conv_tile_cols(cout))
    if blocks == 0:
        return 1
    splits = min(k, max(1, -(-BLOCKS_PER_SM * sms // blocks)))
    return -(-k // -(-k // splits))  # no empty group: ceil(k / offsets per group)


def dw_tile(cin: int, cout: int) -> int:
    """B4's dW tile side (Cin rows, Cout columns): 32 at C <= 32, else 64."""
    return 32 if max(cin, cout) <= 32 else 64


def row_splits(hits: Sequence[int], cin: int, cout: int, sms: int) -> int:
    """Runs each offset's hit pairs are cut into, so that ~BLOCKS_PER_SM blocks run per SM
    and no run of the busiest offset holds fewer than DW_MIN_HITS pairs."""
    k = len(hits)
    t = dw_tile(cin, cout)
    blocks = k * -(-cin // t) * -(-cout // t)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    return max(1, min(want, -(-max(hits, default=0) // DW_MIN_HITS), 65535 // k))


def _check_map(feat: torch.Tensor, idx: torch.Tensor) -> None:
    if feat.dim() != 2 or feat.dtype not in _DTYPES:
        raise ValueError(f"feat must be float32/bfloat16 [N, Cin], got {feat.dtype} {tuple(feat.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != feat.shape[0]:
        raise ValueError(f"idx must be int32 [{feat.shape[0]}, K], got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != feat.device:
        raise ValueError(f"feat on {feat.device} but idx on {idx.device}")


def _check(feat: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> None:
    _check_map(feat, idx)
    cin = feat.shape[1]
    k = idx.shape[1]
    if weight.dim() != 3 or tuple(weight.shape[:2]) != (k, cin) or weight.dtype != feat.dtype:
        raise ValueError(
            f"weight must be {feat.dtype} [{k}, {cin}, Cout], got {weight.dtype} {tuple(weight.shape)}"
        )
    if weight.device != feat.device:
        raise ValueError(f"feat on {feat.device} but weight on {weight.device}")


def _checked_rulebook(name: str, idx: torch.Tensor, rulebook: Optional[Rulebook], *tensors: torch.Tensor) -> Rulebook:
    """What the kernels take: contiguous 16-byte aligned rows of a multiple of CHANNELS channels, at most
    MAX_OFFSETS offsets.  Returns ``rulebook``, or the map's own if none is given."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {tensors[0].device}")
    if not (idx.is_contiguous() and all(t.is_contiguous() for t in tensors)):
        raise ValueError(f"the CUDA kernel {name} takes contiguous tensors")
    if any(t.shape[-1] % CHANNELS or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the CUDA kernel {name} takes channels in multiples of {CHANNELS} on 16-byte aligned rows")
    if rulebook is None:
        return build_rulebook(idx)
    if rulebook.perm.shape[0] != idx.shape[0] or rulebook.nbr.shape[0] != idx.shape[1]:
        raise ValueError(f"the rulebook is of another map than idx {tuple(idx.shape)}")
    return rulebook


def subm_conv_plain(feat: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Gather + matmul in f32: [N, K*Cin] @ [K*Cin, Cout] -> [N, Cout]."""
    n, cin = feat.shape
    k, _, cout = weight.shape
    feat_pad = torch.cat([feat.float(), feat.new_zeros((1, cin), dtype=torch.float32)])
    gathered = feat_pad[idx.long()].reshape(n, k * cin)
    return (gathered @ weight.float().reshape(k * cin, cout)).to(feat.dtype)


def subm_conv(feat: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor,
              rulebook: Optional[Rulebook] = None) -> torch.Tensor:
    """feat [N, Cin], idx int32 [N, K] in [0, N], weight [K, Cin, Cout] -> [N, Cout].

    On the card the kernel walks ``rulebook`` (``build_rulebook(idx)``; built
    here when not given)."""
    global launches
    _check(feat, idx, weight)
    if feat.device.type == "cpu":
        return subm_conv_plain(feat, idx, weight)
    rb = _checked_rulebook("subm_conv", idx, rulebook, feat, weight)
    n, cin = feat.shape
    k, _, cout = weight.shape
    fn = _build.load("sparse_conv").subm_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(feat.device).multi_processor_count
    splits = offset_splits(rb.busy_tiles, k, cout, sms)
    out = torch.empty((n, cout), dtype=feat.dtype, device=feat.device)
    shape = (splits, rb.busy_tiles * TILE, cout) if splits > 1 else (0,)
    workspace = torch.empty(shape, dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), weight.data_ptr(), out.data_ptr(), workspace.data_ptr() or None, rb.perm.data_ptr(),
            rb.nbr.data_ptr(), rb.tile_mask.data_ptr(), n, k, cin, cout, rb.busy_tiles, splits,
            _DTYPES[feat.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"subm_conv_fwd failed: CUDA error {rc}")
    launches += 1
    return out


def subm_conv_dw_plain(feat: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """dW [K, Cin, Cout] f32: the gathered [N, K, Cin] against grad [N, Cout] (``_subm_conv_sym_bwd``'s einsum)."""
    cin = feat.shape[1]
    feat_pad = torch.cat([feat.float(), feat.new_zeros((1, cin), dtype=torch.float32)])
    return torch.einsum("nkc,nd->kcd", feat_pad[idx.long()], grad.float())


def subm_conv_dw(feat: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
                 rulebook: Optional[Rulebook] = None) -> torch.Tensor:
    """feat [N, Cin], idx int32 [N, K] in [0, N], grad [N, Cout] of feat's dtype -> dW f32 [K, Cin, Cout].

    On the card the kernel walks ``rulebook``'s hit pairs (built here when not given)."""
    global dw_launches
    n, cin = feat.shape
    k = idx.shape[1]
    if grad.dim() != 2 or grad.shape[0] != n or grad.dtype != feat.dtype:
        raise ValueError(f"grad must be {feat.dtype} [{n}, Cout], got {grad.dtype} {tuple(grad.shape)}")
    _check_map(feat, idx)
    if grad.device != feat.device:
        raise ValueError(f"feat on {feat.device} but grad on {grad.device}")
    if feat.device.type == "cpu":
        return subm_conv_dw_plain(feat, idx, grad)
    rb = _checked_rulebook("subm_conv_dw", idx, rulebook, feat, grad)
    cout = grad.shape[1]
    fn = _build.load("sparse_conv").subm_conv_dw
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = row_splits(rb.hits, cin, cout, torch.cuda.get_device_properties(feat.device).multi_processor_count)
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=feat.device)
    workspace = torch.empty((splits, k, cin, cout) if splits > 1 else (0,), dtype=torch.float32,
                            device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), grad.data_ptr(), dw.data_ptr(), workspace.data_ptr() or None, rb.pair_in.data_ptr(),
            rb.pair_out.data_ptr(), rb.pair_start.data_ptr(), n, k, cin, cout, splits, _DTYPES[feat.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"subm_conv_dw failed: CUDA error {rc}")
    dw_launches += 1
    return dw


def mirrored_weight(weight: torch.Tensor) -> torch.Tensor:
    """flip(W, 0) with Cin and Cout swapped, contiguous: [K, Cout, Cin]."""
    return weight.flip(0).transpose(1, 2).contiguous()


class SubmConvFunction(torch.autograd.Function):
    """``subm_conv`` with the scatter-free backward of ``_subm_conv_sym``:
    dfeat = subm_conv(g, idx, mirrored W) (kernel B3), dW = subm_conv_dw
    (kernel B4) cast to W's dtype, all three over one ``rulebook`` (built
    here on the card when not given).  ``idx`` gets no gradient.  W may be
    f32 under bf16 features (``amp``): it is cast to the features' dtype
    inside, as ``_subm_conv_sym`` casts it, so B4's f32 dW reaches an f32
    parameter unrounded."""

    @staticmethod
    def forward(ctx, feat, idx, weight, rulebook=None):
        if rulebook is None and feat.device.type == "cuda":
            rulebook = build_rulebook(idx)
        cin = feat.shape[1]
        w = weight.to(feat.dtype)
        pad = -cin % CHANNELS
        if pad:  # zero channels: each adds 0 * 0 to every product
            feat = torch.nn.functional.pad(feat, (0, pad))
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        ctx.save_for_backward(feat, idx, w)
        ctx.rulebook, ctx.cin, ctx.weight_dtype = rulebook, cin, weight.dtype
        return subm_conv(feat, idx, w, rulebook)

    @staticmethod
    def backward(ctx, grad):
        feat, idx, w = ctx.saved_tensors
        rb, cin = ctx.rulebook, ctx.cin
        grad = grad.contiguous()
        dfeat = dweight = None
        if ctx.needs_input_grad[0]:
            dfeat = subm_conv(grad, idx, mirrored_weight(w.to(grad.dtype)), rb)[:, :cin]
        if ctx.needs_input_grad[2]:
            dweight = subm_conv_dw(feat, idx, grad, rb)[:, :cin].contiguous().to(ctx.weight_dtype)
        return dfeat, None, dweight, None
