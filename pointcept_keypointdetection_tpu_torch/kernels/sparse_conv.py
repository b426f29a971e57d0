"""Submanifold sparse conv: kernels B3 (forward) and B4 (weight gradient),
each beside its plain version, and the autograd Function that joins them.

``subm_conv`` replaces the Pallas TPU kernel
``pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py::_conv_kernel``
(via ``fused_subm_conv``, reached from ``ops/sparse.py::_conv_apply``):
out[i] = sum_d feat_pad[idx[i, d]] @ W[d], where index N selects a zero row.
On a CUDA tensor it launches the hand-written gather-GEMM kernel
``csrc/sparse_conv.cu`` (gathered rows and W tiles in shared memory, f32
FFMA accumulation in registers, no im2col in device memory; where the output
has too few tiles to fill the card, the offsets are split across blocks into
an f32 workspace and summed by a second kernel); on a CPU tensor it runs
``subm_conv_plain``, the gather plus matmul of ``_conv_apply``.  It is bound
by its 2*nnz*Cin*Cout flops at the f32 rate.

``subm_conv_dw`` replaces ``_dw_kernel`` (via ``fused_subm_conv_dw``, from
``ops/sparse.py::_subm_conv_sym_bwd``): dW[d] = sum_i feat_pad[idx[i, d]]^T
g[i] in f32.  On a CUDA tensor it launches the second kernel of
``csrc/sparse_conv.cu`` (the N rows split across blocks, sentinel rows
skipped, splits summed in a fixed order by the kernel B3 uses for its
offset splits); on a CPU tensor ``subm_conv_dw_plain``.

``SubmConvFunction`` is ``_subm_conv_sym``'s ``custom_vjp``: the forward is
B3, dfeat is B3 again with the mirrored weight flip(W, 0)^T (for a centered
cube in ``itertools.product`` order offset d's opposite is K-1-d, so
map[i][d] = j exactly when map[j][K-1-d] = i), and dW is B4.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernels in this process (B3, B4); the plain versions do not count.
launches = 0
dw_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # the kernels' BM = BN: output rows and columns per block
BLOCKS_PER_SM = 4  # blocks in flight per SM that the offset and row splits aim for
DW_CHUNK = 256  # rows of one compaction step of the dW kernel: a split holds whole chunks


def offset_splits(n: int, k: int, cout: int, sms: int) -> int:
    """Groups of offsets to spread over blocks so that ~BLOCKS_PER_SM blocks run per SM."""
    tiles = -(-n // TILE) * -(-cout // TILE)
    splits = min(k, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
    return -(-k // -(-k // splits))  # no empty group: ceil(k / offsets per group)


def row_splits(n: int, k: int, cin: int, cout: int, sms: int):
    """(splits, rows per split) of the dW kernel's N rows, so that ~BLOCKS_PER_SM blocks run per SM."""
    tiles = k * -(-cin // TILE) * -(-cout // TILE)
    chunks = max(1, -(-n // DW_CHUNK))
    splits = min(chunks, max(1, -(-BLOCKS_PER_SM * sms // tiles)), 65535 // k)
    rows = -(-chunks // splits) * DW_CHUNK
    return max(1, -(-n // rows)), rows


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


def subm_conv_plain(feat: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Gather + matmul in f32: [N, K*Cin] @ [K*Cin, Cout] -> [N, Cout]."""
    n, cin = feat.shape
    k, _, cout = weight.shape
    feat_pad = torch.cat([feat.float(), feat.new_zeros((1, cin), dtype=torch.float32)])
    gathered = feat_pad[idx.long()].reshape(n, k * cin)
    return (gathered @ weight.float().reshape(k * cin, cout)).to(feat.dtype)


def subm_conv(feat: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """feat [N, Cin], idx int32 [N, K] in [0, N], weight [K, Cin, Cout] -> [N, Cout]."""
    global launches
    _check(feat, idx, weight)
    if feat.device.type == "cpu":
        return subm_conv_plain(feat, idx, weight)
    if feat.device.type != "cuda":
        raise ValueError(f"subm_conv runs on cpu or cuda, not {feat.device}")
    if not (feat.is_contiguous() and idx.is_contiguous() and weight.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous feat, idx and weight")
    n, cin = feat.shape
    k, _, cout = weight.shape
    lib = _build.load("sparse_conv")
    fn = lib.subm_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = offset_splits(n, k, cout, torch.cuda.get_device_properties(feat.device).multi_processor_count)
    out = torch.empty((n, cout), dtype=feat.dtype, device=feat.device)
    workspace = torch.empty((splits, n, cout) if splits > 1 else (0,), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(), workspace.data_ptr() or None,
            n, k, cin, cout, splits, _DTYPES[feat.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"subm_conv_fwd failed: CUDA error {rc}")
    launches += 1
    return out


def subm_conv_dw_plain(feat: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """dW [K, Cin, Cout] f32: the gathered [N, K, Cin] against grad [N, Cout] (``_subm_conv_sym_bwd``'s einsum)."""
    cin = feat.shape[1]
    feat_pad = torch.cat([feat.float(), feat.new_zeros((1, cin), dtype=torch.float32)])
    return torch.einsum("nkc,nd->kcd", feat_pad[idx.long()], grad.float())


def subm_conv_dw(feat: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """feat [N, Cin], idx int32 [N, K] in [0, N], grad [N, Cout] of feat's dtype -> dW f32 [K, Cin, Cout]."""
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
    if feat.device.type != "cuda":
        raise ValueError(f"subm_conv_dw runs on cpu or cuda, not {feat.device}")
    if not (feat.is_contiguous() and idx.is_contiguous() and grad.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous feat, idx and grad")
    cout = grad.shape[1]
    fn = _build.load("sparse_conv").subm_conv_dw
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits, rows = row_splits(n, k, cin, cout, torch.cuda.get_device_properties(feat.device).multi_processor_count)
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=feat.device)
    workspace = torch.empty((splits, k, cin, cout) if splits > 1 else (0,), dtype=torch.float32,
                            device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), idx.data_ptr(), grad.data_ptr(), dw.data_ptr(), workspace.data_ptr() or None,
            n, k, cin, cout, splits, rows, _DTYPES[feat.dtype], stream)
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
    (kernel B4) cast to W's dtype.  ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, feat, idx, weight):
        ctx.save_for_backward(feat, idx, weight)
        return subm_conv(feat, idx, weight)

    @staticmethod
    def backward(ctx, grad):
        feat, idx, weight = ctx.saved_tensors
        grad = grad.contiguous()
        dfeat = subm_conv(grad, idx, mirrored_weight(weight)) if ctx.needs_input_grad[0] else None
        dweight = subm_conv_dw(feat, idx, grad).to(weight.dtype) if ctx.needs_input_grad[2] else None
        return dfeat, None, dweight
