"""Submanifold sparse conv, forward: kernel B3 and its plain version.

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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel in this process; the plain version does not count.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # the kernel's BM = BN: output rows and columns per block
BLOCKS_PER_SM = 4  # blocks in flight per SM that the offset split aims for


def offset_splits(n: int, k: int, cout: int, sms: int) -> int:
    """Groups of offsets to spread over blocks so that ~BLOCKS_PER_SM blocks run per SM."""
    tiles = -(-n // TILE) * -(-cout // TILE)
    splits = min(k, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
    return -(-k // -(-k // splits))  # no empty group: ceil(k / offsets per group)


def _check(feat: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> None:
    if feat.dim() != 2 or feat.dtype not in _DTYPES:
        raise ValueError(f"feat must be float32/bfloat16 [N, Cin], got {feat.dtype} {tuple(feat.shape)}")
    n, cin = feat.shape
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != n:
        raise ValueError(f"idx must be int32 [{n}, K], got {idx.dtype} {tuple(idx.shape)}")
    k = idx.shape[1]
    if weight.dim() != 3 or tuple(weight.shape[:2]) != (k, cin) or weight.dtype != feat.dtype:
        raise ValueError(
            f"weight must be {feat.dtype} [{k}, {cin}, Cout], got {weight.dtype} {tuple(weight.shape)}"
        )
    if not (feat.device == idx.device == weight.device):
        raise ValueError(f"feat, idx, weight on {feat.device}, {idx.device}, {weight.device}")


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
