"""Serialized patch attention, forward: kernel B1 and its plain version.

``patch_attention`` replaces the Pallas TPU kernel
``pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py::
_attn_kernel`` (via ``_pallas_forward``): per (patch, head),
softmax(q k^T * scale, invalid keys at -1e9) v in f32.  On a CUDA tensor it
launches the hand-written kernel ``csrc/patch_attention.cu`` (four threads
per query, keys streamed through shared memory with an online softmax; see
the source for its design); on a CPU tensor it runs
``patch_attention_plain``.  The work is 4*N*K*D flops per head against
~(3+1)*N*H*D elements moved, so at K = 128, D = 16 neither the bytes nor the
f32 rate bound it: its launch and latency do.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the CUDA kernel in this process; the plain version does not count.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 16  # the kernel's compiled head dim: every PTv3 stage of the repo's configs


def _check(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int) -> None:
    if qkv.dim() != 4 or qkv.shape[1] != 3:
        raise ValueError(f"qkv must be [N, 3, H, D], got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if valid.dtype != torch.bool or valid.shape != (qkv.shape[0],):
        raise ValueError(f"valid must be bool[{qkv.shape[0]}], got {valid.dtype} {tuple(valid.shape)}")
    if valid.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device} but valid on {valid.device}")
    if patch_size <= 0 or qkv.shape[0] % patch_size:
        raise ValueError(f"N={qkv.shape[0]} is not a multiple of patch_size={patch_size}")


def patch_attention_plain(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float) -> torch.Tensor:
    """Masked block-diagonal attention in f32 over ``[P, H, K, D]``; [N, H*D]."""
    n, _, h, d = qkv.shape
    p = n // patch_size
    x = qkv.float().reshape(p, patch_size, 3, h, d).permute(2, 0, 3, 1, 4)  # [3, P, H, K, D]
    logits = torch.einsum("phkd,phmd->phkm", x[0] * scale, x[1])
    logits = logits.masked_fill(~valid.reshape(p, 1, 1, patch_size), -1e9)
    out = torch.einsum("phkm,phmd->phkd", logits.softmax(-1), x[2])
    return out.permute(0, 2, 1, 3).reshape(n, h * d).to(qkv.dtype)


def patch_attention(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float) -> torch.Tensor:
    """qkv [N, 3, H, D] and valid bool[N] in serialized order -> [N, H*D]."""
    global launches
    _check(qkv, valid, patch_size)
    if qkv.device.type == "cpu":
        return patch_attention_plain(qkv, valid, patch_size, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"patch_attention runs on cpu or cuda, not {qkv.device}")
    n, _, h, d = qkv.shape
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIM}, got {d}")
    if not qkv.is_contiguous() or not valid.is_contiguous():
        raise ValueError("the CUDA kernel takes contiguous qkv and valid")
    lib = _build.load("patch_attention")
    fn = lib.patch_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, h * d), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), valid.data_ptr(), out.data_ptr(), n, h, d, patch_size, float(scale),
            _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"patch_attention_fwd failed: CUDA error {rc}")
    launches += 1
    return out
