"""Serialized patch attention: kernels B1 (forward) and B2 (backward), each
beside its plain version, and the autograd Function that joins them.

``patch_attention`` replaces the Pallas TPU kernel
``pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py::
_attn_kernel`` (via ``_pallas_forward``): per (patch, head),
softmax(q k^T * scale, invalid keys at -1e9) v in f32.  On a CUDA tensor it
launches the hand-written kernel ``csrc/patch_attention.cu``: a block owns
128 queries of a (patch, head), 16 per warp, and streams the keys through a
``cp.async`` ring in tiles of 64 with an online softmax, walking several
patches so that one patch's loads overlap another's math; every product runs
on the tensor cores (``mma.sync``: bf16, or f32 as 3xTF32), and the
exponentials are base-2 (see the source for the design).  On a CPU tensor it
runs ``patch_attention_plain``.  With the products on the tensor cores, its
least time on the card is that of the bytes it moves (qkv read once, the
output written once); ``PERF.md`` gives how far from it the kernel runs.

``patch_attention_backward`` replaces ``_attn_bwd_kernel`` (via
``_pallas_backward``, the ``custom_vjp`` backward): on a CUDA tensor kernel
B2 on the same design, reading the forward's output in f32 and its per-row
log-sum-exp.  Up to ``ONE_PASS_PATCH`` keys a block holds a patch's keys and
computes dq, dk and dv in one pass (one exponential per score); beyond it two
kernels, dq with the keys streamed, which also writes delta = rowsum(dO * O)
to a scratch the wrapper allocates, then dk/dv with the queries streamed.
On a CPU tensor ``patch_attention_backward_plain``, which recomputes the
probabilities as the Pallas kernel does.  ``PatchAttentionFunction`` runs B1
with the log-sum-exp in its forward and B2 in its backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# Launches of the CUDA kernels in this process (B1, B2); the plain versions do not count.
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 16  # the kernels' compiled head dim: every PTv3 stage of the repo's configs
ONE_PASS_PATCH = 128  # B2 runs in one pass up to this patch size (the kernels' stationary rows per block)


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


def _check_cuda(*tensors: torch.Tensor) -> None:
    if tensors[0].device.type != "cuda":
        raise ValueError(f"patch attention runs on cpu or cuda, not {tensors[0].device}")
    if tensors[0].shape[-1] != HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head dim {HEAD_DIM}, got {tensors[0].shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors if t.dtype != torch.bool):
        raise ValueError("the CUDA kernels copy rows in 16-byte pieces: tensors must start 16-byte aligned")


def _probs(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float):
    """q, k, v as f32 [P, H, K, D] and the masked softmax [P, H, K, K]."""
    n, _, h, d = qkv.shape
    p = n // patch_size
    q, k, v = qkv.float().reshape(p, patch_size, 3, h, d).permute(2, 0, 3, 1, 4)
    logits = torch.einsum("phkd,phmd->phkm", q * scale, k)
    logits = logits.masked_fill(~valid.reshape(p, 1, 1, patch_size), -1e9)
    return q, k, v, logits.softmax(-1)


def patch_attention_plain(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float) -> torch.Tensor:
    """Masked block-diagonal attention in f32 over ``[P, H, K, D]``; [N, H*D]."""
    n, _, h, d = qkv.shape
    _, _, v, probs = _probs(qkv, valid, patch_size, scale)
    out = torch.einsum("phkm,phmd->phkd", probs, v)
    return out.permute(0, 2, 1, 3).reshape(n, h * d).to(qkv.dtype)


def patch_attention_backward_plain(qkv: torch.Tensor, valid: torch.Tensor, grad: torch.Tensor, patch_size: int,
                                   scale: float) -> torch.Tensor:
    """dqkv [N, 3, H, D] of ``patch_attention_plain`` for the output gradient ``grad``
    [N, H*D], as ``_attn_bwd_kernel`` computes it: P recomputed in f32, then
    dv = P^T g, dS = P * (g v^T - rowsum(g v^T * P)), dq = dS k * scale,
    dk = dS^T q * scale.  dS is not gated by the mask."""
    n, _, h, d = qkv.shape
    p = n // patch_size
    q, k, v, probs = _probs(qkv, valid, patch_size, scale)
    g = grad.float().reshape(p, patch_size, h, d).permute(0, 2, 1, 3)  # [P, H, K, D]
    dv = torch.einsum("phkm,phkd->phmd", probs, g)
    dprobs = torch.einsum("phkd,phmd->phkm", g, v)
    dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dq = torch.einsum("phkm,phmd->phkd", dlogits, k) * scale
    dk = torch.einsum("phkm,phkd->phmd", dlogits, q) * scale
    dqkv = torch.stack([dq, dk, dv])  # [3, P, H, K, D]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, 3, h, d).to(qkv.dtype)


def _forward_kernel(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float,
                    lse: Optional[torch.Tensor] = None, out32: Optional[torch.Tensor] = None) -> torch.Tensor:
    global launches
    _check_cuda(qkv, valid)
    n, _, h, d = qkv.shape
    fn = _build.load("patch_attention").patch_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((n, h * d), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), valid.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if out32 is None else out32.data_ptr(), n, h, d, patch_size, float(scale), _DTYPES[qkv.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"patch_attention_fwd failed: CUDA error {rc}")
    launches += 1
    return out


def patch_attention(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float) -> torch.Tensor:
    """qkv [N, 3, H, D] and valid bool[N] in serialized order -> [N, H*D]."""
    _check(qkv, valid, patch_size)
    if qkv.device.type == "cpu":
        return patch_attention_plain(qkv, valid, patch_size, scale)
    return _forward_kernel(qkv, valid, patch_size, scale)


def patch_attention_with_lse(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float):
    """Kernel B1 on a CUDA tensor, also writing what B2 reads: (out [N, H*D], lse f32 [N, H],
    out32 f32 [N, H*D]).  out32 is out itself in f32; in bf16 B1 writes it apart, unrounded."""
    _check(qkv, valid, patch_size)
    n, _, h, d = qkv.shape
    lse = torch.empty((n, h), dtype=torch.float32, device=qkv.device)
    out32 = None if qkv.dtype == torch.float32 else torch.empty((n, h * d), dtype=torch.float32, device=qkv.device)
    out = _forward_kernel(qkv, valid, patch_size, scale, lse, out32)
    return out, lse, out if out32 is None else out32


def patch_attention_backward(qkv: torch.Tensor, valid: torch.Tensor, out32: Optional[torch.Tensor],
                             lse: Optional[torch.Tensor], grad: torch.Tensor, patch_size: int,
                             scale: float) -> torch.Tensor:
    """dqkv [N, 3, H, D] for the output gradient ``grad`` [N, H*D].

    On a CUDA tensor kernel B2, which takes the forward's ``lse`` and
    ``out32``, its output in f32 (``patch_attention_with_lse``); on a CPU
    tensor the plain version, which needs neither."""
    global bwd_launches
    _check(qkv, valid, patch_size)
    n, _, h, d = qkv.shape
    if grad.shape != (n, h * d) or grad.dtype != qkv.dtype:
        raise ValueError(f"grad must be {qkv.dtype} [{n}, {h * d}], got {grad.dtype} {tuple(grad.shape)}")
    if qkv.device.type == "cpu":
        return patch_attention_backward_plain(qkv, valid, grad, patch_size, scale)
    if out32 is None or lse is None or out32.shape != grad.shape or out32.dtype != torch.float32 or \
            lse.shape != (n, h) or lse.dtype != torch.float32:
        raise ValueError("kernel B2 takes the forward's out32 f32 [N, H*D] and lse f32 [N, H]")
    _check_cuda(qkv, valid, out32, lse, grad)
    fn = _build.load("patch_attention").patch_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((n, h), dtype=torch.float32, device=qkv.device)  # rowsum(dO * O): dq writes, dk/dv reads
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), valid.data_ptr(), out32.data_ptr(), lse.data_ptr(), grad.data_ptr(), dqkv.data_ptr(),
            delta.data_ptr(), n, h, d, patch_size, float(scale), _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"patch_attention_bwd failed: CUDA error {rc}")
    bwd_launches += 1
    return dqkv


class PatchAttentionFunction(torch.autograd.Function):
    """Patch attention with kernel B1 forward and kernel B2 backward on the
    card (the plain versions on the CPU), as ``patch_attention_pallas``'s
    ``custom_vjp``.  ``valid`` gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, valid, patch_size, scale):
        if qkv.device.type == "cpu":
            out = patch_attention(qkv, valid, patch_size, scale)
            ctx.save_for_backward(qkv, valid)
        else:
            out, lse, out32 = patch_attention_with_lse(qkv, valid, patch_size, scale)
            ctx.save_for_backward(qkv, valid, out32, lse)
        ctx.patch_size, ctx.scale = patch_size, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        qkv, valid, *saved = ctx.saved_tensors
        out32, lse = saved if saved else (None, None)
        dqkv = patch_attention_backward(qkv, valid, out32, lse, grad.contiguous(), ctx.patch_size, ctx.scale)
        return dqkv, None, None, None


def attention(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int, scale: float) -> torch.Tensor:
    """``patch_attention``, through ``PatchAttentionFunction`` where a gradient is recorded."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return PatchAttentionFunction.apply(qkv, valid, patch_size, scale)
    return patch_attention(qkv, valid, patch_size, scale)
