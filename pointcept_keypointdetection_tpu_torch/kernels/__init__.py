"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain PyTorch version.

* ``patch_attention``: kernels B1 and B2, serialized patch attention forward
  and backward, and ``PatchAttentionFunction``.
* ``sparse_conv``: kernels B3 and B4, gather-GEMM submanifold conv forward
  and weight gradient, and ``SubmConvFunction``.

Sources live in ``../csrc``; ``_build`` compiles them with nvcc at first use.
"""
