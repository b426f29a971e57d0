"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain PyTorch version.

* ``patch_attention``: kernel B1, serialized patch attention forward.
* ``sparse_conv``: kernel B3, gather-GEMM submanifold conv forward.

Sources live in ``../csrc``; ``_build`` compiles them with nvcc at first use.
"""
