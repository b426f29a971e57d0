"""PyTorch/CUDA port of pointcept_keypointdetection_tpu, for NVIDIA Hopper.

The JAX package stays the reference; this package imports nothing of it, nor
``jax``.  Module names mirror the JAX package (``ops/``, ``models/``,
``datasets/``, ``engines/``, ``inference/``, ``utils/``); the hand-written
CUDA kernels are under ``kernels/`` with their sources in ``csrc/``.

Ported so far: the offset-keypoint inference path over PT-v3m1
(``inference.keypoint.OffsetKeypointPredictor``, ``serve``) and its
training path (``engines.train.Trainer``, ``train``).
"""
