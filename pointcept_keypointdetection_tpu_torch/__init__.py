"""PyTorch/CUDA port of pointcept_keypointdetection_tpu, for NVIDIA Hopper.

The JAX package stays the reference; this package imports nothing of it, nor
``jax``.  Module names mirror the JAX package (``ops/``, ``models/``,
``datasets/``, ``engines/``, ``inference/``, ``utils/``); the hand-written
CUDA kernels are under ``kernels/`` with their sources in ``csrc/``.

Ported so far: the offset-keypoint inference path over PT-v3m1
(``inference.keypoint.OffsetKeypointPredictor``, ``serve``) and its
training path (``engines.train.Trainer``, ``train``); the segmentation
inference path of ``DefaultSegmentorV2`` in f32 and bf16
(``inference.segment.SegmentPredictor``, ``serve --task pigseg``, and
``bench``, the counterpart of the repository's ``bench.py``); and its
training path (``models.losses``, ``OneCycleLR``, ``amp``, the segmentation
transforms and datasets, ``SemSegEvaluator``) for the pigseg and ScanNet
PT-v3m1 recipes; the committed keypoint checkpoint (``utils.checkpoint``,
``convert``); and SpUNet-v1m1 under ``DefaultSegmentor`` with
``engines.test.SemSegTester`` and the ``test`` CLI, ``PolyLR``, SGD and
Mix3D, for ``exp/semseg_r3`` and the ScanNet SpUNet recipe; and PointGroup
instance segmentation (``models.point_group``, ``ops.knn``, ``ops.cluster``,
``InsSegEvaluator``, ``engines.test.InsSegTester``) for ``exp/insseg_r3``
and the insseg recipes.
"""
