#!/usr/bin/env python3
"""Drive the PyTorch port's offset-keypoint server and trainer, its pigseg
server, its segmentation bench, its segmentation trainers, the committed
keypoint checkpoint (``exp/kp_r3``) served, evaluated and trained as its
recipe, SpUNet-v1m1 (the committed ``exp/semseg_r3`` evaluated and run
through the tester, the ScanNet SpUNet recipe and the semseg-spunet-r3
recipe trained) and PointGroup instance segmentation (the committed
``exp/insseg_r3`` through the InsSegTester and the ``test`` CLI, the insseg
r3 recipe and both ScanNet PointGroup recipes trained with the
InsSegEvaluator), the global keypoint heads (``serve --task keypoint``,
the KeypointPTv3Plus recipe and the other pig recipes trained through the
fork's readers, ``infer_offset``), OctFormer and Swin3D (served and
trained as the fork's configs write them) with the pig users' four tools
(``inference_split``, ``batch_infer_export_txt``, ``infer_npy``,
``evaluate_all_splits``), OA-CNNs, PT-v2m2, PT-v1 and ST-v1m2 (served
and trained as the fork's configs write them), and SemanticKITTI
segmentation (the SLAM bridge's per-scan labeller and the PT-v3m1,
MinkUNet34C and SPVCNN recipes) on one NVIDIA GPU, and hold its
hand-written kernels against their plain versions.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each fatal on failure:
  1. device: the card's name and power limit;
  2. build: nvcc builds every kernel of the paths from ``csrc/`` and prints
     each kernel's registers, shared memory and spills;
  3. kernels: B1 (patch attention), B2 (its backward) and B3 (sparse conv)
     against their plain versions at the full-width PTv3 serving shapes, and
     B1 at patch 1024, in f32 and bf16;
  4. serve: the server of ``configs/my_dataset/offset_keypoint_ptv3.py``
     (seeded weights) answers 3 POSTs of ~20k-point body-like clouds; each
     kernel must launch once per Block and the conv rulebook be built once
     per kernel map per request;
  5. card against CPU: one request's outputs with the same weights on the CPU
     (plain versions);
  6. training kernels: B1, B2 (attention backward), B3 and B4 (conv dW)
     against their plain versions at every training shape (batch 8) in f32
     and bf16, the conv kernels on the kernel maps of a batch of the
     trainer's data pipeline, B2 at patch 1024, B3 and B4 on a map with
     all-pad tiles and offsets without hits, all four bit for bit run to run
     (B1 and B2 on inputs with an all-invalid patch, also at patch 1024), and
     both autograd Functions against autograd of the plain forwards;
  7. train: the config's trainer at full width, batch 8, on synthetic scenes,
     2 epochs of 2 steps with the evaluator and the checkpoint saver; each
     step must launch B1 22, B2 22, B3 44 and B4 22 times and build 5 conv
     rulebooks (one per kernel map);
  8. card against CPU: one training step (batch 1, no drop path, no order
     shuffling) with the same weights and batch on the CPU;
  9. times: request latency and step time (host clock), one step under
     torch.profiler, and each kernel, its plain version and a library
     yardstick at every serving and training shape, beside the bound (CUDA
     events around a CUDA-graph replay, inputs read from HBM), the
     exponentials B1 and B2 compute per step beside their floor on the card's
     MUFU units, B1 and B2 at patch 1024 at N = 8192 beside SDPA (B2 there
     is on no path; B1 at the bench's levels is phase 12's), and the conv
     rulebook's build per training map (host clock and device time);
 10. pigseg: the server of ``configs/pigseg/semseg-ptv3-v1m1-0-base.py`` at
     slot 32768 (seeded weights) answers 1 warm-up and 3 timed POSTs of
     ~30k-point clouds with one label per point, each launching B1 and B3
     once per Block; one request's logits, card against CPU; B1 and B3
     against their plain versions at every pigseg level in f32 and bf16,
     B3 on a request's own kernel maps;
 11. bench: the port's ``bench`` module (DefaultSegmentorV2, 102,400 points,
     patch 1024): launches of one forward in bf16 and in f32 (B1 and B3
     once per Block), scenes/s in each, one bf16 forward under
     torch.profiler, and the logits against a CPU f32 forward on the same
     bf16-rounded weights (f32 within ``CPU_TOL``, bf16 within
     ``BENCH_BF16_TOL`` and its argmax agreeing on at least
     ``BENCH_BF16_AGREE`` of the valid points);
 12. bench kernels: B1 and B3 against their plain versions and timed beside
     their library calls at every bench level in bf16 and f32, B3 on the
     bench's kernel maps, with the sums per bench forward;
 13. segmentation trainers: the pigseg recipe as written (f32, CE, AdamW
     under OneCycleLR, its train transforms and the default hooks) on
     seeded N x 8 pig clouds the script writes, and the ScanNet PT-v3m1
     recipe (amp bf16, CE + Lovász, slot 131072) on synthetic 100,000-point
     rooms at its 0.02 grid, batch 2, no Mix3D: the first epoch of each (4
     steps, then the SemSegEvaluator and the saver) with each step's
     launches counted (B1 22, B2 22, B3 44, B4 22, 5 rulebooks), the
     kernels' input dtypes watched (bf16 under amp) and every amp parameter
     and gradient held to f32; step median, peak memory, one step under
     torch.profiler, 4 steps of a fresh trainer on a fixed batch whose loss
     must fall; the criteria's device time (CE, Lovász) at the amp step's
     shape;
 14. segmentation kernels: B1-B4 against their plain versions at every level
     of each trainer in its dtype (pigseg f32, amp bf16), the conv kernels on
     the maps of a batch of its data, each timed per step beside its plain
     version, its library call and its bound;
 15. card against CPU: one step of each segmentation trainer at batch 1 at
     its slot, the loss, every gradient and the running statistics (pigseg
     f32 within ``TRAIN_CPU_TOL``; amp bf16 on both sides within
     ``AMP_CPU_TOL``);
 16. r3 anchor: ``exp/kp_r3/model_params.ckpt`` read by the port's reader
     into the r3 model (``configs/synthetic/offset-keypoint-r3.py``: k=3
     stem, 7 input channels, patch 32, 5 Blocks) on the card and on the CPU;
     its 8 val scenes (np.random seeded with the recipe's seed) through the
     evaluator's ``keypoint_distances``: weighted < 6.0 and argmax < 11.0 mm,
     the card within 0.05 mm of the CPU (an argmax pick may differ only on a
     tie), every scene's outputs card against CPU within ``CPU_TOL``, each
     forward launching B1 5 and B3 6 times and building 3 rulebooks;
 17. r3 serve: the r3 server with the checkpoint's weights at slot 4096
     answers 1 warm-up and 3 POSTs of 6,000-point body-like clouds;
 18. r3 train: the recipe as written, its first epoch (32 steps of batch 4,
     each launching B1 5, B2 5, B3 11 and B4 6 times and building 3
     rulebooks), its evaluator and saver, a profiled step, one step at batch
     1 card against CPU, and a trainer with ``weight=`` the checkpoint
     (CheckpointLoader, then its evaluator before any step);
 19. r3 kernels: B1 and B2 at patch 32 at every request (N 4096-1024) and
     step (N 16384-4096) level with an all-invalid patch, B3 and B4 at the
     xCPE widths and at the 7-channel stem (padded to 8, Cout 32) on the
     maps of r3 val batches, f32 and bf16 against the plain versions, all
     bit for bit run to run;
 20. r3 times: each kernel at those levels beside its plain version, its
     library call (SDPA; gather + matmul) and its bound, summed per r3
     request and per r3 step;
 21. semseg_r3 anchor: ``exp/semseg_r3/model_params.ckpt`` read by the port's
     reader into its DefaultSegmentor over SpUNet-v1m1 (k=3 stem, base 24)
     on the card and on the CPU; its 8 val scenes (np.random seeded 123):
     each card forward launching B3 once per conv (33) and building 5
     rulebooks, logits card against CPU within ``CPU_TOL``, labels apart
     only on a tie, the mIoU above 0.95 and within 0.005 of the CPU's;
 22. semseg_r3 tester: the port's ``test`` CLI over
     ``configs/synthetic/semseg-spunet-r3-test.py`` on the card
     (SemSegTester, 8 test scenes, 3 RandomScale variants of GridSample's
     test-mode fragments), each fragment's forward counted, the mIoU above
     0.95;
 23. SpUNet trainers: the ScanNet SpUNet recipe as written (batch 8, slot
     131072, k=5 stem, SGD under OneCycleLR, Mix3D 0.8, f32) on synthetic
     100,000-point rooms through its transforms but the ScanNet-only ones,
     and the semseg-spunet-r3 recipe as written (AdamW under PolyLR): the
     first epoch of each (4 and 24 steps, then the SemSegEvaluator and the
     saver), each step launching B3 twice per conv but once for the stem
     and B4 once per conv, one rulebook per map, every kernel input f32;
     step median, peak memory, a profiled step, 4 steps of a fresh trainer
     on a fixed batch whose loss must fall;
 24. SpUNet kernels: B3 and B4 at every conv shape of each step (the k=5
     stem at K = 125, Cin 6 padded to 8) in f32 and bf16 against their plain
     versions on the maps of a batch of the recipe's data, bit for bit run
     to run, and timed in f32 per step (B3 forward and, for the input
     gradient, with Cin and Cout swapped) beside the plain version, the
     gather + ``torch.matmul`` and the bound; the stem also in bf16;
 25. card against CPU: one step of each SpUNet recipe at batch 1 at its
     slot (the ScanNet recipe at one block per stage, ``SCANNET_CPU_LAYERS``):
     loss, every gradient and the running statistics within
     ``TRAIN_CPU_TOL``, the card's step taking the CPU's side of each ReLU
     whose input lies within ``RELU_TIE`` of 0 (each such tie printed; a
     decision that differs farther out fails); printed beside it, the
     card's gradient error without that rule, as the path runs and with the
     segment sums in the CPU's row order (two steps, bit for bit or not);
 26. insseg_r3 anchor: ``exp/insseg_r3`` (PG-v1m1 over SpUNet, k=3 stem) through
     the port's InsSegTester on the card and on the CPU over its 6 val scenes
     (np.random seeded 7): each forward launching B3 17 times and building 5
     rulebooks, shifts and probabilities card against CPU within
     ``CPU_TOL``, cluster labels compared, mAP >= 0.70 and AP50, AP25 >=
     0.85 on the card and within ``INSSEG_AP_TOL`` of the CPU; then the
     ``test`` CLI over ``exp/insseg_r3/config.py`` on the card, reading the
     tester's AP exactly;
 27. insseg r3 trainer: ``configs/synthetic/insseg-pointgroup-r3.py`` as
     written (batch 4, slot 4096, AdamW under PolyLR), its first epoch (12
     steps, each launching B3 33 and B4 17 times, 5 rulebooks, f32), then
     InsSegEvaluator (forward, kNN and label-propagation times) and the
     saver, a profiled step, each of the four losses (the total, seg, bias,
     dir) falling over 4 steps on a fixed batch; B3 and B4 at every conv
     shape on its maps against their plain versions and timed per step; one
     step at batch 1 card against CPU (as phase 25);
 28. ScanNet PG-v1m1 trainer: ``configs/scannet/insseg-pointgroup-v1m1-0-
     spunet-base.py`` as written (batch 8, slot 131072, k=5 stem, SGD 0.05
     nesterov under PolyLR, Mix3D 0.8, f32) on synthetic 100,000-point rooms
     through all its transforms (the six ScanNet-only ones included; coord +
     color features), as phase 27 at its shapes (B3 93, B4 47, 6 rulebooks
     a step; the fixed-batch probe takes ``PG_PROBE_STEPS``, as SGD 0.05
     first swings the shift loss up), the evaluator over one val batch of 8
     rooms;
 29. ScanNet PG-v1m2 trainer: ``configs/scannet/insseg-pointgroup-v1m2-0-
     ptv3-base.py`` as written in amp bf16 (Mix3D 0.8, AdamW under
     OneCycleLR) at batch 2 (``SCANNET_BATCH``), as phase 13 (B1-B4 in bf16,
     f32 parameters and gradients) with the InsSegEvaluator; B1-B4 at its
     levels in bf16 against their plain versions and timed per step;
 30. connected components card against CPU: on one insseg r3 val batch with
     exp/insseg_r3's weights, the card's inputs clustered on both devices
     give equal labels; each device's own forward's labels differ only
     where a predicted class or a connecting kNN edge does (counted);
 31. keypoint serve: ``serve --task keypoint`` with ``configs/my_dataset/
     keypoint_ptv3_plus.py`` (PT-v3plus: a bottleneck xCPE of K = 125 at
     width 16 in every Block) and with ``keypoint_ptv3.py``, full width, slot
     8192, seeded weights: 1 warm-up and 3 POSTs of ~20k-point clouds each (B1
     and B3 once per Block, 5 rulebooks), one request under torch.profiler,
     and each reply against the CPU port's within ``CPU_TOL`` x the cloud's
     scale;
 32. KeypointPTv3Plus recipe as written (batch 8, slot 8192, AdamW under
     cosine, Dropout, drop path 0.3) through ``KeypointDataset`` on seeded
     N x 7 pig clouds the script writes in the reader's layout: its first
     epoch (4 steps, B1 22, B2 22, B3 44, B4 22, 5 rulebooks each), the
     KeypointEvaluator and the saver, the slots' fill, a profiled step, the
     loss falling over 4 steps on a fixed batch;
 33. K = 125 kernels: B3 and B4 at Cin = Cout = 16 on PT-v3plus's maps of a
     training batch and of a request, every level, f32 and bf16 against their
     plain versions, bit for bit run to run, timed per step and per request
     beside their plain versions, the gather + ``torch.matmul`` and the bound;
 34. card against CPU: one KeypointPTv3Plus step at the recipe's widths with
     one Block per stage, batch 2 (the head's BatchNorm over one pooled row
     would pass the backbone no gradient), the card on the CPU's side of each
     ReLU tie;
 35. other recipes through their readers, the first epoch (4 steps) of each:
     ``keypoint_sparse_unet.py`` (KeypointSparseUNet, B3 and B4 at K = 27 and
     the K = 125 stem), ``ptv3_weight.py`` (PigBodyRegressor,
     RegressionL1Loss, PigWeightDataset) and ``offset_keypoint_ptv3.py`` as
     written (OffsetKeypointDataset with online offsets, its evaluator);
 36. ``infer_offset`` on the card over the written val clouds with the
     offset recipe's trained weights;
 37. OctFormer and Swin3D serve: ``serve --task keypoint`` with
     ``configs/my_dataset/keypoint_octformer.py`` (B3 12 per request at the
     CPE's K = 27, 4 rulebooks, no B1) and ``serve --task offset_keypoint``
     with ``offset_keypoint_swin3d.py`` (no kernel launch: its windowed
     attention with the cRSE is plain torch), full width, slot 8192, seeded
     weights, 1 warm-up and 3 POSTs of ~20k-point clouds each, one request
     of each under torch.profiler, each reply against the CPU port's
     (``CPU_TOL`` x the cloud's scale; the offset head through phase 5's
     check);
 38. OctFormer and Swin3D trained: ``keypoint_octformer.py`` (B3 24, B4 12, 4
     rulebooks a step) and ``keypoint_swin3d_plus.py`` (KeypointSwin3DVote,
     no kernel) as written through ``KeypointDataset`` on the written pig
     clouds, as phase 32; then one step of each card against CPU at batch 2
     with ``CPU_STEP_DEPTHS`` (the dilated and the shifted Block run);
 39. OctFormer kernels: B3 and B4 at K = 27, Cin = Cout = 96, 192, 384 on the
     maps of a training batch and of a request at every level, f32 against
     their plain versions, bit for bit run to run, timed per step and per
     request beside the gather + ``torch.matmul`` and the bound;
 40. the pig users' tools, each on the card and with ``--device cpu``, outputs
     compared and wall times printed: ``inference_split`` over the written
     val split with ``keypoint_octformer.py``; ``batch_infer_export_txt``
     over bare-xyz ``.npy`` and ascii ``.pcd`` scans with
     ``offset_keypoint_swin3d.py``; ``infer_npy`` on a ~30k-point pig scene
     with ``semseg-octformer-v1m1-0-base.py``; ``evaluate_all_splits`` over
     ``semseg-spunet-r3-test.py`` with ``exp/semseg_r3`` (train and val);
 41. the fork's last four keypoint backbones: ``keypoint_oa_cnns.py``
     (OA-CNNs: B3 23 per request, 4 rulebooks), ``keypoint_ptv2.py``
     (PT-v2m2, brute kNN at slot 8192), ``keypoint_ptv1.py`` (PT-v1, farthest
     point sampling) and ``keypoint_stratified_transformer.py`` (ST-v1m2, the
     KPConv stem over ``knn_bucketed``) served as phase 37 (the first reply
     against the CPU's), FPS's and the kNN searches' host-clock share of a
     request, each recipe trained through ``KeypointDataset`` on the written
     clouds as phase 38 (OA-CNNs B3 45, B4 23, 4 rulebooks a step; the others
     no kernel), one step of each card against CPU at batch 2 with one Block
     per stage, and B3 and B4 at every OA-CNNs conv shape (K = 27, Cin ->
     Cout 4 -> 32 through 256 -> 128) on the maps of a step and a request,
     f32 against their plain versions, bit for bit, timed per step and per
     request beside the gather + ``torch.matmul`` and the bound;
 42. SemanticKITTI: seeded scans of 120,000 points (64 rings x 1,875
     azimuths cast onto a street: road, facades, end walls, poles, cars;
     raw ids 40, 50, 80, 10) written in the raw layout for sequences 00
     (train) and 08 (val), read back through the port's reader exactly,
     their voxels' fill of the 131,072 slot printed; the SLAM bridge's
     labeller (``SemanticScanPredictor``) over ``semseg-ptv3-base.py``
     (PT-v3m1: B1 22, B3 22, 5 rulebooks a scan),
     ``semseg-minkunet34c-0-base.py`` (B3 47, 6 rulebooks) and
     ``semseg-spvcnn-v1m1-0-base.py`` (B3 23, 4 rulebooks) at slot 131,072:
     a warm-up and 3 timed scans, one profiled, one card against CPU
     (logits within ``CPU_TOL``, labels apart only on a near tie, the
     embedding within ``CPU_TOL``); each recipe trained as written through
     ``DefaultTrainer`` on the tree (batch 8, f32, Mix3D 0.8,
     its first epoch of 4 steps with the evaluator and the saver: PT-v3m1
     B1 22, B2 22, B3 44, B4 22; MinkUNet34C B3 93, B4 47; SPVCNN B3 46, B4
     23 a step), a profiled step, the loss falling on a fixed batch; one
     step of each at batch 1 and slot ``KITTI_CPU_SLOT`` card against CPU
     (MinkUNet34C and SPVCNN with ``ReluTies``); B1 and B2 at every PT-v3m1
     level (up to 1,048,576 rows, patch 128, head dim 16) and B3 and B4 at
     every conv shape of the three (MinkUNet34C's K = 125 stem at Cin 4
     padded to 8, its and SPVCNN's K = 27 convs) against their plain
     versions on the runs' maps, bit for bit run to run, timed per step and
     per scan beside their library calls and bounds;
 43. SLAM: the 175-frame loop circuit (``tools/make_synthetic_kitti.py``
     with ``configs/slam/synth_loop.py``'s header flags) through the port's
     ``run_slam`` on the card: ``synth_loop.py`` (odometry, ground-truth
     labels; ATE <= 0.05 m) and ``synth_loop_full.py`` (keyframes, loop
     closure, pose graph: live ATE <= 0.05 m, retro-corrected ATE <= 0.065
     m, at least one closure, the counts beside JAX's CPU reading), each
     scan's host ms and scans/s, one scan under torch.profiler and one under
     CUDA's sync debug mode (one host read a scan: the pose); the first 20
     frames on the CPU against the card (2e-3 m, 1e-3 rad a frame); the
     model-label path (PT-v3m1 at slot 131,072, seeded weights) over 10
     frames on the card (B1 22, B3 22 a scan, the share of points the
     filter drops), 2 of its scans card against CPU as phase 42, the card's
     labels through a CPU odometry against the card's poses; B1 on a
     circuit scan's own attention inputs and B3 on its maps against their
     plain versions, timed per scan;
 44. summary: the script's duration, the kernels line (per keypoint training
     step: launches, errors and times of the training levels; B1 and B3 also
     per bench forward in bf16; B1-B4 per pigseg step, ``pigseg_*``, and per
     amp step, ``amp_*``; per r3 step, ``r3_step_*``, and B1 and B3 per r3
     request, ``r3_request_*``, with ``r3_max_abs_err``; per ScanNet SpUNet
     step, ``scannet_spunet_*``, and per semseg_r3 step, ``semseg_r3_step_*``;
     B3 and B4 per launch at the K = 125 stem, ``k125_*`` and
     ``k125_bf16_*``; B3 and B4 per insseg r3 step, ``insseg_r3_step_*``,
     and per ScanNet PG-v1m1 step, ``insseg_scannet_*``; B1-B4 per PG-v1m2
     amp step, ``insseg_amp_*``; B1-B4 per KeypointPTv3Plus step,
     ``kp_plus_step_*``, and B1 and B3 per request, ``kp_plus_request_*``;
     B3 and B4 per OctFormer step, ``octformer_step_*``, and B3 per request,
     ``octformer_request_*``; B3 and B4 per OA-CNNs step, ``oacnns_step_*``,
     and B3 per request, ``oacnns_request_*``; per SemanticKITTI step and
     scan of PT-v3m1, MinkUNet34C and SPVCNN, ``kitti_{ptv3,mink,spvcnn}_
     {step,scan}_*``), then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import expit

from pointcept_keypointdetection_tpu_torch import (
    batch_infer_export_txt,
    bench,
    evaluate_all_splits,
    infer_npy,
    infer_offset,
    inference_split,
    serve,
)
from pointcept_keypointdetection_tpu_torch import run_slam
from pointcept_keypointdetection_tpu_torch import test as test_cli
from pointcept_keypointdetection_tpu_torch.convert import load_jax_checkpoint, load_weights
from pointcept_keypointdetection_tpu_torch.datasets import build_dataset
from pointcept_keypointdetection_tpu_torch.datasets import semantic_kitti as semantic_kitti_module
from pointcept_keypointdetection_tpu_torch.datasets.collate import collate
from pointcept_keypointdetection_tpu_torch.datasets.dataloader import Dataloader
from pointcept_keypointdetection_tpu_torch.datasets.synthetic import SyntheticKeypointDataset, body_cloud, make_pig
from pointcept_keypointdetection_tpu_torch.engines import test as test_module
from pointcept_keypointdetection_tpu_torch.engines.common import build_point_batch, sample_to_device
from pointcept_keypointdetection_tpu_torch.engines.hooks.insseg_evaluator import InsSegEvaluator
from pointcept_keypointdetection_tpu_torch.engines.hooks.keypoint_evaluator import keypoint_distances
from pointcept_keypointdetection_tpu_torch.engines.test import InsSegTester
from pointcept_keypointdetection_tpu_torch.engines.train import Trainer
from pointcept_keypointdetection_tpu_torch.inference.keypoint import (
    OffsetKeypointPredictor,
    aggregate_keypoints,
    estimate_normals_curvature,
)
from pointcept_keypointdetection_tpu_torch.inference.segment import SegmentPredictor
from pointcept_keypointdetection_tpu_torch.inference import semantic_scan
from pointcept_keypointdetection_tpu_torch.inference.semantic_scan import SemanticScanPredictor
from pointcept_keypointdetection_tpu_torch.kernels import _build
from pointcept_keypointdetection_tpu_torch.kernels import patch_attention as pa
from pointcept_keypointdetection_tpu_torch.kernels import sparse_conv as sc
from pointcept_keypointdetection_tpu_torch.models import build_model, cast_parameters, init_weights
from pointcept_keypointdetection_tpu_torch.models import octformer as octformer_module
from pointcept_keypointdetection_tpu_torch.models import point_transformer, point_transformer_v2
from pointcept_keypointdetection_tpu_torch.models import sparse_unet as spunet_module
from pointcept_keypointdetection_tpu_torch.models import stratified_transformer
from pointcept_keypointdetection_tpu_torch.models.losses import build_criteria
from pointcept_keypointdetection_tpu_torch.ops import cluster as cluster_module
from pointcept_keypointdetection_tpu_torch.ops import sparse as sp
from pointcept_keypointdetection_tpu_torch.ops.segment import segment_mean, segment_mean_in_order, segment_sum_in_order
from pointcept_keypointdetection_tpu_torch.ops.serialization import z_order_encode_np
from pointcept_keypointdetection_tpu_torch.slam.pipeline import LidarOdometry, OdometryConfig
from pointcept_keypointdetection_tpu_torch.utils.checkpoint import load_checkpoint
from pointcept_keypointdetection_tpu_torch.utils.config import Config
from pointcept_keypointdetection_tpu_torch.utils.events import EventStorage
from pointcept_keypointdetection_tpu_torch.utils.misc import intersection_and_union

CONFIG = "configs/my_dataset/offset_keypoint_ptv3.py"
REQUESTS = 3
CLOUD_POINTS = 20000
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FFMA and bf16 tensor-core flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# TF32 tensor cores: B1-B4 run f32 as 3xTF32, three TF32 products per f32 product
PEAK_TF32 = 495e12
EX2_PER_CLOCK_PER_SM = 16  # MUFU exponentials (ex2), the floor of B1's and B2's softmax work
MAX_SM_MHZ = 0.0
L2_BYTES = 50 * 2**20
# (atol, rtol); both sides compute in f32 and round the output once, so bf16 may differ by one ulp (2^-7 |x|)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 8e-3)}
# card vs CPU, relative to max(1, |cpu|): f32 through 22 blocks in two summation orders read 3.2e-6
CPU_TOL = 1e-4
# B4 sums each entry's products in f32 in another order than the plain einsum: relative to max|dW|, per
# DW_SUM products in the longest sum (an f32 sum's rounding grows with its length); the readings reach
# 2.8e-6 (f32) and 1.5e-6 (bf16) at up to 65,536 products, and 2.4e-6 (f32) and 1.0e-5 (bf16) at the
# segmentation trainers' 163,423-262,144
DW_TOL = 1e-5
DW_SUM = 65536
# one training step, card against CPU, relative to max(1, |cpu|) per tensor: the readings were 0 (loss),
# 3.2e-5 (gradients, f32 sums in other orders through 22 Blocks and back) and 1.2e-7 (running statistics)
TRAIN_CPU_TOL = 1e-3
# an SpUNet step's ReLU input within this of 0, relative to max(1, max|x|) of its tensor, is a tie that
# rounding decides (CPU_TOL: how far the card's forward may lie from the CPU's); the ties of the batch-1
# semseg_r3 step lie at |x| <= 1.9e-6 of max|x| > 1
RELU_TIE = CPU_TOL
TRAIN_EPOCHS = 2  # of 2 steps each
GATHER_BYTES = 2**31  # a plain conv's f32 gather past which its timing takes one input set
CARD = ""


def stamp() -> str:
    return f"[{CARD}]"


def request_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """A body-like cloud as the server receives it: [n, 7] = xyz (mm), normal, curvature."""
    coord = body_cloud(rng, n)
    return np.concatenate([coord, estimate_normals_curvature(coord)], axis=1)


def copies_for(nbytes: int) -> int:
    """Input sets whose bytes together are at least twice the L2."""
    return max(4, -(-2 * L2_BYTES // nbytes))


def cuda_ms(fn, cases, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: one call per input set of ``cases``, captured in a
    CUDA graph, one replay between two events.  Each call reads its own set, and the sets
    together exceed the L2 twice over, so the calls read their inputs from HBM.  Launched
    one by one, a call's host time (Python, ctypes) exceeds the device time of the smaller
    kernels, and the events would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in cases[:warmup]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in cases:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(cases)


# ---- the slice's kernel shapes ------------------------------------------------------------------


def level_shapes(bb, slot: int):
    """(N, channels, heads, patch, Blocks) of every Block level of the backbone dict ``bb`` at ``slot``."""
    caps = []
    for s, p in enumerate(bb["enc_patch_size"]):
        cap = max(slot // bb["slot_divisors"][s], p)
        caps.append(-(-cap // p) * p)
    shapes = [(caps[s], bb["enc_channels"][s], bb["enc_num_head"][s], bb["enc_patch_size"][s], bb["enc_depths"][s])
              for s in range(len(caps))]
    shapes += [(caps[s], bb["dec_channels"][s], bb["dec_num_head"][s], bb["dec_patch_size"][s], bb["dec_depths"][s])
               for s in range(len(bb["dec_depths"]))]
    return shapes


def surface_kernel_map(rng: np.random.Generator, n: int, z_sorted: bool, valid_frac: float = 0.88):
    """A real k=3 map from ``build_kernel_map`` over n voxel rows of a surface cloud, pads last.

    Rows are in the cloud's input order, as at stage 0 of a request, or with
    ``z_sorted`` in z order, as ``slotted_unique`` leaves the pooled stages."""
    pts = body_cloud(rng, 4 * n) / 1000.0
    grid_size = 0.1
    while True:
        grid = np.floor((pts - pts.min(0)) / grid_size).astype(np.int64)
        _, first = np.unique(z_order_encode_np(grid), return_index=True)
        if len(first) >= int(n * valid_frac):
            break
        grid_size *= 0.85
    nv = int(n * valid_frac)
    g = np.zeros((n, 3), np.int32)
    g[:nv] = grid[np.sort(rng.choice(first, nv, replace=False))]
    if z_sorted:
        g[:nv] = g[np.argsort(z_order_encode_np(g[:nv]), kind="stable")]
    valid = torch.zeros(n, dtype=torch.bool)
    valid[:nv] = True
    grid_t, batch = torch.from_numpy(g).cuda(), torch.zeros(n, dtype=torch.int64, device="cuda")
    valid = valid.cuda()
    index = sp.build_voxel_index(grid_t, batch, valid)
    return sp.build_kernel_map(index, grid_t, batch, valid, sp.SparseConvSpec.cube(3)).neighbor_idx


def card_generator(rng: np.random.Generator) -> torch.Generator:
    """A generator on the card seeded from ``rng``: large inputs are drawn there, not on the host."""
    return torch.Generator(device="cuda").manual_seed(int(rng.integers(2**62)))


def card_normal(rng: np.random.Generator, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=card_generator(rng), device="cuda").to(dtype)


def stem_convs(bb) -> int:
    """B3 launches of the stem per forward: 1 where it is a sparse conv (k <= 3), 0 for the cell-packed k=5."""
    return int(bb.get("stem_kernel", 5) <= 3)


def attention_case(rng, n, heads, patch, dtype):
    gen = card_generator(rng)
    qkv = torch.randn((n, 3, heads, 16), generator=gen, device="cuda").to(dtype)
    valid = torch.rand(n, generator=gen, device="cuda") > 0.12
    valid[patch : 2 * patch] = False  # one patch without a valid key
    return qkv, valid


def conv_case(rng, idx, c, dtype, cin=None):
    """Features [N, cin] and W [K, cin, c] (cin defaults to c) for the map ``idx`` [N, K]."""
    n, k = idx.shape
    cin = cin or c
    feat = card_normal(rng, (n, cin), dtype)
    w = (card_normal(rng, (k, cin, c)) / np.sqrt(k * cin)).to(dtype)
    return feat, w


def padded(feat, w):
    """What the kernels read where Cin is not a multiple of 8 (SubmConvFunction's zero channels)."""
    pad = -feat.shape[1] % sc.CHANNELS
    return (F.pad(feat, (0, pad)), F.pad(w, (0, 0, 0, pad))) if pad else (feat, w)


# ---- phases ---------------------------------------------------------------------------------------


def phase_device() -> str:
    global CARD, MAX_SM_MHZ
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    CARD = smi.splitlines()[0]
    print(smi)
    MAX_SM_MHZ = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                      capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {torch.cuda.get_device_name(0)}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    return CARD


def ptxas_summary(log: str):
    """One line per kernel from nvcc's -Xptxas -v output: its name and template arguments, then
    its registers and shared memory and its spills."""
    kernel, spills = "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:  # the mangled name: <length><name>I<template arguments>E...
            kernel = mangled = entry.group(1)
            end = mangled.find("_kernelI") + len("_kernel")
            for start in range(end):  # the name is the one whose length prefix ends at `start`
                if mangled[:start].endswith(str(end - start)):
                    args = re.match(r"I(\w*?)E+v", mangled[end:])
                    args = args.group(1).replace("13__nv_bfloat16", "bf16").replace("Li", ",") if args else ""
                    kernel = f"{mangled[start:end]}<{'f32' + args[1:] if args.startswith('f') else args}>"
                    break
        elif "spill" in line:
            spills = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}"


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        print(f"built {_build.library_path(name).name}")
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in ptxas_summary(log.read_text()):
                print(f"  ptxas {name}: {line}")
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, one process per source, in parallel)")


def check(label: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(got).all())
    print(f"{label}: max_abs_err={err:.3e} max|ref|={ref.float().abs().max().item():.3e} "
          f"tol=atol {atol:.3g} + rtol {rtol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def check_attention(rng, n, heads, patch, dtype) -> float:
    qkv, valid = attention_case(rng, n, heads, patch, dtype)
    return check(f"B1 patch_attention N={n} H={heads} D=16 patch={patch} {str(dtype)[6:]}",
                 pa.patch_attention(qkv, valid, patch, 16**-0.5), pa.patch_attention_plain(qkv, valid, patch, 16**-0.5),
                 *TOL[dtype])


def check_conv(rng, idx, c, dtype, cin=None) -> float:
    """B3 against its plain version: Cout ``c``, Cin ``cin`` (default ``c``; zero-padded for the kernel
    where it is not a multiple of 8, as the path pads it)."""
    n, k = idx.shape
    feat, w = conv_case(rng, idx, c, dtype, cin)
    fk, wk = padded(feat, w)
    widths = f"Cin=Cout={c}" if cin in (None, c) else f"Cin={cin} Cout={c}"
    return check(f"B3 subm_conv N={n} {widths} K={k} hits={int((idx < n).sum())} {str(dtype)[6:]}",
                 sc.subm_conv(fk, idx, wk), sc.subm_conv_plain(feat, idx, w), *TOL[dtype])


def edge_case_map(rng, n: int = 1000):
    """A surface map of n rows (not a multiple of the kernels' 64-row tile) whose 15% pad rows fill
    whole tiles, with offsets 0 and 26 (a mirrored pair) hit by no row."""
    idx = surface_kernel_map(rng, n, z_sorted=True, valid_frac=0.85)
    idx[:, 0] = n
    idx[:, 26] = n
    return idx


def check_conv_dw(rng, idx, c, dtype, cin=None) -> float:
    """B4 against its plain version (Cin ``cin``, default ``c``, zero-padded for the kernel and cut back)."""
    n, k = idx.shape
    feat, w = conv_case(rng, idx, c, dtype, cin)
    g = card_normal(rng, (n, c), dtype)
    ref = sc.subm_conv_dw_plain(feat, idx, g)
    got = sc.subm_conv_dw(padded(feat, w)[0], idx, g)[:, :feat.shape[1]]
    longest = int((idx < n).sum(0).max())  # products summed into one entry of dW
    widths = f"Cin=Cout={c}" if cin in (None, c) else f"Cin={cin} Cout={c}"
    return check(f"B4 subm_conv_dw N={n} {widths} K={k} hits={int((idx < n).sum())} longest sum {longest} "
                 f"{str(dtype)[6:]}", got, ref, DW_TOL * max(1.0, longest / DW_SUM) * ref.abs().max().item(), 0.0)


def check_conv_bits(rng, idx, c, dtype, cin=None) -> None:
    """B3 and B4 twice on one input, one rulebook: equal bits (fixed summation orders, no atomics)."""
    n = idx.shape[0]
    feat, w = padded(*conv_case(rng, idx, c, dtype, cin))
    rb = sc.build_rulebook(idx)
    runs = {"B3": lambda: sc.subm_conv(feat, idx, w, rb), "B4": lambda: sc.subm_conv_dw(feat, idx, feat, rb)}
    for name, fn in runs.items():
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{name} N={n} C={c} {dtype}: two runs on one input differ")
    print(f"B3, B4 N={n} C={c} {str(dtype)[6:]}: two runs give equal bits")


def phase_conv_edge_cases(rng) -> None:
    """B3 and B4 on a map with all-pad tiles, two offsets that no row hits and N not a multiple of
    the tile, at C = 32 and C = 512, and at C = 40 (a partial step of 32 input channels and a partial
    tile of 64 output columns), in f32 and bf16, and their bits run to run."""
    idx = edge_case_map(rng)
    rb = sc.build_rulebook(idx)
    n = idx.shape[0]
    print(f"edge-case map N={n}: {int((idx[:, 13] < n).sum())} valid rows, {rb.busy_tiles} busy of {-(-n // sc.TILE)} "
          f"tiles, hits per offset {rb.hits}")
    if rb.busy_tiles * sc.TILE > n - sc.TILE or rb.hits[0] or rb.hits[26]:
        raise AssertionError("the edge-case map lacks an all-pad tile or an offset without hits")
    for c in (32, 40, 512):
        for dtype in (torch.float32, torch.bfloat16):
            check_conv(rng, idx, c, dtype)
            check_conv_dw(rng, idx, c, dtype)
            check_conv_bits(rng, idx, c, dtype)


def phase_kernels(cfg):
    """B1, B2 and B3 against their plain versions at every serving shape; returns the surface maps."""
    rng = np.random.default_rng(0)
    maps = {}
    for dtype in (torch.float32, torch.bfloat16):  # the key tiles of a patch of 1024 (bench.py's)
        check_attention(rng, cfg.slot_size, 4, 1024, dtype)
    for n, c, heads, patch, _ in level_shapes(cfg.model.backbone_conf, cfg.slot_size):
        if n not in maps:
            maps[n] = surface_kernel_map(rng, n, z_sorted=n < cfg.slot_size)
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(rng, n, heads, patch, dtype)
            check_attention_bwd(rng, n, heads, patch, dtype)
            check_conv(rng, maps[n], c, dtype)
    return maps


def phase_serve(predictor, clouds, backbone, check_reply, expect=None):
    """POSTs through the server, one per cloud; returns the latencies and the launch counts of the run.
    ``check_reply(i, cloud, reply)`` raises on a wrong reply.  ``expect``: (B1, B3, rulebooks) per
    request, by default a PT-v3 backbone's (one of each per Block, one rulebook per level)."""
    if expect is None:
        per_request = sum(backbone.enc_depths) + sum(backbone.dec_depths)
        expect = (per_request, per_request + stem_convs(backbone), len(backbone.enc_depths))
    server = serve.make_server(predictor, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies = []
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/predict?cols=7"
        pa.launches = 0
        sc.launches = 0
        sc.rulebook_builds = 0
        for i, cloud in enumerate(clouds):
            before = (pa.launches, sc.launches, sc.rulebook_builds)
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=cloud.astype(np.float32).tobytes(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                reply = np.frombuffer(r.read(), np.float32)
            latencies.append((time.perf_counter() - t0) * 1e3)
            delta = (pa.launches - before[0], sc.launches - before[1], sc.rulebook_builds - before[2])
            print(f"request {i}: {cloud.shape[0]} points -> reply {reply.size} floats, "
                  f"{latencies[-1]:.1f} ms, launches B1 +{delta[0]} B3 +{delta[1]}, rulebooks built +{delta[2]}")
            check_reply(i, cloud, reply)
            if delta != expect:  # one kernel map, so one rulebook, per level; the stem shares stage 0's
                raise AssertionError(f"request {i}: expected launches of B1 and B3 and rulebooks {expect}, got {delta}")
        counts = {"patch_attention_fwd": pa.launches, "subm_conv_fwd": sc.launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("the server thread did not stop")
    print(f"serve: {len(clouds)} requests answered; launches {counts}")
    return latencies, counts


def check_keypoints(i, cloud, reply) -> None:
    if reply.shape != (18,) or not np.isfinite(reply).all():
        raise AssertionError(f"request {i}: expected 6 x 3 finite floats, got {reply}")


def phase_cpu(cfg, predictor, cloud, cpu=None) -> None:
    """The card's and the CPU's outputs on one request; an argmax keypoint may differ only where
    the CPU's two best logits are closer than twice the measured logit error (a tie it can flip).
    ``cpu``: the CPU predictor with the card's weights (built here where not given)."""
    if cpu is None:
        state = {k: v.detach().cpu() for k, v in predictor.model.state_dict().items()}
        cpu = OffsetKeypointPredictor(dict(cfg.model), state, cfg.slot_size, device="cpu")
    coord, feat = cloud[:, :3], cloud[:, 3:]
    gpu_res, cpu_res = predictor.infer(coord, feat), cpu.infer(coord, feat)
    np.testing.assert_array_equal(gpu_res["coord"], cpu_res["coord"])
    errs = {}
    for key in ("offset_pred", "mask_logits"):
        a, b = gpu_res[key], cpu_res[key]
        err = errs[key] = float(np.abs(a - b).max())
        scale = float(np.abs(b).max())
        print(f"card vs cpu {key} {a.shape}: max_abs_err={err:.3e} (|cpu| max {scale:.3f}) "
              f"tol={CPU_TOL:g} x max(1, |cpu| max)")
        if not (np.isfinite(a).all() and err <= CPU_TOL * max(1.0, scale)):
            raise AssertionError(f"card and CPU disagree on {key}")
    for method in ("argmax", "weighted"):
        kps = []
        for res in (gpu_res, cpu_res):
            prob = expit(res["mask_logits"])
            kps.append(aggregate_keypoints(res["coord"], res["offset_pred"], prob, method) * res["scale"]
                       + res["centroid"])
        err = float(np.abs(kps[0] - kps[1]).max())
        tol = CPU_TOL * gpu_res["scale"]
        print(f"card vs cpu keypoints ({method}): max_abs_err={err:.3e} mm tol={tol:.3e} mm")
        if err > tol:
            cpu_prob = cpu_res["mask_logits"]
            gpu_arg = gpu_res["mask_logits"].argmax(0)
            gap = float(np.abs(cpu_prob.max(0) - cpu_prob[gpu_arg, np.arange(cpu_prob.shape[1])]).max())
            tie = 2 * errs["mask_logits"]
            if method == "weighted" or gap > tie:
                raise AssertionError(f"card and CPU keypoints disagree ({method}), logit gap {gap:.3e}")
            print(f"  argmax picks differ on a near tie (logit gap {gap:.3e} <= {tie:.3e})")


# ---- the training slice -----------------------------------------------------------------------------


def train_shapes(cfg):
    """(N, channels, heads, patch, Blocks) of every training Block level: serving slots x batch."""
    return [(n * cfg.batch_size, c, h, p, d) for n, c, h, p, d in level_shapes(cfg.model.backbone_conf, cfg.slot_size)]


def training_maps(cfg) -> dict:
    """{N: kernel map} of every training level, from the first batch of the trainer's data pipeline
    (``train_config``, seed 0) through a forward of the full-width model: the maps depend on the
    points only, not on the weights or on the order shuffles."""
    tcfg = train_config()
    np.random.seed(0)
    loader = Dataloader(build_dataset(dict(tcfg.data.train)), batch_size=tcfg.batch_size,
                        slot_size=tcfg.slot_size, seed=0, prefetch=0)
    batch_np = next(iter(loader))
    model = build_model(dict(tcfg.model)).cuda().eval()
    make, maps = model.backbone._kernel_map, {}

    def record(*args, **kwargs):
        kmap = make(*args, **kwargs)
        maps[kmap.neighbor_idx.shape[0]] = kmap.neighbor_idx
        return kmap

    model.backbone._kernel_map = record
    with torch.no_grad():
        model(build_point_batch(sample_to_device(batch_np, "cuda"), batch_np["num_samples"]))
    want = sorted({n for n, *_ in train_shapes(cfg)})
    if sorted(maps) != want:
        raise AssertionError(f"the training forward built maps of {sorted(maps)} rows, expected {want}")
    for n, idx in sorted(maps.items(), reverse=True):
        print(f"training map N={n}: {int((idx < n).sum())} hits, {int((idx[:, 13] < n).sum())} valid rows")
    return maps


def attention_bwd_case(rng, n, heads, patch, dtype):
    qkv, valid = attention_case(rng, n, heads, patch, dtype)
    g = card_normal(rng, (n, heads * 16), dtype)
    _, lse, out32 = pa.patch_attention_with_lse(qkv, valid, patch, 0.25)
    return qkv, valid, out32, lse, g


def check_attention_bwd(rng, n, heads, patch, dtype) -> float:
    qkv, valid, out32, lse, g = attention_bwd_case(rng, n, heads, patch, dtype)
    got = pa.patch_attention_backward(qkv, valid, out32, lse, g, patch, 0.25)
    ref = pa.patch_attention_backward_plain(qkv, valid, g, patch, 0.25)
    return check(f"B2 patch_attention_bwd N={n} H={heads} D=16 patch={patch} {str(dtype)[6:]}", got, ref,
                 *TOL[dtype])


def check_attention_bits(rng, n, heads, patch, dtype) -> None:
    """B1 (with and without the log-sum-exp) and B2 twice on one input, which holds a patch without a
    valid key: equal bits (fixed summation orders, no atomics)."""
    qkv, valid, out32, lse, g = attention_bwd_case(rng, n, heads, patch, dtype)
    runs = {"B1": lambda: pa.patch_attention(qkv, valid, patch, 0.25),
            "B1 with lse": lambda: torch.cat([t.float().flatten() for t in pa.patch_attention_with_lse(qkv, valid,
                                                                                                       patch, 0.25)]),
            "B2": lambda: pa.patch_attention_backward(qkv, valid, out32, lse, g, patch, 0.25)}
    for name, fn in runs.items():
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{name} N={n} H={heads} patch={patch} {dtype}: two runs on one input differ")
    print(f"B1, B2 N={n} H={heads} patch={patch} {str(dtype)[6:]} (one patch without a valid key): "
          f"two runs give equal bits")


def phase_train_kernels(cfg, maps):
    """All four kernels against their plain versions at every training shape, the conv kernels on
    the trainer's maps, and the autograd Functions; returns each kernel's largest f32 error."""
    rng = np.random.default_rng(3)
    errors = dict.fromkeys(("patch_attention_fwd", "patch_attention_bwd", "subm_conv_fwd", "subm_conv_dw"), 0.0)
    for dtype in (torch.float32, torch.bfloat16):  # the key tiles of a patch of 1024 (bench.py's)
        err = check_attention_bwd(rng, cfg.slot_size, 4, 1024, dtype)
        if dtype == torch.float32:
            errors["patch_attention_bwd"] = max(errors["patch_attention_bwd"], err)
        check_attention_bits(rng, cfg.slot_size, 4, 1024, dtype)
    for n, c, heads, patch, _ in train_shapes(cfg):
        idx = maps[n]
        for dtype in (torch.float32, torch.bfloat16):
            found = {"patch_attention_fwd": check_attention(rng, n, heads, patch, dtype),
                     "patch_attention_bwd": check_attention_bwd(rng, n, heads, patch, dtype),
                     "subm_conv_fwd": check_conv(rng, idx, c, dtype)}
            found["subm_conv_dw"] = check_conv_dw(rng, idx, c, dtype)
            check_attention_bits(rng, n, heads, patch, dtype)
            if dtype == torch.float32:
                for name, err in found.items():
                    errors[name] = max(errors[name], err)
                check_conv_bits(rng, idx, c, dtype)
    phase_conv_edge_cases(rng)

    # the Functions against autograd of the plain forwards, at the first training level
    n, c, heads, patch, _ = train_shapes(cfg)[0]
    idx = maps[n]
    feat0, w0 = conv_case(rng, idx, c, torch.float32)
    g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).cuda()
    grads = []
    for fn in (sc.SubmConvFunction.apply, sc.subm_conv_plain):
        feat, w = feat0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(feat, idx, w) * g).sum().backward()
        grads.append((feat.grad, w.grad))
    for name, got, ref in zip(("dfeat (B3, mirrored W)", "dW (B4)"), *grads):
        check(f"SubmConvFunction {name} vs autograd of the plain forward N={n} C={c}", got, ref,
              TOL[torch.float32][0] * max(1.0, ref.abs().max().item()), TOL[torch.float32][1])
    qkv0, valid = attention_case(rng, n, heads, patch, torch.float32)
    g = torch.from_numpy(rng.normal(size=(n, heads * 16)).astype(np.float32)).cuda()
    grads = []
    for fn in (pa.PatchAttentionFunction.apply, pa.patch_attention_plain):
        qkv = qkv0.clone().requires_grad_()
        (fn(qkv, valid, patch, 0.25) * g).sum().backward()
        grads.append(qkv.grad[valid])  # valid rows: autograd of the plain forward gates dS by the mask
    check(f"PatchAttentionFunction dqkv vs autograd of the plain forward N={n} H={heads} (valid rows)",
          grads[0], grads[1], *TOL[torch.float32])
    return errors


def launch_counts():
    return {"patch_attention_fwd": pa.launches, "patch_attention_bwd": pa.bwd_launches,
            "subm_conv_fwd": sc.launches, "subm_conv_dw": sc.dw_launches}


def set_launch_counts_to_zero():
    pa.launches = pa.bwd_launches = sc.launches = sc.dw_launches = sc.rulebook_builds = 0


def train_config(save_path: str = ""):
    """The full-width config on synthetic scenes: 2 steps of batch 8 per epoch, 1 val batch."""
    cfg = Config.fromfile(CONFIG)
    data = {}
    for split, scenes in (("train", 2 * cfg.batch_size), ("val", cfg.batch_size)):
        data[f"data.{split}"] = dict(_delete_=True, type="SyntheticKeypointDataset", split=split, num_scenes=scenes,
                                     num_points=CLOUD_POINTS, num_keypoints=cfg.num_keypoints,
                                     offset_radius=cfg.data[split].offset_radius,
                                     transform=cfg.data[split].transform)
    cfg.merge_from_dict(dict(save_path=save_path, eval_epoch=TRAIN_EPOCHS, seed=0, **data))
    return cfg


def device_kernels(prof) -> dict:
    """{kernel name: (device ms, launches)} of a torch.profiler run."""
    by_kernel = {}
    for evt in prof.events():
        # a user annotation (the optimizer's step) spans kernels of its own on the device timeline
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            ms, cnt = by_kernel.get(evt.name, (0.0, 0))
            by_kernel[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, cnt + 1)
    return by_kernel


def profile_run(label: str, run, top: int = 12) -> dict:
    """``run()`` under torch.profiler: wall ms, device busy ms (the kernels' sum), idle share, kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = device_kernels(prof)
    busy = sum(ms for ms, _ in by_kernel.values())
    out = dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1.0 - busy / wall_ms if busy else None,
               kernels=sum(cnt for _, cnt in by_kernel.values()))
    print(f"{label} under torch.profiler: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {out['idle_share']}, {out['kernels']} kernels {stamp()}")
    for name, (ms, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:9.3f} ms x{cnt:5d}  {name[:110]}")
    if not busy:
        raise AssertionError(f"the profiler saw no device time in {label}")
    return out


def profile_step(trainer, run_step) -> dict:
    """One training step under torch.profiler."""
    trainer.comm_info["input_dict"] = next(iter(trainer.train_loader))
    return profile_run("one training step", run_step)


def counted_training(trainer, label: str, bb, check_step=None, expect=None) -> dict:
    """``trainer.train()`` with every step's launches and rulebook builds counted and checked (each
    kernel once per Block of the PT-v3m1 backbone dict ``bb``, B3 twice, B3 and B4 once more for a
    sparse-conv stem; one rulebook per kernel map; or ``expect``: (launches per step, rulebooks per
    step)), the counts set to 0 just before and read just after the run; its step times (host
    clock), per-step counts, whole-run counts and peak memory.  ``check_step(trainer)`` runs after
    each step."""
    if expect is not None:
        per_step, levels = expect
    else:
        # every Block runs B1 and B3 forward, B2 and B4 backward, and B3 again for the conv's input gradient;
        # a sparse-conv stem runs B3 forward and B4, and no B3 for its input (the features need no gradient)
        blocks = sum(bb["enc_depths"]) + sum(bb["dec_depths"])  # 22 at full depth
        stem = stem_convs(bb)
        per_step = {"patch_attention_fwd": blocks, "patch_attention_bwd": blocks,
                    "subm_conv_fwd": 2 * blocks + stem, "subm_conv_dw": blocks + stem}
        levels = len(bb["enc_depths"])  # kernel maps per step: one rulebook each
    steps, step_ms = [], []
    run_step = trainer.run_step

    def counted_step():
        before, built = launch_counts(), sc.rulebook_builds
        t0 = time.perf_counter()
        run_step()  # ends in the host reading the losses
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        built = sc.rulebook_builds - built
        steps.append(delta)
        m = trainer.comm_info["metrics"]
        print(f"{label} step {len(steps)}: {', '.join(f'{k} {v:.4f}' for k, v in m.items())}, lr "
              f"{trainer.comm_info['lr']:.4e}, {step_ms[-1]:.1f} ms, launches {delta}, rulebooks built {built} "
              f"{stamp()}")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} step {len(steps)}: a loss is not finite: {m}")
        if delta != per_step:
            raise AssertionError(f"{label} step {len(steps)}: expected launches {per_step}, got {delta}")
        if built != levels:
            raise AssertionError(f"{label} step {len(steps)}: expected {levels} rulebooks (one per map), built {built}")
        if check_step is not None:
            check_step(trainer)

    trainer.run_step = counted_step
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_launch_counts_to_zero()
    try:
        trainer.train()
    finally:
        trainer.run_step = run_step
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    unchanged = [k for k, v in trainer.model.state_dict().items() if torch.equal(v, before[k])]
    print(f"{label}: {len(steps)} steps; {len(before) - len(unchanged)} of {len(before)} parameter and statistics "
          f"tensors changed; launches {counts}; peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) {stamp()}")
    if unchanged:
        raise AssertionError(f"{label}: tensors the training did not change: {unchanged[:8]}")
    timed = step_ms[1:]  # the first step also warms up cuBLAS and the allocator
    print(f"{label} step time (host clock, steps 2-{len(step_ms)}): median {statistics.median(timed):.2f} ms, each "
          f"{[round(x, 2) for x in step_ms]} {stamp()}")
    return dict(step_ms=step_ms, counts=counts, steps=steps, peak_bytes=peak)


def phase_train(cfg):
    """The trainer at full width for TRAIN_EPOCHS epochs; returns its step times, launch counts and profile."""
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(train_config(tmp), device="cuda")
        run = counted_training(trainer, "train", cfg.model.backbone_conf)
        if len(run["steps"]) != 2 * TRAIN_EPOCHS:
            raise AssertionError(f"expected {2 * TRAIN_EPOCHS} steps, ran {len(run['steps'])}")
        metric = trainer.comm_info.get("current_metric_value")
        if metric is None or not np.isfinite(metric):
            raise AssertionError(f"the evaluator gave no finite mm error: {metric}")
        print(f"evaluator: mean keypoint distance {-metric:.2f} mm (argmax) after {TRAIN_EPOCHS} epochs {stamp()}")
        run["profile"] = profile_step(trainer, trainer.run_step)
    return run


def step_tensors(model, batch_np, device: str, dtype: torch.dtype, label: str) -> dict:
    """One training step of ``model`` on ``device`` with ``dtype`` features (parameters as they are):
    {kind: {name: tensor}} of the loss, every gradient and the running statistics."""
    model.train()
    batch = sample_to_device(batch_np, device)
    point = build_point_batch(batch, batch_np["num_samples"])
    point = point.replace(feat=point.feat.to(dtype))
    t0 = time.perf_counter()
    # a fresh CPU generator of one seed: the keypoint head's Dropout draws the same masks on both devices
    out = model(point, batch, torch.Generator().manual_seed(0))
    out["loss"].float().backward()
    print(f"{label}: one training step on {device} ({str(dtype)[6:]} features, {torch.get_num_threads()} CPU "
          f"threads): {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock) {stamp()}")
    return {"loss": {"loss": out["loss"].detach()}, "grad": {k: p.grad for k, p in model.named_parameters()},
            "stat": dict(model.named_buffers())}


def worst_errors(got: dict, ref: dict) -> dict:
    """{kind: (max over tensors of max abs err / max(1, max|ref|), that tensor's name)}."""
    worst = {}
    for kind, tensors in ref.items():
        for name, r in tensors.items():
            rel = (got[kind][name].cpu().float() - r.float()).abs().max().item() / max(1.0, r.abs().max().item())
            if rel >= worst.get(kind, (-1.0, ""))[0]:
                worst[kind] = (rel, name)
    return worst


class ReluTies:
    """Holds the card's step to the CPU's side of every ReLU kink that rounding decides.

    A ReLU's gradient jumps at 0, so where its input lies within rounding of 0, two right f32 steps
    that sum in other orders may take either side, and one such decision moves a batch-1 semseg_r3
    step's stem gradient by 2.0e-3 (PERF.md §7).  ``record`` keeps the CPU's decisions (input > 0) of
    each ``F.relu`` call in order; ``replay`` runs the card's step with them and raises where a
    decision differs at an input farther than RELU_TIE x max(1, max|x|) from 0; ``watch`` (of another
    instance over the same decisions) only lists where the card's own decisions differ.  ``ties``
    lists each decision that differs: (call, [row, channel], the card's input)."""

    def __init__(self, masks=None):
        self.masks, self.calls, self.decisions, self.ties = [] if masks is None else masks, 0, 0, []

    @contextlib.contextmanager
    def _patched(self, relu):
        plain = F.relu
        F.relu = relu
        try:
            yield self
        finally:
            F.relu = plain

    def record(self):
        plain = F.relu

        def relu(x, inplace=False):
            self.masks.append(x.detach().cpu() > 0)
            return plain(x)
        return self._patched(relu)

    def replay(self, follow: bool = True):
        plain = F.relu

        def relu(x, inplace=False):
            if self.calls == len(self.masks):
                raise AssertionError(f"the card makes more ReLU calls than the CPU's {len(self.masks)}")
            ref = self.masks[self.calls].to(x.device)
            if ref.shape != x.shape:
                raise AssertionError(f"ReLU call {self.calls}: {tuple(x.shape)} on the card, {tuple(ref.shape)} on "
                                     f"the CPU")
            xd = x.detach()
            differ = ref != (xd > 0)
            if bool(differ.any()):
                values = xd[differ]
                slack = RELU_TIE * max(1.0, xd.abs().max().item())
                if follow and values.abs().max().item() > slack:
                    raise AssertionError(f"ReLU call {self.calls}: a decision differs between card and CPU at an "
                                         f"input of {values.abs().max().item():.3e}, past the tie width {slack:.3e}")
                self.ties += [(self.calls, pos, v) for pos, v in zip(differ.nonzero().tolist(), values.tolist())]
            self.calls += 1
            self.decisions += x.numel()
            return torch.where(ref, x, torch.zeros((), dtype=x.dtype, device=x.device)) if follow else plain(x)
        return self._patched(relu)

    def watch(self):
        return self.replay(follow=False)


class MaxTies:
    """Holds the card's step to the CPU's winners of every segment max that rounding decides.

    A max routes its gradient to the row that wins, so where two rows of a segment lie within rounding of
    each other, two right f32 steps may route it to either (a pooling of ~60,000 rows has a few such
    segments).  ``record`` keeps the CPU's winners (the rows equal to their segment's max) of each call of
    the ``segment_max`` that ``sites`` ((module, name) pairs) name, in order; ``replay`` runs the card's
    step with them, the max taken over the CPU's winners only, and raises where a winner differs at a row
    farther than RELU_TIE x max(1, max|out|) from its segment's max.  ``ties`` lists each winner that
    differs: (call, [row, channel], its distance from the max)."""

    def __init__(self, sites, winners=None):
        self.sites, self.winners, self.calls, self.ties = sites, [] if winners is None else winners, 0, []

    @contextlib.contextmanager
    def _patched(self, wrap):
        plain = [getattr(module, name) for module, name in self.sites]
        for (module, name), fn in zip(self.sites, plain):
            setattr(module, name, wrap(fn))
        try:
            yield self
        finally:
            for (module, name), fn in zip(self.sites, plain):
                setattr(module, name, fn)

    @staticmethod
    def _winners(plain, data, ids, m):
        out = plain(data, ids, m)
        keep = (ids >= 0) & (ids < m)
        win = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
        win[keep] = data[keep] == out[ids[keep]]
        return out, win

    def record(self):
        def wrap(plain):
            def segment_max(data, ids, m):
                out, win = self._winners(plain, data.detach(), ids, m)
                self.winners.append(win.cpu())
                return plain(data, ids, m)
            return segment_max
        return self._patched(wrap)

    def replay(self):
        def wrap(plain):
            def segment_max(data, ids, m):
                ref = self.winners[self.calls].to(data.device)
                out, win = self._winners(plain, data.detach(), ids, m)
                differ = (ref != win).nonzero()
                if len(differ):
                    gap = (data.detach()[differ[:, 0], differ[:, 1]] - out[ids[differ[:, 0]], differ[:, 1]]).abs()
                    slack = RELU_TIE * max(1.0, out[torch.isfinite(out)].abs().max().item())
                    if gap.max().item() > slack:
                        raise AssertionError(f"segment max call {self.calls}: a winner differs between card and CPU "
                                             f"{gap.max().item():.3e} from its max, past the tie width {slack:.3e}")
                    self.ties += [(self.calls, pos, g) for pos, g in zip(differ.tolist(), gap.tolist())]
                self.calls += 1
                neg = torch.full((), float("-inf"), dtype=data.dtype, device=data.device)
                return plain(torch.where(ref, data, neg), ids, m)
            return segment_max
        return self._patched(wrap)


@contextlib.contextmanager
def cpu_order_sums():
    """SpUNet's segment sums (StridedConvDown's parent sums) in the CPU's row order on the card
    (``segment_sum_in_order``), where the path's ``index_add_`` adds with atomics in an order that
    changes from run to run."""
    plain = spunet_module.segment_sum
    spunet_module.segment_sum = segment_sum_in_order
    try:
        yield
    finally:
        spunet_module.segment_sum = plain


def compare_step(label: str, model_cfg, batch_np, dtype: torch.dtype, tol: float, relu_ties: bool = False,
                 max_sites=()) -> dict:
    """One training step, card against CPU, with the same seeded weights and batch: features in
    ``dtype`` (parameters f32, as ``amp`` has them), the loss, every gradient and the running
    statistics, each relative to max(1, |cpu|) within ``tol``; returns the worst of each kind.
    With bf16 features the CPU also takes the step with f32 features, and the CPU's own bf16
    deviation from it is printed beside the card's error: how far bf16 rounding alone moves a tensor.
    With ``relu_ties`` (the SpUNet steps) the card's step runs first as the path runs and then twice
    with its segment sums in the CPU's row order (``cpu_order_sums``): their gradient errors are
    printed, and whether those two repeat bit for bit; the step held to ``tol`` is then the card's
    with the CPU's side taken at every ReLU tie (``ReluTies``), each tie printed, and with ``max_sites``
    also at every tie of those segment maxes' winners (``MaxTies``)."""
    cpu_model = init_weights(build_model(model_cfg), torch.Generator().manual_seed(3))
    initial = copy.deepcopy(cpu_model.state_dict())

    def card_step(context=None) -> dict:
        model = build_model(model_cfg)
        model.load_state_dict(initial)
        with context or contextlib.nullcontext():
            return step_tensors(model.cuda(), batch_np, "cuda", dtype, label)

    ties, max_ties = ReluTies(), MaxTies(max_sites)
    with ties.record() if relu_ties else contextlib.nullcontext(), max_ties.record():
        cpu = step_tensors(cpu_model, batch_np, "cpu", dtype, label)
    card = card_step()
    if relu_ties:
        watched = ReluTies(ties.masks)
        ordered = [card_step(cpu_order_sums())]
        with watched.watch():
            ordered.append(card_step(cpu_order_sums()))
        same = all(torch.equal(a, ordered[1][kind][name]) for kind, tensors in ordered[0].items()
                   for name, a in tensors.items())
        for what, got in (("as the path runs", card), ("segment sums in the CPU's row order", ordered[0])):
            rel, name = worst_errors(got, cpu)["grad"]
            print(f"{label}: card vs cpu gradients without the ReLU tie rule, {what}: {rel:.3e} ({name}) {stamp()}")
        print(f"{label}: two card steps with segment sums in the CPU's row order repeat bit for bit: {same}; their "
              f"ReLU decisions that differ from the CPU's: {watched.ties[:12]} (call, [row, channel], the card's "
              f"input)")
        del ordered
        with max_ties.replay():
            card = card_step(ties.replay())
        if ties.calls != len(ties.masks) or max_ties.calls != len(max_ties.winners):
            raise AssertionError(f"{label}: the CPU made {len(ties.masks)} ReLU and {len(max_ties.winners)} segment "
                                 f"max calls, the card {ties.calls} and {max_ties.calls}")
        if max_sites:
            print(f"{label}: {len(max_ties.ties)} segment max winners differ between card and CPU over "
                  f"{max_ties.calls} calls, each within {RELU_TIE:g} x max(1, max|max|) of its max, and the card's "
                  f"step takes the CPU's winners: {max_ties.ties[:8]} (call, [row, channel], distance) {stamp()}")
        print(f"{label}: {len(ties.ties)} of {ties.decisions} ReLU decisions differ between card and CPU, each at an "
              f"input within {RELU_TIE:g} x max(1, max|x|) of 0, and the card's step takes the CPU's side there: "
              f"{ties.ties[:8]} (call, [row, channel], the card's input) {stamp()}")
    for kind, tensors in card.items():
        for name, got in tensors.items():
            if got.dtype != torch.float32 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label}: {kind} {name} on the card is {got.dtype} or not finite")
    worst = worst_errors(card, cpu)
    yardstick = {}
    if dtype != torch.float32:
        f32_model = build_model(model_cfg)
        f32_model.load_state_dict(initial)
        yardstick = worst_errors(cpu, step_tensors(f32_model, batch_np, "cpu", torch.float32, label))
    for kind, (rel, name) in worst.items():
        own = (f"; the CPU's {str(dtype)[6:]} step against its f32 step: {yardstick[kind][0]:.3e} "
               f"({yardstick[kind][1]})") if yardstick else ""
        print(f"{label}: card vs cpu training step, {kind}: max abs err / max(1, |cpu|) = {rel:.3e} ({name}); "
              f"tol {tol:g}{own} {stamp()}")
        if rel > tol:
            raise AssertionError(f"{label}: card and CPU disagree on {kind} {name}: {rel:.3e} (tol {tol:g})")
    return worst


def phase_train_cpu(cfg) -> None:
    """One keypoint training step, card against CPU: batch 1, no drop path, no order shuffling."""
    model_cfg = dict(cfg.model)
    model_cfg["backbone_conf"] = dict(cfg.model.backbone_conf, drop_path=0.0, shuffle_orders=False)
    np.random.seed(5)
    dataset = SyntheticKeypointDataset(split="train", num_scenes=1, num_points=CLOUD_POINTS,
                                       offset_radius=cfg.data.train.offset_radius, transform=cfg.data.train.transform)
    compare_step("keypoint", model_cfg, collate([dataset[0]], cfg.slot_size, np.random), torch.float32,
                 TRAIN_CPU_TOL)


SOURCES = {  # name: (source, the Pallas kernel body it replaces)
    "patch_attention_fwd": ("pointcept_keypointdetection_tpu_torch/csrc/patch_attention.cu",
                            "pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py:32"),
    "patch_attention_bwd": ("pointcept_keypointdetection_tpu_torch/csrc/patch_attention.cu",
                            "pointcept_keypointdetection_tpu/ops/pallas/patch_attention.py:52"),
    "subm_conv_fwd": ("pointcept_keypointdetection_tpu_torch/csrc/sparse_conv.cu",
                      "pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py:50"),
    "subm_conv_dw": ("pointcept_keypointdetection_tpu_torch/csrc/sparse_conv.cu",
                     "pointcept_keypointdetection_tpu/ops/pallas/sparse_conv.py:115"),
}


def input_sets(make, nbytes: int):
    return [make() for _ in range(copies_for(nbytes))]


def time_kernel(name, cases, kernel, plain, library, nbytes, flops, dtype, peak=None, unit="f32 FFMA",
                single=False):
    """One kernel's device ms beside its plain version's, the library call's and the bound: the larger
    of ``nbytes`` at the HBM rate and ``flops`` at ``peak`` (default: the dtype's rate).  ``single``:
    the plain version and the library call on the first input set only."""
    if dtype == torch.bfloat16:
        unit = "bf16 tensor cores"
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    few = cases[:1] if single else cases
    row = dict(ms=cuda_ms(kernel, cases), plain_ms=cuda_ms(plain, few), library_ms=cuda_ms(library, few),
               bound_ms=max(t_bytes, t_ops), t_bytes=t_bytes, t_ops=t_ops)
    print(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP at {unit}) {stamp()}")
    return row


def time_attention(rng, n, heads, patch, dtype, backward: bool):
    """B1 (or with ``backward`` B2), its plain version and F.scaled_dot_product_attention (its backward:
    forward + backward less the forward, both timed) on the same inputs.  f32 runs as 3xTF32, so its
    operations bound is 3 TF32 products per f32 product at the TF32 rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    tf32 = dict(peak=PEAK_TF32, unit="3xTF32, 495 TFLOP/s") if dtype == torch.float32 else {}
    p = n // patch
    qkv_bytes = n * 3 * heads * 16 * size
    row_bytes = n * heads * 16 * size

    def make():
        qkv, valid, out, lse, g = attention_bwd_case(rng, n, heads, patch, dtype)
        qh = [t.detach().clone().requires_grad_(backward)
              for t in qkv.reshape(p, patch, 3, heads, 16).permute(2, 0, 3, 1, 4)]
        return (qkv, valid, out, lse, g, qh, valid.reshape(p, 1, 1, patch),
                g.reshape(p, patch, heads, 16).permute(0, 2, 1, 3).contiguous())

    def sdpa(qh, m):
        return F.scaled_dot_product_attention(qh[0], qh[1], qh[2], attn_mask=m, scale=0.25)

    if not backward:
        cases = input_sets(make, qkv_bytes + n + row_bytes)
        return time_kernel("B1", cases, lambda q, v, o, l, g, qh, m, gh: pa.patch_attention(q, v, patch, 0.25),
                           lambda q, v, o, l, g, qh, m, gh: pa.patch_attention_plain(q, v, patch, 0.25),
                           lambda q, v, o, l, g, qh, m, gh: sdpa(qh, m),
                           qkv_bytes + n + row_bytes, 4.0 * n * patch * 16 * heads * (3 if tf32 else 1), dtype,
                           **tf32)
    nbytes = 2 * qkv_bytes + n + row_bytes + n * heads * 16 * 4 + n * heads * 4  # dO in the dtype, O and lse in f32
    cases = input_sets(make, nbytes)
    row = time_kernel("B2", cases, lambda q, v, o, l, g, qh, m, gh: pa.patch_attention_backward(q, v, o, l, g, patch, 0.25),
                      lambda q, v, o, l, g, qh, m, gh: pa.patch_attention_backward_plain(q, v, g, patch, 0.25),
                      lambda q, v, o, l, g, qh, m, gh: torch.autograd.grad(sdpa(qh, m), qh, gh),
                      nbytes, 10.0 * n * patch * 16 * heads * (3 if tf32 else 1), dtype, **tf32)
    fwd = cuda_ms(lambda q, v, o, l, g, qh, m, gh: sdpa(qh, m), cases)
    both = row["library_ms"]
    row["library_ms"] -= fwd
    print(f"    (library: SDPA forward + backward {both:.4f} ms less its forward {fwd:.4f} ms = "
          f"{row['library_ms']:.4f} ms)")
    return row


def time_conv(rng, idx, c, dtype, dw: bool, cin=None):
    """B3 (or with ``dw`` B4), its plain version and the gather + torch.matmul on the same inputs, Cout
    ``c`` and Cin ``cin`` (default ``c``).  A Cin that is not a multiple of 8 (the stem's 7) reaches the
    kernels zero-padded, as ``SubmConvFunction`` pads it; the plain version, the library call and the
    bound take it as it is.  Each input set has its own copy of the map and that copy's rulebook, built
    before the timing (a build reads the host, which a CUDA graph cannot hold); ``time_rulebook`` times
    the builds.  f32 runs as 3xTF32, so its operations bound is 3 TF32 products per f32 product at the
    TF32 rate."""
    n, k = idx.shape
    cin = cin or c
    size = torch.tensor([], dtype=dtype).element_size()
    hits = int((idx < n).sum())

    def make():
        feat = card_normal(rng, (n, cin), dtype)
        w = (card_normal(rng, (k, cin, c)) / np.sqrt(k * cin)).to(dtype)
        g = card_normal(rng, (n, c), dtype)
        i = idx.clone()
        fp = torch.cat([feat, feat.new_zeros(1, cin)])
        fk, wk = padded(feat, w)  # what the kernels read
        return dict(f=feat, i=i, w=w, g=g, fp=fp, il=i.long(), w2=w.reshape(k * cin, c), rb=sc.build_rulebook(i),
                    fk=fk, wk=wk)

    flops = 2.0 * hits * cin * c
    ops = dict(flops=flops)
    if dtype == torch.float32:
        ops = dict(flops=3 * flops, peak=PEAK_TF32, unit="3xTF32, 495 TFLOP/s")
    # the plain version and the library call gather [N, K, Cin] (f32 for the plain one): past GATHER_BYTES
    # they are timed on one input set (it exceeds the L2 by itself) so that the graph's pool holds one gather
    single = n * k * cin * 4 > GATHER_BYTES
    if not dw:
        nbytes = (n * cin + n * c + k * cin * c) * size + idx.numel() * 4
        return time_kernel("B3", input_sets(lambda: (make(),), nbytes),
                           lambda a: sc.subm_conv(a["fk"], a["i"], a["wk"], a["rb"]),
                           lambda a: sc.subm_conv_plain(a["f"], a["i"], a["w"]),
                           lambda a: torch.matmul(a["fp"][a["il"]].reshape(n, k * cin), a["w2"]),
                           nbytes, dtype=dtype, single=single, **ops)
    nbytes = (n * cin + n * c) * size + idx.numel() * 4 + k * cin * c * 4
    return time_kernel("B4", input_sets(lambda: (make(),), nbytes),
                       lambda a: sc.subm_conv_dw(a["fk"], a["i"], a["g"], a["rb"]),
                       lambda a: sc.subm_conv_dw_plain(a["f"], a["i"], a["g"]),
                       lambda a: torch.matmul(a["fp"][a["il"]].permute(1, 2, 0), a["g"]),
                       nbytes, dtype=dtype, single=single, **ops)


def time_rulebook(idx, repeats: int = 5) -> dict:
    """One rulebook build: host-clock ms (plain torch ops and one read back to the host, so the
    card's queue is empty at its end), median of ``repeats``; the device ms of its kernels (one
    more build under torch.profiler); its bytes bound: the map read once, the permutation, the
    offset-major map, the tile masks and the pair lists written once."""
    from torch.profiler import ProfilerActivity, profile

    n, k = idx.shape
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rb = sc.build_rulebook(idx)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sc.build_rulebook(idx)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    nbytes = 4 * (idx.numel() + rb.perm.numel() + rb.nbr.numel() + rb.tile_mask.numel() + 2 * rb.pair_in.numel()
                  + rb.pair_start.numel())
    row = dict(ms=statistics.median(times), device_ms=sum(ms for ms, _ in kernels.values()),
               bound_ms=nbytes / PEAK_BYTES * 1e3)
    # B3's dense work, busy tiles x their offsets x 64 rows, per hit; beside it the same in the map's own row order
    hit = torch.cat([idx < n, idx.new_zeros((-(-n // sc.TILE) * sc.TILE - n, k), dtype=torch.bool)])
    unsorted = int(hit.reshape(-1, sc.TILE, k).any(1).sum()) * sc.TILE / max(1, sum(rb.hits))
    by_mask = sum(bin(m).count("1") for m in rb.tile_mask.tolist()) * sc.TILE / max(1, sum(rb.hits))
    print(f"  rulebook build N={n}: {row['ms']:.4f} ms (host clock, median of {repeats}: "
          f"{[round(t, 4) for t in times]}), device {row['device_ms']:.4f} ms in "
          f"{sum(c for _, c in kernels.values())} kernels, bound {row['bound_ms']:.4f} ms "
          f"(bytes: {nbytes / 1e6:.2f} MB); "
          f"{rb.busy_tiles} busy tiles of {-(-n // sc.TILE)}, {sum(rb.hits)} hits; B3's tile rows x offsets per "
          f"hit {by_mask:.3f} (rows in the map's order: {unsorted:.3f}) {stamp()}")
    return row


ROW_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")


def add_row(totals, name, row, launches) -> None:
    """Add ``launches`` times a timed row to ``totals[name]``."""
    t = totals.setdefault(name, dict.fromkeys(ROW_KEYS, 0.0))
    for key in ROW_KEYS:
        t[key] += launches * row[key]


def phase_times(cfg, latencies, serve_maps, train_maps, errors, train):
    """Request latency, step time and each kernel's times; returns the kernels line, each row per
    training step: launches in one step of the trainer's run, errors at the training shapes, and
    times summed over a step's launches at the training levels, conv kernels on the trainer's maps;
    and B1's and B3's sums per request."""
    print(f"request latency (host clock, POST to reply, {REQUESTS} requests): "
          f"median {statistics.median(latencies):.2f} ms, each {[round(x, 2) for x in latencies]} {stamp()}")
    timed = train["step_ms"][1:]  # the first step also warms up cuBLAS and the allocator
    print(f"training step time (host clock, batch {cfg.batch_size}, steps 2-{len(train['step_ms'])}): median "
          f"{statistics.median(timed):.2f} ms, each {[round(x, 2) for x in train['step_ms']]} {stamp()}")
    rng = np.random.default_rng(1)
    per_request = {}
    for n, c, heads, patch, depth in level_shapes(cfg.model.backbone_conf, cfg.slot_size):
        for dtype in (torch.float32, torch.bfloat16):
            print(f"serving level N={n} C={c} H={heads} patch={patch} {str(dtype)[6:]} (x{depth} per request):")
            rows = {"patch_attention_fwd": time_attention(rng, n, heads, patch, dtype, backward=False),
                    "subm_conv_fwd": time_conv(rng, serve_maps[n], c, dtype, dw=False)}
            if dtype == torch.float32:
                for name, row in rows.items():
                    add_row(per_request, name, row, depth)
    for name, t in per_request.items():
        print(f"{name} per request (f32, sum over its launches): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")

    print("rulebook builds, one per training kernel map and step:")
    rows = [time_rulebook(idx) for idx in train_maps.values()]
    rulebook = {key: sum(row[key] for row in rows) for key in ("ms", "device_ms", "bound_ms")}
    print(f"rulebook builds per training step ({len(train_maps)} maps): {rulebook['ms']:.4f} ms (host clock), "
          f"device {rulebook['device_ms']:.4f} ms, bound {rulebook['bound_ms']:.4f} ms {stamp()}")
    per_step = {}
    launches = {"patch_attention_fwd": 1, "patch_attention_bwd": 1, "subm_conv_fwd": 2, "subm_conv_dw": 1}
    for n, c, heads, patch, depth in train_shapes(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            print(f"training level N={n} C={c} H={heads} patch={patch} {str(dtype)[6:]} (x{depth} Blocks per step):")
            rows = {"patch_attention_fwd": time_attention(rng, n, heads, patch, dtype, backward=False),
                    "patch_attention_bwd": time_attention(rng, n, heads, patch, dtype, backward=True),
                    "subm_conv_fwd": time_conv(rng, train_maps[n], c, dtype, dw=False),
                    "subm_conv_dw": time_conv(rng, train_maps[n], c, dtype, dw=True)}
            if dtype == torch.float32:
                for name, row in rows.items():
                    add_row(per_step, name, row, launches[name] * depth)
    conv = per_step["subm_conv_fwd"]["ms"] + per_step["subm_conv_dw"]["ms"]
    print(f"sparse conv per training step (f32, device): B3 {per_step['subm_conv_fwd']['ms']:.4f} + B4 "
          f"{per_step['subm_conv_dw']['ms']:.4f} + rulebook builds {rulebook['device_ms']:.4f} = "
          f"{conv + rulebook['device_ms']:.4f} ms (builds on the host clock: {rulebook['ms']:.4f} ms); bounds "
          f"{per_step['subm_conv_fwd']['bound_ms']:.4f} + {per_step['subm_conv_dw']['bound_ms']:.4f} + "
          f"{rulebook['bound_ms']:.4f} ms {stamp()}")
    kernels = []
    step = train["steps"][-1]  # every step launched the same counts (phase_train checks)
    for name, t in per_step.items():
        print(f"{name} per training step (f32, sum over its {step[name]} "
              f"launches): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms {stamp()}")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
            launches=step[name], max_abs_err=errors[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by="operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            library_ms=t["library_ms"],
        ))

    # B1 takes one exponential per score; B2 one in its one pass (patch <= pa.ONE_PASS_PATCH), two in
    # its two-kernel shape (dq and dk/dv each recompute P)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = EX2_PER_CLOCK_PER_SM * sms * MAX_SM_MHZ * 1e6
    for name in ("patch_attention_fwd", "patch_attention_bwd"):
        exps = sum(n * patch * heads * depth * (2 if name == "patch_attention_bwd" and patch > pa.ONE_PASS_PATCH else 1)
                   for n, _, heads, patch, depth in train_shapes(cfg))
        print(f"{name} per training step: {exps / 1e6:.1f} M exponentials, floor {exps / rate * 1e3:.4f} ms at "
              f"{EX2_PER_CLOCK_PER_SM} per clock per SM x {sms} SMs x {MAX_SM_MHZ:.0f} MHz, beside the kernel's "
              f"{per_step[name]['ms']:.4f} ms {stamp()}")

    n = cfg.slot_size
    for dtype in (torch.float32, torch.bfloat16):
        print(f"bench patch: N={n} H=4 patch=1024 {str(dtype)[6:]} (B2 on no path here; B1 timed at the bench "
              f"levels below; not in the sums above):")
        time_attention(rng, n, 4, 1024, dtype, backward=False)
        time_attention(rng, n, 4, 1024, dtype, backward=True)
    return kernels, per_request


# ---- the segmentation slice --------------------------------------------------------------------------

SEG_CONFIG = "configs/pigseg/semseg-ptv3-v1m1-0-base.py"
SEG_SLOT = 32768
SEG_POINTS = 30000
# bench forward, the card's bf16 logits against the CPU's f32 on the same bf16-rounded weights, relative
# to max(1, max|cpu|): the card read 0.0186 here, and tests/test_torch_segment.py reads JAX bf16 against
# JAX f32 at up to 0.026 through its 5 Blocks; twice the card's reading leaves room for the seeded data
# and stays well below a logit's size (a wrong bf16 forward errs by its logits' order of magnitude)
BENCH_BF16_TOL = 0.04
# the share of valid points whose bf16 label is the CPU f32's: the card read 0.9894 (labels flip only on
# near ties of the 20 seeded logits); a forward that is wrong away from ties falls far below
BENCH_BF16_AGREE = 0.97


def phase_pigseg() -> None:
    """The pigseg server at full width, slot 32768, seeded weights: 1 warm-up and 3 timed requests
    of body-like clouds through HTTP, each launching B1 and B3 once per Block; then one request's
    logits, card against CPU (plain versions), with the same weights; then B1 and B3 against their
    plain versions at every level of the request, in f32 and bf16, B3 on the request's kernel maps."""
    cfg = Config.fromfile(SEG_CONFIG)
    predictor = serve.build_predictor("pigseg", cfg, None, SEG_SLOT, "cuda")
    rng = np.random.default_rng(4)
    clouds = [request_cloud(rng, SEG_POINTS) for _ in range(REQUESTS + 1)]
    warm = clouds.pop()
    predictor.predict(warm[:, :3], warm[:, 3:])  # cuBLAS handles and the allocator's pool
    classes = cfg.model.num_classes

    def check_labels(i, cloud, reply):
        if reply.shape != (cloud.shape[0],) or not np.isin(reply, np.arange(classes)).all():
            raise AssertionError(f"request {i}: expected {cloud.shape[0]} labels in [0, {classes}), got "
                                 f"{reply.shape} {np.unique(reply)[:8]}")

    latencies, _ = phase_serve(predictor, clouds, cfg.model.backbone, check_labels)
    print(f"pigseg request latency (host clock, POST to reply, slot {SEG_SLOT}, {REQUESTS} requests of "
          f"{SEG_POINTS} points x 7): median {statistics.median(latencies):.2f} ms, each "
          f"{[round(x, 2) for x in latencies]} {stamp()}")

    state = {k: v.detach().cpu() for k, v in predictor.model.state_dict().items()}
    cpu = SegmentPredictor(dict(cfg.model), state, SEG_SLOT, device="cpu")
    cloud = clouds[0]
    gpu_res = predictor.infer(cloud[:, :3], cloud[:, 3:])
    t0 = time.perf_counter()
    cpu_res = cpu.infer(cloud[:, :3], cloud[:, 3:])
    print(f"pigseg request on the CPU: {(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    compare_seg_labels("pigseg", gpu_res, cpu_res)

    maps = capture_maps(predictor.model, lambda: predictor.predict(cloud[:, :3], cloud[:, 3:]), "pigseg")
    rng = np.random.default_rng(6)
    for n, c, heads, patch in dict.fromkeys(shape[:4] for shape in level_shapes(cfg.model.backbone, SEG_SLOT)):
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(rng, n, heads, patch, dtype)
            check_conv(rng, maps[n], c, dtype)


def compare_seg_labels(label: str, gpu_res: dict, cpu_res: dict, gpu_labels=None, cpu_labels=None) -> None:
    """A segmentation request's voxel logits (``SegmentPredictor.infer``) card against CPU within
    CPU_TOL x max(1, max|cpu|), and its per-point labels (theirs, or ``gpu_labels`` and ``cpu_labels``
    where given) apart only where the CPU's two best logits are closer than twice the logit error."""
    np.testing.assert_array_equal(gpu_res["inverse"], cpu_res["inverse"])
    a, b = gpu_res["seg_logits"], cpu_res["seg_logits"]
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    print(f"{label} card vs cpu seg_logits {a.shape}: max_abs_err={err:.3e} (|cpu| max {scale:.3f}) "
          f"tol={CPU_TOL:g} x max(1, |cpu| max)")
    if not (np.isfinite(a).all() and err <= CPU_TOL * max(1.0, scale)):
        raise AssertionError(f"card and CPU disagree on the {label} logits")
    top2 = np.sort(b, axis=1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0] <= 2 * err)[cpu_res["inverse"]]
    if gpu_labels is None:
        gpu_labels, cpu_labels = a.argmax(1)[cpu_res["inverse"]], b.argmax(1)[cpu_res["inverse"]]
    differ = gpu_labels != cpu_labels
    print(f"{label} card vs cpu labels: {int(differ.sum())} of {differ.size} points differ; {int(tie.sum())} points "
          f"sit on a near tie (the CPU's two best logits closer than {2 * err:.3e})")
    if (differ & ~tie).any():
        raise AssertionError(f"{int((differ & ~tie).sum())} {label} labels differ away from a near tie")


def capture_maps(model, run, label: str) -> dict:
    """{N: kernel map} of every level of the forward that ``run()`` drives through ``model``."""
    make, maps = model.backbone._kernel_map, {}

    def record(*args, **kwargs):
        kmap = make(*args, **kwargs)
        maps[kmap.neighbor_idx.shape[0]] = kmap.neighbor_idx
        return kmap

    model.backbone._kernel_map = record
    try:
        run()
    finally:
        del model.backbone._kernel_map
    for n, idx in sorted(maps.items(), reverse=True):
        k = idx.shape[1]
        print(f"{label} map N={n} K={k}: {int((idx < n).sum())} hits, {int((idx[:, k // 2] < n).sum())} valid rows")
    return maps


def phase_bench() -> dict:
    """The bench module's forward at 102,400 points: one forward of each dtype with its launches
    counted (B1 and B3 once per Block, a rulebook per kernel map), scenes/s in bf16 and in f32, one
    bf16 forward under torch.profiler, and the logits against a CPU f32 forward (plain versions) on
    the same bf16-rounded weights.  Returns each dtype's launch counts and the bench's kernel maps."""
    base = init_weights(build_model(bench.model_config()), torch.Generator().manual_seed(0))
    cast_parameters(cast_parameters(base, torch.bfloat16), torch.float32)  # bf16-rounded values, kept in f32
    bb = bench.model_config()["backbone"]
    blocks = sum(bb["enc_depths"]) + sum(bb["dec_depths"])
    expect = {"patch_attention_fwd": blocks, "patch_attention_bwd": 0, "subm_conv_fwd": blocks, "subm_conv_dw": 0}
    logits, out = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        model, point = bench.build_workload(bench.POINTS, "cuda", dtype, model=copy.deepcopy(base))
        bench.forward(model, point)  # cuBLAS handles and the allocator's pool
        torch.cuda.synchronize()
        set_launch_counts_to_zero()
        result = bench.forward(model, point)
        torch.cuda.synchronize()
        counts, built = launch_counts(), sc.rulebook_builds
        print(f"bench forward {name}: launches {counts}, rulebooks built {built}")
        if counts != expect or built != len(bb["enc_depths"]):
            raise AssertionError(f"bench forward {name}: expected launches {expect} and {len(bb['enc_depths'])} "
                                 f"rulebooks, got {counts} and {built}")
        if result.shape != (bench.POINTS, 20) or result.dtype != dtype or not bool(torch.isfinite(result).all()):
            raise AssertionError(f"bench forward {name}: logits {result.dtype} {tuple(result.shape)}, not all finite")
        logits[dtype] = result.float().cpu()
        sps = bench.measure(model, point)
        print(f"bench ({bench.METRIC}) {name}: {sps:.4f} scenes/s, {1e3 / sps:.2f} ms per forward "
              f"((t(31) - t(11)) / 20, host clock) {stamp()}")
        out[name] = counts
        if dtype == torch.bfloat16:
            profile_run("one bench forward (bf16)", lambda: bench.forward(model, point), top=10)
            out["maps"] = capture_maps(model, lambda: bench.forward(model, point), "bench")
        del model, point, result
        torch.cuda.empty_cache()

    model, point = bench.build_workload(bench.POINTS, "cpu", torch.float32, model=base)
    t0 = time.perf_counter()
    cpu = bench.forward(model, point)
    print(f"bench forward on the CPU (f32, {torch.get_num_threads()} threads, full scene): "
          f"{time.perf_counter() - t0:.1f} s (host clock)")
    valid = point.valid
    for dtype, tol in ((torch.float32, CPU_TOL), (torch.bfloat16, BENCH_BF16_TOL)):
        a, b = logits[dtype][valid], cpu[valid]
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        agree = (a.argmax(1) == b.argmax(1)).float().mean().item()
        floor = BENCH_BF16_AGREE if dtype == torch.bfloat16 else 0.0
        print(f"bench card {str(dtype)[6:]} vs cpu f32 seg_logits ({int(valid.sum())} valid rows): "
              f"max_abs_err={err:.3e} (|cpu| max {scale:.3f}) tol={tol:g} x max(1, |cpu| max); "
              f"argmax agreement {agree:.5f} (floor {floor:g})")
        if err > tol * max(1.0, scale) or agree < floor:
            raise AssertionError(f"the card's {dtype} bench logits disagree with the CPU's")
    return out


def phase_bench_kernels(maps) -> dict:
    """B1 and B3 against their plain versions at every bench level, in bf16 and f32, B3 on the bench's
    kernel maps, each timed beside its plain version and its library call; returns the per-forward sums
    of each dtype: {dtype name: {kernel name: totals}}."""
    rng = np.random.default_rng(5)
    shapes = {}
    for n, c, heads, patch, depth in level_shapes(bench.model_config()["backbone"], bench.POINTS):
        shapes[(n, c, heads, patch)] = shapes.get((n, c, heads, patch), 0) + depth
    sums = {}
    for (n, c, heads, patch), depth in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            check_attention(rng, n, heads, patch, dtype)
            check_conv(rng, maps[n], c, dtype)
            print(f"bench level N={n} C={c} H={heads} patch={patch} {str(dtype)[6:]} (x{depth} per forward):")
            totals = sums.setdefault(str(dtype)[6:], {})
            add_row(totals, "patch_attention_fwd", time_attention(rng, n, heads, patch, dtype, backward=False), depth)
            add_row(totals, "subm_conv_fwd", time_conv(rng, maps[n], c, dtype, dw=False), depth)
    for name, totals in sums.items():
        for kernel, t in totals.items():
            print(f"{kernel} per bench forward ({name}, sum over its launches): kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")
    return sums


# ---- the segmentor training slice ------------------------------------------------------------------

SCANNET_CONFIG = "configs/scannet/semseg-pt-v3m1-0-base.py"
SEMSEG_TRANSFORMS = "configs/synthetic/semseg-spunet-mini.py"  # the synthetic semseg recipe's transforms
PIG_CLOUD_POINTS = 40000
PIG_CLOUDS = {"train": 8, "val": 4}
SEG_STEPS = 4  # trainer steps of each segmentation recipe: its first epoch
PROBE_STEPS = 4  # steps on one fixed batch, whose loss must fall
# the ScanNet PG-v1m1 recipe's probe: SGD 0.05 first swings its shift loss up (loss_bias 1.19 -> 8.03 -> 4.19
# over steps 1-4, the total 5.46 -> 11.22 -> 7.42); over 16 steps every loss falls (total 2.79, loss_bias
# 0.52, loss_dir 0.969 against 1.02) in two trials
PG_PROBE_STEPS = 16
PG_LOSSES = ("loss", "loss_seg", "loss_bias", "loss_dir")
SCANNET_POINTS = 100_000  # points per synthetic room, ScanNet's scale at its 0.02 grid
SCANNET_GRID = 0.02
SCANNET_BATCH = 2  # the recipe's 8 is a global batch over devices; one card holds 2 at slot 131072
# one amp training step (bf16 features, f32 parameters), the card against the CPU in bf16 on the same input,
# relative to max(1, |cpu|) per tensor: the card read 0.0425 (the stem weight's gradient; loss 1.1e-4,
# running statistics 3.5e-4), where the CPU's own bf16 step reads 0.0566 against its f32 step on the same
# input, so bf16 rounding alone moves that gradient this far; about twice the reading leaves room for the
# seeded data, and an amp path that is wrong (a kernel off, a cast missing) errs by the gradient's own size
AMP_CPU_TOL = 0.1
# the kernels each spy watches: (module, attribute, kernel)
SPIED = ((pa, "_forward_kernel", "patch_attention_fwd"), (pa, "patch_attention_backward", "patch_attention_bwd"),
         (sc, "subm_conv", "subm_conv_fwd"), (sc, "subm_conv_dw", "subm_conv_dw"))


def pig_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """An N x 8 pig scan as the pigseg data holds it: xyz (mm), normal, curvature, label: a body-like
    surface (label 1, 2/3 of the points) standing on a floor (label 0)."""
    nb = n * 2 // 3
    body = body_cloud(rng, nb)
    floor = np.stack([rng.uniform(-1200, 1200, n - nb), rng.uniform(-800, 800, n - nb), rng.normal(-700, 2, n - nb)],
                     1)
    normal = np.zeros((n, 3))
    normal[:nb] = body / np.linalg.norm(body, axis=1, keepdims=True)
    normal[nb:, 2] = 1
    curvature = np.concatenate([rng.uniform(0, 0.2, nb), np.zeros(n - nb)])[:, None]
    label = (np.arange(n) < nb)[:, None]
    return np.concatenate([np.concatenate([body, floor]), normal, curvature, label], 1).astype(np.float32)


def write_pig_clouds(root: str, seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    for split, k in PIG_CLOUDS.items():
        os.makedirs(os.path.join(root, split))
        for i in range(k):
            np.save(os.path.join(root, split, f"pig{i}.npy"), pig_cloud(rng, PIG_CLOUD_POINTS))


def pigseg_train_config(root: str):
    """The pigseg recipe as written, its data roots on seeded clouds: SEG_STEPS steps of batch 8 per epoch."""
    cfg = Config.fromfile(SEG_CONFIG)
    cfg.merge_from_dict({"save_path": os.path.join(root, "exp"), "seed": 0, "data.train.data_root": root,
                         "data.val.data_root": root,
                         "data.train.loop": SEG_STEPS * cfg.batch_size // PIG_CLOUDS["train"]})
    return cfg


def scannet_data(split: str, scenes: int, points: int):
    """SyntheticSemSegDataset rooms through the synthetic semseg recipe's transforms at ScanNet's grid."""
    transform = [dict(t, grid_size=SCANNET_GRID) if t["type"] == "GridSample" else dict(t)
                 for t in Config.fromfile(SEMSEG_TRANSFORMS).data[split].transform]
    return dict(_delete_=True, type="SyntheticSemSegDataset", split=split, num_scenes=scenes, num_points=points,
                num_classes=20, transform=transform)


def scannet_train_config(save_path: str):
    """The ScanNet PT-v3m1 recipe (amp bf16, CE + Lovász, AdamW 0.006 under OneCycleLR, slot 131072, its
    top-level param_dicts ignored as JAX ignores it) on synthetic rooms, no Mix3D, batch SCANNET_BATCH."""
    cfg = Config.fromfile(SCANNET_CONFIG)
    cfg.merge_from_dict({"save_path": save_path, "seed": 0, "mix_prob": 0.0, "batch_size": SCANNET_BATCH,
                         "data.train": scannet_data("train", SEG_STEPS * SCANNET_BATCH, SCANNET_POINTS),
                         "data.val": scannet_data("val", SCANNET_BATCH, SCANNET_POINTS)})
    return cfg


class KernelDtypes:
    """The dtypes each kernel's wrapper receives while it is entered, over all its entries (the
    wrappers count as before)."""

    def __init__(self):
        self.seen = {name: set() for *_, name in SPIED}

    def __enter__(self):
        self.saved = []
        for mod, attr, name in SPIED:
            fn = getattr(mod, attr)

            def spy(x, *args, _fn=fn, _name=name, **kwargs):
                self.seen[_name].add(str(x.dtype)[6:])
                return _fn(x, *args, **kwargs)

            setattr(mod, attr, spy)
            self.saved.append((mod, attr, fn))
        return self.seen

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def params_and_grads_f32(trainer) -> None:
    bad = [k for k, p in trainer.model.named_parameters()
           if p.dtype != torch.float32 or p.grad is None or p.grad.dtype != torch.float32]
    if bad:
        raise AssertionError(f"parameters or gradients not float32 after an amp step: {bad[:8]}")


def phase_seg_train(label: str, cfg, dtype: torch.dtype) -> dict:
    """A segmentation recipe's trainer at full width on the card, with its hooks: the first of its epochs
    (SEG_STEPS steps, then the SemSegEvaluator over the val clouds and the saver), each step's launches
    and rulebooks counted, the kernels' input dtypes watched (``dtype`` everywhere), under amp every
    parameter and gradient checked to stay f32; then one step under torch.profiler, the kernel maps of a
    batch of the recipe's data, and PROBE_STEPS steps of a fresh trainer on that batch (its loss must
    fall)."""
    bb = cfg.model.backbone
    trainer = Trainer(cfg, device="cuda")
    total = len(trainer.train_loader) * trainer.max_epoch
    trainer.max_epoch = 1  # the recipe's first epoch; the schedule keeps the whole run's length
    print(f"{label}: {len(trainer.train_loader)} steps of batch {cfg.batch_size} per epoch, slot {cfg.slot_size}, "
          f"amp {cfg.get('amp')}, model {cfg.model.type}, {cfg.scheduler['type']} over "
          f"{total} steps (lr {trainer.lr_schedule(0):.4e} at step 0), "
          f"{sum(p.numel() for p in trainer.model.parameters())} parameters in "
          f"{len(trainer.optimizer.param_groups)} group")
    check = params_and_grads_f32 if dtype != torch.float32 else None
    spies, run_step = KernelDtypes(), trainer.run_step

    def watched_step():  # the training steps only: the evaluator runs its forward in f32, as JAX's does
        with spies:
            run_step()

    trainer.run_step = watched_step
    run = counted_training(trainer, label, bb, check)
    trainer.run_step = run_step
    seen = spies.seen
    print(f"{label}: dtypes the kernels received in the training steps: {seen}")
    if any(kinds != {str(dtype)[6:]} for kinds in seen.values()):
        raise AssertionError(f"{label}: expected every kernel in {dtype}, got {seen}")
    if len(run["steps"]) != SEG_STEPS:
        raise AssertionError(f"{label}: expected {SEG_STEPS} steps, ran {len(run['steps'])}")
    metric, name = trainer.comm_info.get("current_metric_value"), trainer.comm_info.get("current_metric_name")
    if metric is None or not 0.0 <= metric <= 1.0:
        raise AssertionError(f"{label}: the evaluator gave no {name} in [0, 1]: {metric}")
    print(f"{label}: the evaluator over {len(trainer.val_loader.dataset)} val clouds: {name} {metric:.4f} after "
          f"{SEG_STEPS} steps {stamp()}")
    run["profile"] = profile_step(trainer, trainer.run_step)
    batch = next(iter(trainer.train_loader))
    model = trainer.model.eval()
    with torch.no_grad():
        run["maps"] = capture_maps(model, lambda: model(build_point_batch(sample_to_device(batch, "cuda"),
                                                                          batch["num_samples"])), label)
    del trainer, model
    torch.cuda.empty_cache()

    # a fresh trainer of the same seed (the same initial weights) on one fixed batch: the run above
    # drives the loss of these easy synthetic labels near 0 within its 4 steps, where drop path's
    # draws move it more than a step does
    probe = Trainer(cfg, device="cuda")
    losses = []
    for _ in range(PROBE_STEPS):
        probe.comm_info["input_dict"] = batch
        probe.run_step()
        losses.append(probe.comm_info["metrics"]["loss"])
    print(f"{label}: {PROBE_STEPS} steps of a fresh trainer on one fixed batch: losses "
          f"{[round(x, 5) for x in losses]} {stamp()}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: the loss did not fall on a fixed batch: {losses}")
    del probe
    torch.cuda.empty_cache()
    return run


def phase_lovasz(n: int, classes: int) -> dict:
    """Device time of the ScanNet recipe's criteria, CE and Lovász forward + backward, on [n, classes] logits."""
    rng = np.random.default_rng(8)
    logits = torch.from_numpy(rng.normal(size=(n, classes)).astype(np.float32)).cuda().requires_grad_()
    segment = torch.from_numpy(rng.integers(-1, classes, n).astype(np.int32)).cuda()
    valid = torch.from_numpy(rng.random(n) > 0.15).cuda()
    out = {}
    for crit in Config.fromfile(SCANNET_CONFIG).model.criteria:
        loss = build_criteria([crit])
        loss(logits, segment, valid=valid).backward()  # warm-up
        out[crit["type"]] = profile_run(f"{crit['type']} forward + backward at [{n}, {classes}]",
                                        lambda: loss(logits, segment, valid=valid).backward(), top=6)
    return out


def seg_shapes(bb, slot: int, batch: int):
    """{(N, C, H, patch): Blocks per step} of the levels of a trainer (a segmentation recipe's, r3's) at
    ``batch`` samples of ``slot``."""
    shapes = {}
    for n, c, heads, patch, depth in level_shapes(bb, slot):
        key = (n * batch, c, heads, patch)
        shapes[key] = shapes.get(key, 0) + depth
    return shapes


def phase_seg_kernels(label: str, bb, slot: int, batch: int, maps: dict, dtype: torch.dtype, launches: dict):
    """B1-B4 against their plain versions at every level of a segmentation trainer, in its dtype, the conv
    kernels on the maps of a batch of its data, each timed beside its library call and its bound; returns
    per-step sums (times over a step's launches) and each kernel's largest error."""
    rng = np.random.default_rng(9)
    per_step, errors = {}, dict.fromkeys(SOURCES, 0.0)
    per_block = {"patch_attention_fwd": 1, "patch_attention_bwd": 1, "subm_conv_fwd": 2, "subm_conv_dw": 1}
    for (n, c, heads, patch), depth in seg_shapes(bb, slot, batch).items():
        idx = maps[n]
        found = {"patch_attention_fwd": check_attention(rng, n, heads, patch, dtype),
                 "patch_attention_bwd": check_attention_bwd(rng, n, heads, patch, dtype),
                 "subm_conv_fwd": check_conv(rng, idx, c, dtype),
                 "subm_conv_dw": check_conv_dw(rng, idx, c, dtype)}
        for name, err in found.items():
            errors[name] = max(errors[name], err)
        print(f"{label} level N={n} C={c} H={heads} patch={patch} {str(dtype)[6:]} (x{depth} Blocks per step):")
        rows = {"patch_attention_fwd": time_attention(rng, n, heads, patch, dtype, backward=False),
                "patch_attention_bwd": time_attention(rng, n, heads, patch, dtype, backward=True),
                "subm_conv_fwd": time_conv(rng, idx, c, dtype, dw=False),
                "subm_conv_dw": time_conv(rng, idx, c, dtype, dw=True)}
        for name, row in rows.items():
            add_row(per_step, name, row, per_block[name] * depth)
    for name, t in per_step.items():
        if launches[name] != sum(per_block[name] * d for d in seg_shapes(bb, slot, batch).values()):
            raise AssertionError(f"{label}: {name} launched {launches[name]} times per step, not once per Block")
        print(f"{name} per {label} step ({str(dtype)[6:]}, sum over its {launches[name]} launches): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms {stamp()}")
    return per_step, errors


def phase_seg_train_cpu(pig_cfg, scannet_cfg) -> dict:
    """One training step of each segmentation recipe at batch 1 (one sample of its training data,
    seed 5, at its slot), card against CPU, no drop path and no order shuffling: pigseg in f32 within
    TRAIN_CPU_TOL, the ScanNet recipe with bf16 features on both within AMP_CPU_TOL."""
    worst = {}
    for label, cfg, dtype, tol in (("pigseg", pig_cfg, torch.float32, TRAIN_CPU_TOL),
                                   ("scannet amp", scannet_cfg, torch.bfloat16, AMP_CPU_TOL)):
        model_cfg = dict(cfg.model)
        model_cfg["backbone"] = dict(cfg.model.backbone, drop_path=0.0, shuffle_orders=False)
        np.random.seed(5)
        batch_np = collate([build_dataset(dict(cfg.data.train))[0]], cfg.slot_size, np.random)
        worst[label] = compare_step(label, model_cfg, batch_np, dtype, tol)
    return worst


# ---- the r3 slice: the committed keypoint checkpoint --------------------------------------------------

R3_CONFIG = "configs/synthetic/offset-keypoint-r3.py"
R3_CKPT = "exp/kp_r3/model_params.ckpt"
R3_CLOUD_POINTS = 6000  # points per scene of the r3 recipe's data
# the keypoint error over the 8 val scenes: tests/test_keypoint_checkpoint.py's bounds, and how far the card's
# may lie from the CPU's on the same scenes (an argmax pick may differ only on a tie, as in phase 5)
R3_WEIGHTED_MM, R3_ARGMAX_MM, R3_ANCHOR_MM = 6.0, 11.0, 0.05


def r3_val_batches(cfg, batch_size: int = 1) -> list:
    """The r3 recipe's val scenes at its slot, ``batch_size`` per batch.  GridSample (train mode) and the
    slot subsample draw from the global np.random, so it is seeded first, with the recipe's seed."""
    ds = build_dataset(dict(cfg.data.val))
    np.random.seed(cfg.seed)
    return [collate([ds[j] for j in range(i, min(i + batch_size, len(ds)))], cfg.slot_size, np.random)
            for i in range(0, len(ds), batch_size)]


def r3_model(cfg, device: str, state=None):
    """The r3 model with the committed checkpoint's weights (the port's reader), in eval mode."""
    model = build_model(dict(cfg.model))
    model.load_state_dict(state if state is not None else load_jax_checkpoint(R3_CKPT), strict=True)
    return model.to(device).eval()


def check_stem(rng, idx, cin: int, cout: int, dtype) -> dict:
    """The stem's conv as the path runs it: ``SubmConvFunction`` on features of ``cin`` (7) channels that
    need no gradient, an f32 W cast inside, both zero-padded to 8 input channels: one B3 and, backward,
    one B4 (no B3 for dfeat).  Its output and W's [27, 7, Cout] gradient against the unpadded plain
    versions, and its bits run to run; returns the errors."""
    n = idx.shape[0]
    feat = card_normal(rng, (n, cin), dtype)
    w = card_normal(rng, (27, cin, cout)) / np.sqrt(27 * cin)
    g = card_normal(rng, (n, cout), dtype)
    rb = sc.build_rulebook(idx)

    def run():
        wp = w.clone().requires_grad_()
        before = (sc.launches, sc.dw_launches)
        out = sc.SubmConvFunction.apply(feat, idx, wp, rb)
        out.backward(g)
        torch.cuda.synchronize()
        if (sc.launches - before[0], sc.dw_launches - before[1]) != (1, 1):
            raise AssertionError(f"the stem conv launched B3 {sc.launches - before[0]} and B4 "
                                 f"{sc.dw_launches - before[1]} times, not once each")
        return out, wp.grad

    (out, dw), (out2, dw2) = run(), run()
    if not (torch.equal(out, out2) and torch.equal(dw, dw2)):
        raise AssertionError(f"stem conv N={n} {dtype}: two runs on one input differ")
    if dw.shape != (27, cin, cout) or dw.dtype != torch.float32:
        raise AssertionError(f"the stem's dW is {dw.dtype} {tuple(dw.shape)}, not float32 [27, {cin}, {cout}]")
    label = f"N={n} Cin={cin} (padded to {cin + -cin % sc.CHANNELS}) Cout={cout} K=27 hits={int((idx < n).sum())}"
    ref_dw = sc.subm_conv_dw_plain(feat, idx, g)
    longest = int((idx < n).sum(0).max())
    errs = {"subm_conv_fwd": check(f"B3 stem {label} {str(dtype)[6:]}", out,
                                   sc.subm_conv_plain(feat, idx, w.to(dtype)), *TOL[dtype]),
            "subm_conv_dw": check(f"B4 stem {label} longest sum {longest} {str(dtype)[6:]}", dw, ref_dw,
                                  DW_TOL * max(1.0, longest / DW_SUM) * ref_dw.abs().max().item(), 0.0)}
    print(f"stem conv {label} {str(dtype)[6:]}: one B3 and one B4 per call, two runs give equal bits")
    return errs


def phase_r3_kernels(cfg, request_maps: dict, step_maps: dict) -> dict:
    """B1 and B2 at patch 32 at every r3 level of a request (batch 1: N 4096, 2048, 1024) and of a step
    (batch 4: 16384, 8192, 4096), on inputs with an all-invalid patch; B3 and B4 at the xCPE widths and at
    the 7-channel stem (Cout 32) on the kernel maps of r3 val batches; in f32 and bf16 against the plain
    versions, all four bit for bit run to run.  Returns each kernel's largest f32 error over the step levels."""
    rng = np.random.default_rng(10)
    bb = cfg.model.backbone_conf
    errors = dict.fromkeys(SOURCES, 0.0)
    for batch, maps in ((1, request_maps), (cfg.batch_size, step_maps)):
        for n, c, heads, patch in seg_shapes(bb, cfg.slot_size, batch):
            idx = maps[n]
            for dtype in (torch.float32, torch.bfloat16):
                found = {"patch_attention_fwd": check_attention(rng, n, heads, patch, dtype),
                         "patch_attention_bwd": check_attention_bwd(rng, n, heads, patch, dtype),
                         "subm_conv_fwd": check_conv(rng, idx, c, dtype),
                         "subm_conv_dw": check_conv_dw(rng, idx, c, dtype)}
                check_attention_bits(rng, n, heads, patch, dtype)
                check_conv_bits(rng, idx, c, dtype)
                if dtype == torch.float32 and batch > 1:
                    for name, err in found.items():
                        errors[name] = max(errors[name], err)
        n0 = cfg.slot_size * batch
        for dtype in (torch.float32, torch.bfloat16):
            found = check_stem(rng, maps[n0], bb.in_channels, bb.enc_channels[0], dtype)
            if dtype == torch.float32 and batch > 1:
                for name, err in found.items():
                    errors[name] = max(errors[name], err)
    return errors


def r3_forward_counts(bb) -> dict:
    blocks = sum(bb.enc_depths) + sum(bb.dec_depths)
    return {"patch_attention_fwd": blocks, "patch_attention_bwd": 0, "subm_conv_fwd": blocks + stem_convs(bb),
            "subm_conv_dw": 0}


def phase_r3_anchor(cfg) -> dict:
    """The committed checkpoint, read by the port's reader, on the card: the 8 val scenes (batch 1)
    through the model and the evaluator's ``keypoint_distances``, weighted and argmax mm, on the card
    and on the CPU; each card forward's launches (B1 once per Block, B3 once more for the stem) and
    rulebooks (one per level, the stem sharing stage 0's); every scene's outputs, card against CPU.
    Returns the card's anchor and the kernel maps of a val scene (a request's levels) and of a batch of 4
    val scenes (a training step's)."""
    t0 = time.perf_counter()
    state = load_jax_checkpoint(R3_CKPT)
    print(f"r3: {R3_CKPT} read by the port's reader (pure Python) in {(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"{len(state)} tensors, {sum(v.numel() for v in state.values())} values; epoch "
          f"{load_checkpoint(R3_CKPT)['epoch']}")
    models = {"cuda": r3_model(cfg, "cuda", state), "cpu": r3_model(cfg, "cpu", state)}
    bb = cfg.model.backbone_conf
    expect, levels = r3_forward_counts(bb), len(bb.enc_depths)
    sums = {dev: {"weighted": 0.0, "argmax": 0.0} for dev in models}
    worst, ties = 0.0, []
    batches = r3_val_batches(cfg)
    for i, b in enumerate(batches):
        outs = {}
        for dev, model in models.items():
            set_launch_counts_to_zero()
            with torch.no_grad():
                out = model(build_point_batch(sample_to_device(b, dev), 1))
            if dev == "cuda":
                torch.cuda.synchronize()
                counts, built = launch_counts(), sc.rulebook_builds
                if counts != expect or built != levels:
                    raise AssertionError(f"r3 scene {i}: expected launches {expect} and {levels} rulebooks, got "
                                         f"{counts} and {built}")
            outs[dev] = o = {k: v.float().cpu().numpy() for k, v in out.items()}
            d = keypoint_distances(b["coord"], b["valid"], o["offset_pred"], expit(o["mask_logits"]),
                                   b["keypoint_offset"], b["keypoint_mask"], b["scale"], 1, 0.5)
            for m in sums[dev]:
                sums[dev][m] = sums[dev][m] + d[m].sum(0)
        v = b["valid"]
        for key in ("offset_pred", "mask_logits"):
            a, ref = outs["cuda"][key][v], outs["cpu"][key][v]
            err = float(np.abs(a - ref).max())
            rel = err / max(1.0, float(np.abs(ref).max()))
            worst = max(worst, rel)
            if not (np.isfinite(a).all() and rel <= CPU_TOL):
                raise AssertionError(f"r3 scene {i}: card and CPU disagree on {key}: {err:.3e}")
        logits, ref_logits = outs["cuda"]["mask_logits"][v], outs["cpu"]["mask_logits"][v]
        tie = 2 * float(np.abs(logits - ref_logits).max())
        card_pick, cpu_pick = expit(logits).argmax(0), expit(ref_logits).argmax(0)
        for k in np.nonzero(card_pick != cpu_pick)[0]:
            gap = abs(float(ref_logits[cpu_pick[k], k] - ref_logits[card_pick[k], k]))
            ties.append((i, int(k), gap, tie))
            if gap > tie:
                raise AssertionError(f"r3 scene {i} keypoint {k}: argmax picks differ away from a tie ({gap} > {tie})")
    mm = {dev: {m: float(np.mean(t / len(batches))) for m, t in d.items()} for dev, d in sums.items()}
    print(f"r3 card vs cpu outputs over {len(batches)} val scenes (valid rows): worst max abs err / max(1, |cpu|) "
          f"{worst:.3e}, tol {CPU_TOL:g}; argmax picks on near ties (scene, keypoint, logit gap, 2 x error): {ties}")
    print(f"r3 anchor (exp/kp_r3, {len(batches)} val scenes, np.random seed {cfg.seed}): card weighted "
          f"{mm['cuda']['weighted']:.4f} mm, argmax {mm['cuda']['argmax']:.4f} mm; CPU weighted "
          f"{mm['cpu']['weighted']:.4f} mm, argmax {mm['cpu']['argmax']:.4f} mm; bounds < {R3_WEIGHTED_MM} and "
          f"< {R3_ARGMAX_MM} mm, card within {R3_ANCHOR_MM} mm of the CPU {stamp()}")
    card, cpu = mm["cuda"], mm["cpu"]
    if not (card["weighted"] < R3_WEIGHTED_MM and card["argmax"] < R3_ARGMAX_MM):
        raise AssertionError(f"the card's r3 anchor is out of bounds: {card}")
    if abs(card["weighted"] - cpu["weighted"]) >= R3_ANCHOR_MM or (
            abs(card["argmax"] - cpu["argmax"]) >= R3_ANCHOR_MM and not ties):
        raise AssertionError(f"the card's r3 anchor {card} is not the CPU's {cpu}")
    maps = {}
    for label, b in (("r3 request", batches[0]), ("r3 step", r3_val_batches(cfg, cfg.batch_size)[0])):
        with torch.no_grad():
            maps[label] = capture_maps(models["cuda"], lambda b=b: models["cuda"](
                build_point_batch(sample_to_device(b, "cuda"), b["num_samples"])), label)
    return dict(anchor=card, request_maps=maps["r3 request"], step_maps=maps["r3 step"])


def phase_r3_serve(cfg) -> list:
    """The r3 server (``--weight exp/kp_r3/model_params.ckpt --slot-size 4096``): 1 warm-up and 3 POSTs of
    body-like clouds of the r3 data's size through HTTP.  The server estimates normals from the cloud,
    so these are not the val scenes, and no mm is gated on them."""
    predictor = serve.build_predictor("offset_keypoint", cfg, load_weights(R3_CKPT), cfg.slot_size, "cuda")
    rng = np.random.default_rng(11)
    clouds = [request_cloud(rng, R3_CLOUD_POINTS) for _ in range(REQUESTS + 1)]
    warm = clouds.pop()
    predictor.predict(warm[:, :3], warm[:, 3:])
    latencies, _ = phase_serve(predictor, clouds, cfg.model.backbone_conf, check_keypoints)
    print(f"r3 request latency (host clock, POST to reply, slot {cfg.slot_size}, {REQUESTS} requests of "
          f"{R3_CLOUD_POINTS} points x 7): median {statistics.median(latencies):.2f} ms, each "
          f"{[round(x, 2) for x in latencies]} {stamp()}")
    return latencies


def r3_train_config(save_path: str, **options):
    cfg = Config.fromfile(R3_CONFIG)
    cfg.merge_from_dict(dict(save_path=save_path, **options))
    return cfg


def hook(trainer, name: str):
    return next(h for h in trainer.hooks if type(h).__name__ == name)


def recorded_evaluation(trainer) -> dict:
    """A dict that each run of the trainer's OffsetKeypointEvaluator fills with its weighted and argmax mm
    (the trainer clears its histories after every epoch)."""
    evaluator, seen = hook(trainer, "OffsetKeypointEvaluator"), {}
    run = evaluator.after_epoch

    def recorded():
        run()
        seen.update({m: trainer.storage.history(f"val/keypoint_dist_{m}").latest for m in ("weighted", "argmax")})

    evaluator.after_epoch = recorded
    return seen


def phase_r3_train(cfg) -> dict:
    """The r3 recipe's trainer as written (batch 4, slot 4096, 128 scenes of 6,000 points, AdamW 1.5e-3 under
    cosine over its 64 epochs): its first epoch, 32 steps, each step's launches counted (B1 5, B2 5, B3 11,
    B4 6, 3 rulebooks), then its evaluator and saver; one step under torch.profiler; one step at batch 1,
    card against CPU; then a trainer with ``weight=`` the checkpoint, whose CheckpointLoader loads it and
    whose evaluator runs before any step."""
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(r3_train_config(tmp), device="cuda")
        epoch_mm = recorded_evaluation(trainer)
        total = len(trainer.train_loader) * trainer.max_epoch
        trainer.max_epoch = 1  # the recipe's first epoch; the schedule keeps the whole run's length
        print(f"r3 train: {len(trainer.train_loader)} steps of batch {cfg.batch_size} per epoch, slot {cfg.slot_size}, "
              f"cosine over {total} steps (lr {trainer.lr_schedule(0):.4e} at step 0), "
              f"{sum(p.numel() for p in trainer.model.parameters())} parameters")
        run = counted_training(trainer, "r3 train", cfg.model.backbone_conf)
        if len(run["steps"]) != len(trainer.train_loader):
            raise AssertionError(f"r3 train: ran {len(run['steps'])} steps, not the epoch's {len(trainer.train_loader)}")
        if sorted(epoch_mm) != ["argmax", "weighted"] or not all(np.isfinite(x) for x in epoch_mm.values()):
            raise AssertionError(f"r3 train: the evaluator gave no finite mm error: {epoch_mm}")
        print(f"r3 train: OffsetKeypointEvaluator after the first epoch: weighted {epoch_mm['weighted']:.2f} mm, "
              f"argmax {epoch_mm['argmax']:.2f} mm {stamp()}")
        run["profile"] = profile_step(trainer, trainer.run_step)
        del trainer
        torch.cuda.empty_cache()

        model_cfg = dict(cfg.model)
        model_cfg["backbone_conf"] = dict(cfg.model.backbone_conf, drop_path=0.0, shuffle_orders=False)
        np.random.seed(5)
        run["cpu"] = compare_step("r3", model_cfg, collate([build_dataset(dict(cfg.data.train))[0]], cfg.slot_size,
                                                            np.random), torch.float32, TRAIN_CPU_TOL)

        trainer = Trainer(r3_train_config(os.path.join(tmp, "weight"), weight=R3_CKPT), device="cuda")
        trainer.storage = EventStorage()
        loaded_mm = recorded_evaluation(trainer)
        hook(trainer, "CheckpointLoader").before_train()
        state = load_jax_checkpoint(R3_CKPT)
        if not all(torch.equal(v.cpu(), state[k]) for k, v in trainer.model.state_dict().items()):
            raise AssertionError("r3 train: CheckpointLoader did not load the checkpoint's weights")
        hook(trainer, "OffsetKeypointEvaluator").after_epoch()
        print(f"r3 train with weight={R3_CKPT}: CheckpointLoader loaded it; its OffsetKeypointEvaluator before any "
              f"step (the trainer's val loader, batch {cfg.batch_size}): weighted {loaded_mm['weighted']:.4f} mm, "
              f"argmax {loaded_mm['argmax']:.4f} mm {stamp()}")
        if not (loaded_mm["weighted"] < R3_WEIGHTED_MM and loaded_mm["argmax"] < R3_ARGMAX_MM):
            raise AssertionError(f"r3 train: the loaded checkpoint evaluates out of bounds: {loaded_mm}")
        del trainer
    return run


def phase_r3_times(cfg, request_maps: dict, step_maps: dict, request_counts: dict, step_counts: dict) -> dict:
    """Each kernel at the r3 levels beside its plain version, its library call and its bound, summed per
    r3 request (B1, B3; batch 1) and per r3 training step (B1-B4; batch 4), the stem's B3 (and B4) at
    Cin 7 among them; the sums' launches are checked against the counts of the runs."""
    rng = np.random.default_rng(12)
    bb = cfg.model.backbone_conf
    c0, cin, n0 = bb.enc_channels[0], bb.in_channels, cfg.slot_size
    per_block = {"patch_attention_fwd": 1, "patch_attention_bwd": 1, "subm_conv_fwd": 2, "subm_conv_dw": 1}
    sums = {"request": {}, "step": {}}
    for key, batch, maps in (("request", 1, request_maps), ("step", cfg.batch_size, step_maps)):
        totals, launches = sums[key], {}
        for (n, c, heads, patch), depth in seg_shapes(bb, n0, batch).items():
            print(f"r3 {key} level N={n} C={c} H={heads} patch={patch} f32 (x{depth} Blocks):")
            rows = {"patch_attention_fwd": time_attention(rng, n, heads, patch, torch.float32, backward=False),
                    "subm_conv_fwd": time_conv(rng, maps[n], c, torch.float32, dw=False)}
            if key == "step":
                rows["patch_attention_bwd"] = time_attention(rng, n, heads, patch, torch.float32, backward=True)
                rows["subm_conv_dw"] = time_conv(rng, maps[n], c, torch.float32, dw=True)
            for name, row in rows.items():
                k = (per_block[name] if key == "step" else 1) * depth
                add_row(totals, name, row, k)
                launches[name] = launches.get(name, 0) + k
        print(f"r3 {key} stem N={n0 * batch} Cin={cin} Cout={c0} f32 (x1):")
        stem = {"subm_conv_fwd": time_conv(rng, maps[n0 * batch], c0, torch.float32, dw=False, cin=cin)}
        if key == "step":
            stem["subm_conv_dw"] = time_conv(rng, maps[n0 * batch], c0, torch.float32, dw=True, cin=cin)
        for name, row in stem.items():
            add_row(totals, name, row, 1)
            launches[name] += 1
        counts = request_counts if key == "request" else step_counts
        for name, t in totals.items():
            if launches[name] != counts[name]:
                raise AssertionError(f"r3 {key}: {name} timed for {launches[name]} launches, the run made "
                                     f"{counts[name]}")
            t["launches"] = launches[name]
            print(f"{name} per r3 {key} (f32, sum over its {launches[name]} launches): kernel {t['ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")
    return sums


# ---- the SpUNet slice: exp/semseg_r3, its tester and the ScanNet SpUNet recipe ----------------------------

SPUNET_CONFIG = "configs/scannet/semseg-spunet-v1m1-0-base.py"
SEMSEG_R3_CONFIG = "configs/synthetic/semseg-spunet-r3.py"
SEMSEG_R3_TEST_CONFIG = "configs/synthetic/semseg-spunet-r3-test.py"
SEMSEG_R3_CKPT = "exp/semseg_r3/model_params.ckpt"
# the mIoU of exp/semseg_r3: tests/test_semseg_checkpoint.py's bound, and how far the card's may lie from the
# CPU's on the same scenes (a label may differ only on a tie, as in phase 10)
SEMSEG_R3_MIOU, SEMSEG_R3_MIOU_TOL = 0.95, 0.005
# the ScanNet recipes' transforms that the port lacked when the ScanNet SpUNet phase was written: that phase
# still leaves them out, so that its readings stay comparable with the ones recorded before (PERF.md); the
# PointGroup phases run them
# phase 25 takes the ScanNet SpUNet recipe's batch-1 step at one block per stage (its widths, k=5 stem and
# slot): at the recipe's depth its CPU side took 52-57 s on the H100 machine's host, the script's largest
# CPU cost (PERF.md §6)
SCANNET_CPU_LAYERS = (1,) * 8
SCANNET_ONLY = ("RandomDropout", "ElasticDistortion", "ChromaticAutoContrast", "ChromaticTranslation",
                "ChromaticJitter", "SphereCrop")


def synthetic_rooms(config: str, split: str, scenes: int, points: int, leave_out=()):
    """SyntheticSemSegDataset rooms through a ScanNet recipe's own transforms, less ``leave_out``, with the
    synthetic features (coord, color): the rooms carry no normals (6 channels either way)."""
    transform = [dict(t, feat_keys=("coord", "color")) if t["type"] == "Collect" else dict(t)
                 for t in Config.fromfile(config).data[split].transform if t["type"] not in leave_out]
    return dict(_delete_=True, type="SyntheticSemSegDataset", split=split, num_scenes=scenes, num_points=points,
                num_classes=20, transform=transform)


def spunet_train_config(save_path: str):
    """The ScanNet SpUNet recipe as written (batch 8, slot 131072, k=5 stem, SGD 0.05 nesterov under
    OneCycleLR, Mix3D 0.8, f32) on synthetic rooms of ScanNet's scale: SEG_STEPS steps per epoch."""
    cfg = Config.fromfile(SPUNET_CONFIG)
    cfg.merge_from_dict({"save_path": save_path, "seed": 0,
                         "data.train": synthetic_rooms(SPUNET_CONFIG, "train", SEG_STEPS * cfg.batch_size,
                                                       SCANNET_POINTS, SCANNET_ONLY),
                         "data.val": synthetic_rooms(SPUNET_CONFIG, "val", cfg.batch_size, SCANNET_POINTS,
                                                     SCANNET_ONLY)})
    return cfg


def semseg_r3_train_config(save_path: str):
    """The semseg-spunet-r3 recipe as written (batch 4, slot 8192, k=3 stem, AdamW 3e-3 under PolyLR, 96
    scenes of 16,000 points): 24 steps per epoch."""
    cfg = Config.fromfile(SEMSEG_R3_CONFIG)
    cfg.merge_from_dict({"save_path": save_path})
    return cfg


def spunet_convs(bb, slot: int, batch: int) -> list:
    """Every SubMConv of an SpUNet forward (``models/sparse_unet.py``) at ``batch`` samples of ``slot``:
    (level, N, K, Cin, Cout, is the stem), in call order.  Level 0 is the input's rows; level s + 1 the
    rows of encoder stage s (at slot divisor 1 as many as level 0's)."""
    stages = len(bb["layers"]) // 2
    divisors = bb.get("slot_divisors", (1, 2, 4, 8))
    rows = [slot * batch] + [batch * max(slot // divisors[s], 1) for s in range(stages)]
    stem_k, base, ch, layers = bb.get("stem_kernel", 5), bb.get("base_channels", 32), bb["channels"], bb["layers"]
    convs = [(0, rows[0], stem_k**3, bb["in_channels"], base, True)]
    widths = [base] + [ch[s] for s in range(stages)]
    for s in range(stages):
        convs += [(s + 1, rows[s + 1], 27, ch[s], ch[s], False)] * 2 * layers[s]
    for s in reversed(range(stages)):
        dec = ch[len(ch) - s - 2]
        for i in range(layers[len(ch) - s - 1]):
            convs += [(s, rows[s], 27, dec + widths[s] if i == 0 else dec, dec, False),
                      (s, rows[s], 27, dec, dec, False)]
    return convs


def spunet_expect(bb, training: bool):
    """(launches, rulebooks) of one SpUNet forward or training step: B3 once per conv, and once more for
    each conv's input gradient but the stem's (its input needs none); B4 once per conv in training; one
    rulebook per kernel map: the stem's (k > 3) and one k=3 map per level."""
    convs = 1 + 2 * sum(bb["layers"])
    launches = {"patch_attention_fwd": 0, "patch_attention_bwd": 0,
                "subm_conv_fwd": 2 * convs - 1 if training else convs, "subm_conv_dw": convs if training else 0}
    return launches, 1 + len(bb["layers"]) // 2 + int(bb.get("stem_kernel", 5) != 3)


def capture_spunet_maps(run, label: str) -> dict:
    """{(level, K): kernel map} of every map that ``run()``'s SpUNet forward builds: level 0's stem map
    (k > 3) and k=3 map, then one k=3 map per encoder stage, in that order."""
    make, built = spunet_module.build_kernel_map, []

    def record(*args, **kwargs):
        built.append(make(*args, **kwargs))
        return built[-1]

    spunet_module.build_kernel_map = record
    try:
        run()
    finally:
        spunet_module.build_kernel_map = make
    maps, level = {}, 0
    for kmap in built:
        idx = kmap.neighbor_idx
        n, k = idx.shape
        if (level, k) in maps:
            level += 1
        maps[(level, k)] = idx
        print(f"{label} map level {level} N={n} K={k}: {int((idx < n).sum())} hits, {int((idx[:, k // 2] < n).sum())} "
              f"valid rows")
    return maps


def phase_spunet_train(label: str, cfg, probe_keys=("loss",), probe_steps: int = PROBE_STEPS, expect=None,
                       capture=None) -> dict:
    """An SpUNet recipe's trainer on the card with its hooks: its first epoch, each step's launches and
    rulebooks counted (``spunet_expect``, or ``expect``) and every kernel's input held to f32, then its
    evaluator and the saver; one step under torch.profiler; the kernel maps of a batch of the recipe's
    data (``capture_spunet_maps``, or ``capture(model, run, label)``); then ``probe_steps`` steps of a fresh
    trainer on that batch, each of whose ``probe_keys`` losses must end below its first value."""
    bb = cfg.model.backbone
    trainer = Trainer(cfg, device="cuda")
    total = len(trainer.train_loader) * trainer.max_epoch
    trainer.max_epoch = 1  # the recipe's first epoch; the schedule keeps the whole run's length
    print(f"{label}: {len(trainer.train_loader)} steps of batch {cfg.batch_size} per epoch, slot {cfg.slot_size}, "
          f"stem k={bb.get('stem_kernel', 5)}, mix_prob {cfg.get('mix_prob')}, {cfg.optimizer['type']} under "
          f"{cfg.scheduler['type']} over {total} steps (lr {trainer.lr_schedule(0):.4e} at step 0), "
          f"{sum(p.numel() for p in trainer.model.parameters())} parameters")
    spies, run_step = KernelDtypes(), trainer.run_step

    def watched_step():
        with spies:
            run_step()

    trainer.run_step = watched_step
    run = counted_training(trainer, label, bb, expect=expect or spunet_expect(bb, training=True))
    trainer.run_step = run_step
    seen = {name: kinds for name, kinds in spies.seen.items() if kinds}
    print(f"{label}: dtypes the kernels received in the training steps: {seen}")
    if set(seen) != {"subm_conv_fwd", "subm_conv_dw"} or any(kinds != {"float32"} for kinds in seen.values()):
        raise AssertionError(f"{label}: expected B3 and B4 in float32 only, got {seen}")
    metric, name = trainer.comm_info.get("current_metric_value"), trainer.comm_info.get("current_metric_name")
    if metric is None or not 0.0 <= metric <= 1.0:
        raise AssertionError(f"{label}: the evaluator gave no {name} in [0, 1]: {metric}")
    print(f"{label}: the evaluator over {len(trainer.val_loader.dataset)} val scenes: {name} {metric:.4f} after "
          f"{len(run['steps'])} steps {stamp()}")
    run["profile"] = profile_step(trainer, trainer.run_step)
    batch = next(iter(trainer.train_loader))
    model = trainer.model.eval()
    with torch.no_grad():
        forward = lambda: model(build_point_batch(sample_to_device(batch, "cuda"), batch["num_samples"]))  # noqa: E731
        run["maps"] = capture(model, forward, label) if capture else capture_spunet_maps(forward, label)
    del trainer, model
    torch.cuda.empty_cache()
    probe = Trainer(cfg, device="cuda")
    metrics = []
    for _ in range(probe_steps):
        probe.comm_info["input_dict"] = batch
        probe.run_step()
        metrics.append(probe.comm_info["metrics"])
    print(f"{label}: {probe_steps} steps of a fresh trainer on one fixed batch: "
          f"{ {k: [round(m[k], 5) for m in metrics] for k in metrics[0]} } {stamp()}")
    if not np.isfinite([list(m.values()) for m in metrics]).all():
        raise AssertionError(f"{label}: a loss on a fixed batch is not finite: {metrics}")
    for key in probe_keys:
        if not metrics[-1][key] < metrics[0][key]:
            raise AssertionError(f"{label}: {key} did not fall on a fixed batch: {[m[key] for m in metrics]}")
    del probe
    torch.cuda.empty_cache()
    return run


def phase_spunet_train_cpu(label: str, cfg, layers=None) -> dict:
    """One training step of an SpUNet recipe at batch 1 (one sample of its training data, seed 5, at its
    slot), card against CPU in f32 within TRAIN_CPU_TOL, the card on the CPU's side of every ReLU tie;
    with ``layers``, the backbone at that depth."""
    np.random.seed(5)
    batch_np = collate([build_dataset(dict(cfg.data.train))[0]], cfg.slot_size, np.random)
    model_cfg = dict(cfg.model)
    if layers is not None:
        model_cfg["backbone"] = dict(cfg.model.backbone, layers=layers)
    return compare_step(label, model_cfg, batch_np, torch.float32, TRAIN_CPU_TOL, relu_ties=True)


def phase_spunet_kernels(label: str, bb, slot: int, batch: int, maps: dict, counts: dict,
                         dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """B3 and B4 against their plain versions at every conv shape of an SpUNet training step, in each of
    ``dtypes``, on the maps of a batch of the recipe's data (the stem's K = k^3 map among them, its Cin
    padded to 8 for the kernels), all bit for bit run to run; each timed in f32 beside its plain version, its
    library call (gather + torch.matmul) and its bound, summed per step: B3 per conv forward and, but for
    the stem, for its input gradient (Cin and Cout swapped); B4 per conv.  The sums' launches are checked
    against ``counts``, one step's.  Returns (per-step sums, each kernel's largest f32 error, the stem's
    rows)."""
    rng = np.random.default_rng(13)
    convs = spunet_convs(bb, slot, batch)
    shapes = {}
    for conv in convs:
        shapes[conv] = shapes.get(conv, 0) + 1
    sums, launches, errors, stem = {}, dict.fromkeys(SOURCES, 0), dict.fromkeys(SOURCES, 0.0), {}
    for (level, n, k, cin, cout, is_stem), reps in shapes.items():
        idx = maps[(level, k)]
        for dtype in dtypes:
            found = {"subm_conv_fwd": check_conv(rng, idx, cout, dtype, cin),
                     "subm_conv_dw": check_conv_dw(rng, idx, cout, dtype, cin)}
            if not is_stem:
                found["subm_conv_fwd"] = max(found["subm_conv_fwd"], check_conv(rng, idx, cin, dtype, cout))
            check_conv_bits(rng, idx, cout, dtype, cin)
            if dtype == torch.float32:
                for name, err in found.items():
                    errors[name] = max(errors[name], err)
        print(f"{label} conv level {level} N={n} K={k} Cin={cin} Cout={cout}{' (the stem)' if is_stem else ''} f32 "
              f"(x{reps} per forward):")
        rows = [("subm_conv_fwd", time_conv(rng, idx, cout, torch.float32, dw=False, cin=cin)),
                ("subm_conv_dw", time_conv(rng, idx, cout, torch.float32, dw=True, cin=cin))]
        if not is_stem:
            rows.append(("subm_conv_fwd", time_conv(rng, idx, cin, torch.float32, dw=False, cin=cout)))
        elif torch.bfloat16 in dtypes:
            stem = dict(rows)
            print(f"{label} stem N={n} K={k} Cin={cin} Cout={cout} bf16:")
            stem["bf16_fwd"] = time_conv(rng, idx, cout, torch.bfloat16, dw=False, cin=cin)
            stem["bf16_dw"] = time_conv(rng, idx, cout, torch.bfloat16, dw=True, cin=cin)
        for name, row in rows:
            add_row(sums, name, row, reps)
            launches[name] += reps
    for name, t in sums.items():
        if launches[name] != counts[name]:
            raise AssertionError(f"{label}: {name} timed for {launches[name]} launches, the step made {counts[name]}")
        t["launches"] = launches[name]
        print(f"{name} per {label} step (f32, sum over its {launches[name]} launches): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")
    return sums, errors, stem


def phase_semseg_r3_anchor() -> dict:
    """``exp/semseg_r3`` read by the port's reader into its DefaultSegmentor over SpUNet-v1m1, on the card
    and on the CPU: its 8 val scenes (np.random seeded with the recipe's seed, 123; batch 1 at slot 8192),
    each card forward's launches (B3 once per conv) and rulebooks (one per level) counted; logits card
    against CPU within CPU_TOL; labels apart only on a tie; the mIoU over the valid rows of the 8 scenes
    (intersections and unions summed) above SEMSEG_R3_MIOU on the card, within SEMSEG_R3_MIOU_TOL of the
    CPU's."""
    cfg = Config.fromfile(SEMSEG_R3_CONFIG)
    t0 = time.perf_counter()
    state = load_jax_checkpoint(SEMSEG_R3_CKPT)
    print(f"semseg_r3: {SEMSEG_R3_CKPT} read by the port's reader in {(time.perf_counter() - t0) * 1e3:.1f} ms, "
          f"{len(state)} tensors")
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = build_model(dict(cfg.model))
        models[dev].load_state_dict(state, strict=True)
        models[dev].to(dev).eval()
    bb, k = cfg.model.backbone, cfg.data.num_classes
    expect, levels = spunet_expect(bb, training=False)
    ds = build_dataset(dict(cfg.data.val))
    np.random.seed(cfg.seed)
    batches = [collate([ds[i]], cfg.slot_size, np.random) for i in range(len(ds))]
    sums = {dev: np.zeros((2, k)) for dev in models}
    worst, ties, times = 0.0, 0, []
    for i, b in enumerate(batches):
        logits = {}
        for dev, model in models.items():
            batch = sample_to_device(b, dev)
            set_launch_counts_to_zero()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = model(build_point_batch(batch, 1), batch)["seg_logits"]
            if dev == "cuda":
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                counts, built = launch_counts(), sc.rulebook_builds
                if counts != expect or built != levels:
                    raise AssertionError(f"semseg_r3 scene {i}: expected launches {expect} and {levels} rulebooks, "
                                         f"got {counts} and {built}")
            logits[dev] = out.float().cpu()
            inter, union, _ = intersection_and_union(logits[dev].argmax(-1), torch.from_numpy(b["segment"]), k, -1,
                                                     torch.from_numpy(b["valid"]))
            sums[dev] += np.stack([inter.numpy(), union.numpy()])
        v = torch.from_numpy(b["valid"])
        a, ref = logits["cuda"][v], logits["cpu"][v]
        err = (a - ref).abs().max().item()
        rel = err / max(1.0, ref.abs().max().item())
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= CPU_TOL):
            raise AssertionError(f"semseg_r3 scene {i}: card and CPU disagree on the logits: {err:.3e}")
        top2 = ref.topk(2, -1).values
        differ = a.argmax(-1) != ref.argmax(-1)
        if (differ & (top2[:, 0] - top2[:, 1] > 2 * err)).any():
            raise AssertionError(f"semseg_r3 scene {i}: labels differ away from a tie")
        ties += int(differ.sum())
    miou = {dev: float(np.mean(s[0] / np.maximum(s[1], 1))) for dev, s in sums.items()}
    print(f"semseg_r3 card vs cpu logits over {len(batches)} val scenes (valid rows): worst max abs err / max(1, "
          f"|cpu|) {worst:.3e}, tol {CPU_TOL:g}; {ties} labels differ, each on a tie; card forward (batch 1, slot "
          f"{cfg.slot_size}) median {statistics.median(times):.2f} ms (host clock)")
    print(f"semseg_r3 anchor (exp/semseg_r3, {len(batches)} val scenes, np.random seed {cfg.seed}): mIoU card "
          f"{miou['cuda']:.6f}, CPU {miou['cpu']:.6f}; bound > {SEMSEG_R3_MIOU}, card within {SEMSEG_R3_MIOU_TOL} of "
          f"the CPU {stamp()}")
    if not (miou["cuda"] > SEMSEG_R3_MIOU and abs(miou["cuda"] - miou["cpu"]) < SEMSEG_R3_MIOU_TOL):
        raise AssertionError(f"the card's semseg_r3 mIoU {miou['cuda']} is out of bounds or not the CPU's {miou['cpu']}")
    return dict(miou=miou, worst=worst)


def phase_semseg_r3_tester() -> dict:
    """The port's ``test`` CLI on the card over ``configs/synthetic/semseg-spunet-r3-test.py``: exp/semseg_r3
    through SemSegTester, 8 synthetic test scenes, 3 RandomScale variants of GridSample's test-mode
    fragments; every fragment's forward launches B3 once per conv and builds one rulebook per level; the
    mIoU above SEMSEG_R3_MIOU and a prediction saved per scene."""
    bb = Config.fromfile(SEMSEG_R3_CONFIG).model.backbone
    expect, levels = spunet_expect(bb, training=False)
    with tempfile.TemporaryDirectory() as tmp:
        np.random.seed(123)  # the test scenes' GridSample (train mode) draws from it
        set_launch_counts_to_zero()
        t0 = time.perf_counter()
        result = test_cli.main(["--config-file", SEMSEG_R3_TEST_CONFIG, "--options", f"save_path={tmp}"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, built = launch_counts(), sc.rulebook_builds
        saved = sorted(f for f in os.listdir(os.path.join(tmp, "result")) if f.endswith("_pred.npy"))
    forwards = built // levels
    print(f"semseg_r3 tester (test CLI on the card): {forwards} fragment forwards in {seconds:.2f} s (host clock, "
          f"data included), launches {counts}, rulebooks {built}; {len(saved)} predictions saved; mIoU/mAcc/allAcc "
          f"{result['mIoU']:.4f}/{result['mAcc']:.4f}/{result['allAcc']:.4f} {stamp()}")
    if not forwards or built != forwards * levels or counts != {k: v * forwards for k, v in expect.items()}:
        raise AssertionError(f"semseg_r3 tester: launches {counts} and {built} rulebooks are not {forwards} forwards' "
                             f"{expect} and {levels}")
    if len(saved) != 8 or not result["mIoU"] > SEMSEG_R3_MIOU:
        raise AssertionError(f"semseg_r3 tester: {len(saved)} predictions saved, mIoU {result['mIoU']}")
    return dict(result, forwards=forwards, seconds=seconds)


def spunet_rows(kernels, key: str, sums: dict, errors: dict, counts: dict) -> None:
    """``{key}_*`` per-step entries of B3 and B4 on the kernels line (0 launches of B1 and B2)."""
    for row in kernels:
        t = sums.get(row["name"])
        row[f"{key}_launches"] = counts[row["name"]]
        if t is not None:
            row.update({f"{key}_max_abs_err": errors[row["name"]], f"{key}_ms": t["ms"],
                        f"{key}_plain_ms": t["plain_ms"], f"{key}_library_ms": t["library_ms"],
                        f"{key}_bound_ms": t["bound_ms"],
                        f"{key}_bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"})


# ---- the insseg slice: PointGroup, exp/insseg_r3, its tester and the PointGroup recipes ------------------

INSSEG_R3_CONFIG = "exp/insseg_r3/config.py"  # the committed run's config: its recipe, weight and InsSegTester
INSSEG_R3_RECIPE = "configs/synthetic/insseg-pointgroup-r3.py"
PG_V1M1_CONFIG = "configs/scannet/insseg-pointgroup-v1m1-0-spunet-base.py"
PG_V1M2_CONFIG = "configs/scannet/insseg-pointgroup-v1m2-0-ptv3-base.py"
# exp/insseg_r3's AP over its 6 val scenes: tests/test_insseg_checkpoint.py's bounds (mAP, AP50; AP25 held
# to AP50's)
INSSEG_MAP, INSSEG_AP50 = 0.70, 0.85
# the card's AP against the CPU's on the same scenes.  kNN and clustering give the same labels on both devices
# for the same inputs (phase 30); the inputs differ by f32 rounding of the forward, so a point whose shifted
# position lies within that rounding of the cluster radius, or whose two best classes tie, may change its
# cluster and move one proposal's IoU.  0.005 of mAP is under a third of the anchor's spread over np.random
# seeds (0.749739-0.766294, both packages alike: scripts/insseg_r3_anchor_by_seed.py) and over 20 times what
# one such point moves (a proposal's IoU of ~600 points across one of 10 thresholds: 1/(4 x 10) of one class's
# AP at most, only where it sits on the threshold)
INSSEG_AP_TOL = 0.005


def phase_insseg_anchor() -> dict:
    """``exp/insseg_r3`` (PG-v1m1 over SpUNet, k=3 stem) through the port's InsSegTester on the card and on
    the CPU over its 6 val scenes (np.random seeded with the recipe's seed, 7, before each pass: GridSample's
    train mode draws the scenes): each card forward's launches (B3 once per conv) and rulebooks counted;
    every scene's shifts and probabilities card against CPU within CPU_TOL and its cluster labels compared;
    mAP, AP50 and AP25 at or above the bounds on the card, within INSSEG_AP_TOL of the CPU's; then the
    port's ``test`` CLI over the config on the card, which must read the card tester's AP exactly."""
    cfg = Config.fromfile(INSSEG_R3_CONFIG)
    expect, levels = spunet_expect(cfg.model.backbone, training=False)
    result, outs, labels, seconds = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg.save_path = tmp
        for dev in ("cuda", "cpu"):
            tester = InsSegTester(cfg, device=dev, **{k: v for k, v in cfg.test.items() if k != "type"})
            forward, cluster = tester.forward, test_module.cluster_proposals
            outs[dev], labels[dev] = [], []

            def recorded_forward(tensors, _forward=forward, _outs=outs[dev]):
                out = _forward(tensors)
                _outs.append((tensors["valid"].cpu().numpy(), out[1].float().cpu().numpy(), out[2].cpu().numpy()))
                return out

            def recorded_cluster(*args, _labels=labels[dev], **kwargs):
                _labels.append(cluster(*args, **kwargs))
                return _labels[-1]

            tester.forward, test_module.cluster_proposals = recorded_forward, recorded_cluster
            np.random.seed(cfg.seed)
            set_launch_counts_to_zero()
            t0 = time.perf_counter()
            try:
                result[dev] = tester.test()
            finally:
                test_module.cluster_proposals = cluster
            seconds[dev] = time.perf_counter() - t0
            if dev == "cuda":
                counts, built, scenes = launch_counts(), sc.rulebook_builds, len(outs[dev])
                if scenes != 6 or built != scenes * levels or counts != {k: v * scenes for k, v in expect.items()}:
                    raise AssertionError(f"insseg_r3 anchor: {scenes} scenes, launches {counts} and {built} rulebooks "
                                         f"are not {expect} and {levels} a forward")
            del tester
        worst, ties, moved = 0.0, 0, 0
        for i, ((v, bias, probs), (_, ref_bias, ref_probs)) in enumerate(zip(outs["cuda"], outs["cpu"])):
            for got, ref in ((bias, ref_bias), (probs, ref_probs)):
                err = float(np.abs(got[v] - ref[v]).max()) / max(1.0, float(np.abs(ref[v]).max()))
                worst = max(worst, err)
                if not (np.isfinite(got).all() and err <= CPU_TOL):
                    raise AssertionError(f"insseg_r3 scene {i}: card and CPU disagree: {err:.3e}")
            ties += int((probs[v].argmax(-1) != ref_probs[v].argmax(-1)).sum())
            moved += int((labels["cuda"][i] != labels["cpu"][i]).sum())
        card, cpu = result["cuda"], result["cpu"]
        print(f"insseg_r3 card vs cpu over {len(outs['cuda'])} val scenes (valid rows): shifts and probabilities worst "
              f"max abs err / max(1, |cpu|) {worst:.3e}, tol {CPU_TOL:g}; {ties} predicted classes and {moved} cluster "
              f"labels differ; tester {seconds['cuda']:.2f} s on the card, {seconds['cpu']:.2f} s on the CPU (host "
              f"clock, data and clustering included)")
        print(f"insseg_r3 anchor (exp/insseg_r3, 6 val scenes, np.random seed {cfg.seed}): mAP/AP50/AP25 card "
              f"{card['mAP']:.6f}/{card['AP50']:.6f}/{card['AP25']:.6f}, CPU {cpu['mAP']:.6f}/{cpu['AP50']:.6f}/"
              f"{cpu['AP25']:.6f}; bounds mAP >= {INSSEG_MAP}, AP50 and AP25 >= {INSSEG_AP50}, card within "
              f"{INSSEG_AP_TOL} of the CPU {stamp()}")
        if not (card["mAP"] >= INSSEG_MAP and card["AP50"] >= INSSEG_AP50 and card["AP25"] >= INSSEG_AP50):
            raise AssertionError(f"the card's insseg_r3 AP is out of bounds: {card}")
        if any(abs(card[k] - cpu[k]) > INSSEG_AP_TOL for k in card):
            raise AssertionError(f"the card's insseg_r3 AP {card} is not the CPU's {cpu}")
        np.random.seed(cfg.seed)
        set_launch_counts_to_zero()
        cli = test_cli.main(["--config-file", INSSEG_R3_CONFIG, "--options", f"save_path={tmp}"])
        counts, built = launch_counts(), sc.rulebook_builds
    print(f"insseg_r3 test CLI on the card (InsSegTester, weight from the config): mAP/AP50/AP25 {cli['mAP']:.6f}/"
          f"{cli['AP50']:.6f}/{cli['AP25']:.6f}, launches {counts}, rulebooks {built} {stamp()}")
    if cli != card or counts != {k: v * 6 for k, v in expect.items()}:
        raise AssertionError(f"the test CLI read {cli} with launches {counts}, the tester {card}")
    return dict(card=card, cpu=cpu, seconds=seconds["cuda"])


@contextlib.contextmanager
def recorded_insseg_passes():
    """Each InsSegEvaluator pass's mAP and times (host clock, each part ending in a host read): the
    forwards, the clustering and, inside it, the kNN searches (synchronised around each)."""
    passes, knn_s, run_eval, run_knn = [], [0.0], InsSegEvaluator.eval, cluster_module.knn

    def knn(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_knn(*args, **kwargs)
        torch.cuda.synchronize()
        knn_s[0] += time.perf_counter() - t0
        return out

    def evaluate(self):
        knn_s[0] = 0.0
        run_eval(self)
        passes.append(dict(self.last_times, knn_s=knn_s[0], mAP=self.trainer.comm_info["current_metric_value"]))
        t = passes[-1]
        print(f"InsSegEvaluator pass: mAP {t['mAP']:.4f}; forwards {t['forward_s'] * 1e3:.1f} ms, clustering "
              f"{t['cluster_s'] * 1e3:.1f} ms of which kNN {t['knn_s'] * 1e3:.1f} ms and the label propagation "
              f"{(t['cluster_s'] - t['knn_s']) * 1e3:.1f} ms, AP {t['ap_s'] * 1e3:.1f} ms (host clock) {stamp()}")

    InsSegEvaluator.eval, cluster_module.knn = evaluate, knn
    try:
        yield passes
    finally:
        InsSegEvaluator.eval, cluster_module.knn = run_eval, run_knn


def pg_train_config(config: str, save_path: str, batch: int):
    """A ScanNet PointGroup recipe as written on synthetic rooms of ScanNet's scale through all its
    transforms, at ``batch``: SEG_STEPS steps per epoch, one val batch."""
    cfg = Config.fromfile(config)
    cfg.merge_from_dict({"save_path": save_path, "seed": 0, "batch_size": batch,
                         "data.train": synthetic_rooms(config, "train", SEG_STEPS * batch, SCANNET_POINTS),
                         "data.val": synthetic_rooms(config, "val", batch, SCANNET_POINTS)})
    return cfg


def insseg_r3_train_config(save_path: str):
    """The insseg r3 recipe as written (batch 4, slot 4096, k=3 stem, AdamW 3e-3 under PolyLR, 48 scenes of
    8,000 points): 12 steps per epoch."""
    cfg = Config.fromfile(INSSEG_R3_RECIPE)
    cfg.merge_from_dict({"save_path": save_path})
    return cfg


def phase_insseg_cluster_cpu() -> dict:
    """``connected_components`` on one val batch of the insseg r3 recipe (batch 4, slot 4096) with
    exp/insseg_r3's weights and its tester's radius and ignored classes: the card's shifted coordinates and
    classes clustered on the card and on the CPU must give equal labels; the CPU's own forward's clustered
    on the CPU may differ from the card's only where a predicted class or a connecting kNN edge (in radius,
    same class) differs (both counted)."""
    cfg = Config.fromfile(INSSEG_R3_CONFIG)
    radius, ignore = cfg.test.cluster_thresh, tuple(cfg.test.segment_ignore_index)
    ds = build_dataset(dict(cfg.data.val))
    np.random.seed(cfg.seed)
    batch_np = collate([ds[i] for i in range(cfg.batch_size)], cfg.slot_size, np.random)
    state = load_jax_checkpoint(cfg.weight)
    inputs, graphs, labels, ms = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(dict(cfg.model))
        model.load_state_dict(state, strict=True)
        model.to(dev).eval()
        batch = sample_to_device(batch_np, dev)
        point = build_point_batch(batch, batch_np["num_samples"])
        with torch.no_grad():
            out = model(point, batch)
        shifted, classes = point.coord + out["bias_pred"], out["seg_logits"].argmax(-1).to(torch.int32)
        inputs[dev] = (shifted, classes, point.valid, point.batch)
        rows = point.valid.nonzero().squeeze(1)
        idx, sqd = cluster_module.knn(shifted[rows], shifted, 16, query_batch=point.batch[rows],
                                      base_batch=point.batch, base_valid=point.valid)
        edge = (sqd <= radius * radius) & (classes[idx.long()] == classes[rows, None])
        pairs = rows[:, None] * point.num_points + idx.long()
        graphs[dev] = pairs[edge].cpu().numpy()
        t0 = time.perf_counter()
        labels[dev] = cluster_module.connected_components(*inputs[dev][:3], radius, batch=point.batch,
                                                          ignore_classes=ignore).cpu().numpy()
        ms[dev] = (time.perf_counter() - t0) * 1e3
    same = cluster_module.connected_components(*(t.cpu() for t in inputs["cuda"][:3]), radius,
                                               batch=inputs["cuda"][3].cpu(), ignore_classes=ignore).numpy()
    if not np.array_equal(same, labels["cuda"]):
        raise AssertionError(f"connected_components: card and CPU labels differ on the same inputs at "
                             f"{int((same != labels['cuda']).sum())} points")
    valid = batch_np["valid"]
    classes = int((inputs["cuda"][1].cpu().numpy() != inputs["cpu"][1].numpy())[valid].sum())
    edges = int(np.setxor1d(graphs["cuda"], graphs["cpu"]).size)
    moved = int((labels["cuda"] != labels["cpu"]).sum())
    print(f"connected_components on an insseg_r3 val batch ({int(valid.sum())} valid of {valid.size} rows, radius "
          f"{radius}): card and CPU on the card's inputs equal; on their own forwards {moved} labels differ, with "
          f"{classes} predicted classes and {edges} connecting kNN edges (in radius, same class) apart; {len(np.unique(labels['cuda']))} "
          f"labels; card {ms['cuda']:.1f} ms, CPU {ms['cpu']:.1f} ms (host clock) {stamp()}")
    if moved and not (classes or edges):
        raise AssertionError("connected_components: labels differ where no class and no edge does")
    return dict(moved=moved, classes=classes, edges=edges)



# ---- the keypoint-head slice: KeypointPTv3 / KeypointPTv3Plus, the pig readers, the body-measure regressor --

KP_PLUS_CONFIG = "configs/my_dataset/keypoint_ptv3_plus.py"
KP_CONFIG = "configs/my_dataset/keypoint_ptv3.py"
KP_SPUNET_CONFIG = "configs/my_dataset/keypoint_sparse_unet.py"
WEIGHT_CONFIG = "configs/my_dataset/ptv3_weight.py"
# points per written pig cloud: GridSample at 0.02 of the unit-radius cloud keeps 6,300-8,600 voxels (mean
# ~7,500) of the 8192 slot, so most clouds fill 0.8-1.0 of it and a few are subsampled
KP_CLOUD_POINTS = 11000
KP_CLOUDS = {"train": 32, "val": 8}  # the recipes' batch 8: 4 steps per epoch, one val batch
KP_CPU_BATCH = 2  # the card-vs-CPU step: the head's BatchNorm over one pooled row passes the backbone no gradient


def write_keypoint_clouds(root: str, seed: int = 17) -> None:
    """Seeded pig clouds in the pig readers' layout, per split: ``pointclouds/<ts>.npy`` (N x 7: xyz in mm,
    normal, curvature), ``keypoints/<ts>_关键点坐标.npy`` (6 x 3 mm) and ``labels/<ts>.npy`` (7 body measures:
    weight in kg, then six lengths in mm)."""
    rng = np.random.default_rng(seed)
    for split, count in KP_CLOUDS.items():
        for sub in ("pointclouds", "keypoints", "labels"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(count):
            coord, feat, kp = make_pig(rng, KP_CLOUD_POINTS)
            ts = str(1_700_000_000 + i)
            np.save(os.path.join(root, split, "pointclouds", f"{ts}.npy"), np.concatenate([coord, feat], 1))
            np.save(os.path.join(root, split, "keypoints", f"{ts}_关键点坐标.npy"), kp)
            np.save(os.path.join(root, split, "labels", f"{ts}.npy"),
                    np.concatenate([rng.uniform(80, 130, 1), rng.uniform(200, 1300, 6)]).astype(np.float32))


def recipe_config(config: str, root: str, save_path: str):
    """A keypoint or body-measure recipe as written, its readers' ``data_root`` on the written clouds."""
    cfg = Config.fromfile(config)
    cfg.merge_from_dict({"save_path": save_path, "seed": 0, "data.train.data_root": root,
                         "data.val.data_root": root})
    return cfg


def keypoint_backbone(cfg) -> dict:
    return dict(cfg.model.get("backbone_conf") or cfg.model.backbone)


def phase_kp_serve(config: str, task: str = "keypoint", expect=None, cpu_clouds: int = REQUESTS) -> dict:
    """``serve --task keypoint`` (or ``task``) with a keypoint recipe at full width, slot 8192, seeded
    weights: 1 warm-up and 3 POSTs of body-like clouds (B1 and B3 once per Block, one rulebook per level,
    or ``expect`` for ``phase_serve``), one request under torch.profiler, and the card's reply against the
    CPU port's on each cloud with the same weights and np.random seeded alike (the padding subsamples
    clouds past the slot), within CPU_TOL x the cloud's scale (mm), on the first ``cpu_clouds`` clouds; an
    offset head's through ``phase_cpu`` (its outputs, and its keypoints apart only on an argmax tie).  Returns
    the latencies, launches, profile and a request's maps (none where the backbone builds no kernel map)."""
    cfg = Config.fromfile(config)
    predictor = serve.build_predictor(task, cfg, None, cfg.slot_size, "cuda")
    rng = np.random.default_rng(19)
    clouds = [request_cloud(rng, CLOUD_POINTS) for _ in range(REQUESTS + 1)]
    warm = clouds.pop()
    predictor.predict(warm[:, :3], warm[:, 3:])
    latencies, counts = phase_serve(predictor, clouds, cfg.model.backbone_conf, check_keypoints, expect)
    print(f"{task} serve ({config}): request latency (host clock, POST to reply, slot {cfg.slot_size}, {REQUESTS} "
          f"requests of {CLOUD_POINTS} points x 7): median {statistics.median(latencies):.2f} ms, each "
          f"{[round(x, 2) for x in latencies]} {stamp()}")
    cloud = clouds[0]
    prof = profile_run(f"one {task} request ({cfg.model.type})",
                       lambda: predictor.predict(cloud[:, :3], cloud[:, 3:]), top=8)
    maps = {}
    if hasattr(predictor.model.backbone, "_kernel_map"):
        maps = capture_maps(predictor.model, lambda: predictor.predict(cloud[:, :3], cloud[:, 3:]),
                            f"{task} request")
    state = {k: v.detach().cpu() for k, v in predictor.model.state_dict().items()}
    cpu = serve.build_predictor(task, cfg, state, cfg.slot_size, "cpu")
    if task == "offset_keypoint":
        for c in clouds:
            phase_cpu(cfg, predictor, c, cpu)
        del predictor, cpu
        torch.cuda.empty_cache()
        return dict(latencies=latencies, counts=counts, profile=prof, maps=maps)
    for i, c in enumerate(clouds[:cpu_clouds]):
        replies = []
        for p in (predictor, cpu):
            np.random.seed(23 + i)
            replies.append(p.predict(c[:, :3], c[:, 3:]))
        scale = float(np.linalg.norm(c[:, :3] - c[:, :3].mean(0), axis=1).max())
        err = float(np.abs(replies[0] - replies[1]).max())
        print(f"keypoint request {i} ({cfg.model.type}), card vs cpu: max_abs_err={err:.3e} mm, tol {CPU_TOL:g} x "
              f"scale {scale:.1f} mm = {CPU_TOL * scale:.3e} mm")
        if not (np.isfinite(replies[0]).all() and err <= CPU_TOL * scale):
            raise AssertionError(f"keypoint request {i}: card and CPU disagree")
    del predictor, cpu
    torch.cuda.empty_cache()
    return dict(latencies=latencies, counts=counts, profile=prof, maps=maps)


def phase_kp_train(label: str, cfg, expect=None, probe: bool = False) -> dict:
    """A keypoint or body-measure recipe's trainer on the card through its own reader: its first epoch (4
    steps of batch 8), each step's launches and rulebooks counted, every kernel input f32, then its
    evaluator, if it has one, and the saver; the slots' fill by the first batch.  With ``probe`` also one
    step under torch.profiler, the kernel maps of a batch of the recipe's data and PROBE_STEPS steps of a
    fresh trainer on that batch, whose loss must fall."""
    bb = keypoint_backbone(cfg)
    trainer = Trainer(cfg, device="cuda")
    total = len(trainer.train_loader) * trainer.max_epoch
    trainer.max_epoch = 1  # the recipe's first epoch; the schedule keeps the whole run's length
    batch = next(iter(trainer.train_loader))
    fill = batch["valid"].reshape(batch["num_samples"], -1).mean(1)
    print(f"{label}: {cfg.model.type} over {bb['type']}, {len(trainer.train_loader)} steps of batch {cfg.batch_size} "
          f"per epoch from {cfg.data.train.type}, slot {cfg.slot_size} filled {fill.mean():.3f} on average "
          f"({fill.min():.3f}-{fill.max():.3f}) by the first batch, {cfg.optimizer['type']} under "
          f"{cfg.scheduler['type']} over {total} steps, {sum(p.numel() for p in trainer.model.parameters())} "
          f"parameters")
    spies, run_step = KernelDtypes(), trainer.run_step

    def watched_step():
        with spies:
            run_step()

    trainer.run_step = watched_step
    run = counted_training(trainer, label, bb, expect=expect)
    trainer.run_step = run_step
    seen = {name: kinds for name, kinds in spies.seen.items() if kinds}
    if any(kinds != {"float32"} for kinds in seen.values()):
        raise AssertionError(f"{label}: expected every kernel in float32, got {seen}")
    run["fill"] = float(fill.mean())
    if trainer.val_loader is not None:
        metric, name = trainer.comm_info.get("current_metric_value"), trainer.comm_info.get("current_metric_name")
        if metric is None or not np.isfinite(metric) or metric > 0:
            raise AssertionError(f"{label}: the evaluator gave no finite negated distance: {metric}")
        print(f"{label}: the evaluator over {len(trainer.val_loader.dataset)} val clouds: {name} {metric:.4f} "
              f"after {len(run['steps'])} steps {stamp()}")
    run["save_path"] = cfg.save_path
    if probe:
        run["profile"] = profile_step(trainer, trainer.run_step)
        model = trainer.model.eval()
        run["maps"] = {}
        if hasattr(model.backbone, "_kernel_map"):
            with torch.no_grad():
                run["maps"] = capture_maps(model, lambda: model(build_point_batch(sample_to_device(batch, "cuda"),
                                                                                  batch["num_samples"])), label)
        del trainer, model
        torch.cuda.empty_cache()
        fresh = Trainer(cfg, device="cuda")
        losses = []
        for _ in range(PROBE_STEPS):
            fresh.comm_info["input_dict"] = batch
            fresh.run_step()
            losses.append(fresh.comm_info["metrics"]["loss"])
        print(f"{label}: {PROBE_STEPS} steps of a fresh trainer on one fixed batch: losses "
              f"{[round(x, 5) for x in losses]} {stamp()}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{label}: the loss did not fall on a fixed batch: {losses}")
        del fresh
    else:
        del trainer
    torch.cuda.empty_cache()
    return run


def phase_kp_plus_kernels(cfg, step_maps: dict, request_maps: dict, step: dict, request: dict) -> dict:
    """B3 and B4 at PT-v3plus's xCPE shape (K = 125, Cin = Cout = 16) on its maps at every level of a
    training batch and of a request, in f32 and bf16 against their plain versions and bit for bit run to
    run; each timed in f32 beside its plain version, the gather + torch.matmul and the bound, summed per
    KeypointPTv3Plus step (B3 twice per Block: forward and input gradient; B4 once) and per request (B3
    once per Block); each map's rulebook build timed (host clock and device).  The sums' launches are checked against one step's and one request's counts.
    Returns {"step": sums, "request": sums, "errors": each kernel's largest f32 error}."""
    rng = np.random.default_rng(29)
    bb = keypoint_backbone(cfg)
    width = bb["cpe_bottleneck"]
    errors = dict.fromkeys(("subm_conv_fwd", "subm_conv_dw"), 0.0)
    sums = {"step": {}, "request": {}}
    launches = {"step": dict.fromkeys(errors, 0), "request": dict.fromkeys(errors, 0)}
    blocks = {}
    for n, _, _, _, depth in level_shapes(bb, cfg.slot_size):
        blocks[n] = blocks.get(n, 0) + depth
    for key, maps, per_block in (("step", step_maps, {"subm_conv_fwd": 2, "subm_conv_dw": 1}),
                                 ("request", request_maps, {"subm_conv_fwd": 1})):
        batch = cfg.batch_size if key == "step" else 1
        for n, idx in sorted(maps.items(), reverse=True):
            reps = blocks[n // batch]
            if idx.shape[1] != bb["cpe_kernel_size"] ** 3:
                raise AssertionError(f"{key} map N={n} has K={idx.shape[1]}")
            for dtype in (torch.float32, torch.bfloat16):
                found = {"subm_conv_fwd": check_conv(rng, idx, width, dtype)}
                if key == "step":
                    found["subm_conv_dw"] = check_conv_dw(rng, idx, width, dtype)
                    check_conv_bits(rng, idx, width, dtype)
                if dtype == torch.float32:
                    for name, err in found.items():
                        errors[name] = max(errors[name], err)
            print(f"keypoint plus {key} level N={n} K={idx.shape[1]} Cin=Cout={width} f32 (x{reps} Blocks per {key}):")
            for name, times in per_block.items():
                row = time_conv(rng, idx, width, torch.float32, dw=name == "subm_conv_dw")
                add_row(sums[key], name, row, times * reps)
                launches[key][name] += times * reps
        books = [time_rulebook(idx) for idx in maps.values()]
        print(f"rulebook builds per KeypointPTv3Plus {key} ({len(books)} K = 125 maps): "
              f"{sum(b['ms'] for b in books):.4f} ms (host clock), device {sum(b['device_ms'] for b in books):.4f} ms, "
              f"bound {sum(b['bound_ms'] for b in books):.4f} ms {stamp()}")
        for name, t in sums[key].items():
            counted = (step if key == "step" else request)[name]
            if launches[key][name] != counted:
                raise AssertionError(f"keypoint plus {key}: {name} timed for {launches[key][name]} launches, the "
                                     f"path made {counted}")
            t["launches"] = counted
            print(f"{name} per KeypointPTv3Plus {key} (f32, K=125, Cin=Cout={width}, sum over its {counted} launches): "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms {stamp()}")
    return dict(sums, errors=errors)


def phase_kp_plus_cpu(cfg) -> dict:
    """One KeypointPTv3Plus training step at the recipe's widths and slot, one Block per stage, no drop
    path or order shuffling, batch KP_CPU_BATCH of its data (np.random seeded 5), card against CPU in f32
    within TRAIN_CPU_TOL, the card on the CPU's side of each ReLU tie (the head's two ReLUs)."""
    bb = keypoint_backbone(cfg)
    model_cfg = dict(cfg.model)
    model_cfg["backbone_conf"] = dict(bb, enc_depths=(1,) * len(bb["enc_depths"]),
                                      dec_depths=(1,) * len(bb["dec_depths"]), drop_path=0.0, shuffle_orders=False)
    np.random.seed(5)
    ds = build_dataset(dict(cfg.data.train))
    batch_np = collate([ds[i] for i in range(KP_CPU_BATCH)], cfg.slot_size, np.random)
    return compare_step("keypoint plus", model_cfg, batch_np, torch.float32, TRAIN_CPU_TOL, relu_ties=True)


def phase_infer_offset(root: str, weight: str) -> dict:
    """The port's ``infer_offset`` on the card over the written val split with the offset-keypoint recipe's
    weights from its trainer: K x 3 per cloud, finite errors per keypoint, the txt written, B1 and B3
    launched once per Block per cloud."""
    cfg = Config.fromfile(CONFIG)
    out = os.path.join(root, "infer_offset.txt")
    set_launch_counts_to_zero()
    t0 = time.perf_counter()
    errors = infer_offset.main(["--config-file", CONFIG, "--weight", weight, "--data-root", root, "--split", "val",
                                "--method", "weighted", "--output", out])
    seconds = time.perf_counter() - t0
    clouds = KP_CLOUDS["val"]
    blocks = sum(cfg.model.backbone_conf.enc_depths) + sum(cfg.model.backbone_conf.dec_depths)
    counts = launch_counts()
    lines = open(out).read().splitlines()
    print(f"infer_offset over {clouds} val clouds: {seconds:.2f} s (host clock), launches {counts}; errors "
          f"{None if errors is None else errors.shape} {stamp()}")
    if errors is None or errors.shape != (clouds, 6) or not np.isfinite(errors).all() or len(lines) != clouds:
        raise AssertionError(f"infer_offset: expected {clouds} x 6 finite errors and {clouds} lines")
    if counts["patch_attention_fwd"] != blocks * clouds or counts["subm_conv_fwd"] != blocks * clouds:
        raise AssertionError(f"infer_offset: expected B1 and B3 {blocks} times per cloud, got {counts}")
    return dict(seconds=seconds, mean_mm=float(errors.mean()))


def phase_keypoint_heads(kernels: list, per_request: dict) -> None:
    """Phases 31-36: the keypoint heads' slice; adds ``kp_plus_step_*`` and ``kp_plus_request_*`` to the
    kernels line (B1 and B2 per step and B1 per request at the same shapes as the offset-keypoint path's,
    timed in phase 9)."""
    served = {name: phase_kp_serve(config) for name, config in (("plus", KP_PLUS_CONFIG), ("ptv3", KP_CONFIG))}
    with tempfile.TemporaryDirectory() as root:
        write_keypoint_clouds(root)
        cfg = recipe_config(KP_PLUS_CONFIG, root, os.path.join(root, "exp_plus"))
        plus = phase_kp_train("keypoint plus train", cfg, probe=True)
        step = plus["steps"][-1]
        request = {k: v // REQUESTS for k, v in served["plus"]["counts"].items()}
        conv = phase_kp_plus_kernels(cfg, plus.pop("maps"), served["plus"].pop("maps"), step, request)
        phase_kp_plus_cpu(cfg)
        others = {}
        for key, config, expect in (
                ("spunet", KP_SPUNET_CONFIG, spunet_expect(Config.fromfile(KP_SPUNET_CONFIG).model.backbone_conf,
                                                           training=True)),
                ("weight", WEIGHT_CONFIG, None), ("offset", CONFIG, None)):
            others[key] = phase_kp_train(f"{key} recipe train", recipe_config(config, root, os.path.join(root, key)),
                                         expect)
        inferred = phase_infer_offset(root, os.path.join(others["offset"]["save_path"], "model", "model_last.pth"))
    bound_by = lambda t: "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"  # noqa: E731
    for row in kernels:
        name = row["name"]
        if name in conv["step"]:
            t, err, by = conv["step"][name], conv["errors"][name], bound_by(conv["step"][name])
        else:  # B1, B2: the offset-keypoint step's shapes, timed in phase 9 (the row's own numbers)
            t, err, by = row, row["max_abs_err"], row["bound_by"]
        row.update({"kp_plus_step_launches": step[name], "kp_plus_step_max_abs_err": err,
                    "kp_plus_step_ms": t["ms"], "kp_plus_step_plain_ms": t["plain_ms"],
                    "kp_plus_step_library_ms": t["library_ms"], "kp_plus_step_bound_ms": t["bound_ms"],
                    "kp_plus_step_bound_by": by})
        t = conv["request"].get(name) or per_request.get(name)
        if t is not None:
            row.update({"kp_plus_request_launches": request[name], "kp_plus_request_ms": t["ms"],
                        "kp_plus_request_plain_ms": t["plain_ms"], "kp_plus_request_library_ms": t["library_ms"],
                        "kp_plus_request_bound_ms": t["bound_ms"], "kp_plus_request_bound_by": bound_by(t)})
    for name, s in served.items():
        print(f"keypoint serve {name}: request median {statistics.median(s['latencies']):.2f} ms, launches per "
              f"request { {k: v // REQUESTS for k, v in s['counts'].items()} }; profiled request busy "
              f"{s['profile']['busy_ms']:.2f} ms, idle share {s['profile']['idle_share']:.3f} {stamp()}")
    for key, run in (("plus", plus), *others.items()):
        prof = run.get("profile")
        profiled = (f", profiled step busy {prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
                    f"{prof['kernels']} kernels") if prof else ""
        print(f"keypoint {key} recipe: step median {statistics.median(run['step_ms'][1:]):.2f} ms (host clock, steps "
              f"2-{len(run['step_ms'])}), peak memory {run['peak_bytes'] / 2**30:.2f} GiB, slot fill {run['fill']:.3f}"
              f"{profiled} {stamp()}")
    print(f"infer_offset: {inferred['seconds']:.2f} s over {KP_CLOUDS['val']} clouds, mean error "
          f"{inferred['mean_mm']:.2f} mm (seeded weights after 4 steps) {stamp()}")


# ---- OctFormer and Swin3D, the pig users' tools (phases 37-40) ------------------------------------------

OCT_CONFIG = "configs/my_dataset/keypoint_octformer.py"
OCT_SEG_CONFIG = "configs/pigseg/semseg-octformer-v1m1-0-base.py"
SWIN_OFFSET_CONFIG = "configs/my_dataset/offset_keypoint_swin3d.py"
SWIN_VOTE_CONFIG = "configs/my_dataset/keypoint_swin3d_plus.py"
R3_TEST_CONFIG = "configs/synthetic/semseg-spunet-r3-test.py"
# the card-vs-CPU steps' depths: two Blocks in the first stage, so that the dilated (OctFormer) and the
# shifted (Swin3D) Block run, which one Block per stage would leave out; one Block in each other stage
CPU_STEP_DEPTHS = (2, 1, 1, 1)
TOOL_NPY_SCANS, TOOL_PCD_SCANS = 3, 2  # batch_infer_export_txt's bare-xyz .npy and ascii .pcd scans
TOOL_SCENE_POINTS = 30000  # infer_npy's pig scene
EVAL_CPU_SCENES = 2  # evaluate_all_splits card against CPU: test scenes per split on both devices
SEMSEG_MIOU_TOL = 0.005  # an mIoU card against CPU: labels apart only on ties (phase 21's limit)


def octformer_levels(model) -> list:
    """[(N per sample, channels, Blocks)] of every stage of an OctFormer ``model`` at slot 8192."""
    return [(model._stage_cap(8192, s), c, model.num_blocks[s]) for s, c in enumerate(model.channels)]


def phase_octformer_kernels(levels, batch: int, step_maps: dict, request_maps: dict, step: dict,
                            request: dict) -> dict:
    """B3 (forward, and at the same shape the input gradient's mirrored conv) and B4 at OctFormer's CPE
    (K = 27, Cin = Cout = the stage's width: 96, 192, 384, 384) on its maps at every level of a
    training batch and of a request, in f32 against their plain versions and bit for bit run to run;
    each timed beside its plain version, the gather + torch.matmul and the bound, summed per step (B3
    twice per Block, B4 once) and per request (B3 once per Block); each map's rulebook build timed.
    The sums' launches are checked against one step's and one request's counts.  Returns {"step": sums,
    "request": sums, "errors": each kernel's largest error}."""
    rng = np.random.default_rng(43)
    errors = dict.fromkeys(("subm_conv_fwd", "subm_conv_dw"), 0.0)
    sums = {"step": {}, "request": {}}
    launches = {"step": dict.fromkeys(errors, 0), "request": dict.fromkeys(errors, 0)}
    for key, maps, per_block, b in (("step", step_maps, {"subm_conv_fwd": 2, "subm_conv_dw": 1}, batch),
                                    ("request", request_maps, {"subm_conv_fwd": 1}, 1)):
        if sorted(maps) != sorted(n * b for n, _, _ in levels):
            raise AssertionError(f"OctFormer {key}: maps at N = {sorted(maps)}, expected {levels} x {b}")
        for n, c, blocks in levels:
            idx = maps[n * b]
            if idx.shape[1] != 27:
                raise AssertionError(f"OctFormer {key} map N={n * b} has K={idx.shape[1]}")
            found = {"subm_conv_fwd": check_conv(rng, idx, c, torch.float32)}
            if key == "step":
                found["subm_conv_dw"] = check_conv_dw(rng, idx, c, torch.float32)
            check_conv_bits(rng, idx, c, torch.float32)
            for name, err in found.items():
                errors[name] = max(errors[name], err)
            print(f"OctFormer {key} level N={n * b} K=27 Cin=Cout={c} f32 (x{blocks} Blocks per {key}):")
            for name, times in per_block.items():
                row = time_conv(rng, idx, c, torch.float32, dw=name == "subm_conv_dw")
                add_row(sums[key], name, row, times * blocks)
                launches[key][name] += times * blocks
        books = [time_rulebook(idx) for idx in maps.values()]
        print(f"rulebook builds per OctFormer {key} ({len(books)} K = 27 maps): "
              f"{sum(r['ms'] for r in books):.4f} ms (host clock), device {sum(r['device_ms'] for r in books):.4f} "
              f"ms, bound {sum(r['bound_ms'] for r in books):.4f} ms {stamp()}")
        for name, t in sums[key].items():
            counted = (step if key == "step" else request)[name]
            if launches[key][name] != counted:
                raise AssertionError(f"OctFormer {key}: {name} timed for {launches[key][name]} launches, the path "
                                     f"made {counted}")
            t["launches"] = counted
            print(f"{name} per OctFormer {key} (f32, K=27, sum over its {counted} launches): kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"{stamp()}")
    return dict(sums, errors=errors)


def check_in_order_means() -> None:
    """``segment_mean_in_order`` (Swin3D's anchor and pooled coordinates) gives the CPU's bits on the card,
    where ``segment_mean``'s atomics need not: at the anchor's shape (8 samples of 8192 rows) and at a
    pooling's (65,536 rows into 32,768 parents, a tenth of the rows dropped)."""
    gen = torch.Generator().manual_seed(53)
    rows = torch.randn((8 * 8192, 3), generator=gen) * 1.5
    parents = torch.randint(0, 32768, (rows.shape[0],), generator=gen)
    cases = {"anchor": (torch.arange(rows.shape[0]) // 8192, 8),
             "pooling": (torch.where(torch.rand(rows.shape[0], generator=gen) < 0.1, 32768, parents), 32768)}
    for name, (ids, m) in cases.items():
        card = segment_mean_in_order(rows.cuda(), ids.cuda(), m).cpu()
        cpu = segment_mean_in_order(rows, ids, m)
        racy = segment_mean(rows.cuda(), ids.cuda(), m).cpu()
        print(f"segment_mean_in_order ({name}, {rows.shape[0]} rows into {m}) card vs cpu: equal bits "
              f"{torch.equal(card, cpu)}; the atomic segment_mean's difference {(racy - cpu).abs().max().item():.3e}")
        if not torch.equal(card, cpu):
            raise AssertionError(f"segment_mean_in_order ({name}): the card's means differ from the CPU's")


def phase_backbone_step_cpu(label: str, cfg) -> dict:
    """One training step of a keypoint recipe over OctFormer or Swin3D at its widths and slot, depths
    CPU_STEP_DEPTHS, no drop path, batch KP_CPU_BATCH of its data (np.random seeded 5), card against CPU
    in f32 within TRAIN_CPU_TOL, the card on the CPU's side of each ReLU tie (the heads' ReLUs)."""
    bb = keypoint_backbone(cfg)
    depths = "num_blocks" if bb["type"].startswith("OctFormer") else "depths"
    model_cfg = dict(cfg.model)
    model_cfg["backbone_conf"] = dict(bb, drop_path_rate=0.0, **{depths: CPU_STEP_DEPTHS})
    np.random.seed(5)
    ds = build_dataset(dict(cfg.data.train))
    batch_np = collate([ds[i] for i in range(KP_CPU_BATCH)], cfg.slot_size, np.random)
    return compare_step(label, model_cfg, batch_np, torch.float32, TRAIN_CPU_TOL, relu_ties=True)


def tool_config(root: str, base: str, **overrides) -> str:
    """A config file over ``base`` with ``overrides``, for the CLIs that take no ``--options``."""
    path = os.path.join(root, f"tool_{len(glob.glob(os.path.join(root, 'tool_*')))}_{os.path.basename(base)}")
    lines = [f"_base_ = [{os.path.abspath(base)!r}]"] + [f"{k} = {v!r}" for k, v in overrides.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def timed_tool(label: str, run) -> dict:
    """``run()`` with the launch counts set to 0 just before and read just after, and its host-clock time."""
    torch.cuda.synchronize()
    set_launch_counts_to_zero()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"{label}: {seconds:.2f} s (host clock), launches {counts}, rulebooks {sc.rulebook_builds} {stamp()}")
    return dict(result=result, seconds=seconds, counts=counts)


def cloud_scale(coord: np.ndarray) -> float:
    """The normalization's scale of a cloud: its largest distance from its centroid (mm)."""
    return float(np.linalg.norm(coord - coord.mean(0), axis=1).max())


def phase_inference_split(root: str, blocks: int) -> dict:
    """``inference_split`` with ``keypoint_octformer.py`` (seeded weights) over the written val split on
    the card and with ``--device cpu``: [clouds, 6] errors in mm, B3 once per Block per cloud on the card,
    the errors and the txt tables card against CPU within CPU_TOL x the largest cloud scale (the tables'
    2 decimals besides), a PLY per cloud from each."""
    config = tool_config(root, OCT_CONFIG, data=dict(train=dict(data_root=root), val=dict(data_root=root)))
    runs = {}
    for device in ("cuda", "cpu"):
        np.random.seed(31)
        argv = ["--config-file", config, "--split", "val", "--out", os.path.join(root, f"errors_{device}.txt"),
                "--viz-dir", os.path.join(root, f"viz_{device}"), "--device", device]
        runs[device] = timed_tool(f"inference_split on {device}", lambda: inference_split.main(argv))
    clouds = KP_CLOUDS["val"]
    card, cpu = runs["cuda"]["result"], runs["cpu"]["result"]
    scale = max(cloud_scale(np.load(p)[:, :3]) for p in glob.glob(os.path.join(root, "val", "pointclouds", "*.npy")))
    err = float(np.abs(card - cpu).max())
    print(f"inference_split card vs cpu: errors {card.shape}, mean {card.mean():.2f} mm on the card, max_abs_err "
          f"{err:.3e} mm, tol {CPU_TOL:g} x scale {scale:.1f} mm = {CPU_TOL * scale:.3e} mm")
    if card.shape != (clouds, 6) or not np.isfinite(card).all() or err > CPU_TOL * scale:
        raise AssertionError("inference_split: card and CPU disagree")
    tables = [open(os.path.join(root, f"errors_{d}.txt")).read().splitlines() for d in ("cuda", "cpu")]
    for a, b in zip(*tables[:2]):
        ta, tb = a.split("\t"), b.split("\t")
        if ta[0] != tb[0] or (ta[0] != "sample" and np.abs(np.float64(ta[1:]) - np.float64(tb[1:])).max()
                              > CPU_TOL * scale + 0.01):
            raise AssertionError(f"inference_split tables differ: {a!r} / {b!r}")
    if len(tables[0]) != clouds + 1 or len(os.listdir(os.path.join(root, "viz_cuda"))) != clouds:
        raise AssertionError("inference_split: expected a table row and a PLY per cloud")
    if runs["cuda"]["counts"]["subm_conv_fwd"] != blocks * clouds or runs["cuda"]["counts"]["patch_attention_fwd"]:
        raise AssertionError(f"inference_split: expected B3 {blocks} per cloud and no B1: {runs['cuda']['counts']}")
    return {d: r["seconds"] for d, r in runs.items()}


def write_pcd(path: str, coord: np.ndarray) -> None:
    """An ascii PCD of xyz."""
    with open(path, "w") as f:
        f.write(f"VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\nWIDTH {len(coord)}\nHEIGHT 1\n"
                f"POINTS {len(coord)}\nDATA ascii\n")
        np.savetxt(f, coord, fmt="%.4f")


def export_ties(name: str, predictors, coord: np.ndarray, card_kp: np.ndarray, cpu_kp: np.ndarray,
                tol: float) -> None:
    """A scan whose keypoints from ``batch_infer_export_txt`` (argmax) differ between the card's txt and the
    CPU's by more than ``tol``: the scan's logits and offsets again through the predictor on both devices,
    within CPU_TOL x max(1, max|cpu|), and each keypoint that differs in the txts must be, in the CPU's, the
    candidate of the CPU's best logit and, in the card's, the candidate of a point whose CPU logit lies
    within twice the measured logit error of that best (a near tie that the card's sums can flip);
    else it fails.  Each such waiver is printed."""
    card, cpu = (p.infer(coord) for p in predictors)
    np.testing.assert_array_equal(card["coord"], cpu["coord"])
    errs = {}
    for key in ("offset_pred", "mask_logits"):
        errs[key] = float(np.abs(card[key] - cpu[key]).max())
        if not (np.isfinite(card[key]).all() and errs[key] <= CPU_TOL * max(1.0, float(np.abs(cpu[key]).max()))):
            raise AssertionError(f"batch_infer_export_txt {name}: card and CPU disagree on {key} ({errs[key]:.3e})")
    logits, tie = cpu["mask_logits"], 2 * errs["mask_logits"]
    candidates = (cpu["coord"][:, None, :] + cpu["offset_pred"]) * cpu["scale"] + cpu["centroid"]  # [N, K, 3]
    for k in np.nonzero(np.abs(card_kp - cpu_kp).max(1) > tol)[0]:
        best = int(logits[:, k].argmax())
        if np.abs(candidates[best, k] - cpu_kp[k]).max() > tol:
            raise AssertionError(f"batch_infer_export_txt {name}: keypoint {k} of the CPU's txt is not its argmax pick")
        gap = logits[best, k] - logits[:, k]
        picks = np.nonzero((gap <= tie) & (np.abs(candidates[:, k] - card_kp[k]).max(1) <= tol))[0]
        if not len(picks):
            raise AssertionError(f"batch_infer_export_txt {name}: keypoint {k} of the card's txt is no argmax pick "
                                 f"within a logit gap of {tie:.3e} of the CPU's best")
        print(f"  batch_infer_export_txt {name}: keypoint {k} waived: the card picked point {int(picks[0])} at a CPU "
              f"logit gap {float(gap[picks[0]]):.3e} <= {tie:.3e} (2 x the logit error), the CPU point {best}")


def phase_batch_export(root: str) -> dict:
    """``batch_infer_export_txt`` with ``offset_keypoint_swin3d.py`` (seeded weights, argmax) over a
    directory of bare-xyz .npy and ascii .pcd scans (the written val clouds' xyz) on the card and with
    ``--device cpu``: one 6 x 3 txt per scan, card against CPU within CPU_TOL x the scan's scale (and
    the txt's 3 decimals); where they differ more, ``export_ties`` must find each keypoint that differs on
    a near argmax tie."""
    scans = os.path.join(root, "scans")
    os.makedirs(scans)
    paths = sorted(glob.glob(os.path.join(root, "val", "pointclouds", "*.npy")))[:TOOL_NPY_SCANS + TOOL_PCD_SCANS]
    files = []  # in the tool's order: by name
    for i, p in enumerate(paths):
        coord = np.load(p)[:, :3]
        files.append(os.path.join(scans, f"scan{i}.npy" if i < TOOL_NPY_SCANS else f"scan{i}.pcd"))
        if i < TOOL_NPY_SCANS:
            np.save(files[-1], coord)
        else:
            write_pcd(files[-1], coord)
    cfg, runs = Config.fromfile(SWIN_OFFSET_CONFIG), {}
    for device in ("cuda", "cpu"):
        argv = ["--config-file", SWIN_OFFSET_CONFIG, "--scan-dir", scans, "--out-dir",
                os.path.join(root, f"batch_{device}"), "--tag", "swin3d", "--slot-size", str(cfg.slot_size),
                "--device", device]
        runs[device] = timed_tool(f"batch_infer_export_txt on {device}", lambda: batch_infer_export_txt.main(argv))
    predictors = None
    for scan, a, b in zip(files, runs["cuda"]["result"], runs["cpu"]["result"]):
        kp_a, kp_b = np.loadtxt(a), np.loadtxt(b)
        coord, _ = batch_infer_export_txt.load_cloud(scan)
        tol = CPU_TOL * cloud_scale(coord) + 1e-3
        err = float(np.abs(kp_a - kp_b).max())
        print(f"batch_infer_export_txt {os.path.basename(a)}: {kp_a.shape}, card vs cpu max_abs_err {err:.3e} mm, "
              f"tol {tol:.3e} mm")
        if kp_a.shape != (6, 3) or not np.isfinite(kp_a).all():
            raise AssertionError(f"batch_infer_export_txt: expected 6 x 3 finite keypoints in {a}")
        if err > tol:
            if predictors is None:  # the tool's seeded weights on both devices
                card = OffsetKeypointPredictor(dict(cfg.model), None, cfg.slot_size, "cuda")
                state = {k: v.detach().cpu() for k, v in card.model.state_dict().items()}
                predictors = (card, OffsetKeypointPredictor(dict(cfg.model), state, cfg.slot_size, "cpu"))
            export_ties(os.path.basename(scan), predictors, coord, kp_a, kp_b, tol)
    if len(runs["cuda"]["result"]) != len(paths) or any(runs["cuda"]["counts"].values()):
        raise AssertionError(f"batch_infer_export_txt: expected {len(paths)} txts and no kernel launch (Swin3D), "
                             f"got {runs['cuda']['counts']}")
    return {d: r["seconds"] for d, r in runs.items()}


def phase_infer_npy(root: str, blocks: int) -> dict:
    """``infer_npy`` with ``semseg-octformer-v1m1-0-base.py`` (seeded weights, slot 32768) on one
    ~30k-point pig scene on the card and with ``--device cpu``: one label per cleaned point, B3 once per
    Block on the card, the labels card against CPU apart only on a near tie of the voxel logits (read
    through ``SegmentPredictor`` on both devices), and both PLYs."""
    scene = os.path.join(root, "scene.npy")
    np.save(scene, pig_cloud(np.random.default_rng(47), TOOL_SCENE_POINTS)[:, :7])
    runs = {}
    for device in ("cuda", "cpu"):
        argv = [scene, "--config-file", OCT_SEG_CONFIG, "--out-dir", os.path.join(root, f"npy_{device}"),
                "--device", device]
        runs[device] = timed_tool(f"infer_npy on {device}", lambda: infer_npy.main(argv))
    coord, feat = infer_npy.preprocess(np.load(scene))
    model = dict(Config.fromfile(OCT_SEG_CONFIG).model)
    res = [SegmentPredictor(model, None, SEG_SLOT, device).infer(coord, feat) for device in ("cuda", "cpu")]
    preds = [runs[d]["result"] for d in ("cuda", "cpu")]
    compare_seg_labels("infer_npy", *res, *preds)
    pig = int((preds[0] == 1).sum())
    for name, count in (("scene_pred", len(coord)), ("scene_pig_only", pig)):
        with open(os.path.join(root, "npy_cuda", f"{name}.ply")) as f:
            head = f.read(200)
        if f"element vertex {count}\n" not in head:
            raise AssertionError(f"infer_npy: {name}.ply does not hold {count} points")
    if runs["cuda"]["counts"]["subm_conv_fwd"] != blocks:
        raise AssertionError(f"infer_npy: expected B3 {blocks} times, got {runs['cuda']['counts']}")
    print(f"infer_npy: {len(coord)} cleaned points, {pig} labelled pig on the card {stamp()}")
    return {d: r["seconds"] for d, r in runs.items()}


def phase_evaluate_all_splits(root: str) -> dict:
    """``evaluate_all_splits`` over ``semseg-spunet-r3-test.py`` with ``exp/semseg_r3`` (its train and val
    splits, 8 scenes each; the synthetic scenes are seeded by split) on the card, mIoU above 0.95 on both;
    then EVAL_CPU_SCENES scenes per split on the card and with ``--device cpu``, each metric within
    SEMSEG_MIOU_TOL."""
    runs = {}
    for key, device, scenes in (("card", "cuda", None), ("card_small", "cuda", EVAL_CPU_SCENES),
                                ("cpu", "cpu", EVAL_CPU_SCENES)):
        config = tool_config(root, R3_TEST_CONFIG, save_path=os.path.join(root, "eval_" + key),
                             **({"data": dict(test=dict(num_scenes=scenes))} if scenes else {}))
        argv = ["--config-file", config, "--device", device]
        runs[key] = timed_tool(f"evaluate_all_splits ({key})", lambda: evaluate_all_splits.main(argv))
    full = runs["card"]["result"]
    print(f"evaluate_all_splits on the card: {full} {stamp()}")
    if sorted(full) != ["train", "val"] or any(r["mIoU"] <= 0.95 for r in full.values()):
        raise AssertionError(f"evaluate_all_splits: expected mIoU above 0.95 on train and val, got {full}")
    for split, r in runs["cpu"]["result"].items():
        diff = {k: abs(v - runs["card_small"]["result"][split][k]) for k, v in r.items()}
        print(f"evaluate_all_splits {split} ({EVAL_CPU_SCENES} scenes) card vs cpu: |diff| {diff} (tol "
              f"{SEMSEG_MIOU_TOL})")
        if max(diff.values()) > SEMSEG_MIOU_TOL:
            raise AssertionError(f"evaluate_all_splits {split}: card and CPU disagree")
    return {k: r["seconds"] for k, r in runs.items()}


def phase_backbones(kernels: list) -> None:
    """Phases 37-40: OctFormer and Swin3D served, trained, the CPE's kernels at OctFormer's widths, and
    the pig users' four tools; adds ``octformer_step_*`` and ``octformer_request_*`` to the kernels line."""
    oct_model = build_model(dict(Config.fromfile(OCT_CONFIG).model.backbone_conf))
    levels, blocks, stages = octformer_levels(oct_model), sum(oct_model.num_blocks), len(oct_model.channels)
    del oct_model
    # OctFormer: B3 per Block's CPE (twice in a step: the input gradient), B4 once in a step, no B1 or B2;
    # one rulebook per stage.  Swin3D: no kernel, no rulebook
    oct_step = {"patch_attention_fwd": 0, "patch_attention_bwd": 0, "subm_conv_fwd": 2 * blocks, "subm_conv_dw": blocks}
    check_in_order_means()
    served = {"octformer": phase_kp_serve(OCT_CONFIG, "keypoint", (0, blocks, stages)),
              "swin3d": phase_kp_serve(SWIN_OFFSET_CONFIG, "offset_keypoint", (0, 0, 0))}
    with tempfile.TemporaryDirectory() as root:
        write_keypoint_clouds(root)
        trained, batch = {}, None
        for key, config, expect in (("octformer", OCT_CONFIG, (oct_step, stages)),
                                    ("swin3d", SWIN_VOTE_CONFIG, (dict.fromkeys(oct_step, 0), 0))):
            cfg = recipe_config(config, root, os.path.join(root, f"exp_{key}"))
            trained[key] = phase_kp_train(f"{key} recipe train", cfg, expect, probe=True)
            phase_backbone_step_cpu(f"{key} recipe", cfg)
            batch = batch or cfg.batch_size
        step = trained["octformer"]["steps"][-1]
        request = {name: served["octformer"]["counts"].get(name, 0) // REQUESTS for name in oct_step}
        conv = phase_octformer_kernels(levels, batch, trained["octformer"].pop("maps"),
                                       served["octformer"].pop("maps"), step, request)
        tools = {"inference_split": phase_inference_split(root, blocks), "batch_infer_export_txt":
                 phase_batch_export(root), "infer_npy": phase_infer_npy(root, blocks),
                 "evaluate_all_splits": phase_evaluate_all_splits(root)}
    bound_by = lambda t: "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"  # noqa: E731
    for row in kernels:
        name = row["name"]
        row["octformer_step_launches"], row["octformer_request_launches"] = step[name], request[name]
        if name in conv["step"]:
            t = conv["step"][name]
            row.update({"octformer_step_max_abs_err": conv["errors"][name], "octformer_step_ms": t["ms"],
                        "octformer_step_plain_ms": t["plain_ms"], "octformer_step_library_ms": t["library_ms"],
                        "octformer_step_bound_ms": t["bound_ms"], "octformer_step_bound_by": bound_by(t)})
        if name in conv["request"]:
            t = conv["request"][name]
            row.update({"octformer_request_ms": t["ms"], "octformer_request_plain_ms": t["plain_ms"],
                        "octformer_request_library_ms": t["library_ms"], "octformer_request_bound_ms": t["bound_ms"],
                        "octformer_request_bound_by": bound_by(t)})
    for name, s in served.items():
        print(f"{name} serve: request median {statistics.median(s['latencies']):.2f} ms, launches per request "
              f"{ {k: v // REQUESTS for k, v in s['counts'].items()} }; profiled request busy "
              f"{s['profile']['busy_ms']:.2f} ms, idle share {s['profile']['idle_share']:.3f} {stamp()}")
    for name, run in trained.items():
        prof = run["profile"]
        print(f"{name} recipe: step median {statistics.median(run['step_ms'][1:]):.2f} ms (host clock, steps "
              f"2-{len(run['step_ms'])}), peak memory {run['peak_bytes'] / 2**30:.2f} GiB, slot fill {run['fill']:.3f}, "
              f"profiled step busy {prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, {prof['kernels']} "
              f"kernels {stamp()}")
    for name, seconds in tools.items():
        print(f"{name}: wall time (host clock) {', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())} {stamp()}")


# ---- the fork's last four keypoint backbones: OA-CNNs, PT-v2m2, PT-v1, ST-v1m2 (phase 41) ---------------

LAST_CONFIGS = {"oacnns": "configs/my_dataset/keypoint_oa_cnns.py", "ptv2": "configs/my_dataset/keypoint_ptv2.py",
                "ptv1": "configs/my_dataset/keypoint_ptv1.py",
                "stratified": "configs/my_dataset/keypoint_stratified_transformer.py"}
# each backbone's depth options, set to one Block (or layer) per stage in the card-vs-CPU step, and its drop path
DEPTH_KEYS = {"OA-CNNs": ("layers",), "PT-v2m2": ("enc_depths", "dec_depths"), "PT-v1": ("blocks",),
              "ST-v1m2": ("depths",)}
DROP_PATH_KEYS = {"PT-v2m2": "drop_path_rate", "ST-v1m2": "drop_path_rate"}


def oacnns_convs(bb) -> list:
    """[(level, Cin, Cout, convs)] of one OA-CNNs forward: the stem (Cin the input's, padded to 8 on the
    card), each encoder BasicBlock's two convs, each decoder block's two (Cin = 2C, then C)."""
    base, channels, layers = bb.get("base_channels", 32), bb["channels"], bb["layers"]
    convs = [(0, bb["in_channels"], base, 1)]
    for s, c in enumerate(channels):
        for i in range(layers[s]):
            convs += [(s, base if s == 0 and i == 0 else c, c, 1), (s, c, c, 1)]
    for s in range(len(channels) - 1):
        convs += [(s, 2 * channels[s], channels[s], 1), (s, channels[s], channels[s], 1)]
    merged = {}
    for level, cin, cout, n in convs:
        merged[(level, cin, cout)] = merged.get((level, cin, cout), 0) + n
    return [(level, cin, cout, n) for (level, cin, cout), n in merged.items()]


def phase_oacnns_kernels(bb, batch: int, step_maps: dict, request_maps: dict, step: dict, request: dict) -> dict:
    """B3 and B4 at every OA-CNNs conv shape (K = 27; Cin -> Cout 4 (padded to 8) -> 32, 32 -> 32, 64 -> 64,
    128 -> 128, 64 -> 32, 128 -> 64, 256 -> 128) on its maps at every level of a training batch and of a
    request, in f32 against their plain versions and bit for bit run to run: B3 forward, B3 at the input
    gradient's mirrored shape (Cout -> Cin; none for the stem, whose input needs no gradient) and B4; the
    stem through ``SubmConvFunction`` as the path runs it.  Each timed beside its plain version, the gather
    + torch.matmul and the bound, summed per step and per request; each map's rulebook build timed.  The
    sums' launches are checked against one step's and one request's counts.  Returns {"step": sums,
    "request": sums, "errors": each kernel's largest error}."""
    rng = np.random.default_rng(47)
    convs = oacnns_convs(bb)
    caps = [max(8192 // d, 16) for d in bb.get("slot_divisors", (1, 2, 4, 8))]
    errors = dict.fromkeys(("subm_conv_fwd", "subm_conv_dw"), 0.0)
    sums = {"step": {}, "request": {}}
    launches = {"step": dict.fromkeys(errors, 0), "request": dict.fromkeys(errors, 0)}
    for key, maps, b in (("step", step_maps, batch), ("request", request_maps, 1)):
        if sorted(maps) != sorted(cap * b for cap in caps):
            raise AssertionError(f"OA-CNNs {key}: maps at N = {sorted(maps)}, expected {caps} x {b}")
        timed = {}
        for level, cin, cout, count in convs:
            idx = maps[caps[level] * b]
            if idx.shape[1] != 27:
                raise AssertionError(f"OA-CNNs {key} map N={idx.shape[0]} has K={idx.shape[1]}")
            stem = level == 0 and cin == bb["in_channels"]
            # (kernel, Cin, Cout, launches): the forward, and in a step the input gradient's and B4
            runs = [("subm_conv_fwd", cin, cout, count)]
            if key == "step":
                runs += [("subm_conv_dw", cin, cout, count)] + ([] if stem else [("subm_conv_fwd", cout, cin, count)])
                if stem:
                    for name, err in check_stem(rng, idx, cin, cout, torch.float32).items():
                        errors[name] = max(errors[name], err)
                else:
                    errors["subm_conv_dw"] = max(errors["subm_conv_dw"],
                                                 check_conv_dw(rng, idx, cout, torch.float32, cin))
            for name, ci, co, n in runs:
                if name == "subm_conv_fwd" and (level, ci, co) not in timed:
                    errors[name] = max(errors[name], check_conv(rng, idx, co, torch.float32, ci))
                    check_conv_bits(rng, idx, co, torch.float32, ci)
                shape = (name, level, ci, co)
                if shape not in timed:
                    print(f"OA-CNNs {key} level {level} N={idx.shape[0]} K=27 Cin={ci} Cout={co} {name} f32 "
                          f"(x{n} per {key}):")
                    timed[shape] = time_conv(rng, idx, co, torch.float32, dw=name == "subm_conv_dw", cin=ci)
                    timed[(level, ci, co)] = True
                add_row(sums[key], name, timed[shape], n)
                launches[key][name] += n
        books = [time_rulebook(idx) for idx in maps.values()]
        print(f"rulebook builds per OA-CNNs {key} ({len(books)} K = 27 maps): "
              f"{sum(r['ms'] for r in books):.4f} ms (host clock), device {sum(r['device_ms'] for r in books):.4f} "
              f"ms, bound {sum(r['bound_ms'] for r in books):.4f} ms {stamp()}")
        for name, t in sums[key].items():
            counted = (step if key == "step" else request)[name]
            if launches[key][name] != counted:
                raise AssertionError(f"OA-CNNs {key}: {name} timed for {launches[key][name]} launches, the path "
                                     f"made {counted}")
            t["launches"] = counted
            print(f"{name} per OA-CNNs {key} (f32, K=27, sum over its {counted} launches): kernel {t['ms']:.4f} ms, "
                  f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"{stamp()}")
    return dict(sums, errors=errors)


def phase_last_step_cpu(label: str, cfg) -> dict:
    """One training step of a keypoint recipe over OA-CNNs, PT-v2m2, PT-v1 or ST-v1m2 at its widths and slot,
    one Block (or layer) per stage, no drop path, batch KP_CPU_BATCH of its data (np.random seeded 5), card
    against CPU in f32 within TRAIN_CPU_TOL, the card on the CPU's side of each ReLU tie and of each tie of a
    segment max's winners."""
    bb = keypoint_backbone(cfg)
    # the backbones' segment maxes: PT-v2m2's grid pooling, ST-v1m2's (OctFormer's pool_parents)
    sites = ((point_transformer_v2, "segment_max"), (octformer_module, "segment_max"))
    depths = {key: (1,) * len(bb[key]) for key in DEPTH_KEYS[bb["type"]]}
    if bb["type"] in DROP_PATH_KEYS:
        depths[DROP_PATH_KEYS[bb["type"]]] = 0.0
    model_cfg = dict(cfg.model)
    model_cfg["backbone_conf"] = dict(bb, **depths)
    np.random.seed(5)
    ds = build_dataset(dict(cfg.data.train))
    batch_np = collate([ds[i] for i in range(KP_CPU_BATCH)], cfg.slot_size, np.random)
    return compare_step(label, model_cfg, batch_np, torch.float32, TRAIN_CPU_TOL, relu_ties=True, max_sites=sites)


def timed_share(predictor, cloud: np.ndarray, module, name: str) -> dict:
    """One request with ``module.name`` (FPS, a kNN search) timed on the host clock, the card synchronized
    around each call, beside the request's own host-clock time: (ms in the calls, calls, request ms)."""
    plain, spent = getattr(module, name), []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict(cloud[:, :3], cloud[:, 3:])
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(module, name, plain)
    return dict(ms=sum(spent), calls=len(spent), request_ms=total)


def phase_last_backbones(kernels: list) -> None:
    """Phase 41: OA-CNNs, PT-v2m2, PT-v1 and ST-v1m2 served and trained as the fork's configs write them,
    a step of each card against CPU, FPS's and the brute kNN's share of a request, and B3 and B4 at every
    OA-CNNs shape; adds ``oacnns_step_*`` and ``oacnns_request_*`` to the kernels line."""
    oa_bb = dict(Config.fromfile(LAST_CONFIGS["oacnns"]).model.backbone_conf)
    convs = oacnns_convs(oa_bb)
    forward = sum(n for *_, n in convs)  # 23
    stem = sum(n for level, cin, _, n in convs if level == 0 and cin == oa_bb["in_channels"])
    stages = len(oa_bb["channels"])
    # B3 once per conv in a request; in a step B3 forward and for every input gradient but the stem's, B4 once
    oa_step = {"patch_attention_fwd": 0, "patch_attention_bwd": 0, "subm_conv_fwd": 2 * forward - stem,
               "subm_conv_dw": forward}
    print(f"OA-CNNs: {forward} B3 launches a request; a step (batch 8): B3 {oa_step['subm_conv_fwd']}, B4 "
          f"{oa_step['subm_conv_dw']}; {stages} rulebooks; conv shapes (level, Cin, Cout, convs) {convs}")
    none = (dict.fromkeys(oa_step, 0), 0)
    served, shares = {}, {}
    for key, config in LAST_CONFIGS.items():
        served[key] = phase_kp_serve(config, "keypoint", (0, forward, stages) if key == "oacnns" else (0, 0, 0),
                                     cpu_clouds=1)
    for key, module, name in (("ptv1", point_transformer, "farthest_point_sampling_batched"),
                              ("ptv1", point_transformer, "knn"), ("ptv2", point_transformer_v2, "knn"),
                              ("stratified", stratified_transformer, "knn_bucketed")):
        cfg = Config.fromfile(LAST_CONFIGS[key])
        predictor = serve.build_predictor("keypoint", cfg, None, cfg.slot_size, "cuda")
        cloud = request_cloud(np.random.default_rng(59), CLOUD_POINTS)
        predictor.predict(cloud[:, :3], cloud[:, 3:])
        shares[(key, name)] = timed_share(predictor, cloud, module, name)
        del predictor
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        write_keypoint_clouds(root)
        trained, batch = {}, None
        for key, config in LAST_CONFIGS.items():
            cfg = recipe_config(config, root, os.path.join(root, f"exp_{key}"))
            trained[key] = phase_kp_train(f"{key} recipe train", cfg, (oa_step, stages) if key == "oacnns" else none,
                                          probe=True)
            phase_last_step_cpu(f"{key} recipe", cfg)
            batch = batch or cfg.batch_size
        step = trained["oacnns"]["steps"][-1]
        request = {name: served["oacnns"]["counts"].get(name, 0) // REQUESTS for name in oa_step}
        conv = phase_oacnns_kernels(oa_bb, batch, trained["oacnns"].pop("maps"), served["oacnns"].pop("maps"), step,
                                    request)
    bound_by = lambda t: "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"  # noqa: E731
    for row in kernels:
        name = row["name"]
        row["oacnns_step_launches"], row["oacnns_request_launches"] = step[name], request[name]
        if name in conv["step"]:
            t = conv["step"][name]
            row.update({"oacnns_step_max_abs_err": conv["errors"][name], "oacnns_step_ms": t["ms"],
                        "oacnns_step_plain_ms": t["plain_ms"], "oacnns_step_library_ms": t["library_ms"],
                        "oacnns_step_bound_ms": t["bound_ms"], "oacnns_step_bound_by": bound_by(t)})
        if name in conv["request"]:
            t = conv["request"][name]
            row.update({"oacnns_request_ms": t["ms"], "oacnns_request_plain_ms": t["plain_ms"],
                        "oacnns_request_library_ms": t["library_ms"], "oacnns_request_bound_ms": t["bound_ms"],
                        "oacnns_request_bound_by": bound_by(t)})
    for name, s in served.items():
        print(f"{name} serve: request median {statistics.median(s['latencies']):.2f} ms, launches per request "
              f"{ {k: v // REQUESTS for k, v in s['counts'].items()} }; profiled request busy "
              f"{s['profile']['busy_ms']:.2f} ms, idle share {s['profile']['idle_share']:.3f} {stamp()}")
    for (key, name), t in shares.items():
        print(f"{key} request: {name} {t['ms']:.2f} ms in {t['calls']} calls of a {t['request_ms']:.2f} ms request "
              f"(host clock, the card synchronized around each call): share {t['ms'] / t['request_ms']:.3f} {stamp()}")
    for name, run in trained.items():
        prof = run["profile"]
        print(f"{name} recipe: step median {statistics.median(run['step_ms'][1:]):.2f} ms (host clock, steps "
              f"2-{len(run['step_ms'])}), peak memory {run['peak_bytes'] / 2**30:.2f} GiB, slot fill "
              f"{run['fill']:.3f}, profiled step busy {prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
              f"{prof['kernels']} kernels {stamp()}")


# ---- SemanticKITTI: the SLAM bridge's per-scan labeller and the outdoor recipes (phase 42) --------------

KITTI_CONFIGS = {"ptv3": "configs/semantic_kitti/semseg-ptv3-base.py",
                 "mink": "configs/semantic_kitti/semseg-minkunet34c-0-base.py",
                 "spvcnn": "configs/semantic_kitti/semseg-spvcnn-v1m1-0-base.py"}
KITTI_RINGS, KITTI_AZIMUTHS = 64, 1875  # 120,000 returns a scan, as an HDL-64E's at 10 Hz
# the rings' elevations (degrees): the top ring meets the farthest end wall (70 m) below PointClip's z = 2 m
KITTI_ELEVATION = (-24.9, 1.5)
KITTI_SENSOR_HEIGHT = 1.73  # m above the road, as on the KITTI car
RAW_ROAD, RAW_BUILDING, RAW_POLE, RAW_CAR = 40, 50, 80, 10
KITTI_SCANS = {"00": 8, "08": 2}  # a train and a val sequence
KITTI_SLOT = 131072  # the bridge's slot (tools/run_slam.py) and the recipes'
KITTI_STEPS = 4  # the first epoch of each recipe
KITTI_LABELLER_SCANS = 3
# the card-vs-CPU training steps run at this slot, full width and depth: the CPU's step at 131,072 rows would
# take the phase's time (PERF.md)
KITTI_CPU_SLOT = 32768


def kitti_scan(rng: np.random.Generator):
    """One LiDAR scan in SemanticKITTI's sensor frame: KITTI_RINGS x KITTI_AZIMUTHS rays from a sensor
    KITTI_SENSOR_HEIGHT above a road, each ray's first return among the road, two facades along the street,
    two end walls across it, poles along both curbs and car-sized boxes in the lanes, with 2 cm of range
    noise.  Returns float32 [N, 4] (xyz, reflectance) and the raw uint32 labels (road 40, building 50,
    pole 80, car 10)."""
    el = np.deg2rad(np.linspace(*KITTI_ELEVATION, KITTI_RINGS))
    step = 2 * np.pi / KITTI_AZIMUTHS
    az = np.arange(KITTI_AZIMUTHS) * step + rng.uniform(0, step)
    e, a = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)
    h = KITTI_SENSOR_HEIGHT
    best = np.full(d.shape[0], np.inf)
    label = np.zeros(d.shape[0], np.uint32)

    def hit(t, raw):
        closer = np.isfinite(t) & (t > 0.5) & (t < best)
        best[closer] = t[closer]
        label[closer] = raw

    with np.errstate(divide="ignore", invalid="ignore"):
        hit(np.where(d[:, 2] < 0, -h / d[:, 2], np.inf), RAW_ROAD)
        half = rng.uniform(10.0, 16.0, 2)  # the street's half widths, left and right
        for y in (half[0], -half[1]):
            t = y / d[:, 1]
            hit(np.where(t * d[:, 2] < 15.0 - h, t, np.inf), RAW_BUILDING)
        for x in (rng.uniform(55.0, 70.0), -rng.uniform(55.0, 70.0)):
            t = x / d[:, 0]
            hit(np.where(t * d[:, 2] < 15.0 - h, t, np.inf), RAW_BUILDING)
        for px in np.arange(-48.0, 48.0, 12.0) + rng.uniform(-2.0, 2.0):
            for py in (half[0] - 0.6, -half[1] + 0.6):
                qa = d[:, 0] ** 2 + d[:, 1] ** 2
                qb = -2 * (d[:, 0] * px + d[:, 1] * py)
                disc = qb**2 - 4 * qa * (px**2 + py**2 - 0.15**2)
                t = (-qb - np.sqrt(np.maximum(disc, 0))) / (2 * qa)
                z = t * d[:, 2]
                hit(np.where((disc >= 0) & (z > -h) & (z < 6.0 - h), t, np.inf), RAW_POLE)
        for _ in range(10):
            cx = rng.choice([-1, 1]) * rng.uniform(6.0, 45.0)
            cy = rng.uniform(-half[1] + 2.0, half[0] - 2.0)
            lo, hi = np.array([cx - 2.2, cy - 0.9, -h]), np.array([cx + 2.2, cy + 0.9, -h + 1.5])
            t1, t2 = lo / d, hi / d
            near = np.minimum(t1, t2).max(1)
            far = np.maximum(t1, t2).min(1)
            hit(np.where(far >= near, near, np.inf), RAW_CAR)
    ranges = best + rng.normal(0, 0.02, best.shape)
    xyz = d * ranges[:, None]
    reflect = {RAW_ROAD: 0.25, RAW_BUILDING: 0.4, RAW_POLE: 0.6, RAW_CAR: 0.8}
    r = np.array([reflect[int(c)] for c in label]) + rng.uniform(-0.1, 0.1, label.shape)
    return np.concatenate([xyz, r[:, None]], 1).astype(np.float32), label


def write_kitti_scans(root: str, seed: int = 31) -> dict:
    """KITTI_SCANS seeded scans per sequence in the raw layout (``velodyne/NNNNNN.bin``,
    ``labels/NNNNNN.label``) under ``root``; returns {sequence: [(scan, raw labels)]}."""
    rng = np.random.default_rng(seed)
    written = {}
    for seq, count in KITTI_SCANS.items():
        base = os.path.join(root, "dataset", "sequences", seq)
        os.makedirs(os.path.join(base, "velodyne"))
        os.makedirs(os.path.join(base, "labels"))
        written[seq] = []
        for i in range(count):
            scan, raw = kitti_scan(rng)
            scan.tofile(os.path.join(base, "velodyne", f"{i:06d}.bin"))
            raw.tofile(os.path.join(base, "labels", f"{i:06d}.label"))
            written[seq].append((scan, raw))
    return written


def check_kitti_reader(root: str, written: dict) -> None:
    """The port's reader over the written tree: each split's scans (train "00", val "08") with their
    coordinates, reflectance and train ids exactly as written; the slot's fill by each scan's voxels."""
    from pointcept_keypointdetection_tpu_torch.datasets.semantic_kitti import LEARNING_MAP

    for split, seq in (("train", "00"), ("val", "08")):
        ds = build_dataset(dict(type="SemanticKITTIDataset", split=split, data_root=root, transform=None))
        if len(ds) != len(written[seq]):
            raise AssertionError(f"SemanticKITTI {split}: {len(ds)} scans read, {len(written[seq])} written")
        for i, (scan, raw) in enumerate(written[seq]):
            got = ds[i]
            want = np.array([LEARNING_MAP[int(c)] for c in raw], np.int32)
            if not (np.array_equal(got["coord"], scan[:, :3]) and np.array_equal(got["strength"], scan[:, 3:])
                    and np.array_equal(got["segment"], want) and got["name"] == f"{seq}_{i:06d}"):
                raise AssertionError(f"SemanticKITTI {split} scan {i}: the reader's arrays differ from the written")
    voxels = [SemanticScanPredictor.voxelize(scan)[0]["coord"].shape[0] for scans in written.values()
              for scan, _ in scans]
    ids, counts = np.unique(np.concatenate([raw for scans in written.values() for _, raw in scans]),
                            return_counts=True)
    print(f"SemanticKITTI reader: {sum(len(v) for v in written.values())} scans of {KITTI_RINGS * KITTI_AZIMUTHS} "
          f"points read back exactly (train ids through the learning map); raw ids "
          f"{dict(zip(ids.tolist(), counts.tolist()))}; "
          f"voxels at 0.05 m per scan {min(voxels)}-{max(voxels)} (median {int(np.median(voxels))}), the "
          f"{KITTI_SLOT} slot filled {min(voxels) / KITTI_SLOT:.3f}-{max(voxels) / KITTI_SLOT:.3f}")
    if max(voxels) > KITTI_SLOT:
        raise AssertionError(f"a scan has {max(voxels)} voxels, more than the slot {KITTI_SLOT}")


def kitti_expect(key: str, bb, training: bool):
    """(launches, rulebooks) of one forward, or with ``training`` one step: PT-v3m1's B1 and B3 once per
    Block (its k=5 stem is cell-packed), B2, B3 again and B4 once per Block in a step, one rulebook per level;
    MinkUNet's and SPVCNN's B3 once per conv forward and once more for every input gradient but MinkUNet's
    stem's, B4 once per conv, one rulebook per map (MinkUNet: the stem's K = 125, one K = 27 per stage and
    the full-resolution K = 27 of the last decoder stage; SPVCNN: one K = 27 per stage)."""
    if key == "ptv3":
        blocks = sum(bb["enc_depths"]) + sum(bb["dec_depths"])
        launches = {"patch_attention_fwd": blocks, "patch_attention_bwd": blocks if training else 0,
                    "subm_conv_fwd": 2 * blocks if training else blocks, "subm_conv_dw": blocks if training else 0}
        return launches, len(bb["enc_depths"])
    backbone = build_model(dict(Config.fromfile(KITTI_CONFIGS[key]).model)).backbone
    convs = sum(isinstance(m, spunet_module.SubMConv) for m in backbone.modules())  # each runs once a forward
    stems, books = (1, 2 + len(backbone.slot_divisors)) if key == "mink" else (0, len(backbone.channels))
    return {"patch_attention_fwd": 0, "patch_attention_bwd": 0, "subm_conv_fwd": 2 * convs - stems if training
            else convs, "subm_conv_dw": convs if training else 0}, books


def capture_kitti_convs(model, run, label: str) -> dict:
    """The kernel maps and the convs of the MinkUNet or SPVCNN forward that ``run()`` drives through
    ``model``: {"maps": {(N, K): map}, "convs": [(N, K, Cin, Cout, is MinkUNet's stem)] in call order}."""
    make, conv = spunet_module.build_kernel_map, spunet_module.SubMConv.forward
    maps, convs = {}, []
    stem = getattr(model.backbone, "conv0", None)

    def record(*args, **kwargs):
        kmap = make(*args, **kwargs)
        maps[tuple(kmap.neighbor_idx.shape)] = kmap.neighbor_idx
        return kmap

    def recorded_conv(self, feat, kmap):
        k, cin, cout = self.weight.shape
        convs.append((feat.shape[0], k, cin, cout, self is stem))
        return conv(self, feat, kmap)

    spunet_module.build_kernel_map, spunet_module.SubMConv.forward = record, recorded_conv
    try:
        run()
    finally:
        spunet_module.build_kernel_map, spunet_module.SubMConv.forward = make, conv
    for (n, k), idx in sorted(maps.items(), reverse=True):
        print(f"{label} map N={n} K={k}: {int((idx < n).sum())} hits, {int((idx[:, k // 2] < n).sum())} valid rows")
    return dict(maps=maps, convs=convs)


def phase_kitti_labeller(key: str, scans: list) -> dict:
    """``SemanticScanPredictor`` of a KITTI config at slot 131,072 (seeded weights) on the card: a warm-up
    scan, then KITTI_LABELLER_SCANS scans timed on the host clock, each with its launches and rulebooks
    counted (``kitti_expect``) and its labels and embedding checked; one scan under torch.profiler; the
    kernel maps (and MinkUNet's and SPVCNN's convs) of one scan; one scan card against CPU with the same
    weights: the logits within CPU_TOL x max(1, max|cpu|), each raw point's label apart only on a near tie,
    the embedding within CPU_TOL x max(1, max|cpu|)."""
    config = KITTI_CONFIGS[key]
    cfg = Config.fromfile(config)
    expect = kitti_expect(key, cfg.model.backbone, training=False)
    predictor = SemanticScanPredictor(config, None, KITTI_SLOT, "cuda")
    predictor(scans[-1])  # cuBLAS handles and the allocator's pool
    latencies = []
    for i, scan in enumerate(scans[:KITTI_LABELLER_SCANS]):
        torch.cuda.synchronize()
        set_launch_counts_to_zero()
        t0 = time.perf_counter()
        labels, emb = predictor(scan)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        got = (launch_counts(), sc.rulebook_builds)
        print(f"{key} labeller scan {i}: {scan.shape[0]} points -> {labels.shape} labels, embedding {emb.shape}, "
              f"{latencies[-1]:.1f} ms, launches {got[0]}, rulebooks built {got[1]} {stamp()}")
        if got != expect:
            raise AssertionError(f"{key} labeller scan {i}: expected launches and rulebooks {expect}, got {got}")
        if labels.shape != (scan.shape[0],) or not np.isin(labels, np.arange(19)).all():
            raise AssertionError(f"{key} labeller scan {i}: labels {labels.shape} {np.unique(labels)[:8]}")
        if emb.dtype != np.float32 or emb.ndim != 1 or not np.isfinite(emb).all():
            raise AssertionError(f"{key} labeller scan {i}: embedding {emb.dtype} {emb.shape} is not finite f32 [C]")
    prof = profile_run(f"one {key} labeller scan", lambda: predictor(scans[0]), top=8)
    data = predictor.voxelize(scans[0])[0]
    batch = sample_to_device(collate([data], KITTI_SLOT), "cuda")

    def run():
        with torch.inference_mode():
            predictor.model(build_point_batch(batch, 1))

    if key == "ptv3":
        capture = dict(maps=capture_maps(predictor.model, run, f"{key} scan"))
    else:
        capture = capture_kitti_convs(predictor.model, run, f"{key} scan")
    state = {k: v.detach().cpu() for k, v in predictor.model.state_dict().items()}
    cpu = SemanticScanPredictor(config, None, KITTI_SLOT, "cpu")
    cpu.model.load_state_dict(state)
    outs = []
    for p in (predictor, cpu):
        t0 = time.perf_counter()
        outs.append(p.infer(scans[0], logits=True))
        print(f"{key} labeller on {p.device}: logits, labels and embedding of one scan in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock) {stamp()}")
    compare_seg_labels(f"{key} labeller", outs[0], outs[1], outs[0]["labels"], outs[1]["labels"])
    err = float(np.abs(outs[0]["embedding"] - outs[1]["embedding"]).max())
    scale = max(1.0, float(np.abs(outs[1]["embedding"]).max()))
    print(f"{key} labeller card vs cpu embedding {outs[0]['embedding'].shape}: max_abs_err={err:.3e}, tol "
          f"{CPU_TOL:g} x "
          f"{scale:.3f} {stamp()}")
    if err > CPU_TOL * scale:
        raise AssertionError(f"{key} labeller: card and CPU embeddings disagree: {err:.3e}")
    del predictor, cpu
    torch.cuda.empty_cache()
    return dict(latencies=latencies, counts=expect[0], profile=prof, capture=capture)


def kitti_train_config(key: str, root: str):
    """A KITTI recipe as written (batch 8, slot 131,072, f32, its optimizer, schedule, criteria,
    transforms and Mix3D; batch 8 fits the card for all three, PERF.md) over the written tree: KITTI_STEPS
    steps per epoch."""
    cfg = Config.fromfile(KITTI_CONFIGS[key])
    cfg.merge_from_dict({"save_path": os.path.join(root, f"exp_{key}"), "seed": 0, "data.train.data_root": root,
                         "data.val.data_root": root,
                         "data.train.loop": KITTI_STEPS * cfg.batch_size // KITTI_SCANS["00"]})
    return cfg


def phase_kitti_step_cpu(key: str, cfg) -> dict:
    """One training step of a KITTI recipe at batch 1 (one scan of its training data through its transforms,
    np.random seeded 5) at slot KITTI_CPU_SLOT, full width and depth, no drop path and no order shuffling,
    card against CPU in f32 within TRAIN_CPU_TOL; MinkUNet's and SPVCNN's with the card on the CPU's side of
    every ReLU tie (PT-v3m1 has none: GELU)."""
    model_cfg = dict(cfg.model)
    if key == "ptv3":
        model_cfg["backbone"] = dict(cfg.model.backbone, drop_path=0.0, shuffle_orders=False)
    np.random.seed(5)
    batch_np = collate([build_dataset(dict(cfg.data.train))[0]], KITTI_CPU_SLOT, np.random)
    return compare_step(f"kitti {key} (slot {KITTI_CPU_SLOT})", model_cfg, batch_np, torch.float32, TRAIN_CPU_TOL,
                        relu_ties=key != "ptv3")


def phase_kitti_ptv3_scan_kernels(bb, maps: dict, counts: dict) -> dict:
    """B1 and B3 at every PT-v3m1 level of one scan (slot 131,072, patch 128, head dim 16) in f32 against
    their plain versions, B3 on the scan's maps, each timed beside its library call and its bound, summed
    per scan."""
    rng = np.random.default_rng(67)
    per_scan = {}
    for (n, c, heads, patch), depth in seg_shapes(bb, KITTI_SLOT, 1).items():
        check_attention(rng, n, heads, patch, torch.float32)
        check_conv(rng, maps[n], c, torch.float32)
        print(f"kitti ptv3 scan level N={n} C={c} H={heads} patch={patch} f32 (x{depth} Blocks per scan):")
        add_row(per_scan, "patch_attention_fwd", time_attention(rng, n, heads, patch, torch.float32, False), depth)
        add_row(per_scan, "subm_conv_fwd", time_conv(rng, maps[n], c, torch.float32, dw=False), depth)
    for name, t in per_scan.items():
        t["launches"] = counts[name]
        print(f"{name} per kitti ptv3 scan (f32, sum over its {counts[name]} launches): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms {stamp()}")
    return per_scan


def phase_kitti_conv_kernels(key: str, step_capture: dict, scan_capture: dict, step: dict, scan: dict) -> tuple:
    """B3 and B4 at every conv shape of a MinkUNet34C or SPVCNN step (batch 8) and of a scan,
    on the maps the runs captured, in f32 against their plain versions (the K = 125 stem's Cin 4 padded to
    8 for the kernels) and bit for bit run to run: B3 forward, B3 at the input gradient's mirrored shape
    (Cout -> Cin; none for the stem) and B4 in a step, B3 forward in a scan.  Each timed beside its plain
    version, the gather + torch.matmul and its bound, summed per step and per scan; the sums' launches
    checked against the runs' counts.  Returns ({"step": sums, "scan": sums}, each kernel's largest error)."""
    rng = np.random.default_rng(71)
    errors = dict.fromkeys(("subm_conv_fwd", "subm_conv_dw"), 0.0)
    sums = {"step": {}, "scan": {}}
    for part, capture, counts in (("step", step_capture, step), ("scan", scan_capture, scan)):
        shapes, timed, launches, bits = {}, {}, dict.fromkeys(errors, 0), set()
        for conv in capture["convs"]:
            shapes[conv] = shapes.get(conv, 0) + 1
        for (n, k, cin, cout, stem), reps in shapes.items():
            idx = capture["maps"][(n, k)]
            runs = [("subm_conv_fwd", cin, cout)]
            if part == "step":
                runs += [("subm_conv_dw", cin, cout)] + ([] if stem else [("subm_conv_fwd", cout, cin)])
            if (n, k) not in bits:
                check_conv_bits(rng, idx, cout, torch.float32, cin)
                bits.add((n, k))
            for name, ci, co in runs:
                shape = (name, n, k, ci, co)
                if shape not in timed:
                    check_fn = check_conv if name == "subm_conv_fwd" else check_conv_dw
                    errors[name] = max(errors[name], check_fn(rng, idx, co, torch.float32, ci))
                    print(f"kitti {key} {part} N={n} K={k} Cin={ci} Cout={co}{' (the stem)' if stem else ''} {name} "
                          f"f32 (x{reps} per {part}):")
                    timed[shape] = time_conv(rng, idx, co, torch.float32, dw=name == "subm_conv_dw", cin=ci)
                add_row(sums[part], name, timed[shape], reps)
                launches[name] += reps
        for name, t in sums[part].items():
            if launches[name] != counts[name]:
                raise AssertionError(f"kitti {key} {part}: {name} timed for {launches[name]} launches, the run made "
                                     f"{counts[name]}")
            t["launches"] = counts[name]
            print(f"{name} per kitti {key} {part} (f32, sum over its {counts[name]} launches): kernel {t['ms']:.4f} "
                  f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"{stamp()}")
    return sums, errors


def phase_kitti(kernels: list) -> None:
    """Phase 42: SemanticKITTI segmentation.  Seeded scans written in the raw layout and read back through
    the port's reader; the SLAM bridge's labeller (``SemanticScanPredictor``) over PT-v3m1, MinkUNet34C and
    SPVCNN at slot 131,072; each recipe trained as written through ``DefaultTrainer`` on the tree (batch 8,
    f32, its first epoch of KITTI_STEPS steps, the evaluator, the saver, a fixed-batch probe);
    one step of each card against CPU; B1-B4 at PT-v3m1's KITTI levels and B3 and B4 at every MinkUNet34C
    and SPVCNN conv shape against their plain versions, timed per step and per scan.  Adds
    ``kitti_{ptv3,mink,spvcnn}_{step,scan}_*`` to the kernels line."""
    labelled, trained, batch = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        written = write_kitti_scans(root)
        check_kitti_reader(root, written)
        scans = [scan for scan, _ in written["00"]]
        for key in KITTI_CONFIGS:
            labelled[key] = phase_kitti_labeller(key, scans)
        for key in KITTI_CONFIGS:
            cfg = kitti_train_config(key, root)
            batch[key] = cfg.batch_size
            label = f"kitti {key} recipe train"
            if key == "ptv3":
                trained[key] = phase_seg_train(label, cfg, torch.float32)
            else:
                trained[key] = phase_spunet_train(label, cfg, expect=kitti_expect(key, cfg.model.backbone, True),
                                                  capture=capture_kitti_convs)
            phase_kitti_step_cpu(key, cfg)
    rows = {}
    for key in KITTI_CONFIGS:
        step, scan = trained[key]["steps"][-1], labelled[key]["counts"]
        if key == "ptv3":
            bb = Config.fromfile(KITTI_CONFIGS[key]).model.backbone
            sums, errors = phase_seg_kernels("kitti ptv3", bb, KITTI_SLOT, batch[key],
                                             trained[key].pop("maps"), torch.float32, step)
            sums = {"step": sums, "scan": phase_kitti_ptv3_scan_kernels(bb, labelled[key]["capture"]["maps"], scan)}
            for name, t in sums["step"].items():
                t["launches"] = step[name]
        else:
            sums, errors = phase_kitti_conv_kernels(key, trained[key].pop("maps"), labelled[key]["capture"], step,
                                                    scan)
        rows[key] = (sums, errors, step, scan)
    bound_by = lambda t: "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"  # noqa: E731
    for row in kernels:
        name = row["name"]
        for key, (sums, errors, step, scan) in rows.items():
            prefix = f"kitti_{key}"
            row[f"{prefix}_step_launches"], row[f"{prefix}_scan_launches"] = step[name], scan[name]
            if name in errors:
                row[f"{prefix}_step_max_abs_err"] = errors[name]
            for part in ("step", "scan"):
                t = sums[part].get(name)
                if t is not None:
                    row.update({f"{prefix}_{part}_ms": t["ms"], f"{prefix}_{part}_plain_ms": t["plain_ms"],
                                f"{prefix}_{part}_library_ms": t["library_ms"],
                                f"{prefix}_{part}_bound_ms": t["bound_ms"], f"{prefix}_{part}_bound_by": bound_by(t)})
    for key, run in labelled.items():
        print(f"kitti {key} labeller: scan median {statistics.median(run['latencies']):.2f} ms (host clock, "
              f"{len(run['latencies'])} scans of {KITTI_RINGS * KITTI_AZIMUTHS} points, slot {KITTI_SLOT}), launches "
              f"per scan B1 {run['counts']['patch_attention_fwd']} B3 {run['counts']['subm_conv_fwd']}; profiled scan "
              f"busy {run['profile']['busy_ms']:.2f} ms, idle share {run['profile']['idle_share']:.3f} {stamp()}")
    for key, run in trained.items():
        prof = run["profile"]
        print(f"kitti {key} recipe: batch {batch[key]} (the recipe's), step median "
              f"{statistics.median(run['step_ms'][1:]):.2f} ms (host clock, steps 2-{len(run['step_ms'])}), peak memory "
              f"{run['peak_bytes'] / 2**30:.2f} GiB, profiled step busy {prof['busy_ms']:.2f} ms, idle "
              f"share {prof['idle_share']:.3f}, {prof['kernels']} kernels {stamp()}")


SLAM_CIRCUIT = ["--frames", "175", "--loop", "--straight", "40", "--radius", "16", "--step", "1.2", "--n-cars", "8"]
SLAM_ODOMETRY = "configs/slam/synth_loop.py"
SLAM_FULL = "configs/slam/synth_loop_full.py"
SLAM_ATE_MAX = 0.05  # m: the odometry's and the back end's live ATE (JAX's committed odometry trajectory: 0.0266)
SLAM_RETRO_ATE_MAX = 0.065  # m: the back end's retro-corrected ATE
# tools/run_slam.py with the JAX package on a CPU over the same circuit (synth_loop_full.py)
SLAM_JAX_CPU = dict(keyframes=88, edges=100, closures=13, ate=0.032, ate_live=0.026)
SLAM_CPU_FRAMES = 20
SLAM_CPU_POS_TOL = 2e-3  # m a frame, card against CPU
SLAM_CPU_ROT_TOL = 1e-3  # rad a frame
SLAM_MODEL_FRAMES = 10
SLAM_MODEL_CPU_SCANS = 2


def pose_gaps(card: np.ndarray, cpu: np.ndarray):
    """Per frame: the largest position difference (m) and the rotation angle between two trajectories of
    3x4 rows (the sine of the angle, from the skew part of Ra^T Rb, exact near 0)."""
    a, b = card.reshape(-1, 3, 4).astype(np.float64), cpu.reshape(-1, 3, 4).astype(np.float64)
    pos = np.abs(a[:, :, 3] - b[:, :, 3]).max(1)
    d = np.einsum("nji,njk->nik", a[:, :, :3], b[:, :, :3])
    skew = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], 1)
    return pos, np.arcsin(np.clip(np.linalg.norm(skew, axis=1) / 2, 0, 1))


def check_pose_gaps(label: str, card: np.ndarray, cpu: np.ndarray) -> None:
    pos, rot = pose_gaps(card, cpu)
    print(f"{label}: card vs cpu over {len(pos)} frames: worst position gap {pos.max():.3e} m (frame "
          f"{int(pos.argmax())}), worst rotation gap {rot.max():.3e} rad (frame {int(rot.argmax())}); "
          f"{int((pos > 0).sum())} frames not bit for bit; tol {SLAM_CPU_POS_TOL:g} m, {SLAM_CPU_ROT_TOL:g} rad "
          f"{stamp()}")
    if pos.max() > SLAM_CPU_POS_TOL or rot.max() > SLAM_CPU_ROT_TOL:
        raise AssertionError(f"{label}: card and CPU poses disagree")


def slam_run(config: str, root: str, device: str = "cuda", frames=None, options=()) -> dict:
    """The port's ``run_slam`` over the written circuit, as a user calls it."""
    argv = ["--config-file", config, "--device", device, "--options", f"data_root={root}",
            f"save_path={os.path.join(root, 'exp')}", *options]
    if frames:
        argv += ["--max-frames", str(frames)]
    torch.cuda.synchronize()
    return run_slam.main(argv)


def circuit_scan(root: str, i: int):
    seq = os.path.join(root, "dataset", "sequences", "00")
    scan = semantic_kitti_module.read_scan(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
    return scan, semantic_kitti_module.read_label(os.path.join(seq, "labels", f"{i:06d}.label"))


def slam_scan_profile(engine, root: str, label: str, sync_check: bool) -> dict:
    """One more scan of the circuit (its last) through the engine after its run, under torch.profiler; with
    ``sync_check`` (an odometry) one more under CUDA's sync debug mode, where the step's only synchronizing
    call must be the pose's read."""
    import warnings

    scan, labels = circuit_scan(root, 174)
    prof = profile_run(f"one {label} scan", lambda: engine.process(scan, labels), top=10)
    if sync_check:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                engine.process(scan, labels)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
        print(f"one {label} scan under CUDA's sync debug mode: {len(syncs)} synchronizing call(s) {stamp()}")
        if len(syncs) != 1:
            raise AssertionError(f"{label}: a scan synchronized {len(syncs)} times, not once (the pose's read)")
    return prof


def phase_slam_runs(root: str) -> dict:
    """The odometry and the back end over the circuit on the card, each run's launches counted (the odometry
    is plain torch: none), ATE, RPE and the graph's counts checked; the first frames on the CPU meanwhile."""
    cpu = start_cpu_odometry(root)
    try:
        out = {}
        for key, config in (("odometry", SLAM_ODOMETRY), ("full", SLAM_FULL)):
            set_launch_counts_to_zero()
            res = slam_run(config, root)
            torch.cuda.synchronize()
            counts = launch_counts()
            engine = res["engine"]
            scans = len(res["step_ms"])
            line = (f"slam {key} ({config}): {scans} scans in {res['seconds']:.2f} s, {scans / res['seconds']:.3f} "
                    f"scans/s, median host ms a scan {statistics.median(res['step_ms'][1:]):.2f} (frames 2-{scans}), "
                    f"ATE {res['ate']:.4f} m, RPE@10 {res['rpe']:.4f} m")
            if key == "full":
                line += (f", live ATE {res['ate_live']:.4f} m; keyframes {engine.keyframe_count}, edges "
                         f"{engine.edge_count}, loop closures {engine.loop_count} (JAX on a CPU: "
                         f"{SLAM_JAX_CPU['keyframes']}, {SLAM_JAX_CPU['edges']}, {SLAM_JAX_CPU['closures']}; ATE "
                         f"{SLAM_JAX_CPU['ate']}, live {SLAM_JAX_CPU['ate_live']})")
            print(f"{line}; launches {counts} {stamp()}")
            if any(counts.values()):
                raise AssertionError(f"slam {key}: the odometry launched kernels {counts}")
            if not np.isfinite(res["trajectory"]).all() or res["trajectory"].shape != (175, 12):
                raise AssertionError(f"slam {key}: trajectory {res['trajectory'].shape} is not 175 finite 3x4 poses")
            if key == "odometry" and res["ate"] > SLAM_ATE_MAX:
                raise AssertionError(f"slam odometry: ATE {res['ate']:.4f} m > {SLAM_ATE_MAX}")
            if key == "full" and (res["ate_live"] > SLAM_ATE_MAX or res["ate"] > SLAM_RETRO_ATE_MAX
                                  or engine.loop_count < 1):
                raise AssertionError(f"slam full: live ATE {res['ate_live']:.4f}, retro ATE {res['ate']:.4f}, "
                                     f"{engine.loop_count} closures")
            res["profile"] = slam_scan_profile(engine, root, f"slam {key}", sync_check=key == "odometry")
            out[key] = res
        check_pose_gaps("slam odometry", out["odometry"]["trajectory"][:SLAM_CPU_FRAMES], finish_cpu_odometry(cpu))
    finally:
        if cpu[0].poll() is None:  # a card run failed: stop the CPU run too
            cpu[0].kill()
            cpu[0].wait()
    return out


def start_cpu_odometry(root: str):
    """``run_slam`` of ``synth_loop.py`` over the first SLAM_CPU_FRAMES frames on the CPU, in a process of its
    own beside the card's runs (on all cores but one, at nice 10, so that the host thread driving the card
    keeps its core): (the process, its trajectory's .npy, the start time)."""
    out = os.path.join(root, "cpu_trajectory.npy")
    threads = max(1, len(os.sched_getaffinity(0)) - 1)
    code = ("import os, sys, numpy as np, torch; os.nice(10); torch.set_num_threads(int(sys.argv[2])); "
            "from pointcept_keypointdetection_tpu_torch import run_slam; "
            "np.save(sys.argv[1], run_slam.main(sys.argv[3:])['trajectory'])")
    argv = [sys.executable, "-c", code, out, str(threads), "--config-file", SLAM_ODOMETRY, "--device", "cpu",
            "--max-frames", str(SLAM_CPU_FRAMES), "--options", f"data_root={root}",
            f"save_path={os.path.join(root, 'exp_cpu')}"]
    return subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out, time.perf_counter()


def finish_cpu_odometry(cpu) -> np.ndarray:
    proc, out, t0 = cpu
    try:
        log, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"slam odometry on the CPU ({SLAM_CPU_FRAMES} frames, its own process beside the card's runs): done "
          f"{time.perf_counter() - t0:.1f} s after its start, exit {proc.returncode} {stamp()}")
    if proc.returncode != 0:
        raise AssertionError(f"slam odometry on the CPU failed:\n{log[-3000:]}")
    return np.load(out)


@contextlib.contextmanager
def recorded_labeller():
    """Every ``SemanticScanPredictor`` call's (predictor, scan, labels, embedding)."""
    calls, plain = [], semantic_scan.SemanticScanPredictor.__call__

    def spy(self, scan):
        labels, emb = plain(self, scan)
        calls.append((self, scan, labels, emb))
        return labels, emb

    semantic_scan.SemanticScanPredictor.__call__ = spy
    try:
        yield calls
    finally:
        semantic_scan.SemanticScanPredictor.__call__ = plain


def phase_slam_model_labels(root: str) -> dict:
    """``synth_loop.py`` with its labels from PT-v3m1 (seeded weights, slot 131,072) over SLAM_MODEL_FRAMES
    frames on the card: B1 and B3 per scan, rulebooks, the labeller's ms a scan and the share of points the
    filter drops; SLAM_MODEL_CPU_SCANS scans card against CPU as phase 42; the card's labels through a CPU
    odometry against the card's poses."""
    bb = Config.fromfile(KITTI_CONFIGS["ptv3"]).model.backbone
    expect, books = kitti_expect("ptv3", bb, training=False)
    opts = ("semantic.labels_from=model", f"semantic.config={KITTI_CONFIGS['ptv3']}")
    with recorded_labeller() as calls:
        set_launch_counts_to_zero()
        res = slam_run(SLAM_ODOMETRY, root, frames=SLAM_MODEL_FRAMES, options=opts)
        torch.cuda.synchronize()
        counts, rulebooks = launch_counts(), sc.rulebook_builds
    per_scan = {name: n / SLAM_MODEL_FRAMES for name, n in counts.items()}
    dynamic = tuple(Config.fromfile(SLAM_ODOMETRY).semantic.dynamic_classes)
    dropped = [float(np.isin(labels, dynamic).mean()) for _, _, labels, _ in calls]
    print(f"slam model labels: {SLAM_MODEL_FRAMES} frames, launches per scan {per_scan}, rulebooks "
          f"{rulebooks / SLAM_MODEL_FRAMES:g} a scan; labeller median {statistics.median(res['label_ms'][1:]):.2f} "
          f"ms a scan (host clock, scans 2-{SLAM_MODEL_FRAMES}), odometry median "
          f"{statistics.median(res['step_ms'][1:]):.2f} ms; the filter drops {np.mean(dropped):.4f} of the points "
          f"(per scan {min(dropped):.4f}-{max(dropped):.4f}) {stamp()}")
    if len(calls) != SLAM_MODEL_FRAMES or {k: v for k, v in per_scan.items()} != {k: float(v) for k, v in
                                                                                  expect.items()}:
        raise AssertionError(f"slam model labels: {len(calls)} labeller calls, launches per scan {per_scan}, "
                             f"expected {expect}")
    if rulebooks != books * SLAM_MODEL_FRAMES:
        raise AssertionError(f"slam model labels: {rulebooks} rulebooks, expected {books} a scan")
    predictor = calls[0][0]
    cpu = SemanticScanPredictor(KITTI_CONFIGS["ptv3"], None, KITTI_SLOT, "cpu")
    cpu.model.load_state_dict({k: v.detach().cpu() for k, v in predictor.model.state_dict().items()})
    for _, scan, labels, emb in calls[:SLAM_MODEL_CPU_SCANS]:
        outs = [p.infer(scan, logits=True) for p in (predictor, cpu)]
        np.testing.assert_array_equal(outs[0]["labels"], labels)
        compare_seg_labels("slam labeller", outs[0], outs[1], outs[0]["labels"], outs[1]["labels"])
        err = float(np.abs(outs[0]["embedding"] - outs[1]["embedding"]).max())
        scale = max(1.0, float(np.abs(outs[1]["embedding"]).max()))
        print(f"slam labeller card vs cpu embedding: max_abs_err={err:.3e}, tol {CPU_TOL:g} x {scale:.3f} {stamp()}")
        if err > CPU_TOL * scale or not np.allclose(outs[0]["embedding"], emb):
            raise AssertionError(f"slam labeller: card and CPU embeddings disagree: {err:.3e}")
    del cpu
    odo_cfg = Config.fromfile(SLAM_ODOMETRY)
    odo = LidarOdometry(OdometryConfig(dynamic_classes=dynamic, **dict(odo_cfg.odometry)), "cpu")
    cpu_traj = np.stack([odo.process(scan, labels)[:3].reshape(-1) for _, scan, labels, _ in calls])
    check_pose_gaps("slam odometry on the card's labels", res["trajectory"], cpu_traj)
    return dict(counts=counts, per_scan=per_scan, predictor=predictor, label_ms=res["label_ms"], dropped=dropped)


def phase_slam_kernels(predictor, root: str, per_scan: dict) -> tuple:
    """B1 on each of its calls' own inputs in one circuit scan's forward (the scan's fill of the slot) and B3
    on that scan's kernel maps (random features), f32 against their plain versions; each timed beside its
    library call and bound at every PT-v3m1 level, summed per scan.  Returns (sums, largest errors)."""
    scan, _ = circuit_scan(root, 0)
    data = predictor.voxelize(scan)[0]
    print(f"slam scan: {scan.shape[0]} points, {data['coord'].shape[0]} voxels in the {KITTI_SLOT} slot "
          f"(fill {data['coord'].shape[0] / KITTI_SLOT:.3f})")
    batch = sample_to_device(collate([data], KITTI_SLOT), "cuda")
    captured, plain_fwd = [], pa._forward_kernel

    def spy(qkv, valid, patch_size, scale, *args, **kwargs):
        captured.append((qkv.detach().clone(), valid.clone(), patch_size, scale))
        return plain_fwd(qkv, valid, patch_size, scale, *args, **kwargs)

    def run():
        with torch.inference_mode():
            predictor.model(build_point_batch(batch, 1))

    pa._forward_kernel = spy
    try:
        maps = capture_maps(predictor.model, run, "slam scan")
    finally:
        pa._forward_kernel = plain_fwd
    errors = {"patch_attention_fwd": 0.0, "subm_conv_fwd": 0.0}
    for qkv, valid, patch, scale in captured:
        label = (f"B1 patch_attention on a circuit scan's inputs N={qkv.shape[0]} H={qkv.shape[2]} patch={patch} "
                 f"valid={int(valid.sum())}")
        errors["patch_attention_fwd"] = max(errors["patch_attention_fwd"], check(
            label, pa.patch_attention(qkv, valid, patch, scale), pa.patch_attention_plain(qkv, valid, patch, scale),
            *TOL[torch.float32]))
    if len(captured) != per_scan["patch_attention_fwd"]:
        raise AssertionError(f"slam scan: {len(captured)} B1 calls captured, the path made "
                             f"{per_scan['patch_attention_fwd']} a scan")
    rng = np.random.default_rng(73)
    sums = {}
    bb = predictor.cfg.model.backbone
    for (n, c, heads, patch), depth in seg_shapes(bb, KITTI_SLOT, 1).items():
        errors["subm_conv_fwd"] = max(errors["subm_conv_fwd"], check_conv(rng, maps[n], c, torch.float32))
        print(f"slam scan level N={n} C={c} H={heads} patch={patch} f32 (x{depth} Blocks per scan):")
        add_row(sums, "patch_attention_fwd", time_attention(rng, n, heads, patch, torch.float32, False), depth)
        add_row(sums, "subm_conv_fwd", time_conv(rng, maps[n], c, torch.float32, dw=False), depth)
    for name, t in sums.items():
        print(f"{name} per slam scan (f32, sum over its {per_scan[name]:g} launches): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"{stamp()}")
    return sums, errors


def phase_slam(kernels: list) -> None:
    """Phase 43: the SLAM bridge's odometry and back end over the loop circuit, the labeller in the loop, B1
    and B3 at a circuit scan's occupancy.  Adds ``slam_scan_b1_*`` (to B1's row) and ``slam_scan_b3_*`` (to
    B3's) to the kernels line."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "tools/make_synthetic_kitti.py", "--out", root, *SLAM_CIRCUIT], check=True,
                       capture_output=True)
        print(f"slam circuit: 175 frames written in {time.perf_counter() - t0:.1f} s {stamp()}")
        runs = phase_slam_runs(root)
        model = phase_slam_model_labels(root)
        sums, errors = phase_slam_kernels(model["predictor"], root, model["per_scan"])
    for key, run in runs.items():
        prof = run["profile"]
        print(f"slam {key}: profiled scan wall {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms, idle "
              f"share {prof['idle_share']:.3f}, {prof['kernels']} kernel launches {stamp()}")
    bound_by = lambda t: "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"  # noqa: E731
    for row in kernels:
        tag = {"patch_attention_fwd": "b1", "subm_conv_fwd": "b3"}.get(row["name"])
        if tag:
            t = sums[row["name"]]
            row.update({f"slam_scan_{tag}_launches": model["per_scan"][row["name"]],
                        f"slam_scan_{tag}_max_abs_err": errors[row["name"]], f"slam_scan_{tag}_ms": t["ms"],
                        f"slam_scan_{tag}_plain_ms": t["plain_ms"], f"slam_scan_{tag}_library_ms": t["library_ms"],
                        f"slam_scan_{tag}_bound_ms": t["bound_ms"], f"slam_scan_{tag}_bound_by": bound_by(t)})


def mark(phases: str, t_start: float) -> None:
    """The script's clock at the end of ``phases``: what each part of the time limit goes to."""
    print(f"chip_smoke clock: {phases} done at {time.perf_counter() - t_start:.1f} s {stamp()}")


def main() -> None:
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    cfg = Config.fromfile(CONFIG)
    maps = phase_kernels(cfg)
    predictor = serve.build_predictor("offset_keypoint", cfg, None, cfg.slot_size, "cuda")
    rng = np.random.default_rng(2)
    clouds = [request_cloud(rng, CLOUD_POINTS) for _ in range(REQUESTS + 1)]
    warm = clouds.pop()
    predictor.predict(warm[:, :3], warm[:, 3:])  # cuBLAS handles and the allocator's pool, outside the timed requests
    latencies, _ = phase_serve(predictor, clouds, cfg.model.backbone_conf, check_keypoints)
    phase_cpu(cfg, predictor, clouds[0])
    del predictor
    train_maps = training_maps(cfg)
    errors = phase_train_kernels(cfg, train_maps)
    train = phase_train(cfg)
    phase_train_cpu(cfg)
    kernels, per_request = phase_times(cfg, latencies, maps, train_maps, errors, train)
    mark("phases 1-9 (keypoint serving and training)", t_start)
    phase_pigseg()
    mark("phase 10 (pigseg serving)", t_start)
    run = phase_bench()
    sums = phase_bench_kernels(run.pop("maps"))
    for row in kernels:  # B1 and B3 per bench forward, bf16
        if row["name"] in sums["bfloat16"]:
            t = sums["bfloat16"][row["name"]]
            row.update(bench_launches=run["bfloat16"][row["name"]], bench_ms=t["ms"],
                       bench_plain_ms=t["plain_ms"], bench_library_ms=t["library_ms"], bench_bound_ms=t["bound_ms"],
                       bench_bound_by="operations" if t["t_ops"] >= t["t_bytes"] else "bytes")
    with tempfile.TemporaryDirectory() as root:
        write_pig_clouds(root)
        seg = {}
        for key, label, cfg, dtype in (("pigseg", "pigseg train", pigseg_train_config(root), torch.float32),
                                       ("amp", "scannet amp train", scannet_train_config(os.path.join(root, "scannet")),
                                        torch.bfloat16)):
            trained = phase_seg_train(label, cfg, dtype)
            if key == "amp":
                phase_lovasz(cfg.batch_size * cfg.slot_size, cfg.model.num_classes)
            step = trained["steps"][-1]
            sums, errs = phase_seg_kernels(key, cfg.model.backbone, cfg.slot_size, cfg.batch_size, trained.pop("maps"),
                                           dtype, step)
            seg[key] = (cfg, step, sums, errs)
        phase_seg_train_cpu(seg["pigseg"][0], seg["amp"][0])
    mark("phases 11-15 (bench, segmentation trainers)", t_start)
    r3_cfg = Config.fromfile(R3_CONFIG)
    r3 = phase_r3_anchor(r3_cfg)
    r3_latencies = phase_r3_serve(r3_cfg)
    r3_train = phase_r3_train(r3_cfg)
    r3_errors = phase_r3_kernels(r3_cfg, r3["request_maps"], r3["step_maps"])
    r3_sums = phase_r3_times(r3_cfg, r3["request_maps"], r3["step_maps"], r3_forward_counts(r3_cfg.model.backbone_conf),
                             r3_train["steps"][-1])
    for row in kernels:  # B1-B4 per step of the pigseg trainer (f32) and the ScanNet recipe's (amp, bf16)
        for key, (_, step, sums, errs) in seg.items():
            t = sums[row["name"]]
            row.update({f"{key}_launches": step[row["name"]], f"{key}_max_abs_err": errs[row["name"]],
                        f"{key}_ms": t["ms"], f"{key}_plain_ms": t["plain_ms"], f"{key}_library_ms": t["library_ms"],
                        f"{key}_bound_ms": t["bound_ms"],
                        f"{key}_bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"})
    for row in kernels:  # B1-B4 per r3 training step, B1 and B3 per r3 request (f32)
        for key, t in ((key, r3_sums[key].get(row["name"])) for key in ("step", "request")):
            if t is not None:
                row.update({f"r3_{key}_launches": t["launches"], f"r3_{key}_ms": t["ms"],
                            f"r3_{key}_plain_ms": t["plain_ms"], f"r3_{key}_library_ms": t["library_ms"],
                            f"r3_{key}_bound_ms": t["bound_ms"],
                            f"r3_{key}_bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"})
        row["r3_max_abs_err"] = r3_errors[row["name"]]
    print(f"r3: anchor {r3['anchor']} mm on the card; request median {statistics.median(r3_latencies):.2f} ms; "
          f"step median {statistics.median(r3_train['step_ms'][1:]):.2f} ms {stamp()}")
    mark("phases 16-20 (r3)", t_start)
    anchor = phase_semseg_r3_anchor()
    tester = phase_semseg_r3_tester()
    spunet = {}
    with tempfile.TemporaryDirectory() as root:
        for key, label, cfg in (("scannet_spunet", "scannet spunet train", spunet_train_config(os.path.join(root, "s"))),
                                ("semseg_r3_step", "semseg_r3 train", semseg_r3_train_config(os.path.join(root, "r")))):
            trained = phase_spunet_train(label, cfg)
            step = trained["steps"][-1]
            sums, errs, stem = phase_spunet_kernels(key, cfg.model.backbone, cfg.slot_size, cfg.batch_size,
                                                    trained.pop("maps"), step)
            phase_spunet_train_cpu(label, cfg, SCANNET_CPU_LAYERS if key == "scannet_spunet" else None)
            spunet_rows(kernels, key, sums, errs, step)
            spunet[key] = (trained, stem)
    stem = spunet["scannet_spunet"][1]
    for row in kernels:  # the k=5 stem's conv, per launch, on the ScanNet recipe's map (Cin 6 padded to 8)
        part = {"subm_conv_fwd": "fwd", "subm_conv_dw": "dw"}.get(row["name"])
        if part:
            for prefix, t in (("k125_", stem[row["name"]]), ("k125_bf16_", stem[f"bf16_{part}"])):
                row.update({f"{prefix}{k}": t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    for key, (trained, _) in spunet.items():
        print(f"{key}: step median {statistics.median(trained['step_ms'][1:]):.2f} ms (host clock, steps "
              f"2-{len(trained['step_ms'])}), peak memory {trained['peak_bytes'] / 2**30:.2f} GiB; profiled step: "
              f"busy {trained['profile']['busy_ms']:.2f} ms, idle share {trained['profile']['idle_share']:.3f}, "
              f"{trained['profile']['kernels']} kernels {stamp()}")
    print(f"semseg_r3: anchor mIoU {anchor['miou']}; tester mIoU {tester['mIoU']:.4f} over {tester['forwards']} "
          f"fragment forwards {stamp()}")
    mark("phases 21-25 (SpUNet)", t_start)
    insseg = phase_insseg_anchor()
    pg = {}
    with tempfile.TemporaryDirectory() as root:
        for key, label, cfg in (
                ("insseg_r3_step", "insseg_r3 train", insseg_r3_train_config(os.path.join(root, "r3"))),
                ("insseg_scannet", "scannet PG-v1m1 train",
                 pg_train_config(PG_V1M1_CONFIG, os.path.join(root, "v1m1"), Config.fromfile(PG_V1M1_CONFIG).batch_size))):
            with recorded_insseg_passes() as passes:
                trained = phase_spunet_train(label, cfg, PG_LOSSES,
                                             PROBE_STEPS if key == "insseg_r3_step" else PG_PROBE_STEPS)
            step = trained["steps"][-1]
            sums, errs, _ = phase_spunet_kernels(key, cfg.model.backbone, cfg.slot_size, cfg.batch_size,
                                                 trained.pop("maps"), step, dtypes=(torch.float32,))
            if key == "insseg_r3_step":  # phase 25 holds the same backbone's step at the ScanNet scale
                phase_spunet_train_cpu(label, cfg)
            spunet_rows(kernels, key, sums, errs, step)
            pg[key] = (trained, passes)
        phase_insseg_cluster_cpu()
        cfg = pg_train_config(PG_V1M2_CONFIG, os.path.join(root, "v1m2"), SCANNET_BATCH)
        with recorded_insseg_passes() as passes:
            trained = phase_seg_train("scannet PG-v1m2 amp train", cfg, torch.bfloat16)
        step = trained["steps"][-1]
        sums, errs = phase_seg_kernels("insseg_amp", cfg.model.backbone, cfg.slot_size, cfg.batch_size,
                                       trained.pop("maps"), torch.bfloat16, step)
        pg["insseg_amp"] = (trained, passes)
        for row in kernels:  # B1-B4 per PG-v1m2 amp step (bf16)
            t = sums[row["name"]]
            row.update({"insseg_amp_launches": step[row["name"]], "insseg_amp_max_abs_err": errs[row["name"]],
                        "insseg_amp_ms": t["ms"], "insseg_amp_plain_ms": t["plain_ms"],
                        "insseg_amp_library_ms": t["library_ms"], "insseg_amp_bound_ms": t["bound_ms"],
                        "insseg_amp_bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"})
    for key, (trained, passes) in pg.items():
        t = passes[-1]
        print(f"{key}: step median {statistics.median(trained['step_ms'][1:]):.2f} ms (host clock, steps "
              f"2-{len(trained['step_ms'])}), peak memory {trained['peak_bytes'] / 2**30:.2f} GiB; profiled step: "
              f"busy {trained['profile']['busy_ms']:.2f} ms, idle share {trained['profile']['idle_share']:.3f}, "
              f"{trained['profile']['kernels']} kernels; InsSegEvaluator mAP {t['mAP']:.4f}, forwards "
              f"{t['forward_s'] * 1e3:.1f} ms, kNN {t['knn_s'] * 1e3:.1f} ms, label propagation "
              f"{(t['cluster_s'] - t['knn_s']) * 1e3:.1f} ms {stamp()}")
    print(f"insseg_r3: anchor mAP/AP50/AP25 card {insseg['card']}, CPU {insseg['cpu']}; tester {insseg['seconds']:.2f} s "
          f"on the card {stamp()}")
    mark("phases 26-30 (PointGroup)", t_start)
    phase_keypoint_heads(kernels, per_request)
    mark("phases 31-36 (keypoint heads)", t_start)
    phase_backbones(kernels)
    mark("phases 37-40 (OctFormer, Swin3D, the pig tools)", t_start)
    phase_last_backbones(kernels)
    mark("phase 41 (the last four keypoint backbones)", t_start)
    phase_kitti(kernels)
    mark("phase 42 (SemanticKITTI)", t_start)
    phase_slam(kernels)
    mark("phase 43 (SLAM)", t_start)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s {stamp()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
