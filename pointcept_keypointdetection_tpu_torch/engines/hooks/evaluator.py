"""Semantic-segmentation validation after every epoch: the port's
``SemSegEvaluator`` (``pointcept_keypointdetection_tpu/engines/hooks/
evaluator.py:25-100``).

Each val batch runs the model in eval mode (f32 features, as the JAX eval
step, ``amp`` or not); the argmax labels of the valid rows are counted per
class against ``segment`` (``intersection_and_union``) on the device, and
the host sums the counts.  Logged: mIoU, mAcc, allAcc and each class's IoU
and accuracy; stored: ``val/loss`` (the mean of the batches' losses),
``val/mIoU``, ``val/mAcc`` and ``val/allAcc``; mIoU is the metric the
checkpoint saver keeps the best of.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.logger import get_root_logger
from ...utils.misc import intersection_and_union
from ..common import build_point_batch, sample_to_device
from . import HOOKS, HookBase


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    def __init__(self, num_classes=None, ignore_index=-1):
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def after_epoch(self):
        if self.trainer.val_loader is not None:
            self.eval()

    def eval(self):
        trainer = self.trainer
        logger = get_root_logger()
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        k = self.num_classes or trainer.cfg.data.get("num_classes")
        sums = torch.zeros(3, k, dtype=torch.int64)
        losses = []
        model = trainer.model
        model.eval()
        with torch.no_grad():
            for batch_np in trainer.val_loader:
                batch = sample_to_device(batch_np, trainer.device)
                point = build_point_batch(batch, batch_np["num_samples"])
                out = model(point, batch)
                pred = out["seg_logits"].argmax(-1)
                counts = intersection_and_union(pred, batch["segment"], k, self.ignore_index, point.valid)
                sums += torch.stack(counts).cpu()
                losses.append(float(out["loss"]) if "loss" in out else 0.0)
        model.train()
        inter, union, target = sums.numpy().astype(np.float64)
        iou_class = inter / np.maximum(union, 1)
        acc_class = inter / np.maximum(target, 1)
        m_iou, m_acc = float(np.mean(iou_class)), float(np.mean(acc_class))
        all_acc = float(inter.sum() / max(target.sum(), 1))
        logger.info(f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}.")
        for c in range(k):
            logger.info(f"Class_{c} Result: iou/accuracy {iou_class[c]:.4f}/{acc_class[c]:.4f}")
        trainer.storage.put_scalar("val/loss", float(np.mean(losses)) if losses else 0.0)
        trainer.storage.put_scalar("val/mIoU", m_iou)
        trainer.storage.put_scalar("val/mAcc", m_acc)
        trainer.storage.put_scalar("val/allAcc", all_acc)
        trainer.comm_info["current_metric_value"] = m_iou
        trainer.comm_info["current_metric_name"] = "mIoU"
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
