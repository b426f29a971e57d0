"""Testers: full-resolution test-time-augmented inference.

The port's counterparts of ``pointcept_keypointdetection_tpu/engines/
test.py:36-262``: the ``TESTERS`` registry, ``TesterBase`` and
``SemSegTester``.  A test scene arrives as a ``fragment_list`` (GridSample's
test-mode parts x the aug variants, each fragment with ``index``, the scene
rows it holds); each fragment is padded to the fixed capacity (truncated
first, deterministically, where it holds more), runs through the model in
eval mode, and its softmax probabilities are added into the scene's
prediction at ``index``.  The argmax is projected through ``inverse`` onto
``origin_segment`` where the scene has both, saved as ``<name>_pred.npy``,
and counted into the global mIoU, mAcc and allAcc.

The weight: ``cfg.weight``, else ``<save_path>/model/model_best`` and then
``model_last``, each as the port's ``.pth`` or a JAX ``.ckpt``, read by
``convert.load_weights``.  The model runs on the card unless the caller
asks for the CPU.  Not ported: the submission writers of the benchmarks
(``save_submit`` raises) and the other testers.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..convert import load_weights
from ..datasets import build_dataset
from ..datasets.collate import collate, pad_sample
from ..models import build_model
from ..utils.logger import get_root_logger
from ..utils.misc import intersection_and_union
from ..utils.registry import Registry
from .common import build_point_batch, sample_to_device

TESTERS = Registry("testers")


class TesterBase:
    def __init__(self, cfg, model: Optional[torch.nn.Module] = None, test_loader=None, verbose: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Tester: device is cuda but no CUDA device is available")
        self.logger = get_root_logger(log_file=os.path.join(cfg.save_path, "test.log"), file_mode="a")
        self.cfg = cfg
        self.verbose = verbose
        if model is None:
            self.logger.info("=> Building model ...")
            model = build_model(dict(cfg.model))
            model.load_state_dict(load_weights(self.weight_path()), strict=True)
        self.model = model.to(self.device).eval()
        if test_loader is None:
            self.logger.info("=> Building test dataset & loader ...")
            test_loader = build_dataset(dict(cfg.data.test))
        self.test_dataset = test_loader

    def weight_path(self) -> str:
        """``cfg.weight``, else the first of model_best and model_last (.pth, then .ckpt) that exists."""
        if self.cfg.get("weight"):
            path = self.cfg.weight
        else:
            base = os.path.join(self.cfg.save_path, "model")
            found = [os.path.join(base, f"{stem}{ext}") for stem in ("model_best", "model_last")
                     for ext in (".pth", ".ckpt")]
            path = next((p for p in found if os.path.isfile(p)), found[0])
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        self.logger.info(f"Loading weight at: {path}")
        return path

    def test(self):
        raise NotImplementedError


def _pad_fragment(frag: Dict, capacity: int) -> Dict:
    """One fragment padded to the fixed capacity (its ``index`` popped before)."""
    return pad_sample(dict(frag), capacity)


@TESTERS.register_module()
class SemSegTester(TesterBase):
    """Fragment and test-time-augmentation semantic segmentation tester (`engines/test.py:122-262`)."""

    def __init__(self, cfg, fragment_capacity: Optional[int] = None, **kwargs):
        self.fragment_capacity = fragment_capacity or cfg.get("slot_size", 131072)
        self.num_classes = cfg.data.num_classes
        self.ignore_index = cfg.data.get("ignore_index", -1)
        super().__init__(cfg, **kwargs)

    @torch.no_grad()
    def forward(self, batch: Dict) -> np.ndarray:
        """Softmax probabilities [capacity, classes] of one padded fragment, f32 on the host."""
        tensors = sample_to_device(batch, self.device)
        logits = self.model(build_point_batch(tensors, 1), tensors)["seg_logits"]
        return torch.softmax(logits.float(), -1).cpu().numpy()

    def test(self) -> Dict[str, float]:
        if not self.test_dataset.test_mode:
            raise ValueError("SemSegTester needs a dataset in test mode")
        if self.cfg.get("save_submit"):
            raise NotImplementedError("SemSegTester: the benchmarks' submission writers are not ported yet")
        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        save_path = os.path.join(self.cfg.save_path, "result")
        os.makedirs(save_path, exist_ok=True)
        k, cap = self.num_classes, self.fragment_capacity
        sums = np.zeros((3, k))
        self.model.eval()
        for idx in range(len(self.test_dataset)):
            start = time.time()
            data_dict = self.test_dataset[idx]
            fragment_list = data_dict.pop("fragment_list")
            segment = data_dict.pop("segment")
            name = data_dict.pop("name")
            pred = None
            for frag in fragment_list:
                index = frag.pop("index")
                n = frag["coord"].shape[0]
                if n > cap:
                    # deterministic: row r of the output must stay index[r]'s
                    logger.warning(f"{name}: fragment {n} pts > capacity {cap}; truncating")
                    frag = {key: (v[:cap] if isinstance(v, np.ndarray) and v.shape[:1] == (n,) else v)
                            for key, v in frag.items()}
                    index, n = index[:cap], cap
                probs = self.forward(collate([_pad_fragment(frag, cap)], cap))
                if pred is None:
                    pred = np.zeros((segment.size, probs.shape[1]), np.float32)
                pred[index[:n]] += probs[:n]
            if pred is None:
                pred = np.zeros((segment.size, k), np.float32)
            seg_pred = pred[:, :k].argmax(axis=1)
            if "origin_segment" in data_dict and "inverse" in data_dict:
                seg_pred = seg_pred[data_dict["inverse"]]
                segment = data_dict["origin_segment"]
            np.save(os.path.join(save_path, f"{name}_pred.npy"), seg_pred)
            counts = np.stack([c.numpy() for c in intersection_and_union(
                torch.from_numpy(seg_pred), torch.from_numpy(np.asarray(segment)), k, self.ignore_index)])
            sums += counts
            inter, union, target = counts
            logger.info(f"Test: {name} [{idx + 1}/{len(self.test_dataset)}]-{segment.size} "
                        f"Batch {time.time() - start:.3f} Accuracy {inter.sum() / (target.sum() + 1e-10):.4f} "
                        f"mIoU {inter.sum() / (union.sum() + 1e-10):.4f}")
        inter_sum, union_sum, target_sum = sums
        if self.cfg.get("save_confusion"):
            split = self.cfg.data.test.get("split", "test")
            np.savez(os.path.join(save_path, f"confusion_{split}.npz"), intersection=inter_sum, union=union_sum,
                     target=target_sum)
        iou_class = inter_sum / np.maximum(union_sum, 1)
        acc_class = inter_sum / np.maximum(target_sum, 1)
        m_iou, m_acc = float(iou_class.mean()), float(acc_class.mean())
        all_acc = float(inter_sum.sum() / np.maximum(target_sum.sum(), 1))
        logger.info(f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}")
        for c in range(k):
            logger.info(f"Class_{c} Result: iou/accuracy {iou_class[c]:.4f}/{acc_class[c]:.4f}")
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return dict(mIoU=m_iou, mAcc=m_acc, allAcc=all_acc)
