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
asks for the CPU.  One process: JAX's scene sharding and the all-gather
of the per-scene association structures are the identity here.  Not
ported: the submission writers of the benchmarks (``save_submit`` raises)
and the other testers.
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
from ..models.point_group import cluster_proposals, proposals_from_labels
from ..ops.knn import knn
from ..utils.logger import get_root_logger
from ..utils.misc import intersection_and_union
from ..utils.registry import Registry
from .common import build_point_batch, sample_to_device
from .hooks.insseg_evaluator import OVERLAPS, associate_instances, evaluate_matches, summarize_ap

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


@TESTERS.register_module()
class InsSegTester(TesterBase):
    """Instance segmentation tester (`engines/test.py:474-616`): each whole scene padded to
    ``capacity`` rows (its first ``capacity`` rows where it has more), one forward, the shifted
    coordinates clustered into proposals scored by mean confidence (``models/point_group.py``), the
    masks mapped to the raw points by their nearest voxel row where the scene kept ``origin_coord``,
    and ScanNet-devkit AP over all scenes."""

    def __init__(self, cfg, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1, cluster_thresh=0.05,
                 cluster_min_points=50, cluster_propose_points=100, capacity=None, **kwargs):
        self.num_classes = cfg.data.num_classes
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.cluster_thresh = cluster_thresh
        self.cluster_min_points = cluster_min_points
        self.cluster_propose_points = cluster_propose_points
        self.capacity = capacity or cfg.get("slot_size", 131072)
        super().__init__(cfg, **kwargs)

    @torch.no_grad()
    def forward(self, tensors: Dict[str, torch.Tensor]):
        """(predicted class int32, shift, softmax probabilities f32) of one padded scene, on the device."""
        out = self.model(build_point_batch(tensors, 1), tensors)
        probs = torch.softmax(out["seg_logits"].float(), -1)
        return probs.argmax(-1).to(torch.int32), out["bias_pred"], probs

    def test(self) -> Dict[str, float]:
        logger = self.logger
        logger.info(">>>>>>>>>>>>>>>> Start Evaluation >>>>>>>>>>>>>>>>")
        cap = self.capacity
        scenes = []
        for idx in range(len(self.test_dataset)):
            start = time.time()
            data_dict = dict(self.test_dataset[idx])
            name = data_dict.pop("name", f"scene{idx}")
            segment = np.asarray(data_dict["segment"]).reshape(-1)
            instance = np.asarray(data_dict["instance"]).reshape(-1)
            n = data_dict["coord"].shape[0]
            if n > cap:
                logger.warning(f"{name}: {n} pts > capacity {cap}; truncating")
                for key, v in list(data_dict.items()):
                    if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
                        data_dict[key] = v[:cap]
                segment, instance = segment[:cap], instance[:cap]
            batch = collate([_pad_fragment(dict(data_dict), cap)], cap)
            tensors = sample_to_device(batch, self.device)
            seg_pred, bias_pred, probs = self.forward(tensors)
            valid = np.asarray(batch["valid"]).reshape(-1)
            labels = cluster_proposals(tensors["coord"], seg_pred, bias_pred, tensors["valid"],
                                       cluster_thresh=self.cluster_thresh,
                                       segment_ignore_index=self.segment_ignore_index,
                                       min_points=self.cluster_min_points)
            masks, classes, scores = proposals_from_labels(labels, seg_pred.cpu().numpy(), probs.cpu().numpy(),
                                                           propose_points=self.cluster_propose_points)
            masks = masks[:, valid] if len(masks) else masks
            if "origin_coord" in data_dict:
                # 1-nn map-to-origin of the proposal masks (`test.py:575-590`)
                origin = torch.from_numpy(np.asarray(data_dict["origin_coord"], np.float32)).to(self.device)
                reverse, _ = knn(origin, tensors["coord"], 1, base_valid=tensors["valid"])
                reverse = reverse.cpu().numpy().reshape(-1)
                # masks are over valid rows; re-index via the dense->valid map
                dense_to_valid = np.cumsum(valid) - 1
                masks = masks[:, dense_to_valid[reverse]] if len(masks) else masks
                segment = np.asarray(data_dict["origin_segment"]).reshape(-1)
                instance = np.asarray(data_dict["origin_instance"]).reshape(-1)
            gt, pr = associate_instances(classes, scores, masks, segment, instance, self.num_classes,
                                         self.segment_ignore_index, self.instance_ignore_index)
            scenes.append(dict(gt=gt, pr=pr))
            logger.info(f"Test: {name} [{idx + 1}/{len(self.test_dataset)}] proposals {len(masks)} "
                        f"Batch {time.time() - start:.3f}")
        class_ids = [c for c in range(self.num_classes) if c not in self.segment_ignore_index]
        ap = evaluate_matches(scenes, class_ids)
        all_ap, ap50, ap25 = summarize_ap(ap)
        logger.info(f"Val result: mAP/AP50/AP25 {all_ap:.4f}/{ap50:.4f}/{ap25:.4f}")
        names = self.cfg.data.get("names")
        main = ~np.isclose(OVERLAPS, 0.25)
        for i, c in enumerate(class_ids):
            label = names[c] if names else f"class_{c}"
            with np.errstate(invalid="ignore"):
                row_ap = np.nanmean(ap[i][main])
            logger.info(f"Class_{c}-{label} Result: AP/AP50/AP25 {row_ap:.4f}/{ap[i][0]:.4f}/{ap[i][-1]:.4f}")
        logger.info("<<<<<<<<<<<<<<<<< End Evaluation <<<<<<<<<<<<<<<<<")
        return dict(mAP=all_ap, AP50=ap50, AP25=ap25)
