"""Hook-driven trainer: the counterpart of ``pointcept_keypointdetection_tpu/
engines/train.py:54-406`` for one device.

``TrainerBase`` runs the hook lifecycle ``before_train -> (before_epoch ->
(before_step -> run_step -> after_step)* -> after_epoch)* -> after_train``.
``Trainer`` (``DefaultTrainer``) builds the model with seeded weights, the
loaders, AdamW and the per-iteration schedule; its ``run_step`` is a
forward in training mode, the loss's backward, ``clip_grad`` as optax's
global-norm clip, the optimizer step at the schedule's rate for the steps
taken so far, and the step count.  Randomness: the global ``np.random``
(data transforms, as in JAX) and ``random`` are seeded from ``seed``, the
model's order shuffles and drop path draw from one ``torch.Generator``
seeded from it, and the initial weights from another.

``amp`` ("bf16" or "fp16") is JAX's (`engines/train.py:219-234`): only the
input features are cast, the parameters stay f32 and get f32 gradients,
every Dense computes in the features' dtype, and the loss is cast to f32;
no autocast and no loss scaling.  The kernels take f32 and bf16, so "fp16"
runs on the CPU only.  A top-level ``param_dicts`` is ignored, as JAX
ignores it (it reads ``optimizer.param_dicts`` only, which the port refuses).

``mix_prob`` > 0 mixes the training batches Mix3D-style (``datasets/
collate.py``); the val batches are not mixed.

Not ported (raise NotImplementedError): ``remat``,
``gradient_accumulation_steps`` > 1, ``ema``, model parallelism and
``MultiDatasetTrainer``.
"""

from __future__ import annotations

import os
import random
import weakref
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..datasets.builder import build_dataset
from ..datasets.dataloader import Dataloader
from ..models import build_model, init_weights
from ..utils.config import Config
from ..utils.events import EventStorage
from ..utils.logger import get_root_logger
from ..utils.optimizer import build_optimizer, clip_grad
from ..utils.registry import Registry
from ..utils.scheduler import build_scheduler
from .common import build_point_batch, sample_to_device
from .hooks import build_hooks

TRAINERS = Registry("trainers")
AMP_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}

# config keys whose set values select paths the port does not have yet
_UNPORTED = dict(remat=False, gradient_accumulation_steps=1, ema=None, model_parallel=1)


class TrainerBase:
    def __init__(self):
        self.hooks = []
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.comm_info: Dict[str, Any] = {}
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks_cfg):
        self.hooks = build_hooks(hooks_cfg)
        for h in self.hooks:
            h.trainer = weakref.proxy(self)

    def _call(self, name: str):
        for h in self.hooks:
            getattr(h, name)()

    def run_step(self):
        raise NotImplementedError

    def train(self):
        self.storage = EventStorage()
        self._call("before_train")
        for self.epoch in range(self.start_epoch, self.max_epoch):
            self.before_epoch()
            for self.comm_info["iter"], self.comm_info["input_dict"] in enumerate(self.train_loader):
                self._call("before_step")
                self.run_step()
                self._call("after_step")
            self._call("after_epoch")
            self.storage.reset_histories()
        self.storage.put_scalar("train_done", 1)
        self._call("after_train")

    def before_epoch(self):
        self._call("before_epoch")


@TRAINERS.register_module("DefaultTrainer")
class Trainer(TrainerBase):
    def __init__(self, cfg: Config, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device is cuda but no CUDA device is available")
        for key, default in _UNPORTED.items():
            if (cfg.get(key) or default) != default:
                raise NotImplementedError(f"Trainer: {key}={cfg.get(key)!r} is not ported yet")
        amp = cfg.get("amp")
        if amp is not None and amp not in AMP_DTYPES:
            raise ValueError(f"Trainer: amp must be one of {sorted(AMP_DTYPES)} or None, got {amp!r}")
        self.amp_dtype = AMP_DTYPES.get(amp)
        self.cfg = cfg
        self.max_epoch = cfg.eval_epoch
        self.best_metric_value = -float("inf")
        self.step = 0  # optimizer steps taken
        os.makedirs(cfg.save_path, exist_ok=True)
        self.logger = get_root_logger(log_file=os.path.join(cfg.save_path, "train.log"),
                                      file_mode="a" if cfg.get("resume", False) else "w")
        self.logger.info(f"=> Save path: {cfg.save_path}, device: {self.device}")
        seed = cfg.get("seed")
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little") % (2**31)
        random.seed(seed)
        np.random.seed(seed % (2**32 - 1))
        self.generator = torch.Generator().manual_seed(seed)  # order shuffles, drop path

        self.logger.info("=> Building model ...")
        self.model = build_model(dict(cfg.model))
        init_weights(self.model, torch.Generator().manual_seed(seed + 1))
        self.model.to(self.device)
        self.logger.info(f"Num params: {sum(p.numel() for p in self.model.parameters())}")
        self.logger.info("=> Building train dataset & loader ...")
        self.train_loader = Dataloader(build_dataset(dict(cfg.data.train)), batch_size=cfg.batch_size,
                                       slot_size=cfg.slot_size, shuffle=True, drop_last=True, seed=seed,
                                       num_workers=cfg.get("num_worker", 0), mix_prob=cfg.get("mix_prob") or 0.0)
        self.val_loader = None
        if cfg.get("evaluate", True) and "val" in cfg.data:
            self.val_loader = Dataloader(build_dataset(dict(cfg.data.val)),
                                         batch_size=cfg.get("batch_size_val") or cfg.batch_size,
                                         slot_size=cfg.get("slot_size_val") or cfg.slot_size, shuffle=False,
                                         drop_last=False, num_workers=cfg.get("num_worker", 0))
        self.logger.info("=> Building optimizer & scheduler ...")
        total_steps = len(self.train_loader) * self.max_epoch
        self.optimizer = build_optimizer(dict(cfg.optimizer), self.model.parameters())
        self.lr_schedule = build_scheduler(dict(cfg.scheduler), total_steps, cfg.optimizer.get("lr", 1e-3))
        self.register_hooks(cfg.get("hooks"))

    def run_step(self):
        batch_np = self.comm_info["input_dict"]
        batch = sample_to_device(batch_np, self.device)
        point = build_point_batch(batch, batch_np["num_samples"])
        if self.amp_dtype is not None:
            point = point.replace(feat=point.feat.to(self.amp_dtype))
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.model.train()
        out = self.model(point, batch, self.generator)
        out["loss"] = out["loss"].float()
        self.optimizer.zero_grad(set_to_none=True)
        out["loss"].backward()
        if self.cfg.get("clip_grad"):
            clip_grad(self.model.parameters(), self.cfg.clip_grad)
        self.optimizer.step()
        self.step += 1
        self.comm_info["metrics"] = {k: v.item() for k, v in out.items() if v.dim() == 0}
        self.comm_info["lr"] = lr

    def before_epoch(self):
        self.train_loader.set_epoch(self.epoch)
        super().before_epoch()

    def train(self):
        self.logger.info(">>>>>>>>>>>>>>>> Start Training >>>>>>>>>>>>>>>>")
        super().train()
        self.logger.info("==>Training done!")


@TRAINERS.register_module("MultiDatasetTrainer")
def _multi_dataset_trainer(cfg, device="cuda"):
    raise NotImplementedError("MultiDatasetTrainer is not ported yet")
