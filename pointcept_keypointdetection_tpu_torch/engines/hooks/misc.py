"""Timing, log and checkpoint hooks (counterparts of
``pointcept_keypointdetection_tpu/engines/hooks/misc.py``).

Checkpoints are the port's own format, written with ``torch.save``: a dict
of ``epoch``, ``step``, ``model`` (the state_dict), ``optimizer`` (its
state_dict), ``generator`` (the training generator's state) and
``best_metric_value``, at ``<save_path>/model/model_last.pth`` (written to a
temporary file, then renamed), copied to ``model_best.pth`` when the
evaluator's metric improves.  The JAX package's flax-msgpack ``.ckpt`` files
are not read here.
"""

from __future__ import annotations

import datetime
import os
import shutil
import time

import torch

from ...utils.logger import get_root_logger
from . import HOOKS, HookBase


@HOOKS.register_module()
class IterationTimer(HookBase):
    """Data and batch time per step, and the remaining time."""

    def __init__(self, warmup_iter=2):  # warmup_iter: the configs pass it; unused, as in JAX
        self._iter_timer = time.perf_counter()
        self._remain_iter = 0

    def before_train(self):
        self._remain_iter = (self.trainer.max_epoch - self.trainer.start_epoch) * len(self.trainer.train_loader)

    def before_epoch(self):
        self._iter_timer = time.perf_counter()

    def before_step(self):
        self.trainer.storage.put_scalar("data_time", time.perf_counter() - self._iter_timer)

    def after_step(self):
        # run_step ends in the host reading the losses, so the step's device work is done
        batch_time = time.perf_counter() - self._iter_timer
        self._iter_timer = time.perf_counter()
        self.trainer.storage.put_scalar("batch_time", batch_time)
        self._remain_iter -= 1
        remain = self._remain_iter * self.trainer.storage.history("batch_time").avg()
        self.trainer.comm_info["remain_time"] = str(datetime.timedelta(seconds=int(remain)))


@HOOKS.register_module()
class InformationWriter(HookBase):
    """The per-step log line every ``log_interval`` steps and the epoch's means."""

    def __init__(self, log_interval=10):
        self.log_interval = log_interval

    def after_step(self):
        trainer = self.trainer
        for key, value in trainer.comm_info.get("metrics", {}).items():
            trainer.storage.put_scalar(f"train_batch/{key}", value)
        if "lr" in trainer.comm_info:
            trainer.storage.put_scalar("lr", trainer.comm_info["lr"])
        i = trainer.comm_info.get("iter", 0)
        if (i + 1) % self.log_interval != 0:
            return
        h = trainer.storage.histories()
        parts = [f"Train: [{trainer.epoch + 1}/{trainer.max_epoch}]", f"[{i + 1}/{len(trainer.train_loader)}]"]
        for key, name in (("data_time", "Data"), ("batch_time", "Batch")):
            if key in h:
                parts.append(f"{name} {h[key].latest:.3f} ({h[key].avg():.3f})")
        if "remain_time" in trainer.comm_info:
            parts.append(f"Remain {trainer.comm_info['remain_time']}")
        if "lr" in trainer.comm_info:
            parts.append(f"Lr {trainer.comm_info['lr']:.3e}")
        for key in sorted(k for k in h if k.startswith("train_batch/")):
            parts.append(f"{key.split('/', 1)[1]} {h[key].latest:.4f}")
        get_root_logger().info(" ".join(parts))

    def after_epoch(self):
        h = self.trainer.storage.histories()
        msg = " ".join(f"{k.split('/', 1)[1]}: {v.global_avg():.4f}"
                       for k, v in sorted(h.items()) if k.startswith("train_batch/"))
        if msg:
            get_root_logger().info(f"Train result: {msg}")


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """model_last.pth after every epoch, model_best.pth on a better metric,
    ``epoch_<n>.pth`` every ``save_freq`` epochs."""

    def __init__(self, save_freq=None):
        self.save_freq = save_freq

    def after_epoch(self):
        trainer = self.trainer
        logger = get_root_logger()
        is_best = False
        value = trainer.comm_info.get("current_metric_value")
        name = trainer.comm_info.get("current_metric_name")
        if value is not None:
            if value > trainer.best_metric_value:
                trainer.best_metric_value = value
                is_best = True
                logger.info(f"Best validation {name} updated to: {value:.4f}")
            logger.info(f"Currently Best {name}: {trainer.best_metric_value:.4f}")
        ckpt_dir = os.path.join(trainer.cfg.save_path, "model")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, "model_last.pth")
        payload = dict(
            epoch=trainer.epoch + 1,
            step=trainer.step,
            model=trainer.model.state_dict(),
            optimizer=trainer.optimizer.state_dict(),
            generator=trainer.generator.get_state(),
            best_metric_value=trainer.best_metric_value,
        )
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        logger.info(f"Saved checkpoint: {path}")
        if is_best:
            shutil.copyfile(path, os.path.join(ckpt_dir, "model_best.pth"))
        if self.save_freq and (trainer.epoch + 1) % self.save_freq == 0:
            shutil.copyfile(path, os.path.join(ckpt_dir, f"epoch_{trainer.epoch + 1}.pth"))


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Resume (``resume=True``: model, optimizer, step, epoch, generator and
    best metric from model_last.pth) or start from the weights of
    ``weight`` (a checkpoint of this format)."""

    def __init__(self, strict=True):
        self.strict = strict

    def before_train(self):
        logger = get_root_logger()
        trainer = self.trainer
        resume = trainer.cfg.get("resume", False)
        path = os.path.join(trainer.cfg.save_path, "model", "model_last.pth") if resume else trainer.cfg.get("weight")
        if not path or not os.path.isfile(path):
            logger.info("No weight found, training from scratch")
            return
        logger.info(f"Loading checkpoint: {path}")
        # weights_only: the payload is tensors, numbers and plain containers
        payload = torch.load(path, map_location=trainer.device, weights_only=True)
        trainer.model.load_state_dict(payload["model"], strict=self.strict)
        if resume:
            trainer.optimizer.load_state_dict(payload["optimizer"])
            trainer.generator.set_state(payload["generator"].cpu())
            trainer.step = int(payload["step"])
            trainer.start_epoch = int(payload["epoch"])
            trainer.best_metric_value = float(payload["best_metric_value"])
            logger.info(f"Resuming training from epoch {trainer.start_epoch}")
