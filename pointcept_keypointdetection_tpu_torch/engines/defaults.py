"""CLI defaults: argument parser, config parser and setup (counterparts of
``pointcept_keypointdetection_tpu/engines/defaults.py``)."""

from __future__ import annotations

import argparse
import os

from ..utils.config import Config, DictAction
from ..utils.logger import get_root_logger


def default_argument_parser(epilog=None):
    parser = argparse.ArgumentParser(epilog=epilog or "PyTorch/CUDA Pointcept-KeypointDetection")
    parser.add_argument("--config-file", default="", metavar="FILE", help="path to config file")
    parser.add_argument("--num-processes", type=int, default=1, help="processes (one per device)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--options", nargs="+", action=DictAction, help="custom options, key=value")
    return parser


def default_config_parser(file_path: str, options=None) -> Config:
    """The config with ``options`` merged, a default seed, the save path of
    the name protocol ``configs/<dataset>/<exp>.py`` -> ``exp/<dataset>/<exp>``
    when none is set, and a copy of the merged config written there."""
    if not os.path.isfile(file_path):
        raise FileNotFoundError(f"config not found: {file_path}")
    cfg = Config.fromfile(file_path)
    if options is not None:
        cfg.merge_from_dict(options)
    if cfg.get("seed") is None:
        cfg.seed = 4258 % (2**16)
    if not cfg.get("save_path"):
        experiment = os.path.splitext(os.path.basename(file_path))[0]
        dataset = os.path.basename(os.path.dirname(file_path))
        cfg.save_path = os.path.join("exp", dataset, experiment)
    os.makedirs(cfg.save_path, exist_ok=True)
    cfg.dump(os.path.join(cfg.save_path, "config.py"))
    return cfg


def default_setup(cfg: Config) -> Config:
    logger = get_root_logger(log_file=os.path.join(cfg.save_path, "train.log"))
    logger.info(f"Config:\n{cfg.pretty_text}")
    return cfg
