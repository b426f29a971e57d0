"""The port's root logger: console plus an optional file, created once per
process (a copy of ``get_root_logger`` in ``pointcept_keypointdetection_tpu/
utils/logger.py`` for one process)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGER_NAME = "pkt_torch"
_FORMAT = "[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s"


def get_root_logger(log_file: Optional[str] = None, log_level: int = logging.INFO,
                    file_mode: str = "a") -> logging.Logger:
    """The root logger; the first call with ``log_file`` adds a handler
    writing there, and a later call with another file moves it there."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        logger.setLevel(log_level)
        logger.propagate = False
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(console)
    if log_file is not None:
        path = os.path.abspath(log_file)
        files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if not any(h.baseFilename == path for h in files):
            for h in files:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = logging.FileHandler(path, file_mode)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger
