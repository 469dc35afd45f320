"""Logging setup: colored console on process 0, timestamped file sink.

Counterpart of `lhrs_bot_tpu/utils/logger.py` `setup_logger`: a named
logger, handlers on the main process only, a colored level prefix on a
terminal, optional file output in the work dir.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

_COLORS = {"WARNING": 33, "INFO": 32, "DEBUG": 36, "ERROR": 31,
           "CRITICAL": 35}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stdout.isatty():
            return f"\x1b[{color}m{msg}\x1b[0m"
        return msg


def setup_logger(name: str = "lhrs_tpu", output: Optional[str] = None,
                 rank: int = 0, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger

    fmt = "[%(asctime)s %(name)s %(levelname)s] %(message)s"
    datefmt = "%m/%d %H:%M:%S"
    if rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(_ColorFormatter(fmt, datefmt))
        logger.addHandler(console)
    if output:
        os.makedirs(output, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(
            os.path.join(output, f"log_rank{rank}_{stamp}.txt"))
        fh.setFormatter(logging.Formatter(fmt, datefmt))
        logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
