"""glog-style logging, colored headings, and stage timers (counterpart of
foundpose_tpu/utils/logging_util.py).

Re-design of the reference logging/timing utilities
(reference: utils/logging.py:14-120, utils/misc.py:30-45). PyTorch queues
CUDA work asynchronously, so `Timer.elapsed()` takes an optional tensor to
synchronize on: given a CUDA tensor it waits for that tensor's device, and
the stage time covers the device work instead of its enqueue.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Optional

import torch

GREEN_BOLD = "\033[1;32m"
_RESET = "\033[0m"

_FORMAT = "%(levelname).1s%(asctime)s.%(msecs)03d %(filename)s:%(lineno)d] %(message)s"
_DATEFMT = "%m%d %H:%M:%S"


def get_logger(name: str = "foundpose_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_heading(logger: logging.Logger, msg: str, style: str = GREEN_BOLD) -> None:
    """ANSI-colored section heading. (reference: utils/logging.py:109-120)"""
    bar = "-" * max(len(msg), 10)
    logger.info(f"{style}{bar}{_RESET}")
    logger.info(f"{style}{msg}{_RESET}")
    logger.info(f"{style}{bar}{_RESET}")


class Timer:
    """Start/elapsed stage timer. (reference: utils/misc.py:30-45)"""

    def __init__(self, enabled: bool = True, logger: Optional[logging.Logger] = None):
        self.enabled = enabled
        self.logger = logger or get_logger()
        self.start_time: Optional[float] = None

    def start(self) -> None:
        if self.enabled:
            self.start_time = time.perf_counter()

    def elapsed(self, msg: str = "Elapsed", sync_on=None) -> Optional[float]:
        """Seconds since start(), logged; with `sync_on` a CUDA tensor, after
        waiting for its device (a CPU tensor or other value needs no wait)."""
        if not self.enabled or self.start_time is None:
            return None
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        dt = time.perf_counter() - self.start_time
        self.logger.info(f"{msg}: {dt:.5f}s")
        return dt
