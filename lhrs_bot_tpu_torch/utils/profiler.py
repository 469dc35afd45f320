"""Tracing and device memory.

Counterpart of `lhrs_bot_tpu/utils/profiler.py`: the trainer records data
and iteration times itself; this module adds a trace window over CPU and
CUDA activity (`torch.profiler`, written as a Chrome trace: open it in
chrome://tracing or Perfetto), either around a block (`trace`) or over
steps of training (`ProfilerHook`), and the caching allocator's
statistics of each visible card. JAX's on-demand profiler server has no
torch counterpart (`start_profiler_server` raises).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch

from ..train.hooks import HookBase

logger = logging.getLogger("lhrs_torch")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    return prof


def _stop(prof, log_dir: str) -> str:
    """End the window and write its Chrome trace under `log_dir`; returns
    the file's path."""
    prof.__exit__(None, None, None)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}"
                        ".json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the enclosed block (CPU and, with a card, CUDA activity) to a
    Chrome trace file under `log_dir`."""
    prof = _start(log_dir)
    try:
        yield
    finally:
        logger.info("trace written to %s", _stop(prof, log_dir))


def start_profiler_server(port: int = 9999) -> None:
    """JAX's on-demand profiling endpoint has no torch counterpart."""
    raise NotImplementedError(
        "torch has no on-demand profiler server: use utils.profiler.trace "
        "around a block or ProfilerHook over training steps")


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` of each visible card, keyed "cuda:<i>";
    {} with none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


class ProfilerHook(HookBase):
    """Trace iterations [start_step, start_step + num_steps) of training
    to a Chrome trace under `log_dir`; a window that outlasts training
    ends with it."""

    def __init__(self, log_dir: str, start_step: int = 10,
                 num_steps: int = 3):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self.paths = []

    @property
    def active(self) -> bool:
        return self._prof is not None

    def before_iter(self):
        if self.trainer.cur_iter == self.start_step and self._prof is None:
            self._prof = _start(self.log_dir)

    def after_iter(self):
        if self.trainer.cur_iter + 1 == self.stop_step and self._prof:
            self._finish()
            logger.info("profiler trace (%d steps) -> %s",
                        self.stop_step - self.start_step, self.paths[-1])

    def after_train(self):
        if self._prof is not None:  # the window outlasted training
            self._finish()

    def _finish(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.paths.append(_stop(self._prof, self.log_dir))
        self._prof = None
