"""Hook protocol and the standard hooks of the trainer.

Counterpart of `lhrs_bot_tpu/train/hooks.py`: eight phases
(before/after_train, before/after_epoch, before/after_iter, after_backward,
after_step); `LoggerHook` (console, and TensorBoard when
`torch.utils.tensorboard` can be imported) and `LRSchedulerHook` (records
the schedule's value; the update itself reads the schedule). The
checkpoint, eval and epoch-seed hooks need `core/checkpoint.py`, which is
not ported yet.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Optional

logger = logging.getLogger("lhrs_torch")


class HookBase:
    trainer = None  # set by Trainer.register_hook

    def before_train(self): ...
    def after_train(self): ...
    def before_epoch(self): ...
    def after_epoch(self): ...
    def before_iter(self): ...
    def after_iter(self): ...
    def after_backward(self): ...
    def after_step(self): ...

    @property
    def checkpointable(self) -> bool:
        return callable(getattr(self, "state_dict", None))

    @property
    def class_name(self) -> str:
        return self.__class__.__name__


class LoggerHook(HookBase):
    """Console (and optional TensorBoard) logging every `period` iters:
    the metrics (smoothed where they are), iteration and ETA."""

    def __init__(self, period: int = 50, tb_log_dir: Optional[str] = None,
                 use_tensorboard: bool = False):
        self.period = period
        self._writer = None
        if use_tensorboard and tb_log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(tb_log_dir)
            except Exception:  # pragma: no cover
                logger.warning("tensorboard unavailable; console only")
        self._start_time = None

    def before_train(self):
        self._start_time = time.perf_counter()

    def after_iter(self):
        t = self.trainer
        if (t.cur_iter + 1) % self.period and t.cur_iter + 1 != t.max_iters:
            return
        vals = t.metric_storage.values_maybe_smooth()
        elapsed = time.perf_counter() - self._start_time
        done = t.cur_iter + 1 - t.start_iter
        eta = datetime.timedelta(seconds=int(
            elapsed / max(done, 1) * (t.max_iters - t.cur_iter - 1)))
        parts = [f"iter {t.cur_iter + 1}/{t.max_iters}", f"eta {eta}"]
        parts += [f"{k} {v:.4g}" for k, v in sorted(vals.items())]
        logger.info("  ".join(parts))
        if self._writer is not None:
            for k, v in vals.items():
                self._writer.add_scalar(k, v, t.cur_iter)

    def after_train(self):
        if self._writer is not None:
            self._writer.close()


class LRSchedulerHook(HookBase):
    """Records schedule(cur_iter) (0-based) into the metrics."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def after_iter(self):
        t = self.trainer
        t.metric_storage.update(lr=float(self.schedule(t.cur_iter)),
                                smooth=False)
