"""Hook protocol and the standard hooks of the trainer.

Counterpart of `lhrs_bot_tpu/train/hooks.py`: eight phases
(before/after_train, before/after_epoch, before/after_iter, after_backward,
after_step); `LoggerHook` (console, and TensorBoard when
`torch.utils.tensorboard` can be imported), `LRSchedulerHook` (records
the schedule's value; the update itself reads the schedule),
`CheckpointHook` (periodic `trainer.save` with pruning, and one at the end),
`EvalHook` (a periodic eval callable, the best score kept and saved under
the "best" tag) and `EpochSeedHook` (the sampler's epoch set each epoch;
not a default hook, as in JAX). A hook with `state_dict` is checkpointed
in the trainer's client state.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Dict, Optional

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


class CheckpointHook(HookBase):
    """`trainer.save(max_to_keep=)` every `period` iterations (or epochs
    with `by_epoch`), and at the end of training."""

    def __init__(self, period: int, max_to_keep: Optional[int] = 1,
                 by_epoch: bool = False):
        self.period = period
        self.max_to_keep = max_to_keep
        self.by_epoch = by_epoch

    def _maybe_save(self, counter: int):
        if (counter + 1) % self.period == 0:
            self.trainer.save(max_to_keep=self.max_to_keep)

    def after_iter(self):
        if not self.by_epoch:
            self._maybe_save(self.trainer.cur_iter)

    def after_epoch(self):
        if self.by_epoch:
            self._maybe_save(self.trainer.cur_epoch)

    def after_train(self):
        self.trainer.save(max_to_keep=self.max_to_keep)


class EvalHook(HookBase):
    """Call `eval_fn() -> {metric: value}` every `period` iterations (or
    epochs), record the metrics, keep the best `key` and save a
    checkpoint under the "best" tag when it improves (`save_best`)."""

    def __init__(self, period: int, eval_fn: Callable[[], Dict[str, float]],
                 key: str = "accuracy", by_epoch: bool = False,
                 save_best: bool = True):
        self.period = period
        self.eval_fn = eval_fn
        self.key = key
        self.by_epoch = by_epoch
        self.save_best = save_best
        self.best = float("-inf")

    def _maybe_eval(self, counter: int):
        if (counter + 1) % self.period:
            return
        metrics = self.eval_fn()
        self.trainer.metric_storage.update(smooth=False, **metrics)
        score = metrics.get(self.key)
        if score is not None and score > self.best:
            self.best = score
            if self.save_best:
                self.trainer.save(tag="best")

    def after_iter(self):
        if not self.by_epoch:
            self._maybe_eval(self.trainer.cur_iter)

    def after_epoch(self):
        if self.by_epoch:
            self._maybe_eval(self.trainer.cur_epoch)

    def state_dict(self):
        return {"best": self.best}

    def load_state_dict(self, state):
        self.best = state.get("best", float("-inf"))


class EpochSeedHook(HookBase):
    """Set the loader's (sampler's) epoch before each epoch, so that each
    epoch draws its own shuffle."""

    def before_epoch(self):
        loader = self.trainer.data_loader
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.trainer.cur_epoch)
