"""Trainer runtime: the train step and the hook-driven loop.

Counterpart of `lhrs_bot_tpu/train/trainer.py`: `make_train_step` (loss,
backward, the gradient norm, the optimizer update) and `Trainer` with its
epoch- and iteration-based forms, the eight hook phases and the metrics
fetched one step late (step N is queued on the card before step N-1's
metrics are read, so the host's read of a few floats overlaps the card's
work instead of waiting for it).

Differences from the JAX trainer: the step runs eagerly on one device and
updates the trainable tensors in place; gradients are taken with
`torch.autograd.grad` with respect to the trainable tensors only, so the
frozen weights never get a gradient (nor a `.grad`) and the decoder's
backward computes only what flows to the perceiver. Checkpoints and resume
(`ckpt_period`, `resume`) need `core/checkpoint.py` and meshes need the
parallel layer: neither is ported yet, and both raise.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.vlm import VLMConfig, vlm_forward_loss
from .hooks import HookBase, LoggerHook, LRSchedulerHook
from .metric import MetricStorage
from .optimizer import TrainOptimizer, global_norm

logger = logging.getLogger("lhrs_torch")


def make_train_step(cfg: VLMConfig, optimizer: TrainOptimizer,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: bool = False) -> Callable:
    """step(params, batch) -> metrics: the forward loss, its gradients with
    respect to the optimizer's (trainable) tensors, their global norm
    before clipping, and the optimizer update in place. Metrics are 0-d
    tensors on the device: total_loss, text_loss, grad_norm."""

    def step(params, batch) -> Dict[str, torch.Tensor]:
        out = vlm_forward_loss(params, cfg, batch,
                               compute_dtype=compute_dtype, remat=remat)
        grads = torch.autograd.grad(out["total_loss"], optimizer.params)
        metrics = {"total_loss": out["total_loss"].detach(),
                   "text_loss": out["text_loss"].detach(),
                   "grad_norm": global_norm(grads)}
        optimizer.step(grads)
        return metrics

    return step


def _device_of(params) -> torch.device:
    return params["llama"]["embed_tokens"].device


class Trainer:
    """Iteration-based core loop; EpochBasedTrainer adapts it to epochs."""

    def __init__(
        self,
        model_cfg: VLMConfig,
        params,
        optimizer: TrainOptimizer,
        data_loader: Iterable,
        *,
        max_iters: Optional[int] = None,
        epochs: Optional[int] = None,
        epoch_len: Optional[int] = None,
        mesh=None,
        work_dir: str = "output",
        compute_dtype: torch.dtype = torch.bfloat16,
        remat: bool = False,
        log_period: int = 50,
        ckpt_period: Optional[int] = None,
        schedule: Optional[Callable[[int], float]] = None,
        use_tensorboard: bool = False,
        hooks: Optional[List[HookBase]] = None,
    ):
        if mesh is not None:
            raise NotImplementedError("meshes (data / tensor parallelism) "
                                      "are not ported to lhrs_bot_tpu_torch "
                                      "yet")
        if ckpt_period:
            raise NotImplementedError("checkpoints (ckpt_period) need "
                                      "core/checkpoint.py, not ported to "
                                      "lhrs_bot_tpu_torch yet")
        self.model_cfg = model_cfg
        self.params = params
        self.optimizer = optimizer
        self.work_dir = work_dir
        self.data_loader = data_loader
        self._data_iter = iter(data_loader)
        self.device = _device_of(params)

        if epochs is not None:
            if epoch_len is None:
                epoch_len = len(data_loader)  # type: ignore[arg-type]
            self.epoch_len = epoch_len
            self.max_epochs = epochs
            self.max_iters = epochs * epoch_len
        else:
            if max_iters is None:
                raise ValueError("give max_iters or epochs")
            self.epoch_len = epoch_len or max_iters
            self.max_epochs = -(-max_iters // self.epoch_len)
            self.max_iters = max_iters

        self.cur_iter = 0
        self.start_iter = 0
        self.metric_storage = MetricStorage()
        self._pending_metrics = None
        self._step_fn = make_train_step(model_cfg, optimizer, compute_dtype,
                                        remat)

        self._hooks: List[HookBase] = []
        default_hooks: List[HookBase] = []
        if schedule is not None:
            default_hooks.append(LRSchedulerHook(schedule))
        default_hooks.append(LoggerHook(
            log_period, tb_log_dir=os.path.join(work_dir, "tb"),
            use_tensorboard=use_tensorboard))
        for h in (hooks or []) + default_hooks:
            self.register_hook(h)

    # -- hooks --------------------------------------------------------------

    def register_hook(self, hook: HookBase) -> None:
        hook.trainer = self
        self._hooks.append(hook)

    def _dispatch(self, phase: str) -> None:
        for h in self._hooks:
            getattr(h, phase)()

    @property
    def cur_epoch(self) -> int:
        return self.cur_iter // self.epoch_len

    @property
    def inner_iter(self) -> int:
        return self.cur_iter % self.epoch_len

    # -- data ---------------------------------------------------------------

    def _next_batch(self):
        try:
            batch = next(self._data_iter)
        except StopIteration:
            self._data_iter = iter(self.data_loader)
            batch = next(self._data_iter)
        return self._put(batch)

    def _put(self, batch):
        """numpy arrays (the collators' batches) -> tensors on the
        device."""
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     non_blocking=True)
                if not isinstance(v, torch.Tensor)
                else v.to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # -- loop ---------------------------------------------------------------

    def train_on_iter(self) -> None:
        start = time.perf_counter()
        batch = self._next_batch()
        data_time = time.perf_counter() - start
        metrics = self._step_fn(self.params, batch)
        # one step late: step N is queued, then step N-1's metrics are read
        self._flush_metrics()
        self._pending_metrics = (self.cur_iter, metrics, data_time, start)

    def _flush_metrics(self) -> None:
        """Read the previous step's metrics to the host (blocks only until
        that step finished). iter_time is the wall clock from the previous
        step's start to this read."""
        if self._pending_metrics is None:
            return
        it, metrics, data_time, start_t = self._pending_metrics
        self._pending_metrics = None
        host_metrics = {k: float(v) for k, v in metrics.items()}
        iter_time = time.perf_counter() - start_t
        self.metric_storage.update(it, **host_metrics)
        self.metric_storage.update(it, data_time=data_time,
                                   iter_time=iter_time)

    def train(self, resume: bool = False) -> None:
        if resume:
            raise NotImplementedError("resume needs core/checkpoint.py, not "
                                      "ported to lhrs_bot_tpu_torch yet")
        logger.info("start training: iters %d->%d", self.cur_iter,
                    self.max_iters)
        self._dispatch("before_train")
        epoch = -1
        while self.cur_iter < self.max_iters:
            if self.cur_epoch != epoch:
                if epoch >= 0:
                    self._dispatch("after_epoch")
                epoch = self.cur_epoch
                self._dispatch("before_epoch")
            self._dispatch("before_iter")
            self.train_on_iter()
            self._dispatch("after_iter")
            self.cur_iter += 1
        self._flush_metrics()
        self._dispatch("after_epoch")
        self._dispatch("after_train")


class EpochBasedTrainer(Trainer):
    """`epochs` semantics: cur_iter = epoch * epoch_len + inner_iter."""

    def __init__(self, *args, epochs: int, **kwargs):
        super().__init__(*args, epochs=epochs, **kwargs)


class IterBasedTrainer(Trainer):
    """`max_iters` semantics."""

    def __init__(self, *args, max_iters: int, **kwargs):
        super().__init__(*args, max_iters=max_iters, **kwargs)
