"""Trainer runtime: the train step and the hook-driven loop.

Counterpart of `lhrs_bot_tpu/train/trainer.py`: `make_train_step` (loss,
backward, the gradient norm, the optimizer update) and `Trainer` with its
epoch- and iteration-based forms, the eight hook phases, the metrics
fetched one step late (step N is queued on the card before step N-1's
metrics are read, so the host's read of a few floats overlaps the card's
work instead of waiting for it), checkpoints (`save`, `CheckpointHook`
every `ckpt_period` iterations, `core/checkpoint.py`'s layout) and
`resume`.

Differences from the JAX trainer: the step runs eagerly on one device and
updates the trainable tensors in place; gradients are taken with
`torch.autograd.grad` with respect to the trainable tensors only, so the
frozen weights never get a gradient (nor a `.grad`) and the decoder's
backward computes only what flows to the perceiver. A checkpoint's
`cur_iter` counts the iterations done, also when a hook saves inside an
iteration (JAX records the index of the iteration being run there, so its
resume repeats that iteration; the reference resumes after it). The resumed
data iterator is made after the first `before_epoch` hooks have run, so an
`EpochSeedHook` has set the sampler's epoch when the skipped batches are
drawn.

`mesh` (`parallel.mesh.Mesh`, one process a rank) trains data and tensor
parallel, as the JAX trainer does over its mesh: `params` is this rank's
slice (`parallel.partition.shard_params`) and `optimizer` a
`ShardedTrainOptimizer` over it (`build_optimizer(..., mesh=)`;
`core.build_trainer` composes both), and each data index draws its own
batch: `batch_size` is per process, as in JAX's multi-process path and in
the reference. The loss of a rank is its valid tokens' loss over the data
group's count, so the summed losses and gradients are the global batch's
(`models.llama.causal_lm_loss`); the reported total_loss, text_loss and
grad_norm are the global batch's. A checkpoint holds the single-rank
layout, gathered (rank 0 writes it), with `mesh_shape`; `resume` slices
it for the current mesh, whatever mesh wrote it.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt_lib
from ..core.convert import _remember_source, as_loaded
from ..models.vlm import VLMConfig, vlm_forward_loss
from ..ops.quant import QuantizedTensor
from ..parallel.mesh import Mesh
from ..parallel.partition import (gather_params, shard_leaf, spec_of,
                                  vlm_param_specs)
from .hooks import CheckpointHook, HookBase, LoggerHook, LRSchedulerHook
from .metric import MetricStorage
from .optimizer import TrainOptimizer, global_norm

logger = logging.getLogger("lhrs_torch")


def make_train_step(cfg: VLMConfig, optimizer: TrainOptimizer,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: bool = False, mesh: Optional[Mesh] = None,
                    cp_mesh=None) -> Callable:
    """step(params, batch) -> metrics: the forward loss, its gradients with
    respect to the optimizer's (trainable) tensors, their global norm
    before clipping, and the optimizer update in place. Metrics are 0-d
    tensors on the device: total_loss, text_loss, grad_norm. Over a
    `mesh` the losses are summed over the data group and the norm is the
    sharded optimizer's (both the global batch's). Over a `cp_mesh`
    (`parallel.context.CpMesh`: context parallelism, whole weights and a
    plain `TrainOptimizer` on every rank, `batch` this data index's rows)
    each rank's gradients are summed over the seq and data groups
    (`parallel.context.reduce_gradients`) before the update, the losses
    likewise, and the norm is the global batch's; every rank applies the
    same update. `mesh` and `cp_mesh` do not compose (ValueError)."""
    if mesh is not None and cp_mesh is not None:
        raise ValueError("cp_mesh and mesh do not compose: context "
                         "parallelism takes whole weights")

    def step(params, batch) -> Dict[str, torch.Tensor]:
        out = vlm_forward_loss(params, cfg, batch,
                               compute_dtype=compute_dtype, remat=remat,
                               cp_mesh=cp_mesh, mesh=mesh)
        grads = torch.autograd.grad(out["total_loss"], optimizer.leaves)
        if cp_mesh is not None:
            from ..parallel.context import reduce_gradients

            grads = reduce_gradients(grads, cp_mesh)
            losses = torch.stack([out["total_loss"].detach(),
                                  out["text_loss"].detach()]).float()
            cp_mesh.seq.all_reduce(losses)
            cp_mesh.data.all_reduce(losses)
            metrics = {"total_loss": losses[0], "text_loss": losses[1],
                       "grad_norm": global_norm(grads)}
            optimizer.step(grads)
            return metrics
        if mesh is None:
            metrics = {"total_loss": out["total_loss"].detach(),
                       "text_loss": out["text_loss"].detach(),
                       "grad_norm": global_norm(grads)}
            optimizer.step(grads)
            return metrics
        losses = torch.stack([out["total_loss"].detach(),
                              out["text_loss"].detach()]).float()
        if mesh.dp_axis is not None:
            mesh.data.all_reduce(losses)
        norm = optimizer.step(grads)
        return {"total_loss": losses[0], "text_loss": losses[1],
                "grad_norm": norm}

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
        max_to_keep: int = 1,
        schedule: Optional[Callable[[int], float]] = None,
        use_tensorboard: bool = False,
        hooks: Optional[List[HookBase]] = None,
    ):
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a lhrs_bot_tpu_torch.parallel"
                                f".Mesh, got {type(mesh).__name__}")
            if getattr(optimizer, "mesh", None) is not mesh:
                raise ValueError("a mesh trainer takes the optimizer "
                                 "build_optimizer(..., mesh=mesh) made over "
                                 "shard_params(mesh, params)")
        self.mesh = mesh
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
        self._in_iter = False  # between an iteration's step and cur_iter += 1
        self._skip = None  # batches to skip at the first epoch after resume
        self._step_fn = make_train_step(model_cfg, optimizer, compute_dtype,
                                        remat, mesh)

        self._hooks: List[HookBase] = []
        default_hooks: List[HookBase] = []
        if schedule is not None:
            default_hooks.append(LRSchedulerHook(schedule))
        default_hooks.append(LoggerHook(
            log_period, tb_log_dir=os.path.join(work_dir, "tb"),
            use_tensorboard=use_tensorboard))
        if ckpt_period:
            default_hooks.append(CheckpointHook(ckpt_period, max_to_keep))
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
            self.resume()
        logger.info("start training: iters %d->%d", self.cur_iter,
                    self.max_iters)
        try:
            self._dispatch("before_train")
            epoch = -1
            while self.cur_iter < self.max_iters:
                if self.cur_epoch != epoch:
                    if epoch >= 0:
                        self._dispatch("after_epoch")
                    epoch = self.cur_epoch
                    self._dispatch("before_epoch")
                    if self._skip is not None:
                        self._fast_forward()
                self._dispatch("before_iter")
                self.train_on_iter()
                self._in_iter = True
                self._dispatch("after_iter")
                self._in_iter = False
                self.cur_iter += 1
            self._flush_metrics()
            self._dispatch("after_epoch")
            self._dispatch("after_train")
        except BaseException:
            # stop the loader's workers before the error leaves
            close = getattr(self._data_iter, "close", None)
            if close is not None:
                close()
            raise
        finally:
            self._in_iter = False

    # -- checkpoint ---------------------------------------------------------

    def save(self, tag: Optional[str] = None,
             max_to_keep: Optional[int] = None) -> str:
        """checkpoint_<iterations done>/ under work_dir/checkpoints (or
        checkpoints_<tag>): the parameters as loaded or trained
        (`core.convert.as_loaded`), the optimizer state and the client
        state (cur_iter, world_size, mesh_shape, metric_storage, the
        checkpointable hooks' states). Returns its path."""
        self._flush_metrics()  # the checkpointed metrics must be current
        done = self.cur_iter + int(self._in_iter)
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        client_state = {
            "cur_iter": done,
            "world_size": dist.get_world_size() if up else 1,
            "mesh_shape": None if self.mesh is None else self.mesh.shape,
            "metric_storage": self.metric_storage.state_dict(),
            "hooks": {h.class_name: h.state_dict()
                      for h in self._hooks if h.checkpointable},
        }
        sub = "checkpoints" if tag is None else f"checkpoints_{tag}"
        directory = os.path.join(self.work_dir, sub)
        if self.mesh is None:
            return ckpt_lib.save_checkpoint(
                directory, done, as_loaded(self.params),
                self.optimizer.state_dict(), client_state,
                max_to_keep=max_to_keep)
        # every rank gathers; rank 0 writes the single-rank layout
        params = as_loaded(gather_params(self.mesh, self.params))
        opt_state = self.optimizer.state_dict()
        path = os.path.join(directory, f"checkpoint_{done}")
        if self.mesh.rank == 0:
            path = ckpt_lib.save_checkpoint(directory, done, params,
                                            opt_state, client_state,
                                            max_to_keep=max_to_keep)
        dist.barrier()
        return path

    def resume(self, path: Optional[str] = None) -> bool:
        """Load `path` (default: the latest checkpoint under
        work_dir/checkpoints): parameters, optimizer state, cur_iter, the
        metric storage and the hooks' states; the first epoch then skips
        cur_iter % len(loader) batches. False when there is none."""
        path = path or ckpt_lib.latest_checkpoint(
            os.path.join(self.work_dir, "checkpoints"))
        if path is None:
            logger.info("no checkpoint found; training from scratch")
            return False
        restored = ckpt_lib.load_checkpoint(path)
        slicer = None
        if self.mesh is not None:  # reshard the single-rank layout
            specs = vlm_param_specs(restored["params"])
            axis = self.mesh.tp_axis

            def slicer(keys, leaf):
                return shard_leaf(leaf, spec_of(specs, keys), axis)
        self.params = _restore(self.params, restored["params"], "", (),
                               slicer)
        if restored.get("opt_state") is not None:
            self.optimizer.load_state_dict(restored["opt_state"])
        cs = restored.get("client_state", {})
        saved_ws = cs.get("world_size")
        if saved_ws not in (None, 1):
            logger.warning("resuming in one process from a checkpoint "
                           "written by %d: data-order reproducibility is "
                           "not preserved", saved_ws)
        self.cur_iter = cs.get("cur_iter", restored["step"])
        self.start_iter = self.cur_iter
        self.metric_storage.load_state_dict(cs.get("metric_storage", {}))
        for h in self._hooks:
            if h.checkpointable and h.class_name in cs.get("hooks", {}):
                h.load_state_dict(cs["hooks"][h.class_name])
        self._skip = (self.cur_iter % max(len(self.data_loader), 1)
                      if hasattr(self.data_loader, "__len__") else 0)
        logger.info("resumed from %s at iter %d", path, self.cur_iter)
        return True

    def _fast_forward(self) -> None:
        """A fresh data iterator (drawn after the epoch's hooks), advanced
        past the batches the checkpointed run had taken this epoch."""
        skip, self._skip = self._skip, None
        close = getattr(self._data_iter, "close", None)
        if close is not None:
            close()
        self._data_iter = iter(self.data_loader)
        for _ in range(skip):
            try:
                next(self._data_iter)
            except StopIteration:
                self._data_iter = iter(self.data_loader)


def _restore(have, saved, path, keys=(), slicer=None):
    """The trainer's parameter tree `have` with the checkpoint's values:
    trainable masters (and quantized codes) overwritten in place, since the
    optimizer holds them; each frozen float leaf replaced by the saved leaf
    cast as before, which becomes its source (`core.convert.source_of`).
    `slicer(keys, saved leaf)` gives a mesh rank's slice of a saved leaf
    (the whole saved leaf stays the source)."""
    if isinstance(have, dict) and not isinstance(saved, QuantizedTensor):
        if not isinstance(saved, dict) or set(saved) != set(have):
            raise ValueError(f"checkpoint params at {path or '/'}: keys "
                             f"{sorted(saved)} differ from {sorted(have)}")
        return {k: _restore(v, saved[k], f"{path}/{k}", keys + (k,),
                            slicer) for k, v in have.items()}
    local = saved if slicer is None else slicer(keys, saved)
    with torch.no_grad():
        if isinstance(have, QuantizedTensor):
            q, scale = ((local.q, local.scale)
                        if isinstance(local, QuantizedTensor)
                        else (local["q"], local["scale"]))
            have.q.copy_(torch.as_tensor(np.asarray(q)))
            have.scale.copy_(torch.as_tensor(np.asarray(scale)))
            return have
        arr = torch.as_tensor(np.asarray(local))
        if tuple(arr.shape) != tuple(have.shape):
            raise ValueError(f"checkpoint params at {path}: shape "
                             f"{tuple(arr.shape)} differs from "
                             f"{tuple(have.shape)}")
        if have.requires_grad or not have.is_floating_point():
            have.copy_(arr)
            return have
        out = arr.to(device=have.device, dtype=have.dtype, copy=True)
        _remember_source(out, saved)
        return out


class EpochBasedTrainer(Trainer):
    """`epochs` semantics: cur_iter = epoch * epoch_len + inner_iter."""

    def __init__(self, *args, epochs: int, **kwargs):
        super().__init__(*args, epochs=epochs, **kwargs)


class IterBasedTrainer(Trainer):
    """`max_iters` semantics."""

    def __init__(self, *args, max_iters: int, **kwargs):
        super().__init__(*args, max_iters=max_iters, **kwargs)
