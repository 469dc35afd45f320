"""Training: schedules, optimizers, metrics, hooks and the trainer
(counterpart of `lhrs_bot_tpu/train`)."""

from .hooks import HookBase, LoggerHook, LRSchedulerHook  # noqa: F401
from .metric import HistoryBuffer, MetricStorage  # noqa: F401
from .optimizer import (TrainOptimizer, build_optimizer,  # noqa: F401
                        global_norm, weight_decay_mask)
from .schedule import build_schedule  # noqa: F401
from .trainer import (EpochBasedTrainer, IterBasedTrainer,  # noqa: F401
                      Trainer, make_train_step)
