"""Learning-rate schedules as plain functions of the step.

Counterpart of `lhrs_bot_tpu/train/schedule.py` (:20-267): fixed, step,
exp, poly, inv, cosine, flat-cosine, cosine-restart, linear annealing,
cyclic and one-cycle, each with iteration-based warmup (constant / linear /
exp ramp of a base factor), and `build_schedule` from the YAML `schedule`
block. Each schedule takes the step (an int) and returns a Python float.
The arithmetic runs on 0-d float32 tensors in the JAX functions' order, so
the values are the JAX package's float32 ones.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[int], float]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 1.0)


def _cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(math.pi * x)


def _wrap(fn) -> Schedule:
    """A function of a float32 step tensor -> a schedule of the step."""
    return lambda step: float(fn(_f32(step)))


def _warmup_wrap(schedule, base_lr: float, warmup_iters: int = 0,
                 warmup_method: str = "linear",
                 warmup_factor: float = 0.1) -> Schedule:
    """Scale the schedule during warmup: a factor ramps from warmup_factor
    to 1 over warmup_iters ('constant', 'linear' or 'exp')."""
    if warmup_iters <= 0:
        return _wrap(schedule)

    def wrapped(step_f):
        frac = _clip01(step_f / warmup_iters)
        if warmup_method == "constant":
            factor = _f32(warmup_factor)
        elif warmup_method == "exp":
            factor = torch.pow(_f32(warmup_factor), 1.0 - frac)
        else:  # linear
            factor = warmup_factor * (1.0 - frac) + frac
        base = schedule(step_f)
        return torch.where(step_f < warmup_iters, base * factor, base)

    return _wrap(wrapped)


def cosine(base_lr: float, total_iters: int, min_lr: float = 0.0,
           **warmup) -> Schedule:
    def fn(step_f):
        t = _clip01(step_f / max(total_iters, 1))
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + _cos(t))
    return _warmup_wrap(fn, base_lr, **warmup)


def flat_cosine(base_lr: float, total_iters: int, start_percent: float = 0.75,
                min_lr: float = 0.0, **warmup) -> Schedule:
    flat_until = int(total_iters * start_percent)

    def fn(step_f):
        t = _clip01((step_f - flat_until) / max(total_iters - flat_until, 1))
        cos_val = min_lr + 0.5 * (base_lr - min_lr) * (1 + _cos(t))
        return torch.where(step_f < flat_until, _f32(base_lr), cos_val)
    return _warmup_wrap(fn, base_lr, **warmup)


def cosine_restart(base_lr: float, periods: Sequence[int],
                   restart_weights: Sequence[float] = None,
                   min_lr: float = 0.0, **warmup) -> Schedule:
    restart_weights = restart_weights or [1.0] * len(periods)
    starts = [0]
    for p in periods[:-1]:
        starts.append(starts[-1] + p)

    def fn(step_f):
        lr = _f32(min_lr)
        for start, period, w in zip(starts, periods, restart_weights):
            t = _clip01((step_f - start) / period)
            seg = min_lr + 0.5 * (base_lr * w - min_lr) * (1 + _cos(t))
            inside = (step_f >= start) & (step_f < start + period)
            lr = torch.where(inside, seg, lr)
        return lr
    return _warmup_wrap(fn, base_lr, **warmup)


def step_decay(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
               **warmup) -> Schedule:
    def fn(step_f):
        factor = _f32(1.0)
        for m in milestones:
            factor = torch.where(step_f >= m, factor * gamma, factor)
        return base_lr * factor
    return _warmup_wrap(fn, base_lr, **warmup)


def exp_decay(base_lr: float, gamma: float, **warmup) -> Schedule:
    return _warmup_wrap(lambda step_f: base_lr * torch.pow(_f32(gamma),
                                                           step_f),
                        base_lr, **warmup)


def poly_decay(base_lr: float, total_iters: int, power: float = 1.0,
               min_lr: float = 0.0, **warmup) -> Schedule:
    def fn(step_f):
        t = _clip01(step_f / max(total_iters, 1))
        return (base_lr - min_lr) * (1 - t) ** power + min_lr
    return _warmup_wrap(fn, base_lr, **warmup)


def inv_decay(base_lr: float, gamma: float, power: float = 1.0,
              **warmup) -> Schedule:
    return _warmup_wrap(
        lambda step_f: base_lr * (1 + gamma * step_f) ** (-power),
        base_lr, **warmup)


def linear_annealing(base_lr: float, total_iters: int, min_lr: float = 0.0,
                     **warmup) -> Schedule:
    def fn(step_f):
        t = _clip01(step_f / max(total_iters, 1))
        return base_lr + (min_lr - base_lr) * t
    return _warmup_wrap(fn, base_lr, **warmup)


def fixed(base_lr: float, **warmup) -> Schedule:
    return _warmup_wrap(lambda step_f: _f32(base_lr), base_lr, **warmup)


def _anneal(strategy: str):
    """annealing_cos / annealing_linear of the reference's hooks."""
    if strategy == "linear":
        return lambda start, end, factor: start + (end - start) * factor
    return lambda start, end, factor: (
        end + 0.5 * (start - end) * (1 + _cos(factor)))


def cyclic(base_lr: float, total_iters: int,
           target_ratio: Sequence[float] = (10.0, 1e-4),
           cyclic_times: int = 1, step_ratio_up: float = 0.4,
           anneal_strategy: str = "cos", gamma: float = 1.0,
           **warmup) -> Schedule:
    """Cyclic LR: up from base_lr to base_lr * target_ratio[0], down to
    base_lr * target_ratio[1] in each cycle; gamma < 1 shrinks the peak
    each cycle, ratio' = 1 - gamma^c + ratio gamma^c."""
    assert 0 <= step_ratio_up < 1.0 and 0 < gamma <= 1
    max_phase = max(total_iters // max(cyclic_times, 1), 1)
    iter_up = int(step_ratio_up * max_phase)
    anneal = _anneal(anneal_strategy)
    tr0, tr1 = float(target_ratio[0]), float(target_ratio[1])

    def fn(step_f):
        curr = torch.remainder(step_f, max_phase)
        cycle = torch.floor(step_f / max_phase)
        scale = torch.pow(_f32(gamma), cycle)
        peak = 1.0 - scale + tr0 * scale
        lr_up = anneal(base_lr, base_lr * peak, curr / max(iter_up, 1))
        lr_down = anneal(base_lr * peak, base_lr * tr1,
                         (curr - iter_up) / max(max_phase - iter_up, 1))
        return torch.where(curr < iter_up, lr_up, lr_down)

    return _warmup_wrap(fn, base_lr, **warmup)


def one_cycle(max_lr: float, total_iters: int, pct_start: float = 0.3,
              anneal_strategy: str = "cos", div_factor: float = 25.0,
              final_div_factor: float = 1e4, three_phase: bool = False,
              **warmup) -> Schedule:
    """1cycle: from max_lr / div_factor up to max_lr over pct_start of the
    run, then down to the initial lr / final_div_factor (optionally through
    a symmetric third phase)."""
    if not 0.0 <= pct_start <= 1.0:
        raise ValueError(f"pct_start must be in [0, 1], got {pct_start}")
    init_lr = max_lr / div_factor
    anneal = _anneal(anneal_strategy)
    if three_phase:
        phases = [
            (float(pct_start * total_iters) - 1, 1.0, div_factor),
            (float(2 * pct_start * total_iters) - 2, div_factor, 1.0),
            (float(total_iters) - 1, 1.0, 1.0 / final_div_factor),
        ]
    else:
        phases = [
            (float(pct_start * total_iters) - 1, 1.0, div_factor),
            (float(total_iters) - 1, div_factor, 1.0 / final_div_factor),
        ]

    def fn(step_f):
        # phases back to front; the earliest phase holding the step wins
        starts = [0.0] + [p[0] for p in phases[:-1]]
        end_l, sr_l, er_l = phases[-1]
        pct = _clip01((step_f - starts[-1]) / max(end_l - starts[-1], 1e-8))
        lr = anneal(init_lr * sr_l, init_lr * er_l, pct)
        for (end, sr, er), start in zip(reversed(phases[:-1]),
                                        reversed(starts[:-1])):
            pct = (step_f - start) / max(end - start, 1e-8)
            cand = anneal(init_lr * sr, init_lr * er, pct)
            lr = torch.where(step_f <= end, cand, lr)
        return lr

    return _warmup_wrap(fn, max_lr, **warmup)


def build_schedule(config, total_iters: int,
                   iters_per_epoch: int = 1) -> Schedule:
    """From a config dict's `schedule` block and `lr` (the schema of
    `Config/*.yaml`). Warmup is given in epochs that iteration-based
    training reads as iterations: warmup_iters = warmup_epochs *
    iters_per_epoch."""
    sched_cfg = config.get("schedule") or {}
    name = str(sched_cfg.get("name", "cosine")).lower()
    base_lr = float(config["lr"])
    min_lr = float(sched_cfg.get("min_lr", 0.0))
    warmup = dict(
        warmup_iters=int(sched_cfg.get("warmup_epochs", 0) * iters_per_epoch),
        warmup_method=sched_cfg.get("warmup_method", "linear"),
        warmup_factor=float(sched_cfg.get("warmup_factor", 0.1)),
    )
    if name == "cosine":
        return cosine(base_lr, total_iters, min_lr, **warmup)
    if name == "flat_cosine":
        return flat_cosine(base_lr, total_iters, min_lr=min_lr, **warmup)
    if name == "step":
        return step_decay(base_lr, sched_cfg.get("multisteps", []),
                          float(sched_cfg.get("gamma", 0.1)), **warmup)
    if name == "exp":
        return exp_decay(base_lr, float(sched_cfg.get("gamma", 0.99)),
                         **warmup)
    if name == "poly":
        return poly_decay(base_lr, total_iters,
                          float(sched_cfg.get("power", 1.0)), min_lr,
                          **warmup)
    if name == "inv":
        return inv_decay(base_lr, float(sched_cfg.get("gamma", 0.1)),
                         float(sched_cfg.get("power", 1.0)), **warmup)
    if name == "linear":
        return linear_annealing(base_lr, total_iters, min_lr, **warmup)
    if name in ("fixed", "const", "constant"):
        return fixed(base_lr, **warmup)
    if name == "cyclic":
        return cyclic(
            base_lr, total_iters,
            target_ratio=tuple(sched_cfg.get("target_ratio", (10.0, 1e-4))),
            cyclic_times=int(sched_cfg.get("cyclic_times", 1)),
            step_ratio_up=float(sched_cfg.get("step_ratio_up", 0.4)),
            anneal_strategy=str(sched_cfg.get("anneal_strategy", "cos")),
            gamma=float(sched_cfg.get("gamma", 1.0)), **warmup)
    if name in ("one_cycle", "onecycle", "1cycle"):
        return one_cycle(
            float(sched_cfg.get("max_lr", base_lr)),
            int(sched_cfg.get("total_steps", total_iters)),
            pct_start=float(sched_cfg.get("pct_start", 0.3)),
            anneal_strategy=str(sched_cfg.get("anneal_strategy", "cos")),
            div_factor=float(sched_cfg.get("div_factor", 25.0)),
            final_div_factor=float(sched_cfg.get("final_div_factor", 1e4)),
            three_phase=bool(sched_cfg.get("three_phase", False)), **warmup)
    raise ValueError(f"unknown schedule {name!r}")
