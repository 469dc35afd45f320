"""Optimizers: Adan / Adan-p, AdamW and SGD with momentum, with the JAX
package's parameter-group rules.

Counterpart of `lhrs_bot_tpu/train/optimizer.py` (`adan`, `build_optimizer`
over optax): no weight decay for tensors with ndim <= 1 (norms, biases);
gradient clipping by global norm; trainable masking (only the trainable
leaves have optimizer state; the frozen ones are never touched); gradient
accumulation over `accumulation_steps` micro-steps (optax `MultiSteps`: the
running mean of the micro-steps' gradients goes through the inner update
once every k calls, and the inner step count advances once per k).

`TrainOptimizer` is a functional update over the trainable tensors: each
step takes their gradients and updates the tensors in place. Every formula
follows optax's and the JAX package's order of operations, not PyTorch's
stock optimizers:
  * clipping scales by max_norm / g_norm only when g_norm >= max_norm (no
    1e-6 added), as `optax.clip_by_global_norm`;
  * Adan evaluates the schedule at the 1-based step count and AdamW / SGD
    at the 0-based one, as `adan` and optax's `scale_by_learning_rate`;
  * AdamW is optax's: bias-corrected moments, eps outside the square root,
    decoupled decay added to the direction before the lr scaling.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch

LR = Union[float, Callable[[int], float]]


def weight_decay_mask(params):
    """Nested dict of bools like `params`: True (decay) for tensors with
    ndim > 1."""
    if isinstance(params, dict):
        return {k: weight_decay_mask(v) for k, v in params.items()}
    return getattr(params, "ndim", 0) > 1


def _leaves(tree, mask, path=()):
    """(path, leaf) pairs of the nested dict whose mask entry is True."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, True if mask is None else mask[k],
                               path + (k,))
    elif mask:
        yield path, tree


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their sums of squares (float32), as
    optax.global_norm sums them, one tensor after another."""
    total = None
    for t in tensors:
        s = t.float().square().sum()
        total = s if total is None else total + s
    return total.sqrt()


def _lr(lr: LR, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


class TrainOptimizer:
    """The update over `params` (the trainable tensors, float32, updated in
    place), with `decay[i]` marking the tensors that take weight decay.

    name: "adan" (proximal Adan), "adanp" (Adan without the proximal step),
    "adamw" (optax adamw), or "sgd" (momentum 0.9)."""

    def __init__(self, params: List[torch.Tensor], decay: List[bool], *,
                 name: str, lr: LR, weight_decay: float = 0.0,
                 betas: Optional[Sequence[float]] = None,
                 max_grad_norm: float = 0.0, accumulation_steps: int = 1,
                 paths: Optional[List[tuple]] = None):
        if name not in ("adan", "adanp", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.params = params
        self.paths = paths
        self.decay = decay
        self.name = name
        self.lr = lr
        self.weight_decay = weight_decay
        if name in ("adan", "adanp"):
            self.betas = (0.98, 0.92, 0.99)
        elif name == "adamw":
            self.betas = (float(betas[0]), float(betas[1])) if betas \
                else (0.9, 0.999)
        else:
            self.betas = (0.9,)
        self.eps = 1e-8
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = accumulation_steps
        self.count = 0  # inner steps taken
        self.mini_step = 0
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        n_state = {"adan": 4, "adanp": 4, "adamw": 2, "sgd": 1}
        # adan: m, v, n, previous grad; adamw: mu, nu; sgd: trace
        self.state = [zeros() for _ in range(n_state[name])]
        self.acc = zeros() if accumulation_steps > 1 else None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One call per micro-step: accumulate, and every
        accumulation_steps calls clip, update and apply."""
        grads = [g.float() for g in grads]
        if self.acc is not None:
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1)
                        for a, g in zip(self.acc, grads)]
            self.mini_step = (n + 1) % self.accumulation_steps
            if self.mini_step:
                return
            grads, self.acc = self.acc, [torch.zeros_like(a)
                                         for a in self.acc]
        if self.max_grad_norm > 0:
            grads = self._clip(grads)
        update = {"adan": self._adan, "adanp": self._adan,
                  "adamw": self._adamw, "sgd": self._sgd}[self.name](grads)
        for p, u in zip(self.params, update):
            p.add_(u)
        self.count += 1

    def _clip(self, grads):
        g_norm = global_norm(grads)
        keep = g_norm < self.max_grad_norm
        return [torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                for g in grads]

    def _adan(self, grads):
        b1, b2, b3 = self.betas
        count = self.count + 1
        m, v, n, prev = self.state
        diff = [g - (g if count == 1 else pg) for g, pg in zip(grads, prev)]
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(m, grads)]
        v = [b2 * v_ + (1 - b2) * d for v_, d in zip(v, diff)]
        n = [b3 * n_ + (1 - b3) * torch.square(g + (1 - b2) * d)
             for n_, g, d in zip(n, grads, diff)]
        self.state = [m, v, n, list(grads)]
        bc1, bc2, bc3 = 1 - b1 ** count, 1 - b2 ** count, 1 - b3 ** count
        out = []
        lr, wd = _lr(self.lr, count), self.weight_decay
        for m_, v_, n_, p, use in zip(m, v, n, self.params, self.decay):
            u = (m_ / bc1 + (1 - b2) * v_ / bc2) / (
                torch.sqrt(n_ / bc3) + self.eps)
            if self.name == "adanp" or not wd:
                if wd and use:
                    u = u + wd * p
                out.append(-lr * u)
            else:  # proximal: p <- (p - lr d) / (1 + lr wd)
                w = wd if use else 0.0
                out.append(-(lr * u + lr * w * p) / (1.0 + lr * w))
        return out

    def _adamw(self, grads):
        b1, b2 = self.betas
        count = self.count + 1
        mu = [(1 - b1) * g + b1 * t for g, t in zip(grads, self.state[0])]
        nu = [(1 - b2) * (g * g) + b2 * t
              for g, t in zip(grads, self.state[1])]
        self.state = [mu, nu]
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        lr, wd = _lr(self.lr, self.count), self.weight_decay
        out = []
        for m_, n_, p, use in zip(mu, nu, self.params, self.decay):
            u = (m_ / bc1) / (torch.sqrt(n_ / bc2) + self.eps)
            if use:
                u = u + wd * p
            out.append(-lr * u)
        return out

    def _sgd(self, grads):
        trace = [g + self.betas[0] * t for g, t in zip(grads, self.state[0])]
        self.state = [trace]
        lr = _lr(self.lr, self.count)
        return [-lr * t for t in trace]


def build_optimizer(config, params, trainable=None,
                    schedule: Optional[Callable[[int], float]] = None
                    ) -> TrainOptimizer:
    """From a config dict (keys optimizer, lr, wd, betas, max_grad_norm,
    accumulation_steps, as in `Config/*.yaml`; "adam" is AdamW, as in the
    JAX package) over the leaves of `params`
    that `trainable` (a nested dict of bools, `models.vlm.trainable_mask`)
    marks, every leaf when it is None. `schedule` overrides the constant
    lr."""
    name = str(config.get("optimizer", "adamw")).lower()
    if name == "adam":
        name = "adamw"
    pairs = list(_leaves(params, trainable))
    decay_mask = weight_decay_mask(params)
    decay = []
    for path, _ in pairs:
        node = decay_mask
        for k in path:
            node = node[k]
        decay.append(node)
    return TrainOptimizer(
        [t for _, t in pairs], decay, name=name,
        lr=schedule if schedule is not None else float(config["lr"]),
        weight_decay=float(config.get("wd", 0.0) or 0.0),
        betas=config.get("betas"),
        max_grad_norm=float(config.get("max_grad_norm", 0.0) or 0.0),
        accumulation_steps=int(config.get("accumulation_steps", 1) or 1),
        paths=[p for p, _ in pairs])
