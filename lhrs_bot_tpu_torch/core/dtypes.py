"""Config dtype names and the mixed-precision policy.

Counterpart of `lhrs_bot_tpu/core/dtypes.py`, with torch dtypes: float16
configs run in bf16 (no loss scaling), as in the JAX package, and int4
names resolve to int8 (the packed int4 weights are unpacked through
int8).
"""

from __future__ import annotations

import dataclasses

import torch

DTYPE_MAP = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float16": torch.bfloat16,
    "fp16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "int4": torch.int8,
}


def resolve_dtype(name):
    """A config's dtype name (any case) -> torch dtype; a non-string is
    returned as it is; an unknown name raises ValueError."""
    if not isinstance(name, str):
        return name
    try:
        return DTYPE_MAP[name.lower()]
    except KeyError as exc:
        raise ValueError(f"unknown dtype name: {name!r}") from exc


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Parameters, compute and accumulation dtypes."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    @classmethod
    def from_config(cls, cfg) -> "DTypePolicy":
        """The compute dtype from `cfg.dtype` (bf16 by default; anything
        but float32 and bf16 computes in bf16)."""
        compute = resolve_dtype(getattr(cfg, "dtype", "bfloat16"))
        if compute not in (torch.float32, torch.bfloat16):
            compute = torch.bfloat16
        return cls(param_dtype=torch.float32, compute_dtype=compute)

    def cast_compute(self, tree):
        """`tree` with every float tensor in the compute dtype."""
        if isinstance(tree, dict):
            return {k: self.cast_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_compute(v) for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.compute_dtype)
        return tree


DEFAULT_POLICY = DTypePolicy()
