"""Rotary position embeddings, HF rotate-half layout.

Counterpart of `lhrs_bot_tpu/ops/rope.py`: the head dim is split into two
contiguous halves [x1, x2] and rotated as [x1*cos - x2*sin, x2*cos + x1*sin],
with inv_freq = theta ** (-2i/d) computed in float64 and rounded to float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _inv_freq(head_dim: int, theta: float) -> tuple:
    freqs = theta ** (-np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    return tuple(freqs.astype(np.float32).tolist())


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions (...,) integer -> cos, sin (..., head_dim) float32, the
    half-dim frequency pattern tiled twice."""
    inv = torch.tensor(_inv_freq(head_dim, theta), dtype=torch.float32,
                       device=positions.device)
    angles = positions.float()[..., None] * inv
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., seq, heads, head_dim); cos/sin (..., seq, head_dim),
    broadcast over the heads axis. Computed in float32."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
