"""Dense projection, gated SiLU MLP (LLaMA-2) and GELU MLP (ViT/perceiver).

Counterpart of `lhrs_bot_tpu/ops/mlp.py` for float weights. Weights keep the
JAX (in, out) layout, so a projection is `x @ w`. A matmul of bf16 operands
accumulates in float32 and rounds its output to bf16, as the JAX
`jnp.dot(..., preferred_element_type=float32).astype(x.dtype)` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense_any(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def silu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    # gate and up stay float32, unrounded (preferred_element_type=float32)
    xf = x.float()
    gate = torch.matmul(xf, w_gate.float())
    up = torch.matmul(xf, w_up.float())
    hidden = (F.silu(gate) * up).to(x.dtype)
    return torch.matmul(hidden, w_down)


def gelu_mlp(x: torch.Tensor, w_fc: torch.Tensor, b_fc: torch.Tensor,
             w_proj: torch.Tensor, b_proj: torch.Tensor, *,
             quick_gelu: bool = False) -> torch.Tensor:
    """QuickGELU (x * sigmoid(1.702 x)) for the CLIP tower, exact erf GELU
    otherwise (the perceiver)."""
    h = dense_any(x, w_fc).float() + b_fc
    if quick_gelu:
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = F.gelu(h)
    h = h.to(x.dtype)
    return (dense_any(h, w_proj).float() + b_proj).to(x.dtype)
