"""Dense projection, gated SiLU MLP (LLaMA-2) and GELU MLP (ViT/perceiver).

Counterpart of `lhrs_bot_tpu/ops/mlp.py`. Weights keep the JAX (in, out)
layout, so a projection is `x @ w`. A matmul of bf16 operands accumulates in
float32 and rounds its output to bf16, as the JAX
`jnp.dot(..., preferred_element_type=float32).astype(x.dtype)` does.

`dense_any` and `gelu_mlp` also take int8 `QuantizedTensor` weights (from
`quant.quantize_vision_layers`) and then go W8A8, as the JAX package's do:
the activation is quantized per row and multiplied by the int8 codes in one
launch of the int8 GEMM (ops/int8_gemm.py, kernel B on the card), whose
epilogue keeps the JAX rounding points: the product is rounded to x.dtype
(`w8a8_matmul`'s output), the bias is added to that, then the GELU, then the
rounding to x.dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .int8_gemm import int8_gemm
from .quant import QuantizedTensor, quantize_activation


def _w8a8(x: torch.Tensor, qt: QuantizedTensor, bias=None,
          act: Optional[str] = None) -> torch.Tensor:
    """x.dtype(act(x.dtype(w8a8 product) + bias)): the JAX `dense_any` /
    `gelu_mlp` steps around `w8a8_matmul`, in one GEMM epilogue."""
    xq, xs = quantize_activation(x)
    return int8_gemm(xq, xs, qt.q, qt.scale,
                     bias=None if bias is None else bias.float().contiguous(),
                     round_mid=x.dtype == torch.bfloat16, act=act,
                     out_dtype=x.dtype)


def dense_any(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    if isinstance(w, QuantizedTensor):
        return _w8a8(x, w, b)
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
    if isinstance(w_fc, QuantizedTensor):
        h = _w8a8(x, w_fc, b_fc, "quick_gelu" if quick_gelu else "gelu")
        return _w8a8(h, w_proj, b_proj)
    h = dense_any(x, w_fc).float() + b_fc
    if quick_gelu:
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = F.gelu(h)
    h = h.to(x.dtype)
    return (dense_any(h, w_proj).float() + b_proj).to(x.dtype)
