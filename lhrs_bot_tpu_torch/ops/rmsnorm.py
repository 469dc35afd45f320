"""RMSNorm and LayerNorm, computed in float32 and cast back.

Counterpart of `lhrs_bot_tpu/ops/rmsnorm.py`; same dtype order (HF
LlamaRMSNorm casts back to the input dtype before the weight multiply).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return weight * normed.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float() + bias.float()).to(x.dtype)
