"""Single-query decode attention over a static-shape KV cache (plain torch).

Counterpart of `lhrs_bot_tpu/ops/decode_attention.py`: the plain reference
that the fused CUDA kernels (ops/fused_decode.py) are held to. With
`k_scale`/`v_scale` the cache is per-vector int8 and dequantization folds
into the attention at the JAX package's rounding points: the codes are cast
to q.dtype before the dot, the scores are multiplied by sm_scale and then by
the key's scale, and after the softmax `probs * v_scale` is cast to q.dtype
before the float32 PV product with the codes in q.dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     sm_scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, 1, D) against k/v_cache (B, H, S_max, D) over the first
    cache_len[b] positions of each row -> (B, H, 1, D) in q.dtype. An int8
    cache comes with k_scale/v_scale (B, H, S_max) float32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_max = k_cache.shape[2]
    kd = k_cache if k_scale is None else k_cache.to(q.dtype)
    scores = torch.matmul(q.float(), kd.float().transpose(-1, -2))
    scores = scores * sm_scale  # (B, H, 1, S_max)
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    positions = torch.arange(s_max, device=q.device)
    valid = positions[None, None, None, :] < cache_len[:, None, None, None]
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = (probs * v_scale[:, :, None, :]).to(q.dtype)
        out = torch.matmul(probs.float(), v_cache.to(q.dtype).float())
    else:
        out = torch.matmul(probs.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)
