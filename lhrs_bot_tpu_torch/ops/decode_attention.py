"""Single-query decode attention over a static-shape KV cache (plain torch).

Counterpart of `lhrs_bot_tpu/ops/decode_attention.py` for float caches: the
plain reference that the fused CUDA kernel (ops/fused_decode.py) is held to.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, 1, D) against k/v_cache (B, H, S_max, D) over the first
    cache_len[b] positions of each row -> (B, H, 1, D) in q.dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s_max = k_cache.shape[2]
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2))
    scores = scores * sm_scale  # (B, H, 1, S_max)
    positions = torch.arange(s_max, device=q.device)
    valid = positions[None, None, None, :] < cache_len[:, None, None, None]
    scores = scores.masked_fill(~valid, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)
