"""Multi-level perceiver resampler ("attention pooler").

Counterpart of `lhrs_bot_tpu/models/perceiver.py` `perceiver_resample`, on
its per-group loop path: 144 learned queries split [64, 48, 32] over the
three vision feature levels; for each group the same pre-LN cross-attention
blocks run with q = the evolving group queries and k/v = the fixed concat of
the group's initial queries and that level's tokens; the group outputs are
concatenated and projected into LLM space. The hoisted/folded K/V variants
and the `batch_groups` path are not ported. Float parameters must already
be in the compute dtype (the engine casts them once). With int8
`QuantizedTensor` projections (`quantize_vision_layers`) every projection
goes W8A8 through `dense_any`, the JAX serving path's perceiver.
`perceiver_resample_fused` runs the fused W8A8 block
(ops/perceiver_block.py) instead, as the JAX function of that name does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.attention import flash_attention
from ..ops.mlp import dense_any, gelu_mlp
from ..ops.perceiver_block import fused_perceiver_block
from ..ops.rmsnorm import layer_norm
from .llama import _layer


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    num_query: int = 144
    num_layers: int = 6
    heads: int = 16
    hidden_size: int = 1024
    encoder_hidden_size: int = 1024
    output_size: int = 4096
    mlp_ratio: int = 4
    ln_eps: float = 1e-5
    stage_num: Tuple[int, ...] = (64, 48, 32)
    split_part: Tuple[int, ...] = (256, 256, 256)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads

    @classmethod
    def tiny_test(cls) -> "PerceiverConfig":
        return cls(num_query=12, num_layers=2, heads=2, hidden_size=32,
                   encoder_hidden_size=32, output_size=64,
                   stage_num=(6, 4, 2), split_part=(4, 4, 4))


def _cross_block(q_tokens: torch.Tensor, kv_tokens: torch.Tensor, lp,
                 cfg: PerceiverConfig) -> torch.Tensor:
    """One pre-LN cross-attention block; kv_tokens are fixed per group."""
    b, sq, h = q_tokens.shape
    skv = kv_tokens.shape[1]
    qn = layer_norm(q_tokens, lp["ln1_scale"], lp["ln1_bias"], cfg.ln_eps)
    kvn = layer_norm(kv_tokens, lp["ln_kv_scale"], lp["ln_kv_bias"],
                     cfg.ln_eps)

    def proj(x, wm, bm, s):
        out = dense_any(x, wm, bm).to(x.dtype)
        return out.reshape(b, s, cfg.heads, cfg.head_dim).transpose(1, 2) \
            .contiguous()

    q = proj(qn, lp["wq"], lp["bq"], sq)
    k = proj(kvn, lp["wk"], lp["bk"], skv)
    v = proj(kvn, lp["wv"], lp["bv"], skv)
    attn = flash_attention(q, k, v, causal=False)
    attn = attn.transpose(1, 2).reshape(b, sq, h)
    x = q_tokens + dense_any(attn, lp["wo"], lp["bo"]).to(q_tokens.dtype)
    h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], cfg.ln_eps)
    return x + gelu_mlp(h2, lp["w_fc"], lp["b_fc"], lp["w_proj"],
                        lp["b_proj"], quick_gelu=False)


def perceiver_resample(params, image_embs: torch.Tensor,
                       cfg: PerceiverConfig,
                       compute_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """(B, sum(split_part), encoder_hidden) vision features ->
    (B, num_query, output_size)."""
    if "in_proj_w" in params:
        raise NotImplementedError("a perceiver whose width differs from the "
                                  "vision width (in_proj) is not ported")
    image_embs = image_embs.to(compute_dtype)
    b = image_embs.shape[0]
    queries = params["query"][None].expand(b, *params["query"].shape)

    outs = []
    q_off = img_off = 0
    for nq, nkv in zip(cfg.stage_num, cfg.split_part):
        q0 = queries[:, q_off:q_off + nq]
        kv_fixed = torch.cat([q0, image_embs[:, img_off:img_off + nkv]],
                             dim=1)
        out = q0
        for li in range(cfg.num_layers):
            out = _cross_block(out, kv_fixed, _layer(params["layers"], li),
                               cfg)
        outs.append(out)
        q_off += nq
        img_off += nkv
    pooled = torch.cat(outs, dim=1)  # (B, num_query, hidden)
    # float32 product of the compute-dtype operands, bias added before the
    # one rounding (preferred_element_type=float32 in the JAX package)
    return (torch.matmul(pooled.float(), params["out_proj_w"].float())
            + params["out_proj_b"]).to(compute_dtype)


def perceiver_resample_fused(params, packed_layers, image_embs: torch.Tensor,
                             cfg: PerceiverConfig) -> torch.Tensor:
    """perceiver_resample through the fused W8A8 block, in bf16, over
    `pack_perceiver_layers_fused` layers. The groups are padded to common
    (q_pad, kv_pad) shapes, the JAX layout, with the padding masked."""
    if "in_proj_w" in params:
        raise NotImplementedError("a perceiver whose width differs from the "
                                  "vision width (in_proj) is not ported")
    bf16 = torch.bfloat16
    image_embs = image_embs.to(bf16)
    b, h = image_embs.shape[0], cfg.hidden_size
    q_pad = -(-max(cfg.stage_num) // 16) * 16
    kv_pad = q_pad + (-(-max(cfg.split_part) // 16) * 16)
    queries = params["query"].to(bf16)
    q_groups, kv_groups, kv_valid = [], [], []
    q_off = img_off = 0
    for nq, nkv in zip(cfg.stage_num, cfg.split_part):
        q0 = torch.zeros(b, q_pad, h, dtype=bf16, device=image_embs.device)
        q0[:, :nq] = queries[q_off:q_off + nq]
        kv = torch.zeros(b, kv_pad, h, dtype=bf16, device=image_embs.device)
        kv[:, :q_pad] = q0
        kv[:, q_pad:q_pad + nkv] = image_embs[:, img_off:img_off + nkv]
        q_groups.append(q0)
        kv_groups.append(kv)
        kv_valid.append(nq + nkv)
        q_off += nq
        img_off += nkv
    q_state = torch.stack(q_groups, dim=1)  # (B, G, q_pad, W)
    kv_fixed = torch.stack(kv_groups, dim=1)  # (B, G, kv_pad, W)
    for li in range(cfg.num_layers):
        q_state = fused_perceiver_block(
            q_state, kv_fixed, _layer(packed_layers, li), heads=cfg.heads,
            group_nq=cfg.stage_num, kv_valid=kv_valid, ln_eps=cfg.ln_eps)
    pooled = torch.cat([q_state[:, g, :nq]
                        for g, nq in enumerate(cfg.stage_num)], dim=1)
    return (torch.matmul(pooled.float(), params["out_proj_w"].to(bf16).float())
            + params["out_proj_b"].float()).to(bf16)
