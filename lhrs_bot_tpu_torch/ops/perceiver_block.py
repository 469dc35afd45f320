"""Fused W8A8 perceiver (AttnPooler) cross-attention block.

Counterpart of `lhrs_bot_tpu/ops/perceiver_block.py`: one shared perceiver
layer for all three query groups of every image. Per group, the evolving
queries and the fixed kv rows (the group's initial queries + its level's
vision tokens) are LayerNormed separately and quantized per row; q and the
fused K|V projection are int8 GEMMs with the TPU kernel's epilogue order
(q: ((acc * s) * x_scale + b) * sm_scale, rounded to bf16 once; k, v
rounded to bf16); per-head attention over the group's valid kv rows in
float32, the normalised probabilities rounded to bf16 before P V (the TPU
kernel's `jax.nn.softmax`, whatever `LHRS_VIT_SOFTMAX` says; K1's
normalize-first variant on the card); then the back half of the ViT block
with the tanh-approximated GELU the TPU kernel uses (ops/vit_block.py
`post_attention`).

The three groups share the layer's weights and every step but attention is
per row, so each step runs once over all B * G padded group rows (the TPU
kernel's (B, G, q_pad, W) / (B, G, kv_pad, W) layout, taken as it is), and
K1 runs over B * G (image, group) pairs with each group's kv mask (initial
query slots past the group's count, and tail padding, masked). Pad query
rows are computed as the TPU kernel computes them. Only tests call this
block (`perceiver_resample_fused`): the serving path's perceiver goes
through `dense_any` (the JAX package's choice, recorded in its docstring).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .vit_block import (_heads, _kernels, _vec, attend_token_major,
                        post_attention, qpack)


def _kv_mask(b: int, q_pad: int, kv_pad: int, group_nq: Sequence[int],
             kv_valid: Sequence[int], device) -> torch.Tensor:
    """(B * G, kv_pad) bool: kv layout [initial queries (q_pad slots, nq
    valid) | image tokens (nkv - nq valid)]."""
    col = torch.arange(kv_pad, device=device)
    rows = [(col < nq) | ((col >= q_pad) & (col < q_pad + (nkv - nq)))
            for nq, nkv in zip(group_nq, kv_valid)]
    return torch.stack(rows).repeat(b, 1)


def fused_perceiver_block(q_state: torch.Tensor, kv_fixed: torch.Tensor,
                          lp: Dict[str, torch.Tensor], *, heads: int,
                          group_nq: Sequence[int], kv_valid: Sequence[int],
                          ln_eps: float = 1e-5,
                          plain: bool = False) -> torch.Tensor:
    """q_state (B, G, q_pad, W) bf16 padded group queries, kv_fixed (B, G,
    kv_pad, W) bf16 padded fixed kv, `lp` one layer of
    `pack_perceiver_layers_fused` -> the new q_state, same shape."""
    b, g, q_pad, w = q_state.shape
    kv_pad = kv_fixed.shape[2]
    sm_scale = (w // heads) ** -0.5
    lnq, gemm = _kernels(plain)
    x = q_state.contiguous()
    qn, qs = lnq(x, _vec(lp["ln1_scale"]), _vec(lp["ln1_bias"]), ln_eps)
    q = gemm(qn, qs, lp["wq"], _vec(lp["sq"]), bias=_vec(lp["bq"]),
             ws_first=True, out_mult=sm_scale, out_dtype=torch.bfloat16)
    kvn, kvs = lnq(kv_fixed, _vec(lp["ln_kv_scale"]), _vec(lp["ln_kv_bias"]),
                   ln_eps)
    kv = gemm(kvn, kvs, lp["wkv"], _vec(lp["skv"]), bias=_vec(lp["bkv"]),
              ws_first=True, out_dtype=torch.bfloat16)
    (qh,) = _heads(q.view(b * g, q_pad, w), 1, heads)
    k, v = _heads(kv.view(b * g, kv_pad, 2 * w), 2, heads)
    mask = _kv_mask(b, q_pad, kv_pad, group_nq, kv_valid, x.device)
    attn = attend_token_major(qh, k, v, mask, 1.0, torch.float32, plain)
    return post_attention(x, attn.view(b, g, q_pad, w), lp, ln_eps,
                          "gelu_tanh", plain)


def fused_perceiver_block_plain(q_state, kv_fixed, lp, **kw) -> torch.Tensor:
    return fused_perceiver_block(q_state, kv_fixed, lp, plain=True, **kw)


def pack_perceiver_layers_fused(layers: Dict[str, torch.Tensor]) -> Dict:
    """Stacked (L, ...) float perceiver layers (models/perceiver.py layout)
    -> int8 weights + float32 scales/biases with the JAX package's keys,
    shapes and values. K and V are one (W, 2W) matmul; the q and kv
    projections carry column-shaped scales and biases, as the JAX layout
    has them for its transposed outputs."""
    wkv = torch.cat([layers["wk"], layers["wv"]], dim=-1)
    bkv = torch.cat([layers["bk"], layers["bv"]], dim=-1)
    q_q, s_q = qpack(layers["wq"])
    q_kv, s_kv = qpack(wkv)
    del wkv
    q_o, s_o = qpack(layers["wo"])
    q_fc, s_fc = qpack(layers["w_fc"])
    q_pj, s_pj = qpack(layers["w_proj"])
    n_layers = q_o.shape[0]

    def as_row(t):
        return t.float().reshape(n_layers, 1, -1)

    def as_col(t):
        return t.float().reshape(n_layers, -1, 1)

    return {
        "ln1_scale": as_row(layers["ln1_scale"]),
        "ln1_bias": as_row(layers["ln1_bias"]),
        "ln_kv_scale": as_row(layers["ln_kv_scale"]),
        "ln_kv_bias": as_row(layers["ln_kv_bias"]),
        "wq": q_q, "sq": as_col(s_q), "bq": as_col(layers["bq"]),
        "wkv": q_kv, "skv": as_col(s_kv), "bkv": as_col(bkv),
        "wo": q_o, "so": as_row(s_o), "bo": as_row(layers["bo"]),
        "ln2_scale": as_row(layers["ln2_scale"]),
        "ln2_bias": as_row(layers["ln2_bias"]),
        "w_fc": q_fc, "s_fc": as_row(s_fc), "b_fc": as_row(layers["b_fc"]),
        "w_proj": q_pj, "s_proj": as_row(s_pj),
        "b_proj": as_row(layers["b_proj"]),
    }
