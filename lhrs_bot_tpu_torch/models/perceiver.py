"""Multi-level perceiver resampler ("attention pooler").

Counterpart of `lhrs_bot_tpu/models/perceiver.py`: 144 learned queries
split [64, 48, 32] over the three vision feature levels; for each group the
same pre-LN cross-attention
blocks run with q = the evolving group queries and k/v = the fixed concat of
the group's initial queries and that level's tokens; the group outputs are
concatenated and projected into LLM space. A perceiver narrower or wider
than the vision features first projects them (`in_proj_w` / `in_proj_b`,
present when `encoder_hidden_size` differs from `hidden_size`). Float
parameters must already be in the compute dtype (the engine casts them
once). `perceiver_resample` also runs the JAX function's variants, by what
the parameters hold: the K/V of every layer hoisted into one product
(`pack_perceiver_kv`: "kv_big_w"), the kv LayerNorm folded into a fused
K|V weight a layer (`pack_perceiver_kv_folded`: layers' "w_kv"), and the
level groups folded into the batch (`batch_groups=True`, equal splits),
each in float or int8 with JAX's folding algebra and rounding points. With
int8 `QuantizedTensor` projections (`quantize_vision_layers`) every projection
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
from ..ops.quant import (QuantizedTensor, dequantize, quantize_int8,
                         transposed_storage)
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


def _normalize_rows(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without the affine: float32 statistics, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.reciprocal(torch.sqrt(var + eps))).to(
        x.dtype)


def _dense_weight(w) -> torch.Tensor:
    return dequantize(w) if isinstance(w, QuantizedTensor) else w.float()


def _quantized_like(w: torch.Tensor, axis: int) -> QuantizedTensor:
    """int8 codes of `w` along its contraction `axis`, in kernel B's
    storage (as `ops.quant.quantize_vision_layers` stores them)."""
    qt = quantize_int8(w, axis=axis)
    return QuantizedTensor(transposed_storage(qt.q), qt.scale, bits=8)


def _folded_kv(layers):
    """The kv LayerNorm's affine folded into K and V, per layer:
    ln(x) @ w + b = x_hat @ (diag(s) w) + (t @ w + b). Returns float32
    (s * wk, s * wv, bk', bv') stacked on layers."""
    wk, wv = _dense_weight(layers["wk"]), _dense_weight(layers["wv"])
    s = layers["ln_kv_scale"].float()
    t = layers["ln_kv_bias"].float()
    bk = torch.einsum("li,lio->lo", t, wk) + layers["bk"].float()
    bv = torch.einsum("li,lio->lo", t, wv) + layers["bv"].float()
    return s[:, :, None] * wk, s[:, :, None] * wv, bk, bv


def pack_perceiver_kv(params):
    """The K/V projections of every layer hoisted into one (h, 2 L h)
    product over the normalized kv rows (the kv LayerNorm's affine folded
    into the weights, `_folded_kv`), int8-quantized once from the folded
    float32 weights where the layers are quantized. Returns `params` with
    "kv_big_w" and "kv_big_b" (float32) added; `perceiver_resample` uses
    them. The JAX package measured it slower than the per-layer path at
    its prefill batch and the engines do not apply it."""
    layers = params["layers"]
    quantized = isinstance(layers["wk"], QuantizedTensor)
    wk, wv, bk, bv = _folded_kv(layers)
    n_layers, h = wk.shape[0], wk.shape[1]
    big = torch.stack([wk, wv])  # (2, L, h, h)
    w_big = big.permute(2, 0, 1, 3).reshape(h, 2 * n_layers * h)
    b_big = torch.stack([bk, bv]).reshape(2 * n_layers * h)
    w_big = (_quantized_like(w_big, -2) if quantized
             else w_big.to(layers["wk"].dtype))
    return {**params, "kv_big_w": w_big, "kv_big_b": b_big}


def pack_perceiver_kv_folded(params):
    """The kv rows normalized once per group, each layer's kv LayerNorm
    affine folded into one fused K|V weight: `layers` gets "w_kv" (L, h,
    2h) (int8 where the layers are quantized) and "b_kv" (L, 2h) float32
    in place of wk, bk, wv, bv and ln_kv_*. `perceiver_resample`
    dispatches on "w_kv"."""
    layers = params["layers"]
    quantized = isinstance(layers["wk"], QuantizedTensor)
    wk, wv, bk, bv = _folded_kv(layers)
    w_kv = torch.cat([wk, wv], dim=-1)
    w_kv = (_quantized_like(w_kv, 1) if quantized
            else w_kv.to(layers["wk"].dtype))
    new_layers = {k: v for k, v in layers.items()
                  if k not in ("wk", "bk", "wv", "bv", "ln_kv_scale",
                               "ln_kv_bias")}
    new_layers["w_kv"] = w_kv
    new_layers["b_kv"] = torch.cat([bk, bv], dim=-1)
    return {**params, "layers": new_layers}


def _heads_of(t: torch.Tensor, cfg: PerceiverConfig) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, cfg.heads, cfg.head_dim).transpose(1, 2) \
        .contiguous()


def _attend_and_mlp(q_tokens, q, k, v, lp, cfg: PerceiverConfig, kv_mask):
    """The block after its projections: attention, O + residual, LN2,
    the GELU MLP + residual."""
    b, sq, h = q_tokens.shape
    attn = flash_attention(q, k, v, kv_mask, causal=False)
    attn = attn.transpose(1, 2).reshape(b, sq, h)
    x = q_tokens + dense_any(attn, lp["wo"], lp["bo"]).to(q_tokens.dtype)
    h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], cfg.ln_eps)
    return x + gelu_mlp(h2, lp["w_fc"], lp["b_fc"], lp["w_proj"],
                        lp["b_proj"], quick_gelu=False)


def _cross_block(q_tokens: torch.Tensor, kv_tokens: torch.Tensor, lp,
                 cfg: PerceiverConfig, kv_mask=None) -> torch.Tensor:
    """One pre-LN cross-attention block; kv_tokens are fixed per group."""
    qn = layer_norm(q_tokens, lp["ln1_scale"], lp["ln1_bias"], cfg.ln_eps)
    kvn = layer_norm(kv_tokens, lp["ln_kv_scale"], lp["ln_kv_bias"],
                     cfg.ln_eps)

    def proj(x, wm, bm):
        return _heads_of(dense_any(x, wm, bm).to(x.dtype), cfg)

    return _attend_and_mlp(q_tokens, proj(qn, lp["wq"], lp["bq"]),
                           proj(kvn, lp["wk"], lp["bk"]),
                           proj(kvn, lp["wv"], lp["bv"]), lp, cfg, kv_mask)


def _cross_block_kv(q_tokens, k, v, lp, cfg: PerceiverConfig):
    """`_cross_block` with K / V already projected, (B, Skv, h) each."""
    qn = layer_norm(q_tokens, lp["ln1_scale"], lp["ln1_bias"], cfg.ln_eps)
    q = _heads_of(dense_any(qn, lp["wq"], lp["bq"]).to(q_tokens.dtype), cfg)
    return _attend_and_mlp(q_tokens, q, _heads_of(k, cfg),
                           _heads_of(v, cfg), lp, cfg, None)


def _in_proj(params, image_embs: torch.Tensor, dtype) -> torch.Tensor:
    """The vision features projected to the perceiver's width where it
    has an in_proj: the product in `dtype` with float32 accumulation, the
    bias rounded to `dtype` and added in float32, rounded once (JAX's plain
    path)."""
    if "in_proj_w" not in params:
        return image_embs
    return (torch.matmul(image_embs.float(),
                         params["in_proj_w"].to(dtype).float())
            + params["in_proj_b"].to(dtype).float()).to(dtype)


def _batch_groups(queries, image_embs, layers, cfg: PerceiverConfig):
    """The level groups folded into the batch axis (equal splits):
    queries zero-padded to the largest group, their pad slots masked out
    of the keys. Returns the pooled (B, num_query, h)."""
    b, n_groups = queries.shape[0], len(cfg.stage_num)
    s_img, max_nq = cfg.split_part[0], max(cfg.stage_num)
    q_pad, q_valid = [], []
    q_off = 0
    for nq in cfg.stage_num:
        grp = queries[:, q_off:q_off + nq]
        q_pad.append(torch.nn.functional.pad(grp, (0, 0, 0, max_nq - nq)))
        q_valid.append(torch.arange(max_nq, device=queries.device) < nq)
        q_off += nq
    q0 = torch.stack(q_pad, dim=1).reshape(b * n_groups, max_nq, -1)
    img = image_embs.reshape(b * n_groups, s_img, -1)
    kv_fixed = torch.cat([q0, img], dim=1)
    valid = torch.stack(q_valid).repeat(b, 1)
    kv_mask = torch.cat([valid, torch.ones(b * n_groups, s_img,
                                           dtype=torch.bool,
                                           device=queries.device)], dim=1)
    out = q0
    for li in range(cfg.num_layers):
        out = _cross_block(out, kv_fixed, _layer(layers, li), cfg, kv_mask)
    out = out.reshape(b, n_groups, max_nq, -1)
    return torch.cat([out[:, g, :nq] for g, nq in enumerate(cfg.stage_num)],
                     dim=1)


def perceiver_resample(params, image_embs: torch.Tensor,
                       cfg: PerceiverConfig,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       batch_groups: bool = False) -> torch.Tensor:
    """(B, sum(split_part), encoder_hidden) vision features ->
    (B, num_query, output_size). Dispatches, as the JAX function does, on
    `batch_groups` (with equal splits), "kv_big_w" (`pack_perceiver_kv`)
    and the layers' "w_kv" (`pack_perceiver_kv_folded`); otherwise the
    per-group loop."""
    layers = params["layers"]
    image_embs = _in_proj(params, image_embs.to(compute_dtype),
                          compute_dtype)
    b = image_embs.shape[0]
    queries = params["query"].to(compute_dtype)[None].expand(
        b, *params["query"].shape)
    h = cfg.hidden_size

    if batch_groups and len(set(cfg.split_part)) == 1:
        pooled = _batch_groups(queries, image_embs, layers, cfg)
    else:
        groups = []
        q_off = img_off = 0
        for nq, nkv in zip(cfg.stage_num, cfg.split_part):
            groups.append((queries[:, q_off:q_off + nq],
                           image_embs[:, img_off:img_off + nkv]))
            q_off += nq
            img_off += nkv
        kvp = None
        if "kv_big_w" in params:
            # every layer's K/V in one product over the normalized rows
            kv_all = torch.cat([torch.cat(g, dim=1) for g in groups], dim=1)
            xhat = _normalize_rows(kv_all, cfg.ln_eps)
            kvp = dense_any(xhat, params["kv_big_w"],
                            params["kv_big_b"].float()).to(compute_dtype)
            kvp = kvp.reshape(b, kv_all.shape[1], 2, cfg.num_layers, h)
        outs = []
        row_off = 0
        for q0, img in groups:
            rows = q0.shape[1] + img.shape[1]
            out = q0
            if "w_kv" in layers:
                # the kv rows normalized once; a fused K|V product a layer
                xhat = _normalize_rows(torch.cat([q0, img], dim=1),
                                       cfg.ln_eps)
                for li in range(cfg.num_layers):
                    lp = _layer(layers, li)
                    kv = dense_any(xhat, lp["w_kv"], lp["b_kv"].float()) \
                        .to(out.dtype)
                    out = _cross_block_kv(out, kv[..., :h], kv[..., h:], lp,
                                          cfg)
            elif kvp is not None:
                for li in range(cfg.num_layers):
                    out = _cross_block_kv(
                        out, kvp[:, row_off:row_off + rows, 0, li],
                        kvp[:, row_off:row_off + rows, 1, li],
                        _layer(layers, li), cfg)
            else:
                kv_fixed = torch.cat([q0, img], dim=1)
                for li in range(cfg.num_layers):
                    out = _cross_block(out, kv_fixed, _layer(layers, li),
                                       cfg)
            outs.append(out)
            row_off += rows
        pooled = torch.cat(outs, dim=1)  # (B, num_query, hidden)
    # float32 product of the compute-dtype operands, bias added before the
    # one rounding (preferred_element_type=float32 in the JAX package)
    return (torch.matmul(pooled.float(), params["out_proj_w"].float())
            + params["out_proj_b"]).to(compute_dtype)


def perceiver_resample_fused(params, packed_layers, image_embs: torch.Tensor,
                             cfg: PerceiverConfig,
                             plain: bool = False) -> torch.Tensor:
    """perceiver_resample through the fused W8A8 block, in bf16, over
    `pack_perceiver_layers_fused` layers (`plain`: the block's plain
    version, on any device). The groups are padded to common (q_pad,
    kv_pad) shapes, the JAX layout, with the padding masked. An in_proj
    runs first: its product in bf16 with float32 accumulation and the bias
    added in float32, as JAX's fused path rounds it."""
    bf16 = torch.bfloat16
    image_embs = image_embs.to(bf16)
    if "in_proj_w" in params:
        image_embs = (torch.matmul(image_embs.float(),
                                   params["in_proj_w"].to(bf16).float())
                      + params["in_proj_b"].float()).to(bf16)
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
            group_nq=cfg.stage_num, kv_valid=kv_valid, ln_eps=cfg.ln_eps,
            plain=plain)
    pooled = torch.cat([q_state[:, g, :nq]
                        for g, nq in enumerate(cfg.stage_num)], dim=1)
    return (torch.matmul(pooled.float(), params["out_proj_w"].to(bf16).float())
            + params["out_proj_b"].float()).to(bf16)
