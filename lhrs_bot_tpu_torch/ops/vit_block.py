"""Fused W8A8 vision transformer block, and its split form.

Counterpart of `lhrs_bot_tpu/ops/vit_block.py`: one pre-LN CLIP encoder
block with int8 weights and per-row int8 activations,

    LN1 -> row quantization -> int8 QKV (softmax scale folded into the Q
    columns, one bf16 rounding) -> per-head attention, float32 output ->
    row quantization -> int8 O + residual (float32) -> LN2 -> row
    quantization -> int8 FC + QuickGELU (float32) -> row quantization ->
    int8 proj + residual -> bf16,

with the TPU kernel's order of float32 operations at every epilogue. The TPU
kernel runs a block per grid step with the layer's weights resident in
VMEM; a ViT-L layer's 12.6 MB of int8 weights do not fit in an SM's shared
memory, so here a block is a composition of three hand-written kernels over
all the batch's tokens at once (M = B * S rows): kernel A (LayerNorm + row
quantization, ops/ln_quant.py), kernel B (int8 GEMM with the epilogue,
ops/int8_gemm.py) and the attention (float32 output, reading Q, K and V in
place from the QKV projection and writing token-major: the normalize-first
kernel, or K1 in the `exp2_post` mode). The contract is the block's output,
not one launch.

The TPU's layout choices are not part of the meaning: the transposed QKV
(heads as sublane slices), the token padding S_pad (272 for ViT-L), images
concatenated along tokens (`group`) and block-diagonal attention over
`attn_pair` images all give the per-image result exactly (masked keys get
probability 0, every other step is per row). `vit_layer_fused`, which the
port's tower runs, computes at S = 257 per image. The public functions take
the JAX layout: a padded (B, S_pad, W) input, whose pad keys are masked and
whose pad rows are computed as the TPU kernel computes them; `group`,
`attn_pair` and `img_tile` are accepted and change nothing.

The block form's softmax follows `LHRS_VIT_SOFTMAX`, read at each call
(`softmax_mode`), as the TPU kernel's `_SOFTMAX_MODE`: "jnn" (the default)
folds sm_scale into the Q columns and rounds the normalised probabilities
to bf16; "exp2_pre" folds sm_scale * log2 e, takes exp2 and rounds the
probabilities multiplied by the reciprocal of their sum; any other value
acts as "exp2_post", which folds the same, rounds the unnormalised exp2
probabilities and scales the P V output by 1 / sum. On the card the first
two launch the normalize-first attention (`flash_attention_fwd_normalized`,
csrc/flash_fwd_norm.cu), the third K1, whose online softmax rounds at that
point. The split
form's attention (XLA's `jax.nn.softmax` in JAX) and the perceiver block's
(`jax.nn.softmax` in its kernel) always normalise first.

Each public function has a plain version (`*_plain`) that runs the same
composition through the plain versions of the three kernels, on any device:
the CPU path and the card's reference.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from .attention import (flash_attention_fwd, flash_attention_fwd_normalized,
                        mha_reference, pad_head_dim, padded_head_dim)
from .int8_gemm import int8_gemm, int8_gemm_plain
from .ln_quant import ln_quant, ln_quant_plain
from .quant import quantize_int8, transposed_storage


_LOG2E = 1.4426950408889634
_NEG_INF = -1e30


def softmax_mode() -> str:
    """`LHRS_VIT_SOFTMAX` now: "jnn" (unset) or "exp2_pre"; any other value
    is "exp2_post", as the JAX kernel's fall-through reads it."""
    mode = os.environ.get("LHRS_VIT_SOFTMAX", "jnn")
    return mode if mode in ("jnn", "exp2_pre") else "exp2_post"


def q_fold(sm_scale: float, mode: str) -> float:
    """The softmax scale folded into the Q columns of the QKV epilogue:
    with log2 e for the exp2 modes (JAX `_q_fold`)."""
    return sm_scale * (1.0 if mode == "jnn" else _LOG2E)


def attention_plain(q, k, v, kv_mask: Optional[torch.Tensor],
                    sm_scale: float, out_dtype, mode: str = "jnn"
                    ) -> torch.Tensor:
    """The TPU vision kernels' attention (`_attn_probs_and_norm`) with
    `mode`'s rounding points, (B, H, S, D) in and out: float32 scores
    times `sm_scale`, pad keys -1e30; "jnn" is `mha_reference` (softmax,
    normalised probabilities rounded to v's dtype); "exp2_pre" rounds
    exp2(s - max) * (1 / sum); "exp2_post" rounds exp2(s - max) and
    multiplies the float32 P V by 1 / sum."""
    if mode == "jnn":
        return mha_reference(q, k, v, kv_mask, sm_scale=sm_scale,
                             out_dtype=out_dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], _NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    recip = 1.0 / p.sum(dim=-1, keepdim=True)
    if mode == "exp2_pre":
        return torch.matmul((p * recip).to(v.dtype).float(),
                            v.float()).to(out_dtype)
    return (torch.matmul(p.to(v.dtype).float(), v.float()) * recip).to(
        out_dtype)


def _kernels(plain: bool):
    """(ln_quant, int8_gemm): the dispatching entry points, or the plain
    versions on any device."""
    return (ln_quant_plain, int8_gemm_plain) if plain else (ln_quant,
                                                            int8_gemm)


def _vec(t: torch.Tensor) -> torch.Tensor:
    """A packed (1, N) row or (N, 1) column as a contiguous (N,) vector."""
    return t.reshape(-1)


def attend_token_major(q, k, v, kv_mask: Optional[torch.Tensor],
                       sm_scale: float, out_dtype, plain: bool = False,
                       mode: str = "jnn") -> torch.Tensor:
    """Attention of (B, H, S, D) views (strided, as sliced from a
    projection) -> token-major (B, Sq, H * D) in `out_dtype`, with the
    softmax `mode` (`attention_plain`; the exp2 modes' scores, sm_scale
    included, are in units of log2). CUDA tensors launch a kernel writing
    token-major in place (a head dim below 128 that the kernels do not take
    zero-padded to 64 or 128, the output cut back): the normalize-first
    attention for "jnn" and "exp2_pre", K1 for "exp2_post"; CPU
    tensors, and `plain`, run `attention_plain`."""
    b, h, sq, d = q.shape
    if q.is_cuda and not plain:
        # the kernels take exp(s * scale): the exp2 modes' scale over log2 e
        k1_scale = sm_scale if mode == "jnn" else sm_scale / _LOG2E

        def k1(qq, kk, vv, out):
            if mode == "exp2_post":
                return flash_attention_fwd(qq, kk, vv, kv_mask, False,
                                           k1_scale, out_dtype, out)
            return flash_attention_fwd_normalized(qq, kk, vv, kv_mask,
                                                  k1_scale, out_dtype, out)

        if d < 128 and d not in (64, 128):  # zero columns, cut back after
            width = padded_head_dim(d)
            out = torch.empty((b, sq, h, width), dtype=out_dtype,
                              device=q.device)
            k1(*(pad_head_dim(t, width) for t in (q, k, v)),
               out.transpose(1, 2))
            return out[..., :d].reshape(b, sq, h * d)
        out = torch.empty((b, sq, h, d), dtype=out_dtype, device=q.device)
        k1(q, k, v, out.transpose(1, 2))
        return out.reshape(b, sq, h * d)
    o = attention_plain(q, k, v, kv_mask, sm_scale, out_dtype, mode)
    return o.transpose(1, 2).reshape(b, sq, h * d)


def _heads(t: torch.Tensor, parts: int, heads: int):
    """(B, S, parts * W) -> `parts` (B, H, S, D) views."""
    b, s, n = t.shape
    return t.view(b, s, parts, heads, n // parts // heads).permute(
        2, 0, 3, 1, 4).unbind(0)


def _qkv(x, lp, ln_eps, q_fold, n_fold, plain):
    """LN1 + row quantization + int8 QKV: (..., W) -> (..., 3W) bf16."""
    lnq, gemm = _kernels(plain)
    hq, hs = lnq(x, _vec(lp["ln1_scale"]), _vec(lp["ln1_bias"]), ln_eps)
    return gemm(hq, hs, lp["wqkv"], _vec(lp["sqkv"]), bias=_vec(lp["bqkv"]),
                ws_first=True, q_fold=q_fold, n_fold=n_fold,
                out_dtype=torch.bfloat16)


def post_attention(x, attn, lp, ln_eps, act, plain=False):
    """The block's back half: row quantization of the attention output,
    int8 O + residual (float32), LN2, int8 FC + `act` (float32), row
    quantization, int8 proj + residual -> x.dtype. Shared by the ViT (block
    and split forms) and the perceiver block."""
    lnq, gemm = _kernels(plain)
    aq, a_s = lnq(attn)
    x1 = gemm(aq, a_s, lp["wo"], _vec(lp["so"]), bias=_vec(lp["bo"]),
              residual=x, out_dtype=torch.float32)
    h2q, h2s = lnq(x1, _vec(lp["ln2_scale"]), _vec(lp["ln2_bias"]), ln_eps)
    fc = gemm(h2q, h2s, lp["w_fc"], _vec(lp["s_fc"]), bias=_vec(lp["b_fc"]),
              act=act, out_dtype=torch.float32)
    fq, fs = lnq(fc)
    return gemm(fq, fs, lp["w_proj"], _vec(lp["s_proj"]),
                bias=_vec(lp["b_proj"]), residual=x1, out_dtype=x.dtype)


def vit_layer_fused(x: torch.Tensor, lp, *, heads: int, ln_eps: float = 1e-5,
                    quick_gelu: bool = True, split_attention: bool = False,
                    kv_mask: Optional[torch.Tensor] = None,
                    plain: bool = False) -> torch.Tensor:
    """One W8A8 block over x (B, S, W) bf16, contiguous. The block form
    folds the softmax scale (with log2 e in the exp2 modes) into the Q
    columns of the QKV epilogue, takes `softmax_mode()`'s softmax and keeps
    the attention output in float32; the split form (the JAX
    `split_attention=True`) scales in the attention, normalises first and
    rounds its output to bf16 before quantizing it."""
    b, s, w = x.shape
    sm_scale = (w // heads) ** -0.5
    act = "quick_gelu" if quick_gelu else "gelu"
    if split_attention:
        q, k, v = _heads(_qkv(x, lp, ln_eps, 1.0, 0, plain), 3, heads)
        attn = attend_token_major(q, k, v, kv_mask, sm_scale,
                                  torch.bfloat16, plain)
    else:
        mode = softmax_mode()
        q, k, v = _heads(_qkv(x, lp, ln_eps, q_fold(sm_scale, mode), w,
                              plain), 3, heads)
        attn = attend_token_major(q, k, v, kv_mask, 1.0, torch.float32,
                                  plain, mode)
    return post_attention(x, attn, lp, ln_eps, act, plain)


def _pad_mask(x: torch.Tensor, s_valid: int) -> Optional[torch.Tensor]:
    b, s_pad, _ = x.shape
    if s_valid == s_pad:
        return None
    keys = torch.arange(s_pad, device=x.device) < s_valid
    return keys.expand(b, s_pad).contiguous()


def fused_vit_block(x: torch.Tensor, lp: Dict[str, torch.Tensor], *,
                    heads: int, s_valid: int, ln_eps: float = 1e-5,
                    quick_gelu: bool = True, img_tile: int = 1,
                    group: int = 1, attn_pair: int = 2,
                    plain: bool = False) -> torch.Tensor:
    """x (B, S_pad, W) bf16, rows past s_valid padding (masked as keys) ->
    the block's output, same shape. `lp` is one layer of
    `pack_vit_layers_fused`. `img_tile`, `group` and `attn_pair` are the TPU
    grid's layout and change nothing here."""
    return vit_layer_fused(x.contiguous(), lp, heads=heads, ln_eps=ln_eps,
                           quick_gelu=quick_gelu,
                           kv_mask=_pad_mask(x, s_valid), plain=plain)


def fused_vit_block_plain(x, lp, **kw) -> torch.Tensor:
    return fused_vit_block(x, lp, plain=True, **kw)


def fused_vit_qkv(x: torch.Tensor, lp, *, ln_eps: float = 1e-5,
                  plain: bool = False) -> torch.Tensor:
    """Split-form front half: (n, gS, W) bf16 -> QKV in the JAX transposed
    layout (n, 3W, gS) bf16, a view of the port's (n, gS, 3W) result."""
    return _qkv(x, lp, ln_eps, 1.0, 0, plain).transpose(1, 2)


def fused_vit_qkv_plain(x, lp, **kw) -> torch.Tensor:
    return fused_vit_qkv(x, lp, plain=True, **kw)


def fused_vit_post(x: torch.Tensor, attn: torch.Tensor, lp, *,
                   ln_eps: float = 1e-5, quick_gelu: bool = True,
                   plain: bool = False) -> torch.Tensor:
    """Split-form back half: x (n, gS, W) bf16 + the bf16 attention output
    -> the block's output, same shape."""
    return post_attention(x.contiguous(), attn, lp, ln_eps,
                          "quick_gelu" if quick_gelu else "gelu", plain)


def fused_vit_post_plain(x, attn, lp, **kw) -> torch.Tensor:
    return fused_vit_post(x, attn, lp, plain=True, **kw)


# ---------------------------------------------------------------------------
# Packing: stacked float ViT layers -> stacked fused-block layout
# ---------------------------------------------------------------------------


def qpack(w: torch.Tensor):
    """(L, in, out) float -> int8 codes (L, in, out) in kernel B's storage,
    float32 scales (L, 1, out); codes and scales are the JAX package's."""
    qt = quantize_int8(w, axis=1)
    return transposed_storage(qt.q), qt.scale.float()


def pack_vit_layers_fused(layers: Dict[str, torch.Tensor]) -> Dict:
    """Stacked (L, ...) float layer params (models/vit.py layout) -> stacked
    int8 weights + float32 scales/biases, with the JAX package's keys,
    shapes and values. QKV is one (W, 3W) matmul whose scales/bias are
    column-shaped (3W, 1), as the JAX layout has them for its transposed
    output."""
    wqkv = torch.cat([layers["wq"], layers["wk"], layers["wv"]], dim=-1)
    bqkv = torch.cat([layers["bq"], layers["bk"], layers["bv"]], dim=-1)
    q_qkv, s_qkv = qpack(wqkv)
    del wqkv
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
        "wqkv": q_qkv, "sqkv": as_col(s_qkv), "bqkv": as_col(bqkv),
        "wo": q_o, "so": as_row(s_o), "bo": as_row(layers["bo"]),
        "ln2_scale": as_row(layers["ln2_scale"]),
        "ln2_bias": as_row(layers["ln2_bias"]),
        "w_fc": q_fc, "s_fc": as_row(s_fc), "b_fc": as_row(layers["b_fc"]),
        "w_proj": q_pj, "s_proj": as_row(s_pj),
        "b_proj": as_row(layers["b_proj"]),
    }
