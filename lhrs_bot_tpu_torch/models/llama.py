"""LLaMA-2 decoder: cached prefill and decode over a static-shape KV cache.

Counterpart of `lhrs_bot_tpu/models/llama.py` (`LlamaConfig`, `KVCache`,
`llama_prefill`, `llama_decode_step`) for float or quantized weights
(`ops.quant.QuantizedTensor`: int8, int4, halves-packed int4 "4h", NF4, and
an int8 lm_head) and bf16/f32 or int8 caches. Prompts are right-padded with
per-row lengths; the cache appends at `length`, so no left-padding or
position remapping is needed. Prefill runs the flash-attention entry point;
each decode layer runs the fused append + attention entry point (the int8
one for an int8 cache), which on CUDA always takes the kernel.

Quantized projections keep the JAX package's split between prefill and
decode: prefill multiplies every QuantizedTensor through `quantized_matmul`
(bf16 activations, so "4h" weights run W4A16), while decode sends "4h"
weights through `w4a8_project` (per-token int8 activations, W4A8), which on
CUDA always takes the W4A8 kernel. The TPU package's backend and shape gates
for the W4 and fused paths do not carry over.

Float parameters must already be in the compute dtype (the engine casts
them once); the compute dtype only sets the activations' dtype.

Unlike the JAX package, the KV cache is updated IN PLACE: `llama_prefill`
and `llama_decode_step` write into the tensors of the cache they are given
and return a KVCache over those same tensors with the new lengths.

`llama_apply` is the cacheless training forward (float32 logits of every
position, `kv_mask` or packing `segment_ids` attention, `remat` through
`torch.utils.checkpoint`) and `causal_lm_loss` its loss; gradients of the
attention go through the flash backward (`ops.attention.FlashAttention`).

Every projection goes through `_proj`, which adds the runtime LoRA side
path where a layer carries `<name>__lora_a` / `<name>__lora_b` (QLoRA over
a quantized base, `models.lora.attach_runtime_lora`), in training, prefill
and decode. Over an int8 / int4 / NF4 base the training backward takes the
input gradient of `quantized_matmul` (`ops.quant`), never a weight
gradient.

Not ported here: context parallelism (`cp_axis_name`) and
`llama_prefill_continue`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..device import resolve_device
from ..ops.attention import flash_attention
from ..ops.fused_decode import fused_decode_attention, fused_decode_attention_q
from ..ops.quant import QuantizedTensor, quantize_activation, quantized_matmul
from ..ops.rmsnorm import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.w4_matmul import w4a8_project
from .constants import IGNORE_INDEX


class _W4Layer:
    """Layer `li` of a stacked halves-packed weight, for the W4A8 decode
    projection (`w4a8_project` reads the layer's slice of the stack)."""

    __slots__ = ("qt", "li")

    def __init__(self, qt: QuantizedTensor, li: int):
        self.qt = qt
        self.li = li


def _layer(layers, li: int, *, w4a8: bool = False):
    """The parameters of layer `li`. With w4a8, "4h" weights become
    `_W4Layer`s (decode); otherwise every weight is the layer's view."""
    out = {}
    for k, t in layers.items():
        if w4a8 and isinstance(t, QuantizedTensor) and t.bits == "4h":
            out[k] = _W4Layer(t, li)
        else:
            out[k] = t[li]
    return out


def _dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a compute-dtype matrix, a QuantizedTensor (scale folded
    into the float32 epilogue) or a `_W4Layer` (W4A8)."""
    if isinstance(w, _W4Layer):
        return w4a8_project(x, w.qt, w.li)
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, out_dtype=x.dtype)
    return torch.matmul(x, w)


def _lm_head_logits(x: torch.Tensor, lm_head) -> torch.Tensor:
    """float32 logits: a compute-dtype head multiplies in float32; an int8
    QuantizedTensor head takes bf16 activations (not W8A8) with its scale
    in the float32 epilogue."""
    if isinstance(lm_head, QuantizedTensor):
        return quantized_matmul(x, lm_head, out_dtype=torch.float32)
    return torch.matmul(x.float(), lm_head.float())


def _proj(lp, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ lp[name], plus the runtime LoRA side path (x A) B where the
    layer carries `<name>__lora_a` / `<name>__lora_b` (B with the scale
    folded in, `models.lora.attach_runtime_lora`): A and B in x's dtype,
    each product rounded to x's dtype, as the JAX `_proj` rounds them."""
    y = _dense(x, lp[name])
    a = lp.get(name + "__lora_a")
    if a is not None:
        b = lp[name + "__lora_b"]
        y = y + torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype))
    return y


def _silu_mlp(x: torch.Tensor, lp) -> torch.Tensor:
    gate = _proj(lp, "w_gate", x)
    up = _proj(lp, "w_up", x)
    return _proj(lp, "w_down", F.silu(gate.float()).to(x.dtype) * up)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny_test(cls) -> "LlamaConfig":
        return cls(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=128)

    @classmethod
    def from_config_dict(cls, text_cfg) -> "LlamaConfig":
        """From the `text` section of a config (a plain dict)."""
        return cls(
            vocab_size=int(text_cfg["vocab_size"]),
            hidden_size=int(text_cfg["hidden_size"]),
            intermediate_size=int(text_cfg["intermediate_size"]),
            num_hidden_layers=int(text_cfg["num_hidden_layers"]),
            num_attention_heads=int(text_cfg["num_attention_heads"]),
            max_position_embeddings=int(text_cfg["max_position_embeddings"]),
            rms_norm_eps=float(text_cfg["rms_norm_eps"]),
            pad_token_id=int(text_cfg["pad_token_id"]),
            bos_token_id=int(text_cfg["bos_token_id"]),
            eos_token_id=int(text_cfg["eos_token_id"]),
        )


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache: k/v (L, B, H, S_max, D) plus the per-row valid
    length (B,) int32. Updated in place by prefill and decode.

    dtype=torch.int8 stores K/V quantized per (position, head) vector with
    float32 scale planes k_scale/v_scale (L, B, H, S_max) that start at 1;
    dequantization folds into attention, so no bf16 copy of the cache is
    made."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> "KVCache":
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"{dtype} KV cache is not ported "
                                      "(bf16/f32/int8 only)")
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, batch, cfg.num_attention_heads,
                 max_len, cfg.head_dim)
        scales = {}
        if dtype == torch.int8:
            scales = {name: torch.ones(shape[:-1], dtype=torch.float32,
                                       device=device)
                      for name in ("k_scale", "v_scale")}
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int32,
                                      device=device), **scales)


def _qkv(x: torch.Tensor, lp, cfg: LlamaConfig, cos, sin):
    """Project + RoPE. x (B, S, D) -> contiguous q/k/v (B, H, S, hd)."""
    b, s, _ = x.shape

    def proj(name):
        return _proj(lp, name, x).reshape(
            b, s, cfg.num_attention_heads, cfg.head_dim)

    def heads(t):
        return t.transpose(1, 2).contiguous()

    q = heads(apply_rope(proj("wq"), cos, sin))
    k = heads(apply_rope(proj("wk"), cos, sin))
    return q, k, heads(proj("wv"))


def llama_prefill(params, cfg: LlamaConfig, cache: KVCache, *,
                  inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  slots: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill the cache from right-padded (B, S, D) embeddings; returns
    (next-token logits (B, V) float32, cache). Writes the first S rows of
    every layer of `cache` in place; the cache's length becomes prompt_len.
    With `slots` ((B,) indices into a larger cache's batch, as the
    continuous-batching scheduler installs an admission) only those rows
    are written and their lengths set; the other rows keep their contents.
    Causal masking alone is correct: pads sit after the valid tokens, and
    their cache rows are overwritten by decode before they are read.
    Attention runs on the fresh K/V; only the write into an int8 cache is
    quantized (`quantize_activation` per (b, h, s) vector)."""
    x = inputs_embeds.to(compute_dtype)
    b, s, _ = x.shape
    rows = slice(None) if slots is None else slots.long()
    positions = torch.arange(s, device=x.device).expand(b, s)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin)
        attn = flash_attention(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        x = x + _proj(lp, "wo", attn)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp)
        if cache.quantized:
            for arr, scale, t in ((cache.k, cache.k_scale, k),
                                  (cache.v, cache.v_scale, v)):
                codes, t_scale = quantize_activation(t)
                arr[li, rows, :, :s] = codes
                scale[li, rows, :, :s] = t_scale[..., 0]
        else:
            cache.k[li, rows, :, :s] = k
            cache.v[li, rows, :, :s] = v
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = (prompt_len.long() - 1).clamp(min=0)
    x_last = x[torch.arange(b, device=x.device), last]
    logits = _lm_head_logits(x_last, params["lm_head"])
    length = prompt_len.to(torch.int32)
    if slots is not None:
        length = cache.length.clone()
        length[rows] = prompt_len.to(torch.int32)
    return logits, dataclasses.replace(cache, length=length)


def _block_full(x: torch.Tensor, lp, cfg: LlamaConfig, cos, sin,
                kv_mask: Optional[torch.Tensor],
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Full-sequence causal block (training / cacheless forward). With
    `segment_ids` (B, S) the attention is block-diagonal: i attends j iff
    seg[i] == seg[j] != 0 and j <= i (`kv_mask` is then not used, as in the
    JAX block); otherwise `kv_mask` masks keys."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(h, lp, cfg, cos, sin)
    if segment_ids is not None:
        attn = flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    else:
        attn = flash_attention(q, k, v, kv_mask, causal=True)
    attn = attn.transpose(1, 2).reshape(b, s, cfg.hidden_size)
    x = x + _proj(lp, "wo", attn)
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _silu_mlp(h2, lp)


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """RoPE positions that restart at every segment boundary: the index
    minus the index of its segment's first token."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device).expand(b, s)
    boundary = torch.ones_like(segment_ids, dtype=torch.bool)
    boundary[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    return idx - start


def llama_apply(params, cfg: LlamaConfig, *,
                input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                remat: bool = False, cp_axis_name: Optional[str] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cacheless forward -> logits (B, S, V) float32. Positions default to
    cumsum(attention_mask) - 1 clipped at 0 (or arange), and restart at
    every segment with `segment_ids` (sequence packing, block-diagonal
    attention). `remat` recomputes each block in the backward
    (`torch.utils.checkpoint`, non-reentrant). Float parameters are cast to
    the compute dtype on the fly, differentiably; frozen ones should already
    be in it (`core.convert.training_params_from_numpy`)."""
    if cp_axis_name is not None:
        raise NotImplementedError("context parallelism (cp_axis_name) is not "
                                  "ported to lhrs_bot_tpu_torch yet")
    if inputs_embeds is None:
        inputs_embeds = params["embed_tokens"][input_ids.long()]
    x = inputs_embeds.to(compute_dtype)
    b, s, _ = x.shape
    if segment_ids is not None and positions is None:
        positions = segment_positions(segment_ids)
    if positions is None:
        if attention_mask is not None:
            positions = (attention_mask.int().cumsum(dim=1) - 1).clamp(min=0)
        else:
            positions = torch.arange(s, device=x.device).expand(b, s)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = {k: _cast(t, compute_dtype)
              for k, t in params["layers"].items()}
    for li in range(cfg.num_hidden_layers):
        lp = _layer(layers, li)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _block_full, x, lp, cfg, cos, sin, attention_mask,
                segment_ids, use_reentrant=False)
        else:
            x = _block_full(x, lp, cfg, cos, sin, attention_mask,
                            segment_ids)
    x = rms_norm(x, _cast(params["final_norm"], compute_dtype),
                 cfg.rms_norm_eps)
    return _lm_head_logits(x, _cast(params["lm_head"], compute_dtype))


def _cast(t, dtype):
    """A float tensor in `dtype` (differentiable); a QuantizedTensor as is."""
    if isinstance(t, QuantizedTensor) or t.dtype == dtype:
        return t
    return t.to(dtype)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Shifted cross-entropy in float32, IGNORE_INDEX masked, mean over the
    valid tokens (at least 1)."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def llama_decode_step(params, cfg: LlamaConfig, cache: KVCache, *,
                      inputs_embeds: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      int8_dots: Optional[bool] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One decode step from the (B, 1, D) embedding of the new token;
    returns (logits (B, V) float32, cache with length + 1). Every layer
    appends its K/V row at cache.length in place and attends over
    length + 1 rows through `fused_decode_attention`, or, for an int8
    cache, appends the `quantize_activation` codes and scales of the row
    through `fused_decode_attention_q` with `int8_dots` (None: the
    LHRS_DECODE_INT8_DOTS default, read at each call). "4h" weights run
    W4A8."""
    x = inputs_embeds.to(compute_dtype)
    b = x.shape[0]
    cos, sin = rope_cos_sin(cache.length[:, None], cfg.head_dim,
                            cfg.rope_theta)
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li, w4a8=True)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin)  # (B, H, 1, hd)
        if cache.quantized:
            k_q, k_s = quantize_activation(k)
            v_q, v_s = quantize_activation(v)
            attn = fused_decode_attention_q(
                q, k_q, k_s[..., 0], v_q, v_s[..., 0], cache.k, cache.v,
                cache.k_scale, cache.v_scale, cache.length, li,
                int8_dots=int8_dots)[0]
        else:
            attn = fused_decode_attention(q, k, v, cache.k, cache.v,
                                          cache.length, li)[0]
        attn = attn.transpose(1, 2).reshape(b, 1, cfg.hidden_size)
        x = x + _proj(lp, "wo", attn)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _lm_head_logits(x[:, 0, :], params["lm_head"])
    return logits, dataclasses.replace(cache, length=cache.length + 1)
