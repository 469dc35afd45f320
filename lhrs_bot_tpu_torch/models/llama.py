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

Unlike the JAX package, the KV cache is updated IN PLACE: `llama_prefill`,
`llama_prefill_continue` and `llama_decode_step` write into the tensors of
the cache they are given and return a KVCache over those same tensors with
the new lengths. `KVCache.resized` is the exception: it allocates a longer
cache and copies into it.

`llama_prefill_continue` extends a filled cache by a suffix (the engine's
sessions, chunked prefill and speculative verify windows): RoPE at global
positions, each layer's suffix rows written first, then attention over the
whole cache row, masked causally. That attention is plain PyTorch, as it is
XLA (no Pallas kernel) in the JAX package.

`llama_apply` is the cacheless training forward (float32 logits of every
position, `kv_mask` or packing `segment_ids` attention, `remat` through
`torch.utils.checkpoint`) and `causal_lm_loss` its loss; gradients of the
attention go through the flash backward (`ops.attention.FlashAttention`).
With `cp_axis` (context parallelism, `parallel.context`) the rank holds a
chunk of the sequence, its attention goes through the K/V ring
(`ops.ring_attention`) and the caller gives the chunk's global positions.

Every projection goes through `_proj`, which adds the runtime LoRA side
path where a layer carries `<name>__lora_a` / `<name>__lora_b` (QLoRA over
a quantized base, `models.lora.attach_runtime_lora`), in training, prefill
and decode. Over an int8 / int4 / NF4 base the training backward takes the
input gradient of `quantized_matmul` (`ops.quant`), never a weight
gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..device import resolve_device
from ..ops.attention import flash_attention
from ..ops.fused_decode import fused_decode_attention, fused_decode_attention_q
from ..ops.quant import QuantizedTensor, quantize_activation, quantized_matmul
from ..ops.ring_attention import ring_attention
from ..ops.rmsnorm import rms_norm
from ..ops.rope import apply_rope, rope_cos_sin
from ..ops.w4_matmul import w4a8_project, w4a8_project_row
from ..parallel.mesh import copy_to_model, gather_from_model, \
    reduce_from_model
from ..parallel.partition import ROW_PARALLEL
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


def _dense(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """x @ w for a compute-dtype matrix, a QuantizedTensor (scale folded
    into the float32 epilogue) or a `_W4Layer` (W4A8), in x's dtype, or
    with `out_dtype` float32 a QuantizedTensor's product before its cast
    (a float matrix's product is x's dtype widened)."""
    if isinstance(w, _W4Layer):
        return w4a8_project(x, w.qt, w.li)
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w, out_dtype=out_dtype or x.dtype)
    y = torch.matmul(x, w)
    return y if out_dtype is None else y.to(out_dtype)


def _lm_head_logits(x: torch.Tensor, lm_head, tp=None) -> torch.Tensor:
    """float32 logits: a compute-dtype head multiplies in float32; an int8
    QuantizedTensor head takes bf16 activations (not W8A8) with its scale
    in the float32 epilogue. Under tensor parallelism (`tp`, the model
    axis) each rank holds V / tp vocabulary columns and the shards are
    gathered, so every rank gets the whole (..., V) logits."""
    x = copy_to_model(x, tp)
    if isinstance(lm_head, QuantizedTensor):
        logits = quantized_matmul(x, lm_head, out_dtype=torch.float32)
    else:
        logits = torch.matmul(x.float(), lm_head.float())
    return gather_from_model(logits, tp)


def _proj(lp, name: str, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x @ lp[name], plus the runtime LoRA side path (x A) B where the
    layer carries `<name>__lora_a` / `<name>__lora_b` (B with the scale
    folded in, `models.lora.attach_runtime_lora`): A and B in x's dtype,
    each product rounded to x's dtype, as the JAX `_proj` rounds them.

    Under tensor parallelism (`tp`, the model axis; the layer holds this
    rank's slice, `parallel.partition`) a column projection multiplies the
    whole x by its columns (`copy_to_model`: the input gradient is summed
    over the group) and a row projection ("wo", "w_down") its slice of x
    by its rows, the partial products summed over the group in float32
    (`reduce_from_model`) before the cast to x's dtype; a W4A8 row
    projection goes through `w4a8_project_row`. The LoRA side path
    follows: a column layer's (x A) is summed in the backward, a row
    layer's (x_i A_i) in the forward, before B. With `tp` None the group
    operations return their input: the single-rank product."""
    w = lp[name]
    a = lp.get(name + "__lora_a")
    if tp is not None and name in ROW_PARALLEL:
        if isinstance(w, _W4Layer):
            y = w4a8_project_row(x, w.qt, w.li, tp)
        else:
            y = reduce_from_model(_dense(x, w, torch.float32), tp) \
                .to(x.dtype)
        if a is not None:
            u = reduce_from_model(torch.matmul(x, a.to(x.dtype)).float(),
                                  tp).to(x.dtype)
            y = y + torch.matmul(u, lp[name + "__lora_b"].to(x.dtype))
        return y
    y = _dense(copy_to_model(x, tp), w)
    if a is not None:
        u = copy_to_model(torch.matmul(x, a.to(x.dtype)), tp)
        y = y + torch.matmul(u, lp[name + "__lora_b"].to(x.dtype))
    return y


def _silu_mlp(x: torch.Tensor, lp, tp=None) -> torch.Tensor:
    gate = _proj(lp, "w_gate", x, tp)
    up = _proj(lp, "w_up", x, tp)
    return _proj(lp, "w_down", F.silu(gate.float()).to(x.dtype) * up, tp)


def _heads(cfg: "LlamaConfig", tp) -> int:
    """Attention heads a rank holds: H / tp under tensor parallelism."""
    return cfg.num_attention_heads // (1 if tp is None else tp.size)


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
               device="cuda", heads: Optional[int] = None) -> "KVCache":
        """Zero K/V of `heads` heads (all of cfg's by default; a
        tensor-parallel rank's cache holds H / tp)."""
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"{dtype} KV cache is not ported "
                                      "(bf16/f32/int8 only)")
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, batch,
                 heads or cfg.num_attention_heads, max_len, cfg.head_dim)
        scales = {}
        if dtype == torch.int8:
            scales = {name: torch.ones(shape[:-1], dtype=torch.float32,
                                       device=device)
                      for name in ("k_scale", "v_scale")}
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int32,
                                      device=device), **scales)

    def resized(self, new_len: int) -> "KVCache":
        """A cache whose position axis is `new_len` long: a new allocation
        holding this cache's rows, zero-padded (the int8 scale planes
        padded with 1.0). The same cache when the length is unchanged;
        ValueError on a shrink."""
        cur = self.k.shape[3]
        if new_len == cur:
            return self
        if new_len < cur:
            raise ValueError(f"cannot shrink cache {cur} -> {new_len}")

        def grow(t, fill):
            out = t.new_full(t.shape[:3] + (new_len,) + t.shape[4:], fill)
            out[:, :, :, :cur] = t
            return out

        return KVCache(
            k=grow(self.k, 0), v=grow(self.v, 0), length=self.length,
            k_scale=None if self.k_scale is None else grow(self.k_scale, 1.0),
            v_scale=None if self.v_scale is None else grow(self.v_scale, 1.0))


def _qkv(x: torch.Tensor, lp, cfg: LlamaConfig, cos, sin, tp=None):
    """Project + RoPE. x (B, S, D) -> contiguous q/k/v (B, H, S, hd), H
    this rank's heads under tensor parallelism."""
    b, s, _ = x.shape
    nh = _heads(cfg, tp)

    def proj(name):
        return _proj(lp, name, x, tp).reshape(b, s, nh, cfg.head_dim)

    def heads(t):
        return t.transpose(1, 2).contiguous()

    q = heads(apply_rope(proj("wq"), cos, sin))
    k = heads(apply_rope(proj("wk"), cos, sin))
    return q, k, heads(proj("wv"))


def llama_prefill(params, cfg: LlamaConfig, cache: KVCache, *,
                  inputs_embeds: torch.Tensor, prompt_len: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  slots: Optional[torch.Tensor] = None, tp=None
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
    quantized (`quantize_activation` per (b, h, s) vector). `tp` (the
    mesh's model axis) runs the decoder tensor parallel over this rank's
    slice of the parameters and its H / tp heads of the cache (every
    prefill and decode function takes it)."""
    x = inputs_embeds.to(compute_dtype)
    b, s, _ = x.shape
    width = _heads(cfg, tp) * cfg.head_dim
    rows = slice(None) if slots is None else slots.long()
    positions = torch.arange(s, device=x.device).expand(b, s)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin, tp)
        attn = flash_attention(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(b, s, width)
        x = x + _proj(lp, "wo", attn, tp)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp, tp)
        if cache.quantized:
            for arr, scale, t in ((cache.k, cache.k_scale, k),
                                  (cache.v, cache.v_scale, v)):
                codes, t_scale = quantize_activation(t)
                arr[li, rows, :, :s] = codes
                scale[li, rows, :, :s] = t_scale[..., 0]
        else:  # index_put (slots) does not cast: a float32 run's bf16 cache
            cache.k[li, rows, :, :s] = k.to(cache.k.dtype)
            cache.v[li, rows, :, :s] = v.to(cache.v.dtype)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = (prompt_len.long() - 1).clamp(min=0)
    x_last = x[torch.arange(b, device=x.device), last]
    logits = _lm_head_logits(x_last, params["lm_head"], tp)
    length = prompt_len.to(torch.int32)
    if slots is not None:
        length = cache.length.clone()
        length[rows] = prompt_len.to(torch.int32)
    return logits, dataclasses.replace(cache, length=length)


# float32 elements of one group's (b, H, W, S) attention scores in
# `llama_prefill_continue`: rows of the batch are attended in groups that
# stay under it (a 512-wide chunk over 2304 rows at H32 is 38M a row)
_CONTINUE_SCORES = 1 << 27


def _continue_attention(q, kc, vc, ks, vs, causal, sm: float):
    """Attention of q (b, H, W, hd) over whole cache rows kc / vc (b, H, S,
    hd; int8 codes with ks / vs (b, H, S) float32 scales, or None), masked
    by causal (b, W, S): float32 scores of compute-dtype operands, the
    int8 scales folded into the scores and the probabilities as JAX's
    `llama_prefill_continue` folds them, probabilities rounded to the
    compute dtype before the product with V."""
    b, h, w, _ = q.shape
    per_row = h * w * kc.shape[2]
    g = max(1, _CONTINUE_SCORES // per_row)
    out = []
    for r in range(0, b, g):
        rows = slice(r, r + g)
        scores = torch.matmul(q[rows].float(), kc[rows].to(q.dtype).float()
                              .transpose(-1, -2)) * sm
        if ks is not None:
            scores = scores * ks[rows, :, None, :]
        scores = scores.masked_fill(~causal[rows, None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        if vs is not None:
            probs = probs * vs[rows, :, None, :]
        out.append(torch.matmul(probs.to(q.dtype), vc[rows].to(q.dtype)))
    return torch.cat(out)


def _suffix_writes(positions: torch.Tensor, suffix_len: torch.Tensor,
                   s_max: int):
    """Where each suffix column's K/V row goes, without a host sync: column
    i of a row writes the row of column min(i, suffix_len - 1) at that
    column's position. The valid columns land at their positions; a padded
    column repeats the row's last valid write (equal values at one index,
    so the duplicate writes agree) and a row with suffix 0 rewrites what
    its cache holds at `start`. Returns (source column (b, W), cache
    position (b, W), has-a-suffix (b,))."""
    w = positions.shape[1]
    last = (suffix_len - 1).clamp(min=0)
    col = torch.minimum(torch.arange(w, device=positions.device)[None, :],
                        last[:, None])
    pos = positions.gather(1, col).clamp(max=s_max - 1)
    return col, pos, suffix_len > 0


def llama_prefill_continue(params, cfg: LlamaConfig, cache: KVCache, *,
                           inputs_embeds: torch.Tensor,
                           suffix_len: torch.Tensor, start: torch.Tensor,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           return_all_logits: bool = False, tp=None
                           ) -> Tuple[torch.Tensor, KVCache]:
    """Extend a filled cache by a suffix (JAX `llama_prefill_continue`):
    inputs_embeds (B, W, D) right-padded suffix embeddings, suffix_len (B,)
    valid suffix tokens, start (B,) tokens already in the cache. RoPE takes
    the global positions start + i; each layer writes the valid suffix
    rows at those positions in place (padded columns write nothing; a row
    of suffix 0 writes nothing), quantized through `quantize_activation`
    for an int8 cache with the scales written before the attention, then
    attends over the whole cache row masked to columns <= start + i.
    Returns (float32 logits: (B, V) at each row's last valid column, or
    (B, W, V) with `return_all_logits`, the speculative verify window's;
    the cache with length start + suffix_len)."""
    x = inputs_embeds.to(compute_dtype)
    b, w, _ = x.shape
    dev = x.device
    s_max = cache.k.shape[3]
    width = _heads(cfg, tp) * cfg.head_dim
    start = start.to(dev).long()
    suffix_len = suffix_len.to(dev).long()
    positions = start[:, None] + torch.arange(w, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    col, pos, has = _suffix_writes(positions, suffix_len, s_max)
    rows_b = torch.arange(b, device=dev)[:, None]
    causal = (torch.arange(s_max, device=dev)[None, None, :]
              <= positions[:, :, None])  # (B, W, S)
    sm = 1.0 / math.sqrt(cfg.head_dim)

    def write(arr, li, rows):  # rows (B, W, H[, d]) at (col, pos)
        keep = arr[li, rows_b, :, pos]
        arr[li, rows_b, :, pos] = torch.where(
            has.view((b,) + (1,) * (keep.dim() - 1)),
            rows[rows_b, col].to(arr.dtype), keep)

    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin, tp)  # (B, H, W, hd)
        k_rows, v_rows = k.transpose(1, 2), v.transpose(1, 2)  # (B, W, H, d)
        if cache.quantized:
            for arr, scale, t in ((cache.k, cache.k_scale, k_rows),
                                  (cache.v, cache.v_scale, v_rows)):
                codes, t_scale = quantize_activation(t)
                write(arr, li, codes)
                write(scale, li, t_scale[..., 0])
            attn = _continue_attention(q, cache.k[li], cache.v[li],
                                       cache.k_scale[li], cache.v_scale[li],
                                       causal, sm)
        else:
            write(cache.k, li, k_rows)
            write(cache.v, li, v_rows)
            attn = _continue_attention(q, cache.k[li], cache.v[li], None,
                                       None, causal, sm)
        attn = attn.transpose(1, 2).reshape(b, w, width)
        x = x + _proj(lp, "wo", attn, tp)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if return_all_logits:
        logits = _lm_head_logits(x, params["lm_head"], tp)
    else:
        last = (suffix_len - 1).clamp(min=0)
        logits = _lm_head_logits(x[torch.arange(b, device=dev), last],
                                 params["lm_head"], tp)
    return logits, dataclasses.replace(
        cache, length=(start + suffix_len).to(torch.int32))


def _block_full(x: torch.Tensor, lp, cfg: LlamaConfig, cos, sin,
                kv_mask: Optional[torch.Tensor],
                segment_ids: Optional[torch.Tensor], tp=None,
                cp_axis=None) -> torch.Tensor:
    """Full-sequence causal block (training / cacheless forward). With
    `segment_ids` (B, S) the attention is block-diagonal: i attends j iff
    seg[i] == seg[j] != 0 and j <= i (`kv_mask` is then not used, as in the
    JAX block); otherwise `kv_mask` masks keys. With `cp_axis` x is this
    rank's chunk of the sequence and `cos` / `sin` / `kv_mask` its global
    positions' and mask's: attention goes through the K/V ring."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q, k, v = _qkv(h, lp, cfg, cos, sin, tp)
    if segment_ids is not None:
        attn = flash_attention(q, k, v, causal=True, segment_ids=segment_ids)
    elif cp_axis is not None:
        attn = ring_attention(q, k, v, kv_mask, axis=cp_axis, causal=True)
    else:
        attn = flash_attention(q, k, v, kv_mask, causal=True)
    attn = attn.transpose(1, 2).reshape(b, s, _heads(cfg, tp) * cfg.head_dim)
    x = x + _proj(lp, "wo", attn, tp)
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _silu_mlp(h2, lp, tp)


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
                remat: bool = False, cp_axis=None,
                segment_ids: Optional[torch.Tensor] = None,
                tp=None) -> torch.Tensor:
    """Cacheless forward -> logits (B, S, V) float32. Positions default to
    cumsum(attention_mask) - 1 clipped at 0 (or arange), and restart at
    every segment with `segment_ids` (sequence packing, block-diagonal
    attention). `remat` recomputes each block in the backward
    (`torch.utils.checkpoint`, non-reentrant). Float parameters are cast to
    the compute dtype on the fly, differentiably; frozen ones should already
    be in it (`core.convert.training_params_from_numpy`). `tp` runs the
    decoder tensor parallel (this rank's slice; the logits gathered
    whole). `cp_axis` (a `parallel.mesh.Axis`, the seq axis of
    `parallel.context.make_cp_mesh`) runs it context parallel: the input
    is this rank's chunk of the sequence, the caller MUST give the chunk's
    global `positions` (the local default would restart RoPE at every
    chunk; `parallel.context.context_parallel_apply` gives them), and the
    logits are the chunk's. Not with `segment_ids` or `tp`."""
    if cp_axis is not None:
        if positions is None:
            raise ValueError("context parallelism needs the chunk's global "
                             "positions")
        if segment_ids is not None or tp is not None:
            raise ValueError("context parallelism does not compose with "
                             "sequence packing or tensor parallelism")
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
                segment_ids, tp, cp_axis, use_reentrant=False)
        else:
            x = _block_full(x, lp, cfg, cos, sin, attention_mask,
                            segment_ids, tp, cp_axis)
    x = rms_norm(x, _cast(params["final_norm"], compute_dtype),
                 cfg.rms_norm_eps)
    return _lm_head_logits(x, _cast(params["lm_head"], compute_dtype), tp)


def _cast(t, dtype):
    """A float tensor in `dtype` (differentiable); a QuantizedTensor as is."""
    if isinstance(t, QuantizedTensor) or t.dtype == dtype:
        return t
    return t.to(dtype)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   data=None) -> torch.Tensor:
    """Shifted cross-entropy in float32, IGNORE_INDEX masked, mean over the
    valid tokens (at least 1). With `data` (the mesh's data axis) the
    count is the whole data group's, so the sum over the group of each
    rank's loss (and of its gradients) is the mean over the global batch,
    as JAX's one loss over the sharded batch is, whatever the ranks'
    counts."""
    return token_lm_loss(logits[:, :-1, :], labels[:, 1:],
                         axes=() if data is None else (data,))


def token_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                  axes=()) -> torch.Tensor:
    """Cross-entropy of `logits` (B, S, V) against `targets` (B, S) at the
    same positions (already shifted), in float32, IGNORE_INDEX masked:
    the sum over the valid targets divided by their count (at least 1),
    counted over the ranks of every `parallel.mesh.Axis` in `axes`."""
    logits = logits.float()
    targets = targets.long()
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    count = valid.sum()
    for axis in axes:
        count = axis.all_reduce(count.float()).to(count.dtype)
    return nll.sum() / count.clamp(min=1)


def llama_decode_step(params, cfg: LlamaConfig, cache: KVCache, *,
                      inputs_embeds: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      int8_dots: Optional[bool] = None, tp=None
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
    width = _heads(cfg, tp) * cfg.head_dim
    cos, sin = rope_cos_sin(cache.length[:, None], cfg.head_dim,
                            cfg.rope_theta)
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li, w4a8=True)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin, tp)  # (B, H, 1, hd)
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
        attn = attn.transpose(1, 2).reshape(b, 1, width)
        x = x + _proj(lp, "wo", attn, tp)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp, tp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _lm_head_logits(x[:, 0, :], params["lm_head"], tp)
    return logits, dataclasses.replace(cache, length=cache.length + 1)
