"""Fused decode step: KV-cache append + single-query attention.

Counterpart of `lhrs_bot_tpu/ops/fused_decode.py` `fused_decode_attention`
(bf16/f32 caches) and `fused_decode_attention_q` (int8 caches with float32
scale planes (L, B, H, S_max)). One call writes the new token's K/V row of
`layer` (and, for int8, its two scales) at row lengths[b] of the stacked
(L, B, H, S_max, D) cache IN PLACE, then attends the query over the
lengths[b] + 1 valid rows.

`fused_decode_attention` and `fused_decode_attention_q` are the entry
points. CPU tensors take the plain versions (`_write_at` [+
`_write_scale_at`] + `decode_attention`, or, with `int8_dots`, the blockwise
int8-dot attention of `fused_decode_attention_q_int8dots_plain`); CUDA
tensors always take the hand-written kernels (csrc/fused_decode.cu,
csrc/fused_decode_q.cu), which read `lengths` on the device, so a decode
step never waits on the host. There is no fallback: what a kernel does not
take raises.

`int8_dots=None` reads `LHRS_DECODE_INT8_DOTS` at every call ("1" turns it
on), as the JAX package resolves it outside its jit; with no jit here, a
change of the variable takes effect at the next call.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from . import cuda_lib
from .decode_attention import _NEG_INF, decode_attention
from .ln_quant import div_exact


def _write_at(cache_arr: torch.Tensor, new_vals: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Write (B, H, 1, D) new_vals into (B, H, S, D) cache_arr at per-row
    positions `lengths`, in place; returns cache_arr."""
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[rows, :, lengths.long()] = new_vals[:, :, 0].to(cache_arr.dtype)
    return cache_arr


def _write_scale_at(scale_arr: torch.Tensor, new_vals: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Write (B, H, 1) new scales into (B, H, S) scale_arr at per-row
    positions `lengths`, in place; returns scale_arr."""
    rows = torch.arange(scale_arr.shape[0], device=scale_arr.device)
    scale_arr[rows, :, lengths.long()] = new_vals[:, :, 0].to(
        scale_arr.dtype)
    return scale_arr


def fused_decode_attention_plain(q, k_new, v_new, k_cache, v_cache, lengths,
                                 layer: int, *,
                                 sm_scale: Optional[float] = None):
    """The plain version: `_write_at` on the layer's cache view (in place),
    then `decode_attention` over lengths + 1 rows."""
    kl = _write_at(k_cache[layer], k_new, lengths)
    vl = _write_at(v_cache[layer], v_new, lengths)
    out = decode_attention(q, kl, vl, lengths + 1, sm_scale=sm_scale)
    return out, k_cache, v_cache


def fused_decode_attention_kernel(q, k_new, v_new, k_cache, v_cache, lengths,
                                  layer: int, sm_scale: float):
    """Launch the CUDA fused decode kernel. Takes contiguous bf16 CUDA
    tensors (D 64 or 128) and int32 lengths on the same device; raises on
    anything else. Counts its launches in
    `fused_decode_attention_kernel.launches`."""
    tensors = (q, k_new, v_new, k_cache, v_cache, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("fused_decode_attention_kernel takes CUDA tensors "
                         "on one device")
    if not all(t.dtype == torch.bfloat16 for t in tensors[:5]):
        raise ValueError("fused_decode_attention_kernel takes bf16 q, k/v "
                         "rows and caches")
    if lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32")
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError("caches must be (L, B, H, S, D) and alike")
    nl, b, h, s, d = k_cache.shape
    if d not in (64, 128) or lengths.shape != (b,):
        raise ValueError(f"bad cache {tuple(k_cache.shape)} or lengths "
                         f"{tuple(lengths.shape)}; D must be 64 or 128")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.shape != (b, h, 1, d):
            raise ValueError(f"{name} must be {(b, h, 1, d)}, got "
                             f"{tuple(t.shape)}")
    for name, t in zip(("q", "k_new", "v_new", "k_cache", "v_cache",
                        "lengths"), tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} out of range [0, {nl})")
    lib = cuda_lib.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_fused_decode_bf16(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), int(layer), nl, b, h, s, d, float(sm_scale),
            stream)
    cuda_lib.check(err, "fused_decode_attention_kernel")
    fused_decode_attention_kernel.launches += 1
    return out, k_cache, v_cache


fused_decode_attention_kernel.launches = 0


def fused_decode_attention(
    q: torch.Tensor,        # (B, H, 1, D) current query
    k_new: torch.Tensor,    # (B, H, 1, D) this step's key
    v_new: torch.Tensor,    # (B, H, 1, D) this step's value
    k_cache: torch.Tensor,  # (L, B, H, S, D), updated in place
    v_cache: torch.Tensor,  # (L, B, H, S, D), updated in place
    lengths: torch.Tensor,  # (B,) int32 valid entries before the append
    layer: int,
    *,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out (B, H, 1, D), k_cache, v_cache); the caches are the
    same tensors, updated in place. A row with lengths[b] >= S has no room
    for the append (callers clamp generation to the cache, as the engine
    does): the CUDA kernel then writes nothing and returns NaN for the row,
    the plain version raises an IndexError."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return fused_decode_attention_kernel(q, k_new, v_new, k_cache,
                                             v_cache, lengths, layer,
                                             sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no decode-attention path for device {q.device}")
    return fused_decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                        lengths, layer, sm_scale=sm_scale)


def fused_decode_attention_q_plain(q, k_new, k_new_scale, v_new, v_new_scale,
                                   k_cache, v_cache, k_scale, v_scale,
                                   lengths, layer: int, *,
                                   sm_scale: Optional[float] = None):
    """The plain version: `_write_at` of the int8 rows and `_write_scale_at`
    of their scales on the layer's views (in place), then `decode_attention`
    with the scale planes over lengths + 1 rows."""
    kl = _write_at(k_cache[layer], k_new, lengths)
    vl = _write_at(v_cache[layer], v_new, lengths)
    ksl = _write_scale_at(k_scale[layer], k_new_scale, lengths)
    vsl = _write_scale_at(v_scale[layer], v_new_scale, lengths)
    out = decode_attention(q, kl, vl, lengths + 1, sm_scale=sm_scale,
                           k_scale=ksl, v_scale=vsl)
    return out, k_cache, v_cache, k_scale, v_scale


def fused_decode_attention_q_kernel(q, k_new, k_new_scale, v_new,
                                    v_new_scale, k_cache, v_cache, k_scale,
                                    v_scale, lengths, layer: int,
                                    sm_scale: float):
    """Launch the CUDA int8-cache fused decode kernel. Takes contiguous
    CUDA tensors on one device: bf16 q (B, H, 1, D) with D 64 or 128, int8
    k/v rows (B, H, 1, D) and caches (L, B, H, S, D), float32 row scales
    (B, H, 1) and scale planes (L, B, H, S), int32 lengths (B,). Raises on
    anything else. Counts its launches in
    `fused_decode_attention_q_kernel.launches`."""
    return _launch_q(q, k_new, k_new_scale, v_new, v_new_scale, k_cache,
                     v_cache, k_scale, v_scale, lengths, layer, sm_scale, 0,
                     fused_decode_attention_q_kernel)


def _launch_q(q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache,
              k_scale, v_scale, lengths, layer, sm_scale, block_s, wrapper):
    """Check the int8-cache kernels' inputs and launch one of them: the
    bf16-dot kernel for block_s 0, the int8-dot kernel otherwise; count the
    launch on `wrapper`."""
    names = ("q", "k_new", "k_new_scale", "v_new", "v_new_scale", "k_cache",
             "v_cache", "k_scale", "v_scale", "lengths")
    tensors = (q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache,
               k_scale, v_scale, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("fused_decode_attention_q_kernel takes CUDA tensors "
                         "on one device")
    want = (torch.bfloat16, torch.int8, torch.float32, torch.int8,
            torch.float32, torch.int8, torch.int8, torch.float32,
            torch.float32, torch.int32)
    for name, t, dt in zip(names, tensors, want):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError("caches must be (L, B, H, S, D) and alike")
    nl, b, h, s, d = k_cache.shape
    if d not in (64, 128) or lengths.shape != (b,):
        raise ValueError(f"bad cache {tuple(k_cache.shape)} or lengths "
                         f"{tuple(lengths.shape)}; D must be 64 or 128")
    for name, t, shape in (("q", q, (b, h, 1, d)), ("k_new", k_new,
                                                    (b, h, 1, d)),
                           ("v_new", v_new, (b, h, 1, d)),
                           ("k_new_scale", k_new_scale, (b, h, 1)),
                           ("v_new_scale", v_new_scale, (b, h, 1)),
                           ("k_scale", k_scale, (nl, b, h, s)),
                           ("v_scale", v_scale, (nl, b, h, s))):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in zip(names, tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} out of range [0, {nl})")
    lib = cuda_lib.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if block_s:
            err = lib.lhrs_fused_decode_q_int8dots(
                *(t.data_ptr() for t in tensors), out.data_ptr(),
                int(layer), nl, b, h, s, d, float(sm_scale), int(block_s),
                stream)
        else:
            err = lib.lhrs_fused_decode_q(
                *(t.data_ptr() for t in tensors), out.data_ptr(),
                int(layer), nl, b, h, s, d, float(sm_scale), stream)
    cuda_lib.check(err, wrapper.__name__)
    wrapper.launches += 1
    return out, k_cache, v_cache, k_scale, v_scale


fused_decode_attention_q_kernel.launches = 0


def _exact_int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8 codes, exact (float64 holds every int32 sum here), as
    float32: the int32 dot's conversion."""
    return torch.matmul(a.double(), b.double()).float()


def int8_dots_attention(q, kl, vl, ksl, vsl, n_valid, *, sm_scale: float,
                        block_s: int) -> torch.Tensor:
    """Attention of q (B, H, 1, D) over the first n_valid[b] rows of the
    int8 (B, H, S, D) caches with scale planes (B, H, S), both dots on the
    codes, in the order of `_kernel_q`'s `int8_dots` branch
    (lhrs_bot_tpu/ops/fused_decode.py:332-336, :374-379, :417-426): q *
    sm_scale quantized per head in float32; per `block_s` block the scores
    (q codes . K codes) * q scale * k scale, the online max, p = exp(s - m),
    p * v scale quantized per head over the block, (p codes . V codes) * p
    scale into the accumulator; the denominator sums the float p. A block
    past a row's n_valid is masked whole and leaves its state unchanged."""
    b, h, s, d = kl.shape
    block_s = min(block_s, s)
    qf = q.float()[:, :, 0, :] * sm_scale                       # (B, H, D)
    q_qscale = div_exact(qf.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    q_i8 = torch.round(qf / q_qscale)
    m = torch.full((b, h, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    nb = -(-int(n_valid.max()) // block_s)
    for i in range(nb):
        cols = slice(i * block_s, min((i + 1) * block_s, s))
        pos = torch.arange(cols.start, cols.stop, device=q.device)
        valid = pos[None, None, :] < n_valid.long()[:, None, None]
        sc = _exact_int_dot(q_i8[:, :, None, :],
                            kl[:, :, cols].transpose(-1, -2))[:, :, 0]
        sc = sc * q_qscale * ksl[:, :, cols]
        sc = torch.where(valid, sc, torch.full_like(sc, _NEG_INF))
        new_m = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - new_m)
        p = torch.exp(sc - new_m)
        ps = p * vsl[:, :, cols]
        p_qscale = div_exact(ps.abs().amax(dim=-1, keepdim=True),
                             127.0) + 1e-12
        p_i8 = torch.round(ps / p_qscale)
        pv = _exact_int_dot(p_i8[:, :, None, :], vl[:, :, cols])[:, :, 0]
        acc = acc * alpha + pv * p_qscale
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = new_m
    return (acc / l)[:, :, None, :].to(q.dtype)


def fused_decode_attention_q_int8dots_plain(
        q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache, k_scale,
        v_scale, lengths, layer: int, *, sm_scale: Optional[float] = None,
        block_s: int = 512):
    """The plain version of `int8_dots=True`: the appends of
    `fused_decode_attention_q_plain` (in place), then
    `int8_dots_attention` over lengths + 1 rows."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kl = _write_at(k_cache[layer], k_new, lengths)
    vl = _write_at(v_cache[layer], v_new, lengths)
    ksl = _write_scale_at(k_scale[layer], k_new_scale, lengths)
    vsl = _write_scale_at(v_scale[layer], v_new_scale, lengths)
    out = int8_dots_attention(q, kl, vl, ksl, vsl, lengths + 1,
                              sm_scale=sm_scale, block_s=block_s)
    return out, k_cache, v_cache, k_scale, v_scale


# Shared memory of the int8-dots kernel bounds its block (a float score and
# an int8 code for each of its rows).
MAX_BLOCK_S = 4096


def fused_decode_attention_q_int8dots_kernel(
        q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache, k_scale,
        v_scale, lengths, layer: int, sm_scale: float, block_s: int = 512):
    """Launch the CUDA int8-dots variant of the int8-cache fused decode
    kernel (`fused_decode_attention_q_kernel`'s inputs, plus `block_s`,
    clamped to S as in the JAX package, at most MAX_BLOCK_S). Counts its
    launches in `fused_decode_attention_q_int8dots_kernel.launches`, apart
    from the bf16-dot kernel's."""
    block_s = int(block_s)
    if k_cache.dim() == 5:
        block_s = min(block_s, k_cache.shape[3])
    if not 1 <= block_s <= MAX_BLOCK_S:
        raise ValueError(f"block_s must lie in [1, {MAX_BLOCK_S}] after "
                         f"clamping to S, got {block_s}")
    return _launch_q(q, k_new, k_new_scale, v_new, v_new_scale, k_cache,
                     v_cache, k_scale, v_scale, lengths, layer, sm_scale,
                     block_s, fused_decode_attention_q_int8dots_kernel)


fused_decode_attention_q_int8dots_kernel.launches = 0


def fused_decode_attention_q(
    q: torch.Tensor,            # (B, H, 1, D) current query
    k_new: torch.Tensor,        # (B, H, 1, D) int8 key codes
    k_new_scale: torch.Tensor,  # (B, H, 1) float32
    v_new: torch.Tensor,        # (B, H, 1, D) int8 value codes
    v_new_scale: torch.Tensor,  # (B, H, 1) float32
    k_cache: torch.Tensor,      # (L, B, H, S, D) int8, updated in place
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,      # (L, B, H, S) float32, updated in place
    v_scale: torch.Tensor,
    lengths: torch.Tensor,      # (B,) int32 valid entries before the append
    layer: int,
    *,
    int8_dots: Optional[bool] = None,
    block_s: int = 512,
    sm_scale: Optional[float] = None,
):
    """int8-cache fused append + attention. Returns (attn_out (B, H, 1, D),
    k_cache, v_cache, k_scale, v_scale); the caches and planes are the same
    tensors, updated in place. `int8_dots=True` runs both dots on the int8
    bytes, with q and each `block_s` block's probability row quantized to
    int8 (`block_s` is part of the result: the row's scale is taken per
    block); None reads LHRS_DECODE_INT8_DOTS now. A row with lengths[b] >= S
    behaves as in `fused_decode_attention`: the CUDA kernel writes nothing
    and returns NaN for it, the plain version raises an IndexError."""
    if int8_dots is None:
        int8_dots = os.environ.get("LHRS_DECODE_INT8_DOTS", "0") == "1"
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    args = (q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache,
            k_scale, v_scale, lengths, layer)
    if q.is_cuda:
        if int8_dots:
            return fused_decode_attention_q_int8dots_kernel(
                *args, sm_scale, block_s)
        return fused_decode_attention_q_kernel(*args, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no decode-attention path for device {q.device}")
    if int8_dots:
        return fused_decode_attention_q_int8dots_plain(
            *args, sm_scale=sm_scale, block_s=block_s)
    return fused_decode_attention_q_plain(*args, sm_scale=sm_scale)
