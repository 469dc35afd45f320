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

K2 and K4 (the bf16-dot kernel of the int8 cache) split each head's rows
across a thread-block cluster of C CTAs in one launch
(csrc/decode_split.cuh); `decode_split_plan` picks C per shape, and
`decode_shares` / `split_decode_attention_plain` are the plain picture of
the split and its merge, for the tests and the card's checks. The int8-dots
kernel (5b) splits each `block_s` block's rows across its cluster instead
(`int8dots_split_plan`; plain picture `int8_dots_attention_split`).

`int8_dots=None` reads `LHRS_DECODE_INT8_DOTS` at every call ("1" turns it
on), as the JAX package resolves it outside its jit; with no jit here, a
change of the variable takes effect at the next call.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Optional, Tuple

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


# A CTA's share of a head's rows starts at a multiple of SPLIT_ROWS (the 32
# key groups times 4 keys of the one-CTA walk), so key j stays in group
# j % 32 whatever the split.
SPLIT_ROWS = 128
SPLITS = (8, 4, 2, 1)  # the cluster sizes the kernels take
# The sizes the plan picks from, the largest first. On the H100 (PERF.md
# section 6) 2 beat 4 and 8 for K2 and K4 at B = 1 and 2 with 32
# heads: a GPC holds fewer clusters of 4 or 8 than its SMs would allow (62
# of 4 and 30 of 8 resident, not 66 and 33), so 32 clusters of 8 take two
# waves and 4-CTA clusters share SMs.
PLAN_SPLITS = (2, 1)
# Per CTA of the split kernels (csrc/decode_split.cuh `Layout`): a ring of
# 3 stages of 16 KB of K rows and 16 KB of V rows (and 4 bytes a row of
# each scale plane for int8), the ranks' folded states, the new rows and
# a row of zeros, the barriers.
_STAGES, _STAGE_BYTES = 3, 16384
# An SM's shared memory, what each CTA reserves of it, and the CTAs its
# registers hold (288 threads held to 112 registers: 2 CTAs)
_SM_SHARED, _CTA_RESERVED, _REGISTER_CTAS = 233472, 1024, 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Page-table entries of one row that the paged split kernel stages (4
# bytes each, csrc/decode_split.cuh kMaxPages)
MAX_PAGES = 2048


def decode_smem_bytes(d: int, elt: int, paged: bool = False) -> int:
    """Shared memory of one CTA of the split kernel for head dim d and
    cache elements of elt bytes (2: bf16, 1: int8 with scales); `paged`:
    the paged int8 kernel, which also stages a row's page ids."""
    row = d * elt
    scales = 2 * (_STAGE_BYTES // row) * 4 if elt == 1 else 0
    return (_STAGES * (2 * _STAGE_BYTES + scales) + max(SPLITS) * (d + 4) * 4
            + 3 * row + 16 + 2 * _STAGES * 8 + (4 * MAX_PAGES if paged
                                                 else 0))


def _resident(smem: int, sm_count: int) -> int:
    """CTAs of `smem` bytes of shared memory (288 threads) that `sm_count`
    SMs hold at once, by shared memory and registers."""
    per_sm = min(_REGISTER_CTAS, _SM_SHARED // (smem + _CTA_RESERVED))
    return per_sm * sm_count


def decode_resident_ctas(d: int, elt: int, sm_count: int) -> int:
    """CTAs of the split kernel that `sm_count` SMs hold at once, by its
    shared memory and registers."""
    return _resident(decode_smem_bytes(d, elt), sm_count)


@functools.lru_cache(maxsize=None)
def decode_split_plan(b: int, h: int, s: int, d: int, elt: int,
                      sm_count: int) -> int:
    """C, the CTAs of a cluster that split each (b, h)'s rows: 1 wherever
    B * H alone reaches the SM count, else the largest of PLAN_SPLITS whose
    B * H * C CTAs are all resident at once (one wave) and that is no more
    than S's SPLIT_ROWS blocks. Cached per shape."""
    if min(b, h, s, sm_count) <= 0 or d not in (64, 128) or elt not in (1, 2):
        raise ValueError(f"bad decode shape B{b} H{h} S{s} D{d} elt {elt} "
                         f"on {sm_count} SMs")
    if b * h >= sm_count:
        return 1
    for c in PLAN_SPLITS:
        if (c * b * h <= decode_resident_ctas(d, elt, sm_count)
                and c <= _cdiv(s, SPLIT_ROWS)):
            return c
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_launch_splits(device, b: int, h: int, s: int, d: int,
                         elt: int) -> int:
    """The C that the kernel wrappers launch with on the card `device`:
    `decode_split_plan` at its SM count, read once."""
    idx = torch.device(device).index
    return decode_split_plan(b, h, s, d, elt,
                             _sm_count(0 if idx is None else idx))


def decode_shares(n_valid: int, splits: int) -> List[Tuple[int, int]]:
    """Rows [start, end) of each rank of a cluster of `splits` CTAs over a
    head's n_valid rows, as the kernels take them on the device: whole
    SPLIT_ROWS blocks, as many for every rank (the last non-empty one may
    end early, trailing ones may be empty)."""
    share = _cdiv(_cdiv(n_valid, SPLIT_ROWS), splits) * SPLIT_ROWS
    return [(min(r * share, n_valid), min((r + 1) * share, n_valid))
            for r in range(splits)]


# the kernels' key groups: 8 lanes a key, 256 threads
_GROUPS = 32


def split_decode_attention_plain(q, kl, vl, lengths, splits: int, *,
                                 sm_scale: float, k_scale=None, v_scale=None,
                                 fault: int = 0) -> torch.Tensor:
    """The split kernels' softmax in plain float32: q (B, H, 1, D) over the
    first lengths[b] + 1 rows of the (already appended) layer views kl, vl
    (B, H, S, D), with the int8 cache's (B, H, S) scale planes if given.
    Row j of rank r's share (`decode_shares`) goes to state r * 32 + j % 32;
    each state keeps its max, sum and accumulator; each rank folds its 32
    states, then rank 0 folds the ranks' in order. fault=1 leaves the last
    rank out, as the kernels' planted fault does. Used by the tests and the
    card's checks; returns float32 (B, H, 1, D)."""
    b, h, _, d = kl.shape
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    qf = q.float()[:, :, 0] * sm_scale                         # (B, H, D)
    for bi in range(b):
        n = int(lengths[bi]) + 1
        share = decode_shares(n, splits)[0][1]
        rows = torch.arange(n, device=q.device)
        state = (rows // share) * _GROUPS + rows % _GROUPS    # (n,)
        ns = splits * _GROUPS
        sc = torch.einsum("hd,hnd->hn", qf[bi], kl[bi, :, :n].float())
        if k_scale is not None:
            sc = sc * k_scale[bi, :, :n].float()
        m = torch.full((h, ns), _NEG_INF, device=q.device).scatter_reduce(
            1, state.expand(h, n), sc, "amax")
        p = torch.exp(sc - m[:, state])
        pw = p * v_scale[bi, :, :n].float() if v_scale is not None else p
        l = torch.zeros(h, ns, device=q.device).index_add(1, state, p)
        acc = torch.zeros(h, ns, d, device=q.device).index_add(
            1, state, pw[..., None] * vl[bi, :, :n].float())
        m = m.view(h, splits, _GROUPS)
        mx = m.amax(-1)                                        # (H, C)
        w = torch.exp(m - mx[..., None])
        den = (l.view(h, splits, _GROUPS) * w).sum(-1)
        num = (acc.view(h, splits, _GROUPS, d) * w[..., None]).sum(-2)
        if fault == 1 and splits > 1:
            mx, den, num = mx[:, :-1], den[:, :-1], num[:, :-1]
        w = torch.exp(mx - mx.amax(-1, keepdim=True))
        out[bi] = (num * w[..., None]).sum(1) / (den * w).sum(1)[..., None]
    return out[:, :, None, :]


def fused_decode_attention_split_plain(q, k_new, v_new, k_cache, v_cache,
                                       lengths, layer: int, *, splits: int,
                                       sm_scale: Optional[float] = None,
                                       fault: int = 0):
    """`fused_decode_attention_plain` with the attention of
    `split_decode_attention_plain` (float32 output)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kl = _write_at(k_cache[layer], k_new, lengths)
    vl = _write_at(v_cache[layer], v_new, lengths)
    out = split_decode_attention_plain(q, kl, vl, lengths, splits,
                                       sm_scale=sm_scale, fault=fault)
    return out, k_cache, v_cache


def fused_decode_attention_q_split_plain(q, k_new, k_new_scale, v_new,
                                         v_new_scale, k_cache, v_cache,
                                         k_scale, v_scale, lengths,
                                         layer: int, *, splits: int,
                                         sm_scale: Optional[float] = None,
                                         fault: int = 0):
    """`fused_decode_attention_q_plain` with the attention of
    `split_decode_attention_plain` (float32 output)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kl = _write_at(k_cache[layer], k_new, lengths)
    vl = _write_at(v_cache[layer], v_new, lengths)
    ksl = _write_scale_at(k_scale[layer], k_new_scale, lengths)
    vsl = _write_scale_at(v_scale[layer], v_new_scale, lengths)
    out = split_decode_attention_plain(q, kl, vl, lengths, splits,
                                       sm_scale=sm_scale, k_scale=ksl,
                                       v_scale=vsl, fault=fault)
    return out, k_cache, v_cache, k_scale, v_scale


def _check_splits(splits: Optional[int]) -> None:
    if splits is not None and splits not in SPLITS:
        raise ValueError(f"splits must be one of {sorted(SPLITS)}, got "
                         f"{splits}")


def decode_max_clusters(d: int, splits: int, *, int8: bool) -> int:
    """How many clusters of `splits` CTAs of K4 (int8) or K2 can be
    resident on the current card at once (`cudaOccupancyMaxActiveClusters`)."""
    import ctypes

    _check_splits(splits)
    count = ctypes.c_int(0)
    lib = cuda_lib.load_library()
    fn = (lib.lhrs_fused_decode_q_max_clusters if int8 else
          lib.lhrs_fused_decode_bf16_max_clusters)
    cuda_lib.check(fn(int(d), int(splits), ctypes.addressof(count)),
                   "decode_max_clusters")
    return count.value


def fused_decode_attention_kernel(q, k_new, v_new, k_cache, v_cache, lengths,
                                  layer: int, sm_scale: float, *,
                                  splits: Optional[int] = None,
                                  fault: int = 0):
    """Launch the CUDA fused decode kernel (K2). Takes contiguous bf16 CUDA
    tensors (D 64 or 128) and int32 lengths on the same device; raises on
    anything else. `splits` forces the cluster size that
    `decode_launch_splits` picks (for the card's checks and the A/B);
    `fault` plants an error for a check. Counts its launches in
    `fused_decode_attention_kernel.launches`."""
    _check_splits(splits)
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
    splits = splits or decode_launch_splits(q.device, b, h, s, d, 2)
    lib = cuda_lib.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_fused_decode_bf16(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), int(layer), nl, b, h, s, d, float(sm_scale),
            int(splits), int(fault), stream)
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
                                    sm_scale: float, *,
                                    splits: Optional[int] = None,
                                    fault: int = 0):
    """Launch the CUDA int8-cache fused decode kernel (K4). Takes contiguous
    CUDA tensors on one device: bf16 q (B, H, 1, D) with D 64 or 128, int8
    k/v rows (B, H, 1, D) and caches (L, B, H, S, D), float32 row scales
    (B, H, 1) and scale planes (L, B, H, S), int32 lengths (B,). Raises on
    anything else. `splits` and `fault` as in
    `fused_decode_attention_kernel`. Counts its launches in
    `fused_decode_attention_q_kernel.launches`."""
    _check_splits(splits)
    return _launch_q(q, k_new, k_new_scale, v_new, v_new_scale, k_cache,
                     v_cache, k_scale, v_scale, lengths, layer, sm_scale, 0,
                     fused_decode_attention_q_kernel, splits, fault)


def _launch_q(q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache,
              k_scale, v_scale, lengths, layer, sm_scale, block_s, wrapper,
              splits=None, fault=0):
    """Check the int8-cache kernels' inputs and launch one of them: the
    split bf16-dot kernel for block_s 0, the int8-dot kernel otherwise,
    each with `splits` CTAs a head (or its plan's); count the launch on
    `wrapper`."""
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
            splits = splits or int8dots_launch_splits(q.device, b, h, s, d,
                                                      block_s)
            err = lib.lhrs_fused_decode_q_int8dots(
                *(t.data_ptr() for t in tensors), out.data_ptr(),
                int(layer), nl, b, h, s, d, float(sm_scale), int(block_s),
                int(splits), int(fault), stream)
        else:
            splits = splits or decode_launch_splits(q.device, b, h, s, d, 1)
            err = lib.lhrs_fused_decode_q(
                *(t.data_ptr() for t in tensors), out.data_ptr(),
                int(layer), nl, b, h, s, d, float(sm_scale), int(splits),
                int(fault), stream)
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


def int8dots_parts(rows: int, splits: int) -> List[Tuple[int, int]]:
    """Rows [start, end) of a block of `rows` rows that each rank of the
    int8-dots kernel's cluster takes: ceil(rows / splits) rounded up to 4
    rows each (the P.V quads, 16 bytes of scales), trailing ranks possibly
    empty."""
    part = _cdiv(_cdiv(rows, splits), 4) * 4
    return [(min(r * part, rows), min((r + 1) * part, rows))
            for r in range(splits)]


def int8_dots_attention_split(q, kl, vl, ksl, vsl, n_valid, *,
                              sm_scale: float, block_s: int, splits: int,
                              fault: int = 0,
                              trace: Optional[dict] = None) -> torch.Tensor:
    """`int8_dots_attention` as the int8-dots kernel computes it on a
    cluster of `splits` CTAs: each `block_s` block of a row's n_valid[b]
    rows cut into `int8dots_parts`; the block max, the p scale (absmax of p
    * v scale) and the sum of p over every part; each part's int32 P.V
    columns summed in rank order (fault=1 leaves the last rank's out, as
    the kernel's planted fault does); the sum of p taken in float64 and
    rounded to float32 once a block, as the kernel takes it. So the q
    codes, p codes, p scales and int32 sums are `int8_dots_attention`'s at
    every C. `trace`, a dict, receives per batch row the q codes and each
    block's p codes and int32 P.V sums (for the tests). Returns (B, H, 1,
    D) in q's dtype."""
    b, h, s, d = kl.shape
    block_s = min(block_s, s)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        n = int(n_valid[bi])
        qf = q[bi, :, 0].float() * sm_scale                       # (H, D)
        q_qscale = div_exact(qf.abs().amax(dim=-1, keepdim=True),
                             127.0) + 1e-12
        q_i8 = torch.round(qf / q_qscale)
        m = torch.full((h, 1), _NEG_INF, device=q.device)
        l = torch.zeros((h, 1), device=q.device)
        acc = torch.zeros((h, d), device=q.device)
        blocks = []
        for start in range(0, n, block_s):
            rows = min(block_s, n - start)
            cols = slice(start, start + rows)
            sc = _exact_int_dot(q_i8[:, None, :],
                                kl[bi, :, cols].transpose(-1, -2))[:, 0]
            sc = sc * q_qscale * ksl[bi, :, cols]
            new_m = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - new_m)
            p = torch.exp(sc - new_m)
            ps = p * vsl[bi, :, cols]
            p_qscale = div_exact(ps.abs().amax(dim=-1, keepdim=True),
                                 127.0) + 1e-12
            p_i8 = torch.round(ps / p_qscale)
            parts = int8dots_parts(rows, splits)
            if fault == 1 and splits > 1:
                parts = parts[:-1]
            pv = torch.zeros((h, d), dtype=torch.int64, device=q.device)
            for p0, p1 in parts:
                pv += _exact_int_dot(
                    p_i8[:, None, p0:p1],
                    vl[bi, :, start + p0:start + p1])[:, 0].long()
            acc = acc * alpha + pv.float() * p_qscale
            l = l * alpha + p.double().sum(dim=-1, keepdim=True).float()
            m = new_m
            blocks.append((p_i8.to(torch.int8), pv))
        out[bi] = acc / l
        if trace is not None:
            trace[bi] = {"q_codes": q_i8.to(torch.int8), "blocks": blocks}
    return out[:, :, None, :].to(q.dtype)


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


def fused_decode_attention_q_int8dots_split_plain(
        q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache, k_scale,
        v_scale, lengths, layer: int, *, splits: int,
        sm_scale: Optional[float] = None, block_s: int = 512,
        fault: int = 0):
    """`fused_decode_attention_q_int8dots_plain` with the attention of
    `int8_dots_attention_split` (the card's checks of the kernel's planted
    exchange fault)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    kl = _write_at(k_cache[layer], k_new, lengths)
    vl = _write_at(v_cache[layer], v_new, lengths)
    ksl = _write_scale_at(k_scale[layer], k_new_scale, lengths)
    vsl = _write_scale_at(v_scale[layer], v_new_scale, lengths)
    out = int8_dots_attention_split(q, kl, vl, ksl, vsl, lengths + 1,
                                    sm_scale=sm_scale, block_s=block_s,
                                    splits=splits, fault=fault)
    return out, k_cache, v_cache, k_scale, v_scale


# Shared memory of the int8-dots kernel bounds its block (for each row of a
# rank's part, a float score and a v scale for two blocks and a p code).
MAX_BLOCK_S = 4096
# Per CTA of the int8-dots kernel (csrc/fused_decode_q.cu `int8dots::
# Layout`): a ring of 4 stages (K stages carry both scale rows), the new
# rows, q's codes, the per-warp partials and the ranks' slots (two sets) of
# the three exchanges, the barriers; then two blocks' part scores and v
# scales and one block's part p codes.
_WARPS, _DOTS_STAGES = 8, 4


def int8dots_smem_bytes(d: int, block_s: int, splits: int) -> int:
    """Shared memory of one CTA of the int8-dots kernel for head dim d,
    blocks of block_s rows and clusters of `splits` CTAs."""
    rows = _STAGE_BYTES // d
    fixed = (_DOTS_STAGES * (_STAGE_BYTES + 2 * rows * 4) + 2 * d + 16 + d
             + _WARPS * (4 + 16 + 4 * d)
             + 2 * max(SPLITS) * (4 + 16 + 4 * d)
             + (2 * _DOTS_STAGES + 6) * 8)
    part = _cdiv(_cdiv(block_s, splits), 4) * 4
    return _cdiv(fixed, 16) * 16 + _cdiv(17 * part, 16) * 16


# The sizes the int8-dots kernel's plan picks from, the largest first, and
# the fewest rows a rank's part of a block keeps for C > 1. Its time goes
# to each block's reductions and exchanges more than to its bytes, so on
# the H100 (PERF.md section 6) 4 beat 2 where the parts stay large
# (block_s 512 at B1 / B2: 0.0209 / 0.0213 ms against 0.0212 / 0.0220) and
# lost where they do not (block_s 96: parts of 24 rows, 0.0730 against
# 0.0598-0.0601 at C = 2); 8 lost everywhere.
INT8DOTS_PLAN_SPLITS = (4, 2, 1)
INT8DOTS_PART_ROWS = 32


@functools.lru_cache(maxsize=None)
def int8dots_split_plan(b: int, h: int, s: int, d: int, block_s: int,
                        sm_count: int) -> int:
    """C for the int8-dots kernel (block_s clamped to S): 1 wherever B * H
    alone reaches the SM count, else the largest of INT8DOTS_PLAN_SPLITS
    whose B * H * C CTAs are all resident at once (by this kernel's shared
    memory) and whose parts of a block keep INT8DOTS_PART_ROWS rows. Cached
    per shape."""
    if (min(b, h, s, sm_count, block_s) <= 0 or d not in (64, 128)):
        raise ValueError(f"bad int8-dots shape B{b} H{h} S{s} D{d} block_s "
                         f"{block_s} on {sm_count} SMs")
    block_s = min(block_s, s)
    if b * h >= sm_count:
        return 1
    for c in INT8DOTS_PLAN_SPLITS[:-1]:
        if (c * b * h <= _resident(int8dots_smem_bytes(d, block_s, c),
                                   sm_count)
                and _cdiv(block_s, c) >= INT8DOTS_PART_ROWS):
            return c
    return 1


def int8dots_launch_splits(device, b: int, h: int, s: int, d: int,
                           block_s: int) -> int:
    """The C that the int8-dots wrapper launches with on the card
    `device`: `int8dots_split_plan` at its SM count."""
    idx = torch.device(device).index
    return int8dots_split_plan(b, h, s, d, block_s,
                               _sm_count(0 if idx is None else idx))


def int8dots_max_clusters(d: int, block_s: int, splits: int) -> int:
    """How many clusters of `splits` CTAs of the int8-dots kernel with
    blocks of block_s rows can be resident on the current card at once."""
    import ctypes

    _check_splits(splits)
    count = ctypes.c_int(0)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib.lhrs_fused_decode_q_int8dots_max_clusters(
        int(d), int(block_s), int(splits), ctypes.addressof(count)),
        "int8dots_max_clusters")
    return count.value


def fused_decode_attention_q_int8dots_kernel(
        q, k_new, k_new_scale, v_new, v_new_scale, k_cache, v_cache, k_scale,
        v_scale, lengths, layer: int, sm_scale: float, block_s: int = 512, *,
        splits: Optional[int] = None, fault: int = 0):
    """Launch the CUDA int8-dots variant of the int8-cache fused decode
    kernel (`fused_decode_attention_q_kernel`'s inputs, plus `block_s`,
    clamped to S as in the JAX package, at most MAX_BLOCK_S). `splits`
    forces the cluster size that `int8dots_launch_splits` picks and `fault`
    plants an error (both for the card's checks and the A/B). Counts its
    launches in `fused_decode_attention_q_int8dots_kernel.launches`, apart
    from the bf16-dot kernel's."""
    _check_splits(splits)
    block_s = int(block_s)
    if k_cache.dim() == 5:
        block_s = min(block_s, k_cache.shape[3])
    if not 1 <= block_s <= MAX_BLOCK_S:
        raise ValueError(f"block_s must lie in [1, {MAX_BLOCK_S}] after "
                         f"clamping to S, got {block_s}")
    return _launch_q(q, k_new, k_new_scale, v_new, v_new_scale, k_cache,
                     v_cache, k_scale, v_scale, lengths, layer, sm_scale,
                     block_s, fused_decode_attention_q_int8dots_kernel,
                     splits, fault)


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
