"""Multi-head attention: the plain reference and the CUDA flash forward.

Counterpart of `lhrs_bot_tpu/ops/attention.py`. Layout: q (B, H, Sq, D),
k/v (B, H, Skv, D), optional kv_mask (B, Skv) bool (True = attend); the
causal mask is top-left aligned (kv_id <= q_id). Returns (B, H, Sq, D) in
q.dtype; `mha_reference` and `flash_attention_fwd` also give it in float32
(`out_dtype`), for the W8A8 vision blocks, which quantize the attention
output before any rounding.

`flash_attention` is the entry point. CPU tensors take `mha_reference`;
CUDA tensors always take the hand-written kernel `flash_attention_fwd`
(csrc/flash_fwd.cu), at every length: the TPU's flash-vs-XLA length cutoff
does not carry over to the port. There is no fallback: what the kernel does
not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cuda_lib

_NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None, *,
                  causal: bool = False,
                  sm_scale: Optional[float] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain attention: float32 scores and softmax, probabilities rounded to
    v.dtype before the PV product (float32 accumulation). A row with no
    valid key gives 0, as the kernels do."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    allowed = None
    if kv_mask is not None:
        allowed = kv_mask[:, None, None, :]
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        tri = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        allowed = tri if allowed is None else allowed & tri
    if allowed is not None:
        scores = scores.masked_fill(~allowed, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if allowed is not None:
        # masked entries are 0 already, except in a row with no valid key
        probs = probs.masked_fill(~allowed, 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(out_dtype or q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor], causal: bool,
                        sm_scale: float, out_dtype=torch.bfloat16,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA flash-attention forward. Takes bf16 CUDA tensors
    with D of 64 or 128, unit stride along D, the other strides multiples of
    8 and 16-byte aligned bases (so Q, K and V can be strided views of one
    projection), any Sq/Skv; writes a bf16 or float32 (B, H, Sq, D) result,
    into `out` when given (any such strides, e.g. the (B, H, Sq, D) view of
    a token-major (B, Sq, H, D) buffer). Raises on anything else. Counts its
    launches in `flash_attention_fwd.launches`."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd takes CUDA tensors on one "
                         "device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash_attention_fwd takes bf16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d or d not in (64, 128):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}; "
                         "D must be 64 or 128")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    if out is None:
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    elif (out.shape != q.shape or out.dtype != out_dtype
          or out.device != q.device):
        raise ValueError(f"out must be a {out_dtype} {tuple(q.shape)} tensor "
                         "on q's device")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have unit stride along D, strides "
                             "that are multiples of 8 and a 16-byte aligned "
                             "base")
        strides += t.stride()[:3]
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or kv_mask.shape != (b, skv)
                or kv_mask.device != q.device or not kv_mask.is_contiguous()):
            raise ValueError("kv_mask must be a contiguous (B, Skv) bool "
                             "tensor on q's device")
    lib = cuda_lib.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            b, h, sq, skv, d, int(causal), float(sm_scale),
            (ctypes.c_longlong * 12)(*strides),
            int(out_dtype == torch.float32), stream)
    cuda_lib.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Multi-head attention. CUDA tensors launch `flash_attention_fwd`; CPU
    tensors run `mha_reference`. Sequence packing (`segment_ids`) is not
    ported yet and raises."""
    if segment_ids is not None:
        raise NotImplementedError("segment_ids (sequence packing) is not "
                                  "ported to lhrs_bot_tpu_torch yet")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, kv_mask, causal, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    return mha_reference(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)
