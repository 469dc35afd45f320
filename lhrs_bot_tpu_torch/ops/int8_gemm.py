"""Kernel B: int8 x int8 -> int32 GEMM with the W8A8 float32 epilogues.

The int8 products of the W8A8 vision blocks (`lhrs_bot_tpu/ops/
vit_block.py`, `perceiver_block.py`) and of `w8a8_matmul`. xq (..., K) int8
activations with float32 per-row scales x_scale (..., 1) times a (K, N)
int8 weight with float32 per-column scales w_scale (N elements, any shape).
The int32 accumulator is exact; the epilogue then follows one of the JAX
package's float32 orders of operations:

    ws_first:  v = (acc * (w_scale * c)) * x_scale     (TPU kernels' QKV/q/kv)
    otherwise: v = (acc * x_scale) * w_scale           (O, FC, proj; XLA)
    round_mid: v = bf16(v)                             (XLA: dense_any)
    bias:      v = v + bias (* c when ws_first)
    out_mult:  v = v * out_mult                        (perceiver q: sm_scale)
    act:       "quick_gelu" | "gelu" (erf) | "gelu_tanh"
    residual:  v = v + residual                        (bf16 or float32)

c is `q_fold` on the first `n_fold` columns and 1 elsewhere (the softmax
scale folded into the Q columns of the ViT block's QKV projection). The
result is `out_dtype` (bf16 or float32), or the raw int32 accumulators for
`out_dtype=torch.int32`.

The weight is given in the JAX (K, N) layout. The kernel reads it as
(N, K) rows, K contiguous (wgmma takes 8-bit operands K-major only), so a
weight given to `int8_gemm_kernel` must be the transposed view of a
contiguous (N, K) tensor: `quant.transposed_storage` makes one, and every
weight the port packs or quantizes for the vision tower is stored so.

`int8_gemm` is the entry point. CPU tensors take `int8_gemm_plain`; CUDA
tensors always take the hand-written kernel `int8_gemm_kernel`
(csrc/int8_gemm.cu). There is no fallback: what the kernel does not take
raises. The plain product runs in float64, which is exact here (K * 127^2 <
2^53; float32 is not exact past 2^24 and torch has no int8 CUDA matmul), so
the kernel's accumulators equal the plain ones bit for bit; the epilogues
agree up to the float32 transcendental functions of the GELUs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_lib

ACTS = {None: 0, "quick_gelu": 1, "gelu": 2, "gelu_tanh": 3}
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.int32: 2}


def _activation(v: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "quick_gelu":
        return v * torch.sigmoid(1.702 * v)
    if act == "gelu":
        return F.gelu(v)
    if act == "gelu_tanh":
        return F.gelu(v, approximate="tanh")
    return v


def _check_args(act, out_dtype, residual, ws_first, round_mid, n_fold):
    if act not in ACTS:
        raise ValueError(f"act must be one of {list(ACTS)}, got {act!r}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be bf16, float32 or int32, got "
                         f"{out_dtype}")
    if residual is not None and residual.dtype not in (torch.bfloat16,
                                                       torch.float32):
        raise ValueError(f"residual must be bf16 or float32, got "
                         f"{residual.dtype}")
    if n_fold and not ws_first:
        raise ValueError("q_fold applies to the ws_first order only")
    if round_mid and ws_first:
        raise ValueError("round_mid applies to the x_scale-first order only")


def int8_gemm_plain(xq: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
                    w_scale: torch.Tensor, *, bias=None,
                    ws_first: bool = False, q_fold: float = 1.0,
                    n_fold: int = 0, round_mid: bool = False,
                    out_mult: float = 1.0, act: Optional[str] = None,
                    residual=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: a float64 product of the codes (exact), then the
    kernel's epilogue in float32, one torch op per step."""
    _check_args(act, out_dtype, residual, ws_first, round_mid, n_fold)
    k, n = w.shape
    lead = xq.shape[:-1]
    acc = torch.matmul(xq.reshape(-1, k).double(), w.double())
    acc = acc.to(torch.int32)
    if out_dtype == torch.int32:
        return acc.reshape(*lead, n)
    a = acc.float()
    xs = x_scale.reshape(-1, 1).float()
    ws = w_scale.reshape(-1).float()
    c = torch.ones(n, dtype=torch.float32, device=w.device)
    c[:n_fold] = q_fold
    v = (a * (ws * c)) * xs if ws_first else (a * xs) * ws
    if round_mid:
        v = v.to(torch.bfloat16).float()
    if bias is not None:
        b = bias.reshape(-1).float()
        v = v + (b * c if ws_first else b)
    if out_mult != 1.0:
        v = v * out_mult
    v = _activation(v, act)
    if residual is not None:
        v = v + residual.reshape(-1, n).float()
    return v.to(out_dtype).reshape(*lead, n)


def int8_gemm_kernel(xq: torch.Tensor, x_scale: torch.Tensor,
                     w: torch.Tensor, w_scale: torch.Tensor, *, bias=None,
                     ws_first: bool = False, q_fold: float = 1.0,
                     n_fold: int = 0, round_mid: bool = False,
                     out_mult: float = 1.0, act: Optional[str] = None,
                     residual=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch kernel B. Takes CUDA tensors on one device: int8 xq (..., K)
    whose rows share one row stride (a multiple of 16) with unit column
    stride, float32 x_scale (M elements); w (K, N) int8, the transposed view
    of a contiguous (N, K) tensor; float32 w_scale and bias of N elements,
    contiguous; residual (M, N) contiguous; K a multiple of 64, N of 8;
    16-byte aligned bases (the kernel's TMA copies and 16-byte epilogue
    loads need them). Raises on anything else. Counts its launches in
    `int8_gemm_kernel.launches`."""
    _check_args(act, out_dtype, residual, ws_first, round_mid, n_fold)
    tensors = [t for t in (xq, x_scale, w, w_scale, bias, residual)
               if t is not None]
    if not all(t.is_cuda and t.device == xq.device for t in tensors):
        raise ValueError("int8_gemm_kernel takes CUDA tensors on one device")
    if w.dim() != 2 or xq.shape[-1] != w.shape[0]:
        raise ValueError(f"bad shapes: xq {tuple(xq.shape)}, w "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError("int8_gemm_kernel takes int8 activations and "
                         "weights")
    if k % 64 or n % 8:
        raise ValueError(f"K ({k}) must be a multiple of 64 and N ({n}) of 8")
    wt = w.t()
    if not wt.is_contiguous() or wt.data_ptr() % 16:
        raise ValueError("w must be the (K, N) view of a contiguous, 16-byte "
                         "aligned (N, K) tensor")
    lead = xq.shape[:-1]
    rows = xq.reshape(-1, k)
    m = rows.shape[0]
    lda = rows.stride(0) if m > 1 else k
    if m == 0 or rows.stride(1) != 1 or lda % 16 or rows.data_ptr() % 16:
        raise ValueError("xq must have unit column stride, a row stride that "
                         "is a multiple of 16 and a 16-byte aligned base")
    for name, t, size in (("x_scale", x_scale, m), ("w_scale", w_scale, n),
                          ("bias", bias, n)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != size
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"{size} elements")
    if residual is not None and (residual.numel() != m * n
                                 or not residual.is_contiguous()
                                 or residual.data_ptr() % 16):
        raise ValueError(f"residual must be a contiguous ({m}, {n}) tensor "
                         "with a 16-byte aligned base")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    lib = cuda_lib.load_library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_int8_gemm(
            rows.data_ptr(), lda, wt.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            int(residual is not None and residual.dtype == torch.float32),
            int(ws_first), float(q_fold), int(n_fold), int(round_mid),
            float(out_mult), ACTS[act], _OUT_KINDS[out_dtype],
            out.data_ptr(), m, n, k, stream)
    cuda_lib.check(err, "int8_gemm_kernel")
    int8_gemm_kernel.launches += 1
    return out.reshape(*lead, n)


int8_gemm_kernel.launches = 0


def int8_gemm(xq: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
              w_scale: torch.Tensor, **epilogue) -> torch.Tensor:
    """(..., N) = epilogue(xq @ w). CUDA tensors launch `int8_gemm_kernel`;
    CPU tensors run `int8_gemm_plain`. Keyword arguments as there."""
    if xq.is_cuda:
        return int8_gemm_kernel(xq, x_scale, w, w_scale, **epilogue)
    if xq.device.type != "cpu":
        raise ValueError(f"no int8 GEMM path for device {xq.device}")
    return int8_gemm_plain(xq, x_scale, w, w_scale, **epilogue)
