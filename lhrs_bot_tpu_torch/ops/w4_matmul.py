"""W4A8 matmul for decode: int8 activations x halves-packed int4 weights.

Counterpart of `lhrs_bot_tpu/ops/w4_matmul.py` (`w4a8_matmul_stacked`,
`w4a8_project`). The weight is a stacked (L, K/2, N) int8 array in the
halves layout of `quant.pack_int4_halves`: byte row r holds weight row r in
its low nibble and row K/2 + r in its high nibble, so the per-token int8
activation splits into two contiguous (B, K/2) halves. The two int8 x int4
dot products accumulate in int32; the epilogue is (acc * w_scale) * x_scale
in float32, then the cast to `out_dtype`.

The TPU kernel scalar-prefetches the layer index into its BlockSpecs; here
`w_packed[layer]` is a free view, so the kernel reads the layer's slice.

`w4a8_matmul_stacked` is the entry point. CPU tensors take the plain
version; CUDA tensors always take the hand-written kernel
`w4a8_matmul_kernel` (csrc/w4a8_matmul.cu). There is no fallback: what the
kernel does not take raises. The kernel is bit-identical to the plain
version: the float32 product of the plain version is a sum of integers whose
magnitude stays below 2^24 (|acc| <= 127 * 8 * K/2 per half, 5.6 M at
K = 11008), so it is exact in any summation order.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .quant import QuantizedTensor, quantize_activation, unpack_int4_halves

_NCOLS = 128        # output columns per CTA (32 lanes x 4 columns)
_WARPS = 8          # warps per CTA, each on its own rows of the CTA's chunk
_ROWS_PER_WARP_STEP = 4
_TARGET_CTAS = 2 * 132  # two CTAs per SM of an H100


def w4a8_matmul_plain(xq_lo, xq_hi, x_scale, w_packed, w_scale, layer: int,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: unpack the layer's nibbles, two float32 products
    of integer-valued tensors (exact), the kernel's epilogue order."""
    w = unpack_int4_halves(w_packed[layer]).float()     # (K, N)
    k2 = w_packed.shape[1]
    acc = (torch.matmul(xq_lo.float(), w[:k2])
           + torch.matmul(xq_hi.float(), w[k2:]))
    return (acc * w_scale[layer].float() * x_scale.float()).to(out_dtype)


def split_k(k2: int, n: int) -> tuple:
    """(CTAs along K, packed rows per CTA) for a (K/2, N) weight: enough
    CTAs to give every SM two, each CTA's rows a multiple of the 32 rows
    its 8 warps take per step."""
    def cdiv(a, b):
        return -(-a // b)

    ksplit = max(1, min(16, cdiv(_TARGET_CTAS, cdiv(n, _NCOLS))))
    step = _WARPS * _ROWS_PER_WARP_STEP
    chunk = cdiv(cdiv(k2, ksplit), step) * step
    return cdiv(k2, chunk), chunk


def w4a8_matmul_kernel(xq_lo, xq_hi, x_scale, w_packed, w_scale, layer: int,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the CUDA W4A8 matmul on layer `layer` of the stack. Takes
    CUDA tensors on one device: int8 (B, K/2) halves with unit column
    stride and one row stride (two contiguous arrays, or the two halves of
    one contiguous (B, K) activation), f32 (B, 1) x_scale, int8
    (L, K/2, N) w_packed, f32 (L, 1, N) w_scale, contiguous; K/2 and N
    multiples of 4; out_dtype bf16 or float32; 16-byte aligned. Raises on
    anything else. Counts its launches in `w4a8_matmul_kernel.launches`."""
    tensors = (xq_lo, xq_hi, x_scale, w_packed, w_scale)
    if not all(t.is_cuda and t.device == xq_lo.device for t in tensors):
        raise ValueError("w4a8_matmul_kernel takes CUDA tensors on one "
                         "device")
    if not (xq_lo.dtype == xq_hi.dtype == w_packed.dtype == torch.int8
            and x_scale.dtype == w_scale.dtype == torch.float32):
        raise ValueError("w4a8_matmul_kernel takes int8 activations and "
                         "weights and float32 scales")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or float32, got "
                         f"{out_dtype}")
    if w_packed.dim() != 3:
        raise ValueError(f"w_packed must be (L, K/2, N), got "
                         f"{tuple(w_packed.shape)}")
    nl, k2, n = w_packed.shape
    b = xq_lo.shape[0]
    if (xq_lo.shape != (b, k2) or xq_hi.shape != (b, k2) or b < 1
            or x_scale.shape != (b, 1) or w_scale.shape != (nl, 1, n)):
        raise ValueError(
            f"bad shapes: x halves {tuple(xq_lo.shape)}/"
            f"{tuple(xq_hi.shape)}, x_scale {tuple(x_scale.shape)}, "
            f"w_packed {tuple(w_packed.shape)}, w_scale "
            f"{tuple(w_scale.shape)}")
    if k2 % 4 or n % 4:
        raise ValueError(f"K/2 ({k2}) and N ({n}) must be multiples of 4")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} out of range [0, {nl})")
    w_l, ws_l = w_packed[layer], w_scale[layer]
    x_stride = xq_lo.stride(0) if b > 1 else k2
    for name, t in (("xq_lo", xq_lo), ("xq_hi", xq_hi)):
        if (t.stride(1) != 1 or (b > 1 and t.stride(0) != x_stride)
                or x_stride < k2 or x_stride % 4 or t.data_ptr() % 16):
            raise ValueError(f"{name} must have unit column stride, the "
                             "other half's row stride (a multiple of 4) and "
                             "16-byte alignment")
    for name, t in (("x_scale", x_scale), ("w_packed[layer]", w_l),
                    ("w_scale[layer]", ws_l)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    ksplit, chunk = split_k(k2, n)
    out = torch.empty((b, n), dtype=out_dtype, device=xq_lo.device)
    scratch = (torch.empty((ksplit, b, n), dtype=torch.int32,
                           device=xq_lo.device) if ksplit > 1 else None)
    lib = cuda_lib.load_library()
    with torch.cuda.device(xq_lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_w4a8_matmul(
            xq_lo.data_ptr(), xq_hi.data_ptr(), x_scale.data_ptr(),
            w_l.data_ptr(), ws_l.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            b, k2, n, x_stride, ksplit, chunk,
            int(out_dtype == torch.float32), stream)
    cuda_lib.check(err, "w4a8_matmul_kernel")
    w4a8_matmul_kernel.launches += 1
    return out


w4a8_matmul_kernel.launches = 0


def w4a8_matmul_stacked(xq_lo: torch.Tensor, xq_hi: torch.Tensor,
                        x_scale: torch.Tensor, w_packed: torch.Tensor,
                        w_scale: torch.Tensor, layer: int,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, N) = dequant(x) @ dequant(W[layer]). CUDA tensors launch
    `w4a8_matmul_kernel`; CPU tensors run `w4a8_matmul_plain`."""
    if xq_lo.is_cuda:
        return w4a8_matmul_kernel(xq_lo, xq_hi, x_scale, w_packed, w_scale,
                                  layer, out_dtype)
    if xq_lo.device.type != "cpu":
        raise ValueError(f"no W4A8 path for device {xq_lo.device}")
    return w4a8_matmul_plain(xq_lo, xq_hi, x_scale, w_packed, w_scale,
                             layer, out_dtype)


def w4a8_project(x: torch.Tensor, qt: QuantizedTensor,
                 layer: int) -> torch.Tensor:
    """x (B, S, K) @ layer `layer` of a stacked halves-packed
    QuantizedTensor -> (B, S, N) in x.dtype: per-token int8 activation,
    split into its two halves (views; the kernel reads them in place)."""
    if qt.bits != "4h":
        raise ValueError(f"w4a8_project takes halves-packed weights, got "
                         f"bits={qt.bits!r}")
    b, s, k = x.shape
    xq, xs = quantize_activation(x.reshape(b * s, k))
    k2 = k // 2
    out = w4a8_matmul_stacked(xq[:, :k2], xq[:, k2:], xs, qt.q, qt.scale,
                              layer, out_dtype=x.dtype)
    return out.reshape(b, s, -1)
