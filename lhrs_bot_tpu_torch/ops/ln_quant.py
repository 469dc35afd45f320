"""Kernel A: float32 LayerNorm (or none) + symmetric per-row int8.

The stage that opens each int8 projection of the W8A8 vision blocks
(`lhrs_bot_tpu/ops/vit_block.py` `_ln_f32` + `_quant_act`,
`perceiver_block.py` `_ln_rows` + `_quant_rows`), and, with no LayerNorm,
`quantize_activation` (the int8 cache's new K/V rows). Per row of width W:
the LayerNorm in float32 (mean, then the mean of squared deviations, then
`(x - mu) * rsqrt(var + eps) * scale + bias`), then amax, s = amax / 127 (1
where amax is 0), codes clip(round_half_even(h / s), +-127). Returns (int8
codes (..., W), float32 scales (..., 1)).

`ln_quant` is the entry point. CPU tensors take `ln_quant_plain`; CUDA
tensors always take the hand-written kernel `ln_quant_kernel`
(csrc/ln_quant.cu). There is no fallback: what the kernel does not take
raises. The CUDA route was chosen over Triton, which the slice allowed for
this row reduction plus elementwise pass, so the port keeps one toolchain
(nvcc, ctypes) and needs no `triton` on the card. Without the LayerNorm the
kernel is bit-identical to the plain version (amax is exact, the quotient an
IEEE division, rounding half to even); with it the mean and variance are
summed in another order, so a code may differ by one where h / s lies
within float32 rounding of a half.

The kernel replaces the `_ln_f32` / `_quant_act` stages of the Pallas TPU
kernels of `lhrs_bot_tpu/ops/vit_block.py` (:111, :132, :319, :338) and
`perceiver_block.py` (:53). On the H100 it is bound by device-memory
bandwidth where the work per element is small (the quantize-only rows);
the LayerNorm's three dependent row reductions and arithmetic set the
LayerNorm mode's time. It holds each row in registers: a group of lanes
(`row_plan`: 8 lanes for the 128-wide K/V rows, a warp for the ViT's
1024, several warps for 4096 and 11008) owns a row and reads it in 16-byte
words, once, and writes its codes in 16-byte words; reductions are warp
shuffles, and only a group of several warps meets in shared memory, once
per reduction. Rows up to 32768 wide (the first design staged a float32
row in shared memory and stopped at 12032).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_lib

_VEC = 16          # elements a lane takes at a time (csrc/ln_quant.cu)
_MAX_LANES = 512   # threads of the widest row group
_MAX_CHUNKS = 4    # 16-element chunks a lane holds in registers
_MIN_THREADS = 256  # a CTA of narrow groups holds 256 / lanes rows
_MAX_WIDTH = _MAX_LANES * _MAX_CHUNKS * _VEC  # 32768


def row_plan(w: int) -> Tuple[int, int, int]:
    """(lanes a row, 16-element chunks a lane, rows a CTA) for rows of
    width w: the smallest power-of-two group (8 to 512 lanes) in which
    each lane holds at most two chunks, more chunks (up to four) only past
    512 lanes. Chunk j of a row goes to lane j % lanes."""
    if not 0 < w <= _MAX_WIDTH:
        raise ValueError(f"row width {w} outside (0, {_MAX_WIDTH}]")
    nvec = -(-w // _VEC)
    lanes = 8
    while lanes < _MAX_LANES and 2 * lanes < nvec:
        lanes *= 2
    chunks = -(-nvec // lanes)
    return lanes, chunks, max(lanes, _MIN_THREADS) // lanes


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which can differ from the
    quotient (and from the JAX package's scales) in the last bit."""
    return x / torch.full_like(x, c)


def ln_quant_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version, in the TPU kernels' order of operations."""
    h = x.float()
    if scale is not None:
        mu = h.mean(dim=-1, keepdim=True)
        var = (h - mu).square().mean(dim=-1, keepdim=True)
        h = (h - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    amax = h.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax),
                    div_exact(amax, 127.0))
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def ln_quant_kernel(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel A. Takes a bf16 or float32 CUDA tensor (..., W) whose
    rows have unit column stride and one row stride (a multiple of 8), W up
    to 32768; scale and bias float32 (W) on the same device for the
    LayerNorm, or both None. Raises on anything else. Counts its launches
    in `ln_quant_kernel.launches`."""
    if not x.is_cuda:
        raise ValueError("ln_quant_kernel takes CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ln_quant_kernel takes bf16 or float32, got "
                         f"{x.dtype}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias go together")
    w = x.shape[-1]
    if x.numel() == 0:
        raise ValueError("ln_quant_kernel takes a non-empty x")
    lanes, chunks, _ = row_plan(w)
    rows = x.reshape(-1, w)  # a view wherever the rows share one stride
    m = rows.shape[0]
    # one row has no stride: any multiple of 8 past its end will do
    stride = rows.stride(0) if m > 1 else -(-w // 8) * 8
    if rows.stride(1) != 1 or stride % 8 or rows.data_ptr() % 16:
        raise ValueError("x must have unit column stride, a row stride that "
                         "is a multiple of 8 and a 16-byte aligned base")
    if scale is not None:
        for name, t in (("scale", scale), ("bias", bias)):
            if (t.dtype != torch.float32 or t.shape != (w,)
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 ({w},) "
                                 "tensor on x's device")
    q = torch.empty((m, w), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    lib = cuda_lib.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_ln_quant(
            rows.data_ptr(), int(x.dtype == torch.float32), stride,
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), q.data_ptr(),
            s.data_ptr(), m, w, lanes, chunks, float(eps), stream)
    cuda_lib.check(err, "ln_quant_kernel")
    ln_quant_kernel.launches += 1
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


ln_quant_kernel.launches = 0


def ln_quant(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm (when scale/bias are given) + per-row int8 codes and
    scales. CUDA tensors launch `ln_quant_kernel`; CPU tensors run
    `ln_quant_plain`."""
    if x.is_cuda:
        return ln_quant_kernel(x, scale, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"no ln_quant path for device {x.device}")
    return ln_quant_plain(x, scale, bias, eps)
