"""Weight quantization: int8, packed int4 (interleaved and halves) and NF4.

Counterpart of `lhrs_bot_tpu/ops/quant.py`. Symmetric per-output-channel
scales: q = round(w / s), s = max|w_col| / 127 (or / 7 for int4), a zero
column takes s = 1. Rounding is half to even, as `jnp.round`, so the codes
and scales are byte for byte the JAX package's on the same float32 input.

`quantized_matmul` is the plain product the JAX package leaves to XLA: the
activation is rounded to bf16 whatever the compute dtype, the product of
the bf16-valued operands is kept in float32, and the scale multiplies that
float32 product before the cast to `out_dtype`. `torch.matmul` of bf16
operands would round the product to bf16 first, so both operands are cast
to float32 here (their bf16 values multiply exactly in float32). Under
autograd it gives the input gradient of QLoRA training over a frozen
quantized base (`_QuantizedMatmul`: it keeps the int8 codes, not a float
copy of the weight, which for the 7B decoder would be 26 GB).

NF4 is the QLoRA NormalFloat4 codebook with per-64-block absmax along the
contraction axis and the JAX package's linear int8 double quantization of
the absmax plane (a round trip applied at quantize time, stored as f32).

`quantize_activation` is kernel A's quantize-only mode (ops/ln_quant.py):
the plain version on CPU tensors, csrc/ln_quant.cu on CUDA tensors, bit for
bit the same. On the card the W4A8 projection (`w4_matmul.w4a8_project`)
no longer calls it: K3 quantizes its own activation inside its launch, to
the same bits; the int8 cache's new K/V rows and the W8A8 products still
do. `w8a8_matmul` (per-row int8 activations x int8 weights, int32
accumulation, scales in the float32 epilogue) runs the int8 GEMM of
ops/int8_gemm.py, kernel B on CUDA tensors. `quantize_vision_layers`
int8-quantizes the ViT/perceiver projections; their codes are stored as the
transposed view of a contiguous (..., out, in) tensor (`transposed_storage`),
the layout kernel B reads, while the values and the (in, out) shape stay
the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .int8_gemm import int8_gemm
from .ln_quant import div_exact, ln_quant


class QuantizedTensor:
    """A quantized weight: int8 values `q` (nibble-packed for 4 / "4h" /
    "nf4") and float32 `scale`. `qt[li]` is the layer's view of a stacked
    (L, ...) weight; `.to(device)` moves both tensors."""

    __slots__ = ("q", "scale", "bits")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits=8):
        self.q = q
        self.scale = scale
        self.bits = bits

    def __getitem__(self, li) -> "QuantizedTensor":
        return QuantizedTensor(self.q[li], self.scale[li], self.bits)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device),
                               self.scale.to(device, torch.float32),
                               self.bits)

    def __repr__(self):  # pragma: no cover
        return (f"QuantizedTensor(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)}, bits={self.bits!r})")


def _symmetric(w: torch.Tensor, axis: int, qmax: float):
    """(codes in [-qmax, qmax] as int8, f32 scale) along `axis`."""
    wf = w.float()
    scale = div_exact(wf.abs().amax(dim=axis, keepdim=True), qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_int8(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Per-output-channel symmetric int8; `axis` is the contraction axis
    of w (reduced for the scales), -2 for (in, out) weights."""
    q, scale = _symmetric(w, axis, 127.0)
    return QuantizedTensor(q, scale, bits=8)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Dynamic per-vector symmetric int8 over the last axis: (..., d) ->
    (int8 values, (..., 1) f32 scales). Kernel A without the LayerNorm
    (csrc/ln_quant.cu on CUDA tensors: the int8 cache's K/V rows, the W8A8
    products); the W4A8 projection does the same inside K3's launch."""
    return ln_quant(x)


def transposed_storage(q: torch.Tensor) -> torch.Tensor:
    """The same (..., in, out) values, stored as the transposed view of a
    contiguous (..., out, in) tensor: the weight layout of kernel B."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def w8a8_matmul(x: torch.Tensor, qt: QuantizedTensor,
                out_dtype=None) -> torch.Tensor:
    """Full-int8 matmul: x (..., in) quantized per row, times int8 (in,
    out) weights, int32 accumulation, (acc * x_scale) * w_scale in float32,
    then `out_dtype` (default x.dtype)."""
    xq, xs = quantize_activation(x)
    return int8_gemm(xq, xs, qt.q, qt.scale, out_dtype=out_dtype or x.dtype)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    if qt.bits == "nf4":
        return _dequantize_nf4(qt.q, qt.scale)
    return _codes(qt).float() * qt.scale


def _codes(qt: QuantizedTensor) -> torch.Tensor:
    """The signed int8 codes of an int8 / int4 / "4h" weight, unpacked."""
    if qt.bits == 4:
        return unpack_int4(qt.q)
    if qt.bits == "4h":
        return unpack_int4_halves(qt.q)
    return qt.q


def _float_weight(q: torch.Tensor, scale: torch.Tensor, bits):
    """(float32 weight the product multiplies, float32 scale of the
    epilogue or None): the codes for int8 / int4 / "4h", the bf16-rounded
    dequantized weight for NF4 (its per-block scales along the contraction
    axis cannot fold into the epilogue)."""
    if bits == "nf4":
        return _dequantize_nf4(q, scale).to(torch.bfloat16).float(), None
    return _codes(QuantizedTensor(q, scale, bits)).float(), scale.float()


class _QuantizedMatmul(torch.autograd.Function):
    """quantized_matmul with the input gradient JAX takes through the same
    operations: the cotangent g in float32, times the scale, times the
    transposed codes (or NF4 weight) in float32, rounded to bf16 (the
    transpose of the activation's bf16 cast), then to x's dtype. Saves the
    codes and the scale (no float copy of the weight); no weight
    gradient."""

    @staticmethod
    def forward(ctx, x, q, scale, bits, out_dtype):
        ctx.save_for_backward(q, scale)
        ctx.bits, ctx.x_dtype = bits, x.dtype
        w, s = _float_weight(q, scale, bits)
        acc = torch.matmul(x.to(torch.bfloat16).float(), w)
        return (acc if s is None else acc * s).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        w, s = _float_weight(q, scale, ctx.bits)
        g = g.float() if s is None else g.float() * s
        dx = torch.matmul(g, w.transpose(-1, -2))
        return dx.to(torch.bfloat16).to(ctx.x_dtype), None, None, None, None


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                     out_dtype=None) -> torch.Tensor:
    """x (..., in) @ quantized (in, out): bf16-rounded operands, float32
    product, scale folded into the float32 epilogue, then `out_dtype`
    (default x.dtype). Differentiable in x (`_QuantizedMatmul`)."""
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        return _QuantizedMatmul.apply(x, qt.q, qt.scale, qt.bits, out_dtype)
    w, s = _float_weight(qt.q, qt.scale, qt.bits)
    acc = torch.matmul(x.to(torch.bfloat16).float(), w)
    return (acc if s is None else acc * s).to(out_dtype)


# ---------------------------------------------------------------------------
# int4 packing (two values per byte along the contraction axis -2)
# ---------------------------------------------------------------------------


def _low_nibble(packed: torch.Tensor) -> torch.Tensor:
    return (packed << 4) >> 4  # int8 arithmetic shift: sign-extended


def _high_nibble(packed: torch.Tensor) -> torch.Tensor:
    return packed >> 4


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., 2n, out) int8 in [-8, 7] -> (..., n, out): row 2i in the low
    nibble, row 2i + 1 in the high nibble of packed row i."""
    if q.shape[-2] % 2:
        raise ValueError(f"pack_int4 needs an even axis -2, got {q.shape}")
    lo = q[..., 0::2, :] & 0x0F
    hi = (q[..., 1::2, :] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: rows lo0, hi0, lo1, hi1, ... along axis -2."""
    inter = torch.stack([_low_nibble(packed), _high_nibble(packed)], dim=-2)
    return inter.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                         packed.shape[-1])


def pack_int4_halves(q: torch.Tensor) -> torch.Tensor:
    """(..., 2n, out) int8 in [-8, 7] -> (..., n, out): row r in the low
    nibble of packed row r, row n + r in its high nibble (the layout the
    W4A8 decode kernel streams)."""
    if q.shape[-2] % 2:
        raise ValueError(f"pack_int4_halves needs an even axis -2, got "
                         f"{q.shape}")
    n = q.shape[-2] // 2
    lo = q[..., :n, :] & 0x0F
    hi = (q[..., n:, :] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4_halves: (..., n, out) -> (..., 2n, out)."""
    return torch.cat([_low_nibble(packed), _high_nibble(packed)], dim=-2)


def _check_axis(w: torch.Tensor, axis: int):
    if axis % w.dim() != w.dim() - 2:
        raise ValueError(f"int4 packs along axis -2 only; got axis {axis} "
                         f"of {tuple(w.shape)}")


def quantize_int4(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    _check_axis(w, axis)
    q, scale = _symmetric(w, axis, 7.0)
    return QuantizedTensor(pack_int4(q), scale, bits=4)


def quantize_int4h(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Symmetric per-output-channel int4 in the halves-packed layout."""
    _check_axis(w, axis)
    q, scale = _symmetric(w, axis, 7.0)
    return QuantizedTensor(pack_int4_halves(q), scale, bits="4h")


# ---------------------------------------------------------------------------
# NF4 (QLoRA 4-bit NormalFloat)
# ---------------------------------------------------------------------------

NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)

NF4_BLOCK = 64        # weights per absmax block
NF4_DQ_BLOCK = 256    # absmax values per double-quant block


def _double_quant_roundtrip(absmax: torch.Tensor,
                            block: int = NF4_DQ_BLOCK) -> torch.Tensor:
    """Subtract the mean, int8-quantize per 256-block, add the mean back;
    returns the f32 absmax carrying the double-quant error."""
    flat = absmax.float().reshape(-1)
    offset = flat.mean()
    c = flat - offset
    n = flat.numel()
    cp = torch.nn.functional.pad(c, (0, (-n) % block)).reshape(-1, block)
    s = div_exact(cp.abs().amax(dim=-1, keepdim=True), 127.0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(cp / s), -127, 127)
    return ((q * s).reshape(-1)[:n] + offset).reshape(absmax.shape)


def quantize_nf4(w: torch.Tensor, axis: int = -2, *,
                 double_quant: bool = True) -> QuantizedTensor:
    """NF4-quantize a (..., in, out) weight: per-64-block absmax along the
    contraction axis, nearest code with a midpoint tie taking the lower
    code, nibble-packed (pack_int4) codes 0..15. scale: (..., in/64, out)
    f32 absmax."""
    _check_axis(w, axis)
    in_dim = w.shape[-2]
    if in_dim % NF4_BLOCK:
        raise ValueError(f"NF4 needs the contraction dim divisible by "
                         f"{NF4_BLOCK}, got {tuple(w.shape)}")
    wf = w.float()
    nb = in_dim // NF4_BLOCK
    blocks = wf.reshape(*wf.shape[:-2], nb, NF4_BLOCK, wf.shape[-1])
    absmax = blocks.abs().amax(dim=-2)                  # (..., nb, out)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    if double_quant:
        absmax = torch.clamp(_double_quant_roundtrip(absmax), min=1e-12)
    xn = blocks / absmax.unsqueeze(-2)
    code = torch.tensor(NF4_CODE, dtype=torch.float32, device=w.device)
    mid = (code[1:] + code[:-1]) / 2.0
    idx = torch.searchsorted(mid, torch.clamp(xn, -1.0, 1.0).contiguous(),
                             right=False, out_int32=True)
    idx = idx.reshape(wf.shape).to(torch.int8)
    return QuantizedTensor(pack_int4(idx), absmax, bits="nf4")


def unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """pack_int4 inverse without sign extension: codes 0..15."""
    inter = torch.stack([packed & 0x0F, (packed >> 4) & 0x0F], dim=-2)
    return inter.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                         packed.shape[-1])


def _dequantize_nf4(q_packed: torch.Tensor,
                    absmax: torch.Tensor) -> torch.Tensor:
    code = torch.tensor(NF4_CODE, dtype=torch.float32,
                        device=q_packed.device)
    vals = code[unpack_uint4(q_packed).long()]          # (..., in, out)
    nb = absmax.shape[-2]
    blocks = vals.reshape(*vals.shape[:-2], nb, vals.shape[-2] // nb,
                          vals.shape[-1])
    return (blocks * absmax.float().unsqueeze(-2)).reshape(vals.shape)


# ---------------------------------------------------------------------------
# Model-level helpers
# ---------------------------------------------------------------------------

_QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llama_layers(layers: Dict[str, torch.Tensor], bits=8, *,
                          quant_type: str = "nf4",
                          double_quant: bool = True) -> Dict[str, Any]:
    """Replace the stacked (L, in, out) projection weights with
    QuantizedTensors (norms stay as they are). bits 8 is int8; bits 4 is
    NF4 for quant_type "nf4", halves-packed int4 for "int4h" and
    interleaved int4 otherwise."""
    if bits == 8:
        def fn(w):
            return quantize_int8(w, axis=1)
    elif quant_type == "nf4":
        def fn(w):
            return quantize_nf4(w, axis=1, double_quant=double_quant)
    elif quant_type == "int4h":
        def fn(w):
            return quantize_int4h(w, axis=1)
    else:
        def fn(w):
            return quantize_int4(w, axis=1)
    return {name: fn(w) if name in _QUANT_TARGETS
            and not isinstance(w, QuantizedTensor) else w
            for name, w in layers.items()}


def dequantize_llama_layers(layers: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    return {name: dequantize(w) if isinstance(w, QuantizedTensor) else w
            for name, w in layers.items()}


_VISION_QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_fc", "w_proj")


def quantize_vision_layers(layers: Dict[str, torch.Tensor],
                           bits: int = 8) -> Dict[str, Any]:
    """int8-quantize the stacked (L, in, out) ViT/perceiver projection
    weights (LayerNorms and biases stay float), so that `dense_any` and
    `gelu_mlp` take the W8A8 path. Codes in kernel B's layout. The JAX
    package's bits=4 variant (int4 codes that its W8A8 matmul cannot use)
    is not ported."""
    if bits != 8:
        raise ValueError(f"quantize_vision_layers takes bits=8, got {bits!r}")

    def fn(w):
        qt = quantize_int8(w, axis=1)
        return QuantizedTensor(transposed_storage(qt.q), qt.scale, bits=8)

    return {name: fn(w) if name in _VISION_QUANT_TARGETS else w
            for name, w in layers.items()}
