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

One hand-written kernel (csrc/w4a8_matmul.cu, K3) serves both entry points,
in two modes. `w4a8_matmul_stacked` takes int8 halves and scales: CPU
tensors run `w4a8_matmul_plain`, CUDA tensors `w4a8_matmul_kernel` (mode
(a)). `w4a8_project` takes the bf16 (or float32) activation: CPU tensors
run the plain `quantize_activation` and `w4a8_matmul_plain`, CUDA tensors
`w4a8_project_kernel` (mode (b)), which quantizes the activation inside the
same launch, so on the card `w4a8_project` no longer launches kernel A.
There is no fallback: what the kernel does not take raises. Both modes are
bit-identical to the plain versions: the float32 product of the plain
version is a sum of integers whose magnitude stays below 2^24 (|acc| <= 127
* 8 * K/2 per half, 5.6 M at K = 11008), so it is exact in any summation
order, and the kernel's per-row amax, IEEE quotient and half-to-even
rounding are `quantize_activation`'s.

The kernel is bound by the weight stream (K/2 * N bytes a call). One
launch does a projection: a thread-block cluster of up to 8 CTAs splits
K/2 for each block of 128 output columns (`w4a8_plan`), its CTAs exchange
the activation's row maxima and add their int32 sums over distributed
shared memory, and one of them applies the epilogue; no scratch in device
memory, no second kernel.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch

from . import cuda_lib
from .quant import QuantizedTensor, quantize_activation, unpack_int4_halves

_NCOLS = 128        # output columns per CTA (8 lanes x 16 columns)
_STEP_ROWS = 128    # packed rows a CTA takes a step (32 groups of 4 rows)
_MAX_CLUSTER = 8    # CTAs of a cluster along K/2 (the portable limit)
_MAX_CHUNK = 2048   # packed rows a CTA
# planted errors the checks on the card must see fail (csrc/w4a8_matmul.cu)
FAULT_PEER_AMAX = 1   # rank 1's row maxima left out of the exchange
FAULT_PEER_SUMS = 2   # the last rank's int32 sums left out


def w4a8_matmul_plain(xq_lo, xq_hi, x_scale, w_packed, w_scale, layer: int,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: unpack the layer's nibbles, two float32 products
    of integer-valued tensors (exact), the kernel's epilogue order."""
    w = unpack_int4_halves(w_packed[layer]).float()     # (K, N)
    k2 = w_packed.shape[1]
    acc = (torch.matmul(xq_lo.float(), w[:k2])
           + torch.matmul(xq_hi.float(), w[k2:]))
    return (acc * w_scale[layer].float() * x_scale.float()).to(out_dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def w4a8_plan(k2: int, n: int, cluster: int = _MAX_CLUSTER
              ) -> Tuple[int, int]:
    """(CTAs of a cluster along K/2, packed rows per CTA) for a (K/2, N)
    weight and a cluster of up to `cluster` CTAs (at most 8): each CTA's
    rows are whole 128-row steps (the last CTA's may end early), at most
    2048, and no CTA is empty, so the cluster may come out smaller than
    asked (or larger, where K/2 needs more than `cluster` x 2048 rows)."""
    if k2 <= 0 or n <= 0:
        raise ValueError(f"bad weight shape ({k2}, {n})")
    if not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"cluster {cluster} outside [1, {_MAX_CLUSTER}]")
    cluster = max(cluster, _cdiv(k2, _MAX_CHUNK))
    if cluster > _MAX_CLUSTER:
        raise ValueError(f"K/2 = {k2} needs more than {_MAX_CLUSTER} CTAs "
                         f"of {_MAX_CHUNK} rows")
    chunk = _cdiv(_cdiv(k2, cluster), _STEP_ROWS) * _STEP_ROWS
    return _cdiv(k2, chunk), chunk


# cluster sizes tried, the largest first: each CTA then streams the least
CLUSTER_SIZES = (8, 6, 4, 3, 2)


def pick_cluster(clusters: int, resident: Callable[[int], int]) -> int:
    """The largest cluster size of CLUSTER_SIZES for which all `clusters`
    clusters of a launch (one per 128-column block and 8-row group) can be
    resident at once, `resident(c)` being how many of size c can; 1 where
    none fits. A launch that needs a second wave of clusters waits a whole
    cluster's time for it (measured on the H100: at B = 7, 3 CTAs, which
    fit, beat 4 and 8, which do not, by 1.4-2.7x)."""
    for c in CLUSTER_SIZES:
        if resident(c) >= clusters:
            return c
    return 1


@functools.lru_cache(maxsize=None)
def _launch_plan(device: int, b: int, k2: int, n: int, fused: bool,
                 x_f32: bool) -> Tuple[int, int]:
    clusters = _cdiv(n, _NCOLS) * _cdiv(b, 8)
    with torch.cuda.device(device):
        return w4a8_plan(k2, n, pick_cluster(
            clusters, lambda c: w4a8_max_clusters(
                b, k2, n, fused=fused, x_f32=x_f32, cluster=c)))


def w4a8_launch_plan(device, b: int, k2: int, n: int, *, fused: bool = True,
                     x_f32: bool = False) -> Tuple[int, int]:
    """(cluster, chunk) that the kernel wrappers launch with on the card
    `device` for B rows and a (K/2, N) weight: `pick_cluster` over the
    occupancy the card reports, then `w4a8_plan`. Cached per shape."""
    return _launch_plan(torch.device(device).index or 0, b, k2, n, fused,
                        x_f32)


def _layer_weights(w_packed, w_scale, layer: int, device):
    """The layer's (K/2, N) codes and (1, N) scales, checked for the
    kernel: int8 / float32 on `device`, contiguous, 16-byte aligned, K/2 a
    multiple of 4 and N of 16."""
    if w_packed.dim() != 3:
        raise ValueError(f"w_packed must be (L, K/2, N), got "
                         f"{tuple(w_packed.shape)}")
    nl, k2, n = w_packed.shape
    if (w_packed.dtype != torch.int8 or w_scale.dtype != torch.float32
            or w_scale.shape != (nl, 1, n)):
        raise ValueError(f"w_packed must be int8 (L, K/2, N) and w_scale "
                         f"float32 (L, 1, N); got {w_packed.dtype} "
                         f"{tuple(w_packed.shape)}, {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    if not (w_packed.device == w_scale.device == device):
        raise ValueError("w4a8 kernels take all tensors on one CUDA device")
    if k2 % 4 or n % 16:
        raise ValueError(f"K/2 ({k2}) must be a multiple of 4 and N ({n}) "
                         "of 16")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} out of range [0, {nl})")
    w_l, ws_l = w_packed[layer], w_scale[layer]
    for name, t in (("w_packed[layer]", w_l), ("w_scale[layer]", ws_l)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return w_l, ws_l, k2, n


def w4a8_max_clusters(b: int, k2: int, n: int, *, fused: bool = True,
                      x_f32: bool = False,
                      cluster: int = _MAX_CLUSTER) -> int:
    """The number of clusters of the kernel that can be resident on the
    card at once for this launch (`cudaOccupancyMaxActiveClusters`)."""
    import ctypes

    cluster, chunk = w4a8_plan(k2, n, cluster)
    count = ctypes.c_int(0)
    err = cuda_lib.load_library().lhrs_w4a8_max_clusters(
        int(fused), int(x_f32), b, k2, n, cluster, chunk,
        ctypes.addressof(count))
    cuda_lib.check(err, "w4a8_max_clusters")
    return count.value


def w4a8_matmul_kernel(xq_lo, xq_hi, x_scale, w_packed, w_scale, layer: int,
                       out_dtype=torch.bfloat16, *,
                       cluster: Optional[int] = None,
                       fault: int = 0) -> torch.Tensor:
    """Launch K3 in mode (a) on layer `layer` of the stack. Takes CUDA
    tensors on one device: int8 (B, K/2) halves with unit column stride
    and one row stride (two contiguous arrays, or the two halves of one
    contiguous (B, K) activation), f32 (B, 1) x_scale, int8 (L, K/2, N)
    w_packed, f32 (L, 1, N) w_scale, contiguous; K/2 a multiple of 4, N of
    16; out_dtype bf16 or float32; 16-byte aligned. `cluster` overrides
    the cluster size `pick_cluster` chooses from the card's occupancy;
    `fault` plants an error for a check.
    Raises on anything else. Counts its launches in
    `w4a8_matmul_kernel.launches`."""
    tensors = (xq_lo, xq_hi, x_scale, w_packed, w_scale)
    if not all(t.is_cuda and t.device == xq_lo.device for t in tensors):
        raise ValueError("w4a8_matmul_kernel takes CUDA tensors on one "
                         "device")
    if not (xq_lo.dtype == xq_hi.dtype == torch.int8
            and x_scale.dtype == torch.float32):
        raise ValueError("w4a8_matmul_kernel takes int8 activations and "
                         "float32 scales")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or float32, got "
                         f"{out_dtype}")
    w_l, ws_l, k2, n = _layer_weights(w_packed, w_scale, layer,
                                      xq_lo.device)
    b = xq_lo.shape[0]
    if (xq_lo.shape != (b, k2) or xq_hi.shape != (b, k2) or b < 1
            or x_scale.shape != (b, 1)):
        raise ValueError(
            f"bad shapes: x halves {tuple(xq_lo.shape)}/"
            f"{tuple(xq_hi.shape)}, x_scale {tuple(x_scale.shape)}, "
            f"w_packed {tuple(w_packed.shape)}")
    x_stride = xq_lo.stride(0) if b > 1 else k2
    for name, t in (("xq_lo", xq_lo), ("xq_hi", xq_hi)):
        if (t.stride(1) != 1 or (b > 1 and t.stride(0) != x_stride)
                or x_stride < k2 or x_stride % 4 or t.data_ptr() % 16):
            raise ValueError(f"{name} must have unit column stride, the "
                             "other half's row stride (a multiple of 4) and "
                             "16-byte alignment")
    if not x_scale.is_contiguous():
        raise ValueError("x_scale must be contiguous")
    cluster, chunk = (w4a8_plan(k2, n, cluster) if cluster else
                      w4a8_launch_plan(xq_lo.device, b, k2, n, fused=False))
    out = torch.empty((b, n), dtype=out_dtype, device=xq_lo.device)
    lib = cuda_lib.load_library()
    with torch.cuda.device(xq_lo.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_w4a8_matmul(
            xq_lo.data_ptr(), xq_hi.data_ptr(), x_scale.data_ptr(),
            w_l.data_ptr(), ws_l.data_ptr(), out.data_ptr(), b, k2, n,
            x_stride, cluster, chunk, int(out_dtype == torch.float32),
            int(fault), stream)
    cuda_lib.check(err, "w4a8_matmul_kernel")
    w4a8_matmul_kernel.launches += 1
    return out


def w4a8_project_kernel(x: torch.Tensor, w_packed: torch.Tensor,
                        w_scale: torch.Tensor, layer: int, *,
                        cluster: Optional[int] = None,
                        fault: int = 0) -> torch.Tensor:
    """Launch K3 in mode (b): x (B, K) bf16 or float32 on the card, unit
    column stride, a row stride that is a multiple of 4, 16-byte aligned,
    K = 2 * K/2 of the (L, K/2, N) stack -> (B, N) in x.dtype, the same
    bits as `quantize_activation` then `w4a8_matmul_plain`. The kernel
    quantizes x itself, so kernel A does not run. Counts its launches in
    `w4a8_matmul_kernel.launches` (the same kernel as mode (a))."""
    if not x.is_cuda:
        raise ValueError("w4a8_project_kernel takes CUDA tensors")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w4a8_project_kernel takes bf16 or float32 x, got "
                         f"{x.dtype}")
    w_l, ws_l, k2, n = _layer_weights(w_packed, w_scale, layer, x.device)
    if x.dim() != 2 or x.shape[1] != 2 * k2 or x.shape[0] < 1:
        raise ValueError(f"x must be (B, {2 * k2}), got {tuple(x.shape)}")
    b = x.shape[0]
    x_stride = x.stride(0) if b > 1 else 2 * k2
    if x.stride(1) != 1 or x_stride % 4 or x.data_ptr() % 16:
        raise ValueError("x must have unit column stride, a row stride "
                         "that is a multiple of 4 and a 16-byte aligned base")
    x_f32 = x.dtype == torch.float32
    cluster, chunk = (w4a8_plan(k2, n, cluster) if cluster else
                      w4a8_launch_plan(x.device, b, k2, n, x_f32=x_f32))
    out = torch.empty((b, n), dtype=x.dtype, device=x.device)
    lib = cuda_lib.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_w4a8_project(
            x.data_ptr(), int(x_f32), w_l.data_ptr(), ws_l.data_ptr(),
            out.data_ptr(), b, k2, n, x_stride, cluster, chunk, int(x_f32),
            int(fault), stream)
    cuda_lib.check(err, "w4a8_project_kernel")
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
    split into its two halves. CUDA tensors launch `w4a8_project_kernel`,
    which quantizes inside the product's launch; CPU tensors run the plain
    `quantize_activation` and `w4a8_matmul_plain`, its reference."""
    if qt.bits != "4h":
        raise ValueError(f"w4a8_project takes halves-packed weights, got "
                         f"bits={qt.bits!r}")
    b, s, k = x.shape
    if x.is_cuda:
        out = w4a8_project_kernel(x.reshape(b * s, k), qt.q, qt.scale, layer)
        return out.reshape(b, s, -1)
    if x.device.type != "cpu":
        raise ValueError(f"no W4A8 path for device {x.device}")
    xq, xs = quantize_activation(x.reshape(b * s, k))
    k2 = k // 2
    out = w4a8_matmul_stacked(xq[:, :k2], xq[:, k2:], xs, qt.q, qt.scale,
                              layer, out_dtype=x.dtype)
    return out.reshape(b, s, -1)
