"""In-place KV-cache row write.

Counterpart of `lhrs_bot_tpu/ops/cache_update.py` `cache_row_update`: the
(H, D) row new_vals[b] is written at position lengths[b] of the (B, H, S, D)
cache, in place. CPU tensors take the plain version (`_write_at`, the
indexed assignment of the decode path); CUDA tensors always take the
hand-written kernel (csrc/cache_update.cu). No path of the port calls it,
as in the JAX package, where only its test does.

A row with lengths[b] >= S has no room: the kernel writes nothing there,
the plain version raises an IndexError (the TPU kernel's 8-row window
would run off the end of the cache, which its callers never ask for).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .fused_decode import _write_at

DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def cache_row_update_plain(cache: torch.Tensor, new_vals: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: the indexed assignment, in place."""
    return _write_at(cache, new_vals, lengths)


def cache_row_update_kernel(cache: torch.Tensor, new_vals: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA row write. Takes a contiguous float32 / bf16 / int8
    (B, H, S, D) cache whose rows are a multiple of 16 bytes, new_vals
    (B, H, 1, D) of its dtype and int32 lengths (B,), all on one CUDA
    device; raises on anything else. Counts
    its launches in `cache_row_update_kernel.launches`."""
    tensors = (cache, new_vals, lengths)
    if not all(t.is_cuda and t.device == cache.device for t in tensors):
        raise ValueError("cache_row_update_kernel takes CUDA tensors on one "
                         "device")
    if cache.dtype not in DTYPES or new_vals.dtype != cache.dtype:
        raise ValueError(f"cache must be one of {DTYPES} and new_vals of its "
                         f"dtype, got {cache.dtype} / {new_vals.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError("lengths must be int32")
    if cache.dim() != 4:
        raise ValueError(f"cache must be (B, H, S, D), got "
                         f"{tuple(cache.shape)}")
    b, h, s, d = cache.shape
    if new_vals.shape != (b, h, 1, d) or lengths.shape != (b,):
        raise ValueError(f"new_vals must be {(b, h, 1, d)} and lengths "
                         f"{(b,)}, got {tuple(new_vals.shape)} / "
                         f"{tuple(lengths.shape)}")
    for name, t in zip(("cache", "new_vals", "lengths"), tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if d * cache.element_size() % 16:
        raise ValueError(f"a row of D * element size bytes must be a multiple "
                         f"of 16, got {d * cache.element_size()}")
    lib = cuda_lib.load_library()
    with torch.cuda.device(cache.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_cache_row_update(
            cache.data_ptr(), new_vals.data_ptr(), lengths.data_ptr(), b, h,
            s, d * cache.element_size(), stream)
    cuda_lib.check(err, "cache_row_update_kernel")
    cache_row_update_kernel.launches += 1
    return cache


cache_row_update_kernel.launches = 0


def cache_row_update(cache: torch.Tensor, new_vals: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """cache (B, H, S, D); new_vals (B, H, 1, D), cast to the cache's dtype
    as in the JAX package; lengths (B,) int32 -> the same cache, with
    new_vals[b] written at [b, :, lengths[b], :]."""
    new_vals = new_vals.to(cache.dtype)
    if cache.is_cuda:
        return cache_row_update_kernel(cache, new_vals, lengths)
    if cache.device.type != "cpu":
        raise ValueError(f"no cache_row_update path for device {cache.device}")
    return cache_row_update_plain(cache, new_vals, lengths)
