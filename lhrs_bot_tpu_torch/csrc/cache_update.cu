// In-place KV-cache row write, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_write_kernel` of `cache_row_update`
// (lhrs_bot_tpu/ops/cache_update.py:20, called at :64): the (H, D) row of
// new values of batch row b is written at position lengths[b] of the
// (B, H, S, D) cache, in place; nothing else of the cache is touched. The
// TPU kernel read-modify-writes the 8-row window around the position
// (its sublane tiling); here each store goes straight to the row.
//
// What bounds it on the H100: bytes, and at these sizes launch latency:
// B * H * D elements are read once and written once.
//
// Design: one CTA per batch row; it reads lengths[b] and copies the H rows
// of D * elt bytes in 16-byte loads and stores, so the copy is the same
// whatever the dtype (float32, bf16, int8). Every row the port holds (D 64
// or 128) is a multiple of 16 bytes; the entry refuses any other. A row
// with lengths[b] outside [0, S) writes nothing, as the decode kernels do;
// the plain version raises there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cache_row_update_kernel(unsigned char* __restrict__ cache,
                            const unsigned char* __restrict__ new_vals,
                            const int* __restrict__ lengths, int H, int S,
                            int row_bytes) {
  const int b = blockIdx.x;
  const int len = lengths[b];
  if (len < 0 || len >= S) return;
  const int units = row_bytes / 16;
  for (int i = threadIdx.x; i < H * units; i += kThreads) {
    const int h = i / units, c = i - h * units;
    const size_t bh = (size_t)b * H + h;
    uint4* dst = reinterpret_cast<uint4*>(cache + (bh * S + len) * row_bytes);
    dst[c] = reinterpret_cast<const uint4*>(new_vals + bh * row_bytes)[c];
  }
}

}  // namespace

// cache (B,H,S,D) and new_vals (B,H,1,D) of one dtype, contiguous and
// 16-byte aligned; lengths (B,) int32 on the device; row_bytes = D * elt, a
// multiple of 16. Returns cudaError_t.
extern "C" int lhrs_cache_row_update(void* cache, const void* new_vals,
                                     const void* lengths, int B, int H, int S,
                                     int row_bytes, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || row_bytes <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  cache_row_update_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(cache),
      static_cast<const unsigned char*>(new_vals),
      static_cast<const int*>(lengths), H, S, row_bytes);
  return (int)cudaGetLastError();
}
