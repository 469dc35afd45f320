// In-place KV-cache row write, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_write_kernel` of `cache_row_update`
// (lhrs_bot_tpu/ops/cache_update.py:20, called at :64): the (H, D) row of
// new values of batch row b is written at position lengths[b] of the
// (B, H, S, D) cache, in place; nothing else of the cache is touched. The
// TPU kernel read-modify-writes the 8-row window around the position
// (its sublane tiling); here each store goes straight to the row.
//
// What bounds it on the H100: bytes (B * H * D elements read once and
// written once, 0.00003 ms at B8 H32 D128 bf16), far below the time of any
// launch; what is left to a kernel is the latency of its dependent loads.
//
// Design: one thread per 16-byte unit of the B * H new rows (B8 H32 D128
// bf16: 4,096 units, 16 CTAs of 256), the grid's y the batch row b. Each
// thread issues its new_vals load and its lengths[b] load together, before
// either value is used and before any arithmetic (the division that finds
// its head waits for them), then stores: one round trip to device memory,
// where a CTA per batch row that reads lengths[b] before its copy takes
// two. The copy is the same whatever
// the dtype (float32, bf16, int8); every row the port holds (D 64 or 128) is
// a multiple of 16 bytes, and the entry refuses any other. A row with
// lengths[b] outside [0, S) writes nothing, as the decode kernels do; the
// plain version raises there.
//
// `lhrs_empty_kernel` launches a kernel that does nothing, on a grid of the
// row write's size: its time is the launch floor the row write is held
// against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    cache_row_update_kernel(uint4* __restrict__ cache,
                            const uint4* __restrict__ new_vals,
                            const int* __restrict__ lengths, int H, int S,
                            int units) {
  const int b = blockIdx.y, n = H * units;  // unit u of batch row b's rows
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= n) return;
  // both loads in flight at once, neither waiting on arithmetic (volatile,
  // so the value's is neither sunk below the test nor dropped)
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(new_vals + (size_t)b * n + u));
  int len;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(len) : "l"(lengths + b));
  if (len >= 0 && len < S) {
    const int h = u / units, c = u - h * units;
    cache[(((size_t)b * H + h) * S + len) * units + c] = v;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// cache (B,H,S,D) and new_vals (B,H,1,D) of one dtype, contiguous and
// 16-byte aligned; lengths (B,) int32 on the device; row_bytes = D * elt, a
// multiple of 16. Returns cudaError_t.
extern "C" int lhrs_cache_row_update(void* cache, const void* new_vals,
                                     const void* lengths, int B, int H, int S,
                                     int row_bytes, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || row_bytes <= 0 ||
      row_bytes % 16 || (long long)H * row_bytes / 16 > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const int units = row_bytes / 16, n = H * units;
  cache_row_update_kernel<<<dim3((n + kThreads - 1) / kThreads, B), kThreads,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(new_vals),
      static_cast<const int*>(lengths), H, S, units);
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing, `blocks` CTAs of 256 threads.
// Returns cudaError_t.
extern "C" int lhrs_empty_kernel(int blocks, void* stream) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
