// A read-rate probe of the L2 cache: the blocks share the buffer in a
// grid-stride loop and together read it `passes` times with 16-byte loads
// that bypass L1, so a buffer that fits the 50 MB L2 is served from L2
// after its first pass.  Every thread keeps 8 independent loads in flight;
// the wrapper tries several block counts and keeps the best rate, so the
// rate is as near the L2's own as a plain read loop gets.  Not a kernel
// of the synthesis path: the smoke check divides the bytes a tile sweep
// pulls from L2 by this rate to state the sweep's L2 floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;

__global__ void __launch_bounds__(256)
l2_read_kernel(const uint4* __restrict__ src, long long n_vec, int passes,
               unsigned* __restrict__ sink) {
  unsigned acc = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (int p = 0; p < passes; ++p) {
    long long i = first;
    for (; i + (UNROLL - 1) * stride < n_vec; i += UNROLL * stride) {
      uint4 v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) v[k] = __ldcg(src + i + k * stride);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) acc ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
    }
    for (; i < n_vec; i += stride) {
      const uint4 v = __ldcg(src + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  // Keeps the loads alive; the buffer is never all-ones.
  if (acc == 0xffffffffu) sink[0] = acc;
}

}  // namespace

// Reads `n_bytes` (a multiple of 16) at `src` `passes` times on `blocks`
// blocks of 256 threads.
extern "C" int ia_l2_read(const void* src, long long n_bytes, int passes,
                          int blocks, unsigned* sink, cudaStream_t stream) {
  if (n_bytes % 16 || blocks < 1) return (int)cudaErrorInvalidValue;
  l2_read_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const uint4*>(src), n_bytes / 16, passes, sink);
  return (int)cudaGetLastError();
}
