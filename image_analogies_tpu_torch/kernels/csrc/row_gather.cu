// Row gather for the polish (kernel K3 of the port): out[r] = table[clamp(
// idx[r], 0, na - 1)], whole rows, bit-exact, in idx order.
//
// Replaces: image_analogies_tpu/kernels/polish_stream.py
// `_make_gather_kernel` (launched by `_gather_rows_jit` through
// `gather_rows`).  That kernel issued one HBM->VMEM DMA per 256 B row
// through a ring of 32 semaphores, because the TPU's gather lowering was
// bound by per-row issue overhead.  On the card a gather is plain loads
// and stores, so the port keeps only what it computes.
//
// Bound: bytes.  Every row read once and written once, plus the indices:
// M x (2 x row bytes + 8) over 3.35 TB/s; 1,048,576 bf16 rows of 256 B at
// the 1024^2 level 0 are ~545 MB, ~0.16 ms.  The table (256 MiB in bf16)
// does not fit the 50 MB L2, so random rows come from HBM.  Design: one
// kernel over BYTES per row, so bf16, int8 and float32 tables share it.
// Each thread moves one 16-byte chunk with a uint4 load and store (16
// threads per bf16 row, 8 per int8 row), neighbouring threads on
// neighbouring chunks of a row, so each row is one or two full 128-byte
// transactions on both sides; a grid-stride loop covers M x chunks, and
// the index is clamped here.  The table is read through the read-only
// path (__ldg).  Indices are int64, the port's index type, so no
// conversion kernel runs before the gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint4* __restrict__ table,
                   const long long* __restrict__ idx,
                   uint4* __restrict__ out, long long total, int na,
                   int chunks) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < total; e += stride) {
    const long long r = e / chunks;
    const int c = (int)(e - r * chunks);
    long long i = idx[r];
    i = i < 0 ? 0 : (i >= na ? na - 1 : i);
    out[e] = __ldg(table + i * chunks + c);
  }
}

}  // namespace

// `row_bytes` must be a multiple of 16 and `table` / `out` 16-byte
// aligned; the wrapper checks both.
extern "C" int ia_gather_rows(const void* table, const long long* idx,
                              void* out, long long m, int na, int row_bytes,
                              cudaStream_t stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || na <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = row_bytes / 16;
  const long long total = m * chunks;
  if (total > 0) {
    const long long want = (total + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    gather_rows_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const uint4*>(table), idx, static_cast<uint4*>(out),
        total, na, chunks);
  }
  return (int)cudaGetLastError();
}
