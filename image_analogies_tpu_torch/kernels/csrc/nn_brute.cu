// Exact nearest neighbour over a feature table: for each query row b,
// the argmin over A rows of ||a||^2 - 2 b.a, accumulated in float32, the
// lowest index winning ties.  The N_B x N_A distance matrix is never
// materialized: each block holds 64 queries and streams the whole A table
// through shared memory in 64-row tiles, keeping a running (distance,
// index) minimum in registers.
//
// Replaces: image_analogies_tpu/kernels/nn_brute.py `_make_nn_kernel`
// (launched by `_nn_chunk_call` through `exact_nn_pallas`).  That kernel
// walked a sequential TPU grid and carried the minimum in VMEM scratch
// from one A tile to the next; here the A-tile walk is a loop inside the
// block, so nothing has to carry between blocks.
//
// Bound: operations.  2 * N_B * N_A * D float32 FLOP (5.8e11 at 65,536^2 x
// 68, the 256^2 level 0) against 67 TFLOP/s of FP32 on the CUDA cores:
// about 9 ms.  The bytes (both tables once, a few MB) are negligible.
// This first kernel is a plain shared-memory-tiled SGEMM on the CUDA
// cores: each of 256 threads owns a 4 x 4 (query, A row) micro-tile with
// a stride of 16, so shared-memory reads are conflict-free.  Tensor cores
// in TF32 would change the argmin against the float32 reference and are
// left for later.
//
// Ties: each thread visits its A rows in increasing index order with a
// strict `<`, so it holds the lexicographic (distance, index) minimum of
// its rows; the 16 threads of a query row then merge lexicographically,
// which gives the global first-index minimum, as jnp.argmin does.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TQ = 64;   // queries per block
constexpr int TA = 64;   // A rows per tile
constexpr int KC = 16;   // feature columns per shared-memory stage

__global__ void __launch_bounds__(256)
nn_argmin_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                 const float* __restrict__ a_sq, int* __restrict__ idx_out,
                 float* __restrict__ d_out, int n_b, int n_a, int d) {
  __shared__ float bs[KC][TQ];
  __shared__ float as[KC][TA + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * TQ;

  float best_d[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_d[i] = CUDART_INF_F;
    best_i[i] = 0;
  }

  for (int j0 = 0; j0 < n_a; j0 += TA) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int k0 = 0; k0 < d; k0 += KC) {
#pragma unroll
      for (int s = 0; s < (TQ * KC) / 256; ++s) {
        const int e = tid + 256 * s;
        const int row = e / KC;
        const int kk = e % KC;
        const int k = k0 + kk;
        const int q = q0 + row;
        const int j = j0 + row;
        bs[kk][row] = (q < n_b && k < d) ? fb[(size_t)q * d + k] : 0.f;
        as[kk][row] = (j < n_a && k < d) ? fa[(size_t)j * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = bs[kk][ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = as[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < n_a) {
        const float sq = a_sq[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dist = sq - 2.f * acc[i][c];
          if (dist < best_d[i]) {
            best_d[i] = dist;
            best_i[i] = j;
          }
        }
      }
    }
  }

  // Lexicographic merge across the 16 threads (one half-warp) that share
  // these query rows.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bd = best_d[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int q = q0 + ty + 16 * i;
    if (tx == 0 && q < n_b) {
      idx_out[q] = bi;
      d_out[q] = bd;
    }
  }
}

}  // namespace

extern "C" int ia_nn_argmin(const float* fb, const float* fa,
                            const float* a_sq, int* idx_out, float* d_out,
                            int n_b, int n_a, int d, cudaStream_t stream) {
  const int blocks = (n_b + TQ - 1) / TQ;
  if (blocks > 0) {
    nn_argmin_kernel<<<blocks, 256, 0, stream>>>(fb, fa, a_sq, idx_out,
                                                 d_out, n_b, n_a, d);
  }
  return static_cast<int>(cudaGetLastError());
}
