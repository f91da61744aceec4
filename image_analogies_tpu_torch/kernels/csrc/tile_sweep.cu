// One PatchMatch propagate + random-search sweep over tile-shared
// candidate offsets (kernel K1 of the port).
//
// Replaces: image_analogies_tpu/kernels/patchmatch_tile.py `_make_kernel`
// (launched by `_tile_sweep_jit` through `tile_sweep`), for its default
// mode: float32 planes and one A band.  What it computes, for interior
// pixel q = (ty0 + u, tx0 + v) of tile (i, j), ty0 = 64 i, tx0 = tw j, and
// candidate slot k with offset (oy, ox):
//
//   sy = clip(ty0 + oy, 0, ha - 64),  sx = clip(tx0 + ox, 0, wa - tw)
//   d  = sum over window groups g, channels c in g and taps (ty, tx) of
//        wy_g[ty] wx_g[tx] (B_c(q + delta) - A_c((sy + u, sx + v) + delta))^2
//        with delta = ((ty - r_g) dil_g, (tx - r_g) dil_g), both images
//        read with edge-clamped coordinates (the planes arrive
//        edge-padded by the halo, so no clamp is needed here);
//   the recorded offset is (sy - ty0, sx - tx0) for every pixel;
//   slots 0-19 fold into a coherent running minimum seeded with the
//   incoming state, slots 20-35 into an approximate one starting at +inf,
//   both with a strict `<` in slot order; an invalid slot is skipped
//   (the reference scores it +inf, which never wins a strict `<`); the
//   output takes the approximate winner iff d_app * coh_factor < d_coh.
//
// The TPU kernel's packed sublane layout, lane rotates, SMEM blocking,
// DMA semaphore ring and banded-matrix window sums are TPU mechanics and
// are not carried over.  Design here: one block of 128 threads per
// (tile, 8-row strip): 144 tiles x 8 strips = 1152 blocks at the 1024^2
// level 0, so the 132 SMs see many waves instead of one and a ragged
// second.  Thread l owns padded column l.  The B strip (8 + 2P rows x 128
// columns x C channels) is staged in shared memory once.  For each valid
// slot (validity is uniform over the tile, so an invalid slot is a
// whole-block skip) every thread reads its column of the A window
// straight from global memory (coalesced rows; the A planes, 17 MB at
// the headline, sit in the 50 MB L2), forms the per-group sum of squared
// channel differences, and the separable window runs as a horizontal
// pass through shared memory and a vertical pass down the thread's own
// column.  The running minima live in registers.  No atomics: the result
// is deterministic.
//
// Bound: operations.  Per launch at the 1024^2 level 0: about 1.2 M pixel
// positions x 36 slots x ~40 FLOP = 1.7 GFLOP against 67 TFLOP/s of FP32,
// about 25 us; the compulsory bytes (A and B planes once, three state
// planes in and out, about 60 MB) take about 18 us at 3.35 TB/s.  This
// first kernel recomputes the 2P halo rows of every strip (12 rows for 8
// outputs at P = 2) and streams the window from L2 for every slot, so it
// sits well above that bound; making it fast is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int LANE = 128;     // padded tile width: tile_w + 2 * halo
constexpr int TILE_H = 64;
constexpr int R = 8;          // output rows per block (strip)
constexpr int K_TOTAL = 36;
constexpr int K_COHERENT = 20;
constexpr int MAXT = 16;      // taps per window axis, at most

struct Params {
  const float* a;        // (C, a_h, a_w) A planes, edge-padded by halo
  const float* b;        // (C, b_h, b_w) B planes, edge-padded by halo
  const int* cand_y;     // (n_tiles, 36)
  const int* cand_x;
  const int* cand_valid;
  const int* oy_in;      // (n_ty * 64, n_tx * tile_w) compact state
  const int* ox_in;
  const float* d_in;
  int* oy_out;
  int* ox_out;
  float* d_out;
  const float* weights;  // (2 groups, 2 axes [y, x], MAXT)
  int n_chan, n_group0, ha, wa, a_h, a_w, b_h, b_w, n_ty, n_tx, tile_w;
  int taps0, dil0, taps1, dil1;
  float coh_factor;
};

template <int P>
__global__ void __launch_bounds__(LANE) tile_sweep_kernel(Params prm) {
  constexpr int ROWS = R + 2 * P;
  extern __shared__ float smem[];
  float* bs = smem;                                  // [C][ROWS][LANE]
  float* acc = bs + prm.n_chan * ROWS * LANE;        // [2][ROWS][LANE]
  float* xs = acc + 2 * ROWS * LANE;                 // [2][ROWS][LANE]
  float* wts = xs + 2 * ROWS * LANE;                 // [2][2][MAXT]

  const int l = threadIdx.x;
  const int tile = blockIdx.x;
  const int ti = tile / prm.n_tx;
  const int tj = tile % prm.n_tx;
  const int ty0 = ti * TILE_H;
  const int tx0 = tj * prm.tile_w;
  const int u0 = blockIdx.y * R;
  const int n_groups = prm.n_group0 < prm.n_chan ? 2 : 1;
  const int taps[2] = {prm.taps0, prm.taps1};
  const int dil[2] = {prm.dil0, prm.dil1};

  if (l < 2 * 2 * MAXT) wts[l] = prm.weights[l];
  for (int c = 0; c < prm.n_chan; ++c) {
    const float* bp = prm.b + (size_t)c * prm.b_h * prm.b_w;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      bs[(c * ROWS + r) * LANE + l] =
          bp[(size_t)(ty0 + u0 + r) * prm.b_w + tx0 + l];
    }
  }

  const bool owner = l < prm.tile_w;
  const int state_w = prm.n_tx * prm.tile_w;
  float d_coh[R], d_app[R];
  int y_coh[R], x_coh[R], y_app[R], x_app[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    d_app[u] = CUDART_INF_F;
    y_app[u] = 0;
    x_app[u] = 0;
    if (owner) {
      const size_t s = (size_t)(ty0 + u0 + u) * state_w + tx0 + l;
      d_coh[u] = prm.d_in[s];
      y_coh[u] = prm.oy_in[s];
      x_coh[u] = prm.ox_in[s];
    } else {
      d_coh[u] = CUDART_INF_F;
      y_coh[u] = 0;
      x_coh[u] = 0;
    }
  }
  __syncthreads();

  const int* cy = prm.cand_y + tile * K_TOTAL;
  const int* cx = prm.cand_x + tile * K_TOTAL;
  const int* cv = prm.cand_valid + tile * K_TOTAL;
  for (int k = 0; k < K_TOTAL; ++k) {
    if (cv[k] <= 0) continue;  // uniform over the block
    const int sy = min(max(ty0 + cy[k], 0), prm.ha - TILE_H);
    const int sx = min(max(tx0 + cx[k], 0), prm.wa - prm.tile_w);

    // Per-group sums of squared channel differences at column l.  The
    // channel loop is outside the unrolled row loop so each thread has a
    // whole column of independent L2 loads in flight per channel.
    float s0[ROWS], s1[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      s0[r] = 0.f;
      s1[r] = 0.f;
    }
    const float* a_col = prm.a + (size_t)(sy + u0) * prm.a_w + sx + l;
    for (int c = 0; c < prm.n_chan; ++c) {
      const float* ac = a_col + (size_t)c * prm.a_h * prm.a_w;
      const float* bc = bs + c * ROWS * LANE + l;
      float v[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) v[r] = ac[(size_t)r * prm.a_w];
      if (c < prm.n_group0) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float diff = bc[r * LANE] - v[r];
          s0[r] += diff * diff;
        }
      } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float diff = bc[r * LANE] - v[r];
          s1[r] += diff * diff;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      acc[r * LANE + l] = s0[r];
      acc[(ROWS + r) * LANE + l] = s1[r];
    }
    __syncthreads();

    if (owner) {
      // Horizontal window pass (reads neighbouring columns), into the
      // thread's own column of xs.
      for (int g = 0; g < n_groups; ++g) {
        const int rg = taps[g] / 2;
        const float* wx = wts + (g * 2 + 1) * MAXT;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float* row = acc + (g * ROWS + r) * LANE + l + P;
          float s = 0.f;
          for (int t = 0; t < taps[g]; ++t) s += wx[t] * row[(t - rg) * dil[g]];
          xs[(g * ROWS + r) * LANE + l] = s;
        }
      }
      // Vertical pass down the same column, then the two running minima.
      const int oy_o = sy - ty0;
      const int ox_o = sx - tx0;
#pragma unroll
      for (int u = 0; u < R; ++u) {
        float d = 0.f;
        for (int g = 0; g < n_groups; ++g) {
          const int rg = taps[g] / 2;
          const float* wy = wts + (g * 2) * MAXT;
          const float* col = xs + (g * ROWS + u + P) * LANE + l;
          float s = 0.f;
          for (int t = 0; t < taps[g]; ++t)
            s += wy[t] * col[(t - rg) * dil[g] * LANE];
          d += s;
        }
        if (k < K_COHERENT) {
          if (d < d_coh[u]) {
            d_coh[u] = d;
            y_coh[u] = oy_o;
            x_coh[u] = ox_o;
          }
        } else if (d < d_app[u]) {
          d_app[u] = d;
          y_app[u] = oy_o;
          x_app[u] = ox_o;
        }
      }
    }
    __syncthreads();  // acc is rewritten by the next slot
  }

  if (owner) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const size_t s = (size_t)(ty0 + u0 + u) * state_w + tx0 + l;
      const bool take_app = d_app[u] * prm.coh_factor < d_coh[u];
      prm.d_out[s] = take_app ? d_app[u] : d_coh[u];
      prm.oy_out[s] = take_app ? y_app[u] : y_coh[u];
      prm.ox_out[s] = take_app ? x_app[u] : x_coh[u];
    }
  }
}

template <int P>
int launch(const Params& prm, cudaStream_t stream) {
  constexpr int ROWS = R + 2 * P;
  const size_t smem =
      ((size_t)(prm.n_chan + 4) * ROWS * LANE + 2 * 2 * MAXT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sweep_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(prm.n_ty * prm.n_tx, TILE_H / R);
  tile_sweep_kernel<P><<<grid, LANE, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ia_tile_sweep(
    const float* a, const float* b, const int* cand_y, const int* cand_x,
    const int* cand_valid, const int* oy_in, const int* ox_in,
    const float* d_in, int* oy_out, int* ox_out, float* d_out,
    const float* weights, int n_chan, int n_group0, int ha, int wa, int a_h,
    int a_w, int b_h, int b_w, int n_ty, int n_tx, int tile_w, int halo,
    int taps0, int dil0, int taps1, int dil1, float coh_factor,
    cudaStream_t stream) {
  Params prm{a,     b,        cand_y, cand_x, cand_valid, oy_in, ox_in,
             d_in,  oy_out,   ox_out, d_out,  weights,    n_chan, n_group0,
             ha,    wa,       a_h,    a_w,    b_h,        b_w,   n_ty,
             n_tx,  tile_w,   taps0,  dil0,   taps1,      dil1,  coh_factor};
  if (tile_w + 2 * halo != LANE) return (int)cudaErrorInvalidValue;
  switch (halo) {
    case 1: return launch<1>(prm, stream);
    case 2: return launch<2>(prm, stream);
    case 3: return launch<3>(prm, stream);
    case 4: return launch<4>(prm, stream);
    case 5: return launch<5>(prm, stream);
    case 6: return launch<6>(prm, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
