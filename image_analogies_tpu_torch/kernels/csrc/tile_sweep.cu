// One PatchMatch propagate + random-search sweep over tile-shared
// candidate offsets (kernel K1 of the port).
//
// Replaces: image_analogies_tpu/kernels/patchmatch_tile.py `_make_kernel`
// (launched by `_tile_sweep_jit` through `tile_sweep`), for one A band,
// with float32 A planes or, in the compressed-candidate mode, int8 A
// planes on the static affine grid q = round(254 x - 127): the A load is
// templated on the element type and an int8 value is dequantized to
// (q + 127) * (1 / 254) in registers, the reference's formula, before
// the channel difference.  What it computes, for interior
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
// are not carried over.
//
// Bound.  By the card's published peaks the work is tiny: at the 1024^2
// level 0 about 1.7 GFLOP a launch (25 us of FP32) and 60 MB of compulsory
// bytes (18 us of HBM).  What bounds the algorithm on this card is the
// window traffic from L2: every (tile, strip, valid slot) pulls a
// C x rows x 128 window of the A planes (which sit in the 50 MB L2), some
// hundreds of MB a launch, and the latency of those loads when nothing
// else is in flight.
//
// Design for this card.
//   - One block of 256 threads per (tile, strip of R output rows); thread
//     (l, h) owns padded column l and half the strip's rows.  A strip of
//     16 rows recomputes 1.25x its rows for the halo at halo 2, one of 8
//     rows 1.5x.  The wrapper chooses R from the channel count and halo
//     (`sweep_plan` in patchmatch_tile.py): two resident blocks an SM
//     come first (16 warps hide the latency that one block's barriers
//     expose), then the taller strip.  At the main path's 4 channels that
//     is 16 rows in both modes (83 KB a block).
//   - The block compacts its tile's valid slots once (ballot over
//     `cand_valid`, slot order kept since the strict `<` depends on it)
//     with the clamped (sy, sx), so the pipeline never meets a skipped
//     slot.
//   - The A window of a slot is read straight from L2 through L1 into
//     registers.  A shared-memory ring that prefetched the next slot's
//     window with `cp.async` was built and measured 7-43 % slower in both
//     modes (the other resident block's warps already hide that latency,
//     and the ring costs its copies' scheduler slots and shared-memory
//     writes), so it was taken out; PERF.md keeps its times.
//   - One `__syncthreads()` per slot: the per-group sums of squared
//     differences go to a double-buffered plane, so slot k + 1's
//     differences are formed between the same two barriers as slot k's
//     window pass.  The horizontal pass reads the neighbours' columns of
//     that plane and keeps its sums in registers; the vertical pass runs
//     down the thread's own registers.
//   - The windows of the main path (5 taps at dilation 1 and 3 taps at
//     dilation 2, halo 2) are a compile-time instantiation with unrolled
//     tap loops (`FIXED`); every other spec runs the general instantiation
//     with run-time tap loops.  Sum order in both: horizontal then
//     vertical per group, group 0 then group 1.
//   - Running minima in registers, no atomics: the result is
//     deterministic.
//   - Frames.  The batch runner's resident frames (the reference's `vmap`
//     gives its kernel the frame axis as a leading grid dimension) are the
//     grid's z dimension: block (x, y, f) reads frame f's B planes,
//     candidate tables and state at 64-bit frame strides and shares the A
//     planes.  Nothing else depends on the frame and no shared-memory or
//     reduction state crosses blocks, so frame f of a launch over F frames
//     is the single-frame launch on frame f's inputs, bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int LANE = 128;     // padded tile width: tile_w + 2 * halo
constexpr int TILE_H = 64;
constexpr int NT = 256;       // threads per block
constexpr int K_TOTAL = 36;
constexpr int K_COHERENT = 20;
constexpr int MAXT = 16;      // taps per window axis, at most
constexpr int LIST = 40;      // ints per slot list (36 used)
constexpr float DEQ = (float)(1.0 / 254.0);  // int8 grid step

__device__ __forceinline__ float load_a(const float* p) { return *p; }
// (q + 127) * (1 / 254).  The integer-to-float conversion runs at a
// quarter of the arithmetic rate, so q + 128 (the byte with its sign bit
// flipped) is placed in the mantissa of 2^23 and the bias subtracted:
// exact, like the conversion.  `__fmul_rn` keeps the product a rounded
// float32 of its own: fused into the channel difference it would round
// once, and the int8 mode would no longer pick what the float32 mode
// picks on dequantized planes.
__device__ __forceinline__ float load_a(const signed char* p) {
  const unsigned u = (unsigned)*reinterpret_cast<const unsigned char*>(p) ^
                     0x80u;
  const float q128 = __uint_as_float(0x4B000000u | u) - 8388608.f;
  return __fmul_rn(q128 - 1.f, DEQ);
}

template <typename TA>
struct Params {
  const TA* a;           // (C, a_h, a_w) A planes, edge-padded by halo
  const float* b;        // (F, C, b_h, b_w) B planes, edge-padded by halo
  const int* cand_y;     // (F, n_tiles, 36)
  const int* cand_x;
  const int* cand_valid;
  const int* oy_in;      // (F, n_ty * 64, n_tx * tile_w) compact state
  const int* ox_in;
  const float* d_in;
  int* oy_out;
  int* ox_out;
  float* d_out;
  const float* weights;  // (2 groups, 2 axes [y, x], MAXT)
  int n_chan, n_group0, ha, wa, a_h, a_w, b_h, b_w, n_ty, n_tx, tile_w;
  int taps0, dil0, taps1, dil1;
  int n_frames;          // the grid's z dimension
  float coh_factor;
};

template <int P, int R>
__host__ __device__ constexpr size_t smem_bytes(int n_chan) {
  // B strip, the double-buffered group sums, weights, slot lists.
  return ((size_t)(n_chan + 4) * (R + 2 * P) * LANE + 2 * 2 * MAXT +
          4 * LIST) * sizeof(float);
}

// FIXED: the main path's windows, 5 taps at dilation 1 (group 0) and 3
// taps at dilation 2 (group 1), at halo 2.
template <int P, typename TA, int R, bool FIXED>
__global__ void __launch_bounds__(NT, 2) tile_sweep_kernel(Params<TA> prm) {
  constexpr int ROWS = R + 2 * P;
  constexpr int HR = ROWS / 2;   // rows of differences per thread
  constexpr int H = R / 2;       // output rows per thread
  constexpr int XR = H + 2 * P;  // horizontal sums a thread needs
  static_assert(!FIXED || P == 2, "the fixed windows have halo 2");
  extern __shared__ __align__(16) float smem[];
  const int C = prm.n_chan;
  float* bs = smem;                                  // [C][ROWS][LANE]
  float* acc = bs + C * ROWS * LANE;                 // [2][2][ROWS][LANE]
  float* wts = acc + 2 * 2 * ROWS * LANE;            // [2][2][MAXT]
  int* slot_k = reinterpret_cast<int*>(wts + 2 * 2 * MAXT);
  int* slot_sy = slot_k + LIST;
  int* slot_sx = slot_sy + LIST;
  int* n_slots = slot_sx + LIST;

  const int tid = threadIdx.x;
  const int l = tid & (LANE - 1);
  const int h = tid >> 7;
  const int tile = blockIdx.x;
  const int ti = tile / prm.n_tx;
  const int tj = tile % prm.n_tx;
  const int ty0 = ti * TILE_H;
  const int tx0 = tj * prm.tile_w;
  const int u0 = blockIdx.y * R;
  const bool two_groups = prm.n_group0 < C;
  const size_t plane = (size_t)prm.a_h * prm.a_w;
  const int state_w = prm.n_tx * prm.tile_w;

  // This block's frame: its B planes, candidate tables and state.
  const long long f = blockIdx.z;
  const float* b_f = prm.b + f * C * (long long)prm.b_h * prm.b_w;
  const long long cand_f = f * prm.n_ty * prm.n_tx * K_TOTAL;
  const long long state_f = f * prm.n_ty * TILE_H * (long long)state_w;

  // The valid slots of this tile, compacted in slot order.
  if (tid < 32) {
    const int* cv = prm.cand_valid + cand_f + tile * K_TOTAL;
    const int* cy = prm.cand_y + cand_f + tile * K_TOTAL;
    const int* cx = prm.cand_x + cand_f + tile * K_TOTAL;
    const bool v0 = cv[tid] > 0;
    const bool v1 = tid < K_TOTAL - 32 && cv[32 + tid] > 0;
    const unsigned m0 = __ballot_sync(0xffffffffu, v0);
    const unsigned m1 = __ballot_sync(0xffffffffu, v1);
    const unsigned below = (1u << tid) - 1u;
    if (v0) {
      const int pos = __popc(m0 & below);
      slot_k[pos] = tid;
      slot_sy[pos] = min(max(ty0 + cy[tid], 0), prm.ha - TILE_H);
      slot_sx[pos] = min(max(tx0 + cx[tid], 0), prm.wa - prm.tile_w);
    }
    if (v1) {
      const int pos = __popc(m0) + __popc(m1 & below);
      slot_k[pos] = 32 + tid;
      slot_sy[pos] = min(max(ty0 + cy[32 + tid], 0), prm.ha - TILE_H);
      slot_sx[pos] = min(max(tx0 + cx[32 + tid], 0), prm.wa - prm.tile_w);
    }
    if (tid == 0) n_slots[0] = __popc(m0) + __popc(m1);
  }
  if (tid < 2 * 2 * MAXT) wts[tid] = prm.weights[tid];
  __syncthreads();
  const int n = n_slots[0];

  for (int c = 0; c < C; ++c) {
    const float* bp = b_f + (size_t)c * prm.b_h * prm.b_w;
#pragma unroll
    for (int i = 0; i < HR; ++i) {
      const int r = h * HR + i;
      bs[(c * ROWS + r) * LANE + l] =
          bp[(size_t)(ty0 + u0 + r) * prm.b_w + tx0 + l];
    }
  }

  const bool owner = l < prm.tile_w;
  const int row0 = ty0 + u0 + h * H;  // the thread's first output row
  float d_coh[H], d_app[H];
  int y_coh[H], x_coh[H], y_app[H], x_app[H];
#pragma unroll
  for (int u = 0; u < H; ++u) {
    d_app[u] = CUDART_INF_F;
    y_app[u] = 0;
    x_app[u] = 0;
    if (owner) {
      const size_t s = state_f + (size_t)(row0 + u) * state_w + tx0 + l;
      d_coh[u] = prm.d_in[s];
      y_coh[u] = prm.oy_in[s];
      x_coh[u] = prm.ox_in[s];
    } else {
      d_coh[u] = CUDART_INF_F;
      y_coh[u] = 0;
      x_coh[u] = 0;
    }
  }

  // Per-group sums of squared channel differences of slot j at the
  // thread's column and HR rows, into plane `buf`.
  auto differences = [&](int j, int buf) {
    const int sy = slot_sy[j];
    const int sx = slot_sx[j];
    float s0[HR], s1[HR];
#pragma unroll
    for (int i = 0; i < HR; ++i) {
      s0[i] = 0.f;
      s1[i] = 0.f;
    }
    const int r0 = h * HR;
    for (int c = 0; c < C; ++c) {
      const long long e0 =
          (long long)c * plane + (long long)(sy + u0 + r0) * prm.a_w + sx;
      const float* bc = bs + (c * ROWS + r0) * LANE + l;
      float v[HR];
      const TA* w = prm.a + e0 + l;
#pragma unroll
      for (int i = 0; i < HR; ++i) v[i] = load_a(w + (size_t)i * prm.a_w);
      if (c < prm.n_group0) {
#pragma unroll
        for (int i = 0; i < HR; ++i) {
          const float diff = bc[i * LANE] - v[i];
          s0[i] += diff * diff;
        }
      } else {
#pragma unroll
        for (int i = 0; i < HR; ++i) {
          const float diff = bc[i * LANE] - v[i];
          s1[i] += diff * diff;
        }
      }
    }
    float* out = acc + (buf * 2 * ROWS + r0) * LANE + l;
#pragma unroll
    for (int i = 0; i < HR; ++i) {
      out[i * LANE] = s0[i];
      out[(ROWS + i) * LANE] = s1[i];
    }
  };

  // The separable window over plane `buf` and the two running minima.
  auto window_pass = [&](int j, int buf) {
    const int k = slot_k[j];
    const int oy_o = slot_sy[j] - ty0;
    const int ox_o = slot_sx[j] - tx0;
    // Row h * H + i of the plane is output row u = i - P of the thread.
    const float* p0 = acc + (buf * 2 * ROWS + h * H) * LANE + l + P;
    const float* p1 = p0 + ROWS * LANE;
    float d[H];
    if (FIXED) {
      const float* w0y = wts;
      const float* w0x = wts + MAXT;
      const float* w1y = wts + 2 * MAXT;
      const float* w1x = wts + 3 * MAXT;
      float xs0[XR], xs1[XR];
#pragma unroll
      for (int i = 0; i < XR; ++i) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 5; ++t) s += w0x[t] * p0[i * LANE + (t - 2)];
        xs0[i] = s;
      }
      if (two_groups) {
#pragma unroll
        for (int i = 0; i < XR; ++i) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < 3; ++t) s += w1x[t] * p1[i * LANE + (t - 1) * 2];
          xs1[i] = s;
        }
      }
#pragma unroll
      for (int u = 0; u < H; ++u) {
        float dd = 0.f;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 5; ++t) s += w0y[t] * xs0[u + P + (t - 2)];
        dd += s;
        if (two_groups) {
          s = 0.f;
#pragma unroll
          for (int t = 0; t < 3; ++t) s += w1y[t] * xs1[u + P + (t - 1) * 2];
          dd += s;
        }
        d[u] = dd;
      }
    } else {
      const int taps[2] = {prm.taps0, prm.taps1};
      const int dil[2] = {prm.dil0, prm.dil1};
      const int n_groups = two_groups ? 2 : 1;
#pragma unroll
      for (int u = 0; u < H; ++u) {
        float dd = 0.f;
        for (int g = 0; g < n_groups; ++g) {
          const int rg = taps[g] / 2;
          const float* wy = wts + (g * 2) * MAXT;
          const float* wx = wy + MAXT;
          const float* pg = (g ? p1 : p0) + (u + P) * LANE;
          float s = 0.f;
          for (int ty = 0; ty < taps[g]; ++ty) {
            const float* row = pg + (ty - rg) * dil[g] * LANE;
            float xs = 0.f;
            for (int tx = 0; tx < taps[g]; ++tx)
              xs += wx[tx] * row[(tx - rg) * dil[g]];
            s += wy[ty] * xs;
          }
          dd += s;
        }
        d[u] = dd;
      }
    }
#pragma unroll
    for (int u = 0; u < H; ++u) {
      if (k < K_COHERENT) {
        if (d[u] < d_coh[u]) {
          d_coh[u] = d[u];
          y_coh[u] = oy_o;
          x_coh[u] = ox_o;
        }
      } else if (d[u] < d_app[u]) {
        d_app[u] = d[u];
        y_app[u] = oy_o;
        x_app[u] = ox_o;
      }
    }
  };

  if (n > 0) {
    __syncthreads();  // the B strip is in place
    differences(0, 0);
    for (int j = 0; j < n; ++j) {
      __syncthreads();  // plane j & 1 is whole; the other one is free
      if (owner) window_pass(j, j & 1);
      if (j + 1 < n) differences(j + 1, (j + 1) & 1);
    }
  }

  if (owner) {
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const size_t s = state_f + (size_t)(row0 + u) * state_w + tx0 + l;
      const bool take_app = d_app[u] * prm.coh_factor < d_coh[u];
      prm.d_out[s] = take_app ? d_app[u] : d_coh[u];
      prm.oy_out[s] = take_app ? y_app[u] : y_coh[u];
      prm.ox_out[s] = take_app ? x_app[u] : x_coh[u];
    }
  }
}

template <int P, typename TA, int R, bool FIXED>
int launch(const Params<TA>& prm, cudaStream_t stream) {
  const size_t smem = smem_bytes<P, R>(prm.n_chan);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sweep_kernel<P, TA, R, FIXED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(prm.n_ty * prm.n_tx, TILE_H / R, prm.n_frames);
  tile_sweep_kernel<P, TA, R, FIXED><<<grid, NT, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <int P, typename TA, bool FIXED>
int launch_rows(const Params<TA>& prm, int rows, cudaStream_t stream) {
  if (rows == 8) return launch<P, TA, 8, FIXED>(prm, stream);
  if (rows == 16) return launch<P, TA, 16, FIXED>(prm, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TA>
int launch_halo(const Params<TA>& prm, int halo, int rows, bool fixed,
                cudaStream_t stream) {
  if (fixed) return launch_rows<2, TA, true>(prm, rows, stream);
  switch (halo) {
    case 1: return launch_rows<1, TA, false>(prm, rows, stream);
    case 2: return launch_rows<2, TA, false>(prm, rows, stream);
    case 3: return launch_rows<3, TA, false>(prm, rows, stream);
    case 4: return launch_rows<4, TA, false>(prm, rows, stream);
    case 5: return launch_rows<5, TA, false>(prm, rows, stream);
    case 6: return launch_rows<6, TA, false>(prm, rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TA>
Params<TA> make_params(
    const void* a, const float* b, const int* cand_y, const int* cand_x,
    const int* cand_valid, const int* oy_in, const int* ox_in,
    const float* d_in, int* oy_out, int* ox_out, float* d_out,
    const float* weights, int n_chan, int n_group0, int ha, int wa, int a_h,
    int a_w, int b_h, int b_w, int n_ty, int n_tx, int tile_w, int taps0,
    int dil0, int taps1, int dil1, int n_frames, float coh_factor) {
  return Params<TA>{static_cast<const TA*>(a), b, cand_y, cand_x, cand_valid,
                    oy_in, ox_in, d_in, oy_out, ox_out, d_out, weights,
                    n_chan, n_group0, ha, wa, a_h, a_w, b_h, b_w, n_ty, n_tx,
                    tile_w, taps0, dil0, taps1, dil1, n_frames, coh_factor};
}

}  // namespace

// `a` points at float32 planes, or at int8 planes when `a_int8` is 1.
// `strip_rows` (8 or 16) is the wrapper's plan; `general` forces the
// run-time tap loops where the fixed windows would apply.  `n_frames`
// frames of B planes, candidate tables and state follow each other in
// memory (one frame: the single-image sweep).
extern "C" int ia_tile_sweep(
    const void* a, const float* b, const int* cand_y, const int* cand_x,
    const int* cand_valid, const int* oy_in, const int* ox_in,
    const float* d_in, int* oy_out, int* ox_out, float* d_out,
    const float* weights, int n_chan, int n_group0, int ha, int wa, int a_h,
    int a_w, int b_h, int b_w, int n_ty, int n_tx, int tile_w, int halo,
    int taps0, int dil0, int taps1, int dil1, int a_int8, int strip_rows,
    int general, int n_frames, float coh_factor, cudaStream_t stream) {
  if (tile_w + 2 * halo != LANE) return (int)cudaErrorInvalidValue;
  if (n_frames < 1 || n_frames > 65535) return (int)cudaErrorInvalidValue;
  const bool fixed = !general && halo == 2 && taps0 == 5 && dil0 == 1 &&
                     (n_group0 == n_chan || (taps1 == 3 && dil1 == 2));
#define IA_PARAMS(TA)                                                        \
  make_params<TA>(a, b, cand_y, cand_x, cand_valid, oy_in, ox_in, d_in,      \
                  oy_out, ox_out, d_out, weights, n_chan, n_group0, ha, wa,  \
                  a_h, a_w, b_h, b_w, n_ty, n_tx, tile_w, taps0, dil0, taps1, \
                  dil1, n_frames, coh_factor)
  if (a_int8)
    return launch_halo(IA_PARAMS(signed char), halo, strip_rows, fixed,
                       stream);
  return launch_halo(IA_PARAMS(float), halo, strip_rows, fixed, stream);
#undef IA_PARAMS
}
