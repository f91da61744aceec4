// One sweep of the per-pixel PatchMatch cascade in one launch (kernel K4
// of the port).
//
// Replaces no TPU kernel.  The JAX package runs this cascade as `jnp`
// under `jit` (image_analogies_tpu/models/patchmatch.py
// `patchmatch_sweeps_lean`), where XLA fuses each candidate's gather,
// distance and accept into a few fusions.  Run eagerly, the port issued
// ~22 launches a candidate, 14 candidates a sweep at the 64^2 level and
// 12 in every tile level's polish; the host's issue of them, not the
// device, set the pace.  This kernel computes what `cascade_sweep_plain`
// (kernels/pixel_cascade.py) computes, the candidates in the same order:
//
//   steps 0-3, propagation, DELTAS order (left, right, up, down):
//     (dy, dx) -> candidate = neighbour's match + (dy, dx), the
//     neighbour being ((y - dy) mod h, (x - dx) mod w) (`torch.roll`);
//   steps 4-7, the same four neighbours' matches unshifted;
//   steps 8.., the sweep's n_random offsets added to the current match.
//   Each candidate is clamped to A, its flat index is cy * wa + cx, its
//   distance sum_k (B[q, k] - A[idx, k])^2 over the B width d (A rows may
//   be wider: zero pad, never read), and it is accepted iff
//   d_c * factor < d_cur, or d_c == d_cur and idx < the current index
//   (factor 1 for the eight neighbour steps, coh_factor for the random
//   ones).
//
// Every step is a Jacobi step: it reads the field the previous step left
// everywhere.  A pixel's random steps read only its own match, so they
// run back to back in registers; the eight neighbour steps read other
// pixels' matches, so they ping-pong between two (py, px, dist) buffers
// with a grid-wide barrier between them (a cooperative launch, sized to
// the blocks that can be resident at once).  With `dist_in` null the
// kernel first computes the incoming match's distance (a sweep's first
// launch), so every distance of the cascade comes from this arithmetic.
//
// Bound.  At 64^2 (float32 rows of 50) a sweep moves ~6 MB of rows
// through L2 and is bound by latency: 8 dependent steps, 7 barriers and
// the random probes' chain, a few microseconds each.  At the 1024^2
// polish (bf16 rows of 68) each step reads 1M B rows and 1M A rows,
// ~280 MB, mostly from HBM (the tables are 136 MB each, the L2 50 MB),
// ~1 ms a sweep at 3.35 TB/s.  Measured on an H100 SXM at 700 W: 0.028
// ms a sweep at 64^2 (the eager cascade 3.99 ms), 1.68 ms at the 1024^2
// polish (eager 17.97 ms) against its 1.02 ms of row traffic at HBM
// rate (PERF.md, the kernel table).
//
// Design.
//   - Eight lanes per pixel: lane l reads elements l, l + 8, ... of both
//     rows, so a pixel's row read is 16 (bf16) or 32 (float32) contiguous
//     bytes an instruction, and four pixels share a warp.  Each lane sums
//     its elements in order (one FMA each), then three xor shuffles
//     (4, 2, 1) add the lanes' sums.  The order is fixed and the adds
//     commute bit for bit, so every lane of a pixel holds the same sum,
//     equal rows give equal bits, and a run repeats its bits.  No atomics.
//   - Rows are read as stored (float32 or bf16, converted in registers);
//     no cast copy of a table is made.
//   - The grid follows H x W: ceil(H W / 32) blocks of 256 threads up to
//     what is resident at once, a grid-stride loop beyond (a 64^2 field
//     is 128 blocks, 1024^2 fills every SM).  Blocks never depend on
//     which pixels they hold, so the result does not depend on the grid.
//   - A frame's launch reads that frame's tables and field only.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 8;                       // lanes per pixel
constexpr int GROUPS_PER_WARP = 32 / LANES;    // pixels per warp
constexpr int PIX_PER_BLOCK = THREADS / LANES; // pixels per block
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* f_b;
  const void* f_a;
  int d, ld_b, ld_a;
  int h, w, ha, wa;
  const long long* py_in;
  const long long* px_in;
  const float* dist_in;  // null: compute the incoming match's distance
  const long long* off;  // (n_random, h, w, 2)
  int n_random;
  float coh;
  int* sy[2];
  int* sx[2];
  float* sd[2];
  long long* py_out;
  long long* px_out;
  float* dist_out;
};

__device__ __forceinline__ int clampi(long long v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : (int)v);
}

// Squared distance between B row `b` and A row `a` over d elements:
// lane `lane` sums elements lane, lane + 8, ... in order, then the eight
// lanes' sums are added by xor shuffles.  Every lane of the warp must
// call it (the shuffles name the whole warp).
template <typename T>
__device__ __forceinline__ float row_dist(const T* __restrict__ b,
                                          const T* __restrict__ a, int d,
                                          int lane) {
  float acc = 0.0f;
  for (int k = lane; k < d; k += LANES) {
    const float diff = __fsub_rn(to_f(b[k]), to_f(a[k]));
    acc = fmaf(diff, diff, acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cascade_kernel(Args g) {
  cg::grid_group grid = cg::this_grid();
  const T* __restrict__ fb = static_cast<const T*>(g.f_b);
  const T* __restrict__ fa = static_cast<const T*>(g.f_a);
  const int lane = threadIdx.x & (LANES - 1);
  const int npix = g.h * g.w;
  const int hi_y = g.ha - 1, hi_x = g.wa - 1;
  // Pixel groups: this thread's, and its warp's first, so that the
  // grid-stride loop's bound is the same for the whole warp.
  const int group = (blockIdx.x * THREADS + threadIdx.x) / LANES;
  const int in_warp = group % GROUPS_PER_WARP;
  const int stride = gridDim.x * PIX_PER_BLOCK;
  for (int step = 0; step < 8; ++step) {
    // DELTAS: (0, -1), (0, 1), (-1, 0), (1, 0).
    const int k = step & 3;
    const int dy = k == 2 ? -1 : (k == 3 ? 1 : 0);
    const int dx = k == 0 ? -1 : (k == 1 ? 1 : 0);
    const bool shift = step < 4;
    const int src = (step + 1) & 1, dst = step & 1;
    for (int base = group - in_warp; base < npix; base += stride) {
      const int p = base + in_warp;
      const bool live = p < npix;
      const int q = live ? p : 0;
      const int y = q / g.w, x = q - (q / g.w) * g.w;
      int sy = y - dy, sx = x - dx;
      sy = sy < 0 ? sy + g.h : (sy >= g.h ? sy - g.h : sy);
      sx = sx < 0 ? sx + g.w : (sx >= g.w ? sx - g.w : sx);
      const int s = sy * g.w + sx;
      const T* brow = fb + (long long)q * g.ld_b;
      int cy, cx, ny, nx;
      float cd;
      if (step == 0) {
        cy = clampi(g.py_in[q], hi_y);
        cx = clampi(g.px_in[q], hi_x);
        ny = clampi(g.py_in[s], hi_y);
        nx = clampi(g.px_in[s], hi_x);
        cd = g.dist_in != nullptr
                 ? g.dist_in[q]
                 : row_dist(brow, fa + (long long)(cy * g.wa + cx) * g.ld_a,
                            g.d, lane);
      } else {
        cy = g.sy[src][q];
        cx = g.sx[src][q];
        cd = g.sd[src][q];
        ny = g.sy[src][s];
        nx = g.sx[src][s];
      }
      if (shift) {
        ny = clampi(ny + dy, hi_y);
        nx = clampi(nx + dx, hi_x);
      }
      const int idx = ny * g.wa + nx;
      const float nd =
          row_dist(brow, fa + (long long)idx * g.ld_a, g.d, lane);
      if (nd < cd || (nd == cd && idx < cy * g.wa + cx)) {
        cy = ny;
        cx = nx;
        cd = nd;
      }
      if (step < 7) {
        if (live && lane == 0) {
          g.sy[dst][q] = cy;
          g.sx[dst][q] = cx;
          g.sd[dst][q] = cd;
        }
        continue;
      }
      // Random search: each probe reads this pixel's match only.
      for (int r = 0; r < g.n_random; ++r) {
        const long long* o = g.off + ((long long)r * npix + q) * 2;
        const int ry = clampi((long long)cy + o[0], hi_y);
        const int rx = clampi((long long)cx + o[1], hi_x);
        const int ridx = ry * g.wa + rx;
        const float rd =
            row_dist(brow, fa + (long long)ridx * g.ld_a, g.d, lane);
        if (__fmul_rn(rd, g.coh) < cd ||
            (rd == cd && ridx < cy * g.wa + cx)) {
          cy = ry;
          cx = rx;
          cd = rd;
        }
      }
      if (live && lane == 0) {
        g.py_out[q] = cy;
        g.px_out[q] = cx;
        g.dist_out[q] = cd;
      }
    }
    if (step < 7) grid.sync();
  }
}

// Resident blocks per SM of each instantiation, per device (0: not
// asked yet).  A benign race: every writer stores the same value.
int g_blocks_per_sm[2][MAX_DEVICES];

template <typename T>
int launch(const Args& args, int dtype, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& per_sm = g_blocks_per_sm[dtype][dev];
  if (per_sm == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, cascade_kernel<T>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm = n;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long npix = (long long)args.h * args.w;
  const long long want = (npix + PIX_PER_BLOCK - 1) / PIX_PER_BLOCK;
  const long long most = (long long)per_sm * sms;
  const int blocks = (int)(want < most ? want : most);
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)cascade_kernel<T>,
                                    dim3(blocks), dim3(THREADS), params, 0,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep.  `dtype` 0: float32 tables, 1: bf16.  Tables are row-major
// with row strides ld_b, ld_a (elements) >= d; the field and the
// offsets are int64; `scratch` holds 6 h w 32-bit words (two (py, px,
// dist) buffers).  The wrapper checks shapes, dtypes and contiguity.
extern "C" int ia_pixel_cascade(
    const void* f_b, const void* f_a, int dtype, int d, int ld_b, int ld_a,
    int h, int w, int ha, int wa, const long long* py_in,
    const long long* px_in, const float* dist_in, const long long* off,
    int n_random, float coh, void* scratch, long long* py_out,
    long long* px_out, float* dist_out, cudaStream_t stream) {
  if (dtype < 0 || dtype > 1 || d < 1 || ld_b < d || ld_a < d || h < 1 ||
      w < 1 || ha < 1 || wa < 1 || n_random < 0 ||
      (long long)ha * wa >= (1LL << 31) || (long long)h * w >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long npix = (long long)h * w;
  int* words = static_cast<int*>(scratch);
  Args args;
  args.f_b = f_b;
  args.f_a = f_a;
  args.d = d;
  args.ld_b = ld_b;
  args.ld_a = ld_a;
  args.h = h;
  args.w = w;
  args.ha = ha;
  args.wa = wa;
  args.py_in = py_in;
  args.px_in = px_in;
  args.dist_in = dist_in;
  args.off = off;
  args.n_random = n_random;
  args.coh = coh;
  for (int i = 0; i < 2; ++i) {
    args.sy[i] = words + (3 * i) * npix;
    args.sx[i] = words + (3 * i + 1) * npix;
    args.sd[i] = reinterpret_cast<float*>(words + (3 * i + 2) * npix);
  }
  args.py_out = py_out;
  args.px_out = px_out;
  args.dist_out = dist_out;
  if (dtype == 0) return launch<float>(args, 0, stream);
  return launch<__nv_bfloat16>(args, 1, stream);
}
