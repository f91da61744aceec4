// Exact nearest neighbour over a feature table: for each query row b,
// the argmin over A rows of ||a||^2 - 2 b.a, accumulated in float32, the
// lowest index winning ties.  The N_B x N_A distance matrix is never
// materialized.
//
// Replaces: image_analogies_tpu/kernels/nn_brute.py `_make_nn_kernel`
// (launched by `_nn_chunk_call` through `exact_nn_pallas`).  That kernel
// walked a sequential TPU grid and carried the minimum in VMEM scratch
// from one A tile to the next; here the A walk is a loop inside the block
// and the running minimum lives in registers.
//
// Bound: operations, on the tensor cores.  bfloat16 rows: 2 N_B N_A D FLOP
// against 989 TFLOP/s.  float32 rows: three TF32 products per pair (below),
// 3 * 2 N_B N_A D_pad FLOP against 495 TFLOP/s; the 67 TFLOP/s of FP32 on
// the CUDA cores is no longer the least time.  The bytes (both tables
// once) are negligible; what competes with the tensor cores is the L2
// traffic of re-streaming the A table once per query block and the
// epilogue's CUDA-core work on N_B N_A outputs.
//
// Design for this card.
//   - Products run on `wgmma` (m64n128, B and A operands from shared
//     memory, float32 accumulators in registers).  bfloat16 rows multiply
//     exactly in float32.  float32 rows are split once per launch by a
//     pre-pass (`split_tf32_kernel`): x = hi + lo with hi = tf32(x) and
//     lo = tf32(x - hi), round-to-nearest, and b.a is accumulated as
//     b_hi.a_lo + b_lo.a_hi + b_hi.a_hi per 8-column step, which keeps
//     about 21 mantissa bits; one TF32 product alone moves the argmin.
//   - The pre-pass also pads D to a multiple of the MMA depth with zeros
//     (which cannot move the argmin), pads the row counts to the tile, and
//     scales the A rows by -2 (a power of two, exact), so the epilogue is
//     one add per output: dist = a_sq + acc.  Padded A rows carry
//     a_sq = +inf and never win the strict `<`.
//   - A block holds up to 256 queries (two warpgroups, each with two sets
//     of 64 rows) resident in shared memory for the whole A walk, which
//     halves the A bytes streamed from L2 per query against 128; wider
//     tables, whose rows would not fit, take 128 or 64 queries a block.
//     A tiles of 128 rows stream through a ring of 3-4 stages filled by
//     16-byte `cp.async`, in units of 64-128 bytes of K per float32 part
//     (256 of bfloat16), so any D up to 256 (float32) fits.  Shared-memory
//     tiles use the no-swizzle core-matrix layout [16-byte K chunk][row],
//     and the pre-pass writes the tables to global memory in that same
//     layout per 128-row tile, so a unit is one contiguous, fully
//     coalesced run of bytes (strided rows cost a third of the time).
//   - Each warpgroup keeps two accumulator sets, one per row set (or, with
//     one row set, alternating by tile): while one set's MMAs run
//     asynchronously it takes the other's minimum on the CUDA cores.  The
//     epilogue first takes the tile minimum (an add and a min per output)
//     and looks for the index only when that beats the running best.
//
// Ties: within a tile a thread takes the first column that reaches the
// tile minimum, and across tiles, visited in increasing order, a strict
// `<`, so it holds the lexicographic (distance, index) minimum of its
// columns; the 4 threads that own a query row's accumulator columns then
// merge lexicographically, which gives the global first-index minimum, as
// jnp.argmin does.  Tensor-core sums round differently from FMA chains, so
// near-ties may resolve differently from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TA = 128;          // A rows per tile (wgmma N)
constexpr int WG_ROWS = 64;      // query rows per warpgroup (wgmma M)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 bytes; `lbo` steps to the next core matrix along K, `sbo`
// to the next 8 rows.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs' start and wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define IA_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define IA_F16(d, i) IA_F4(d, i), IA_F4(d, i + 4), IA_F4(d, i + 8), \
                     IA_F4(d, i + 12)
#define IA_F64(d) IA_F16(d, 0), IA_F16(d, 16), IA_F16(d, 32), IA_F16(d, 48)
#define IA_ACC_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = or += A (64 x 8, tf32) * B^T (128 x 8, tf32).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " IA_ACC_LIST
      ", %64, %65, p, 1, 1;\n}\n"
      : IA_F64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) = or += A (64 x 16, bf16) * B^T (128 x 16, bf16).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IA_ACC_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : IA_F64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Params {
  // Tables in the tiled layout of the pre-pass (`tiled_to_row_col`).
  const char* b_hi;   // (n_b_pad, row_bytes) queries (hi part or bf16 rows)
  const char* b_lo;   // float32 route: the lo part
  const char* a_hi;   // (n_a_pad, row_bytes) A rows scaled by -2
  const char* a_lo;
  const float* a_sq;  // (n_a_pad,), +inf past n_a
  int* idx_out;
  float* d_out;
  int n_b, n_tiles, row_bytes, n_ksteps, n_units, unit_ksteps;
};

// One accumulator set's tile minimum folded into the running best of the
// thread's two query rows; tiles are folded in increasing order, so the
// strict `<` keeps the lowest index.  Accumulator layout of m64n128: d[4 j + e] is
// (row g, column 8 j + 2 tq + e), d[4 j + 2 + e] is (row g + 8, same).
__device__ __forceinline__ void fold_tile(float (&acc)[64], const float* sq,
                                          int tq, int col0, float& best0,
                                          int& idx0, float& best1,
                                          int& idx1) {
  float m0 = CUDART_INF_F, m1 = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(sq + 8 * j + 2 * tq);
    m0 = fminf(m0, fminf(acc[4 * j] + s.x, acc[4 * j + 1] + s.y));
    m1 = fminf(m1, fminf(acc[4 * j + 2] + s.x, acc[4 * j + 3] + s.y));
  }
  if (m0 < best0) {
    best0 = m0;
    int c = 0;
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      const float2 s = *reinterpret_cast<const float2*>(sq + 8 * j + 2 * tq);
      if (acc[4 * j + 1] + s.y == m0) c = 8 * j + 1;
      if (acc[4 * j] + s.x == m0) c = 8 * j;
    }
    idx0 = col0 + c + 2 * tq;
  }
  if (m1 < best1) {
    best1 = m1;
    int c = 0;
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      const float2 s = *reinterpret_cast<const float2*>(sq + 8 * j + 2 * tq);
      if (acc[4 * j + 3] + s.y == m1) c = 8 * j + 1;
      if (acc[4 * j + 2] + s.x == m1) c = 8 * j;
    }
    idx1 = col0 + c + 2 * tq;
  }
}

// NWG warpgroups a block, each with HALVES sets of 64 query rows, a ring
// of S stages.
template <bool F32, int NWG, int HALVES, int S>
struct Kernel {
  static constexpr int NT = NWG * 128;
  static constexpr int TQ = NWG * HALVES * WG_ROWS;
  static constexpr int PARTS = F32 ? 2 : 1;
  // 32-byte K steps per pipeline unit, at most: 128 bytes of K for both
  // float32 parts (64 where 256 resident queries take the room), 256
  // bytes of bfloat16 (a whole tile at D <= 128).
  static constexpr int UNIT_KSTEPS = F32 ? (HALVES == 2 ? 2 : 4) : 8;
  static constexpr int PART_BYTES = UNIT_KSTEPS * 2 * TA * 16;
  static constexpr int STAGE_BYTES = PARTS * PART_BYTES;
  static constexpr int PD = S - 2;  // units in flight ahead of the MMAs
  // An accumulator set is folded just before it is written again: one
  // tile later with two sets of rows, two tiles later with one.
  static constexpr int LAG = HALVES == 2 ? 1 : 2;
  // a_sq tiles alive at once: awaiting their fold, in use, in flight.
  static constexpr int ASQ_SLOTS = LAG + PD + 1;

  static size_t smem_bytes(int row_bytes) {
    return (size_t)PARTS * TQ * row_bytes + (size_t)S * STAGE_BYTES +
           ASQ_SLOTS * TA * sizeof(float);
  }

  // cp.async of unit `u` (tile u / n_units, K chunk u % n_units) into
  // its ring stage.
  static __device__ __forceinline__ void load_unit(const Params& p, int u,
                                                   uint32_t stages,
                                                   uint32_t asq, int tid) {
    const int tile = u / p.n_units;
    const int kc = u - tile * p.n_units;
    if (tile >= p.n_tiles) return;
    const int ks0 = kc * p.unit_ksteps;
    const int nk = min(p.unit_ksteps, p.n_ksteps - ks0);
    const uint32_t st = stages + (u % S) * STAGE_BYTES;
    // The tables arrive in the stage's own layout, [tile][chunk][row], so
    // a unit is one contiguous run of bytes.
    const size_t src0 =
        ((size_t)tile * p.n_ksteps + ks0) * (2 * TA * 16);
    for (int i = tid; i < nk * 2 * TA; i += NT) {
      cp_async16(st + i * 16, p.a_hi + src0 + (size_t)i * 16);
      if (F32) cp_async16(st + PART_BYTES + i * 16,
                          p.a_lo + src0 + (size_t)i * 16);
    }
    if (kc == 0 && tid < TA / 4) {
      cp_async16(asq + ((tile % ASQ_SLOTS) * TA + tid * 4) * 4,
                 p.a_sq + (size_t)tile * TA + tid * 4);
    }
  }

  // What a thread carries across the A walk.
  struct Ctx {
    uint32_t stages, asq;
    float* asq_ptr;
    uint64_t dq_hi, dq_lo;  // the warpgroup's first set of query rows
    int tid, tq, total;
    float best[HALVES][2];
    int idx[HALVES][2];
  };

  // Folds the accumulator set that holds tile `tile` for the warpgroup's
  // row set `h`.
  static __device__ __forceinline__ void fold(Ctx& c, float (&acc)[64],
                                              int h, int tile) {
    fence_acc(acc);
    fold_tile(acc, c.asq_ptr + (tile % ASQ_SLOTS) * TA, c.tq, tile * TA,
              c.best[h][0], c.idx[h][0], c.best[h][1], c.idx[h][1]);
  }

  // One tile, `pos`: the MMAs of row set 0 go into `x`, those of row set
  // 1 (HALVES == 2) into `y`.  What a set held before (tile pos - LAG) is
  // folded just before its first MMA, while the other set's MMAs run.
  static __device__ __forceinline__ void tile_step(const Params& p, Ctx& c,
                                                   int pos, float (&x)[64],
                                                   float (&y)[64]) {
    for (int kc = 0; kc < p.n_units; ++kc) {
      const int u = pos * p.n_units + kc;
      cp_async_wait<PD - 1>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();

      const int ks0 = kc * p.unit_ksteps;
      const int nk = min(p.unit_ksteps, p.n_ksteps - ks0);
      const uint32_t st = c.stages + (u % S) * STAGE_BYTES;
      const uint64_t da_hi = make_desc(st, TA * 16, 128);
      const uint64_t da_lo = make_desc(st + PART_BYTES, TA * 16, 128);
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        float(&acc)[64] = h == 0 ? x : y;
        if (kc == 0 && pos >= LAG) fold(c, acc, h, pos - LAG);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < UNIT_KSTEPS; ++ks) {
          if (ks < nk) {
            // Row set h starts 64 rows (64 x 16 bytes) further on.
            const uint64_t qo =
                (uint64_t)(2 * (ks0 + ks) * TQ + h * WG_ROWS);
            const uint64_t ao = (uint64_t)(2 * ks * TA);
            const int first = (kc == 0 && ks == 0) ? 0 : 1;
            if (F32) {
              wgmma_tf32(acc, c.dq_hi + qo, da_lo + ao, first);
              wgmma_tf32(acc, c.dq_lo + qo, da_hi + ao, 1);
              wgmma_tf32(acc, c.dq_hi + qo, da_hi + ao, 1);
            } else {
              wgmma_bf16(acc, c.dq_hi + qo, da_hi + ao, first);
            }
          }
        }
        wgmma_commit();
        if (h == 0) {
          // The stage of unit u - 2 is free: its MMAs were waited for in
          // the last iteration, by every thread before the barrier above.
          if (u + PD < c.total)
            load_unit(p, u + PD, c.stages, c.asq, c.tid);
          cp_async_commit();
        }
        wgmma_wait<1>();
      }
    }
  }

  static __device__ __forceinline__ void run(const Params& p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int q0 = blockIdx.x * TQ;

    const uint32_t q_hi = smem_u32(smem);
    const uint32_t q_lo = q_hi + TQ * p.row_bytes;
    const uint32_t stages = q_hi + PARTS * TQ * p.row_bytes;
    float* asq_ptr = reinterpret_cast<float*>(
        smem + (size_t)PARTS * TQ * p.row_bytes + (size_t)S * STAGE_BYTES);
    const uint32_t asq = smem_u32(asq_ptr);

    // The block's queries, resident for the whole walk: rows q0 .. q0 + TQ
    // of the tiled table, as [chunk][row].
    const size_t tile_bytes = (size_t)p.n_ksteps * (2 * TA * 16);
    for (int i = tid; i < p.n_ksteps * 2 * TQ; i += NT) {
      const int c = i / TQ;
      const int row = q0 + (i - c * TQ);
      const size_t src =
          (size_t)(row / TA) * tile_bytes + ((size_t)c * TA + row % TA) * 16;
      cp_async16(q_hi + i * 16, p.b_hi + src);
      if (F32) cp_async16(q_lo + i * 16, p.b_lo + src);
    }
    const int total = p.n_tiles * p.n_units;
#pragma unroll
    for (int u = 0; u < PD; ++u) {
      load_unit(p, u, stages, asq, tid);
      cp_async_commit();
    }

    // Descriptors: 8-row groups are 128 bytes apart, the two 16-byte K
    // chunks of a step one whole chunk plane apart.
    Ctx cx;
    cx.stages = stages;
    cx.asq = asq;
    cx.asq_ptr = asq_ptr;
    const uint32_t row_off = wg * HALVES * WG_ROWS * 16;
    cx.dq_hi = make_desc(q_hi + row_off, TQ * 16, 128);
    cx.dq_lo = make_desc(q_lo + row_off, TQ * 16, 128);
    cx.tid = tid;
    cx.tq = tq;
    cx.total = total;
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      cx.best[h][0] = cx.best[h][1] = CUDART_INF_F;
      cx.idx[h][0] = cx.idx[h][1] = 0;
    }
    float acc_a[64], acc_b[64];

    const int n = p.n_tiles;
    for (int t = 0; t < n; t += 2) {
      tile_step(p, cx, t, acc_a, acc_b);
      if (t + 1 < n) {
        if (HALVES == 2) {
          tile_step(p, cx, t + 1, acc_a, acc_b);
        } else {
          tile_step(p, cx, t + 1, acc_b, acc_a);
        }
      }
    }
    wgmma_wait<0>();
    if (HALVES == 2) {
      fold(cx, acc_a, 0, n - 1);
      fold(cx, acc_b, HALVES - 1, n - 1);
    } else {
      // Position t sits in acc_a when t is even, in acc_b when odd.
      if (n >= 2) {
        if (n & 1) {
          fold(cx, acc_b, 0, n - 2);
        } else {
          fold(cx, acc_a, 0, n - 2);
        }
      }
      if (n & 1) {
        fold(cx, acc_a, 0, n - 1);
      } else {
        fold(cx, acc_b, 0, n - 1);
      }
    }

    // Lexicographic merge across the 4 threads that share a query row.
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float bd = cx.best[h][r];
        int bi = cx.idx[h][r];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, bd, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (od < bd || (od == bd && oi < bi)) {
            bd = od;
            bi = oi;
          }
        }
        const int q =
            q0 + (wg * HALVES + h) * WG_ROWS + warp * 16 + g + 8 * r;
        if (tq == 0 && q < p.n_b) {
          p.idx_out[q] = bi;
          p.d_out[q] = bd;
        }
      }
    }
  }
};

template <bool F32, int NWG, int HALVES, int S>
__global__ void __launch_bounds__(NWG * 128, 1) nn_argmin_kernel(Params p) {
  Kernel<F32, NWG, HALVES, S>::run(p);
}

constexpr size_t SMEM_LIMIT = 232448;

// Launches this configuration if its shared memory fits a block and the
// padded query count is a multiple of its tile; -1 otherwise.
template <bool F32, int NWG, int HALVES, int S>
int try_launch(Params p, int n_b_pad, cudaStream_t stream) {
  using K = Kernel<F32, NWG, HALVES, S>;
  const size_t smem = K::smem_bytes(p.row_bytes);
  if (smem > SMEM_LIMIT || n_b_pad % K::TQ) return -1;
  p.n_units = (p.n_ksteps + K::UNIT_KSTEPS - 1) / K::UNIT_KSTEPS;
  p.unit_ksteps = (p.n_ksteps + p.n_units - 1) / p.n_units;
  cudaError_t err = cudaFuncSetAttribute(
      nn_argmin_kernel<F32, NWG, HALVES, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nn_argmin_kernel<F32, NWG, HALVES, S>
      <<<n_b_pad / K::TQ, K::NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The largest query tile whose resident rows fit beside the ring: 256
// queries a block halve the A bytes streamed from L2 per query.
int launch_any(bool f32, Params p, int n_b_pad, int n_a_pad, int d_pad,
               cudaStream_t stream) {
  const int elt = f32 ? 4 : 2;
  p.row_bytes = d_pad * elt;
  if (n_b_pad <= 0 || n_a_pad <= 0 || n_b_pad % 256 || n_a_pad % TA ||
      p.row_bytes % 32 || p.row_bytes <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  p.n_tiles = n_a_pad / TA;
  p.n_ksteps = p.row_bytes / 32;
  int rc;
  if (!f32) {
    if ((rc = try_launch<false, 2, 2, 4>(p, n_b_pad, stream)) >= 0) return rc;
    if ((rc = try_launch<false, 2, 1, 4>(p, n_b_pad, stream)) >= 0) return rc;
    return (int)cudaErrorInvalidValue;
  }
  if ((rc = try_launch<true, 2, 2, 4>(p, n_b_pad, stream)) >= 0) return rc;
  if ((rc = try_launch<true, 2, 1, 4>(p, n_b_pad, stream)) >= 0) return rc;
  if ((rc = try_launch<true, 1, 1, 4>(p, n_b_pad, stream)) >= 0) return rc;
  if ((rc = try_launch<true, 1, 1, 3>(p, n_b_pad, stream)) >= 0) return rc;
  return (int)cudaErrorInvalidValue;
}

// x -> the nearest TF32 value (10 explicit mantissa bits), as a float.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// Where element `i` of a tiled table lives in the row-major source: the
// tables the argmin kernel reads are laid out [row tile of 128][16-byte
// chunk of the row][row in tile][element in chunk], the layout of its
// shared-memory stages.  `epc` is the elements per chunk.
__device__ __forceinline__ void tiled_to_row_col(long long i, int d_pad,
                                                 int epc, long long& row,
                                                 int& col) {
  const long long i16 = i / epc;
  const int e = (int)(i - i16 * epc);
  const int chunks = d_pad / epc;
  const int r = (int)(i16 % TA);
  const long long t = i16 / TA;
  const int c16 = (int)(t % chunks);
  row = (t / chunks) * TA + r;
  col = c16 * epc + e;
}

// (n, d) float32 rows -> the zero-padded tiled (n_pad, d_pad) hi and lo
// parts of scale * x.
__global__ void split_tf32_kernel(const float* __restrict__ src, int n, int d,
                                  long long total, int d_pad, float scale,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long r;
    int c;
    tiled_to_row_col(i, d_pad, 4, r, c);
    const float v = (r < n && c < d) ? scale * src[r * d + c] : 0.f;
    const float h = to_tf32(v);
    hi[i] = h;
    lo[i] = to_tf32(v - h);
  }
}

// (n, d) bfloat16 rows -> the zero-padded tiled (n_pad, d_pad) rows of
// scale * x.
__global__ void pad_bf16_kernel(const __nv_bfloat16* __restrict__ src, int n,
                                int d, long long total, int d_pad,
                                float scale,
                                __nv_bfloat16* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    long long r;
    int c;
    tiled_to_row_col(i, d_pad, 8, r, c);
    const float v =
        (r < n && c < d) ? scale * __bfloat162float(src[r * d + c]) : 0.f;
    out[i] = __float2bfloat16(v);
  }
}

int prep_blocks(long long total) {
  const long long b = (total + 255) / 256;
  return (int)(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

}  // namespace

// Pre-pass of the float32 route: pad, scale, and split into TF32 parts.
extern "C" int ia_nn_split_tf32(const float* src, int n, int d, int n_pad,
                                int d_pad, float scale, float* hi, float* lo,
                                cudaStream_t stream) {
  const long long total = (long long)n_pad * d_pad;
  split_tf32_kernel<<<prep_blocks(total), 256, 0, stream>>>(
      src, n, d, total, d_pad, scale, hi, lo);
  return (int)cudaGetLastError();
}

// Pre-pass of the bfloat16 route: pad and scale.
extern "C" int ia_nn_pad_bf16(const __nv_bfloat16* src, int n, int d,
                              int n_pad, int d_pad, float scale,
                              __nv_bfloat16* out, cudaStream_t stream) {
  const long long total = (long long)n_pad * d_pad;
  pad_bf16_kernel<<<prep_blocks(total), 256, 0, stream>>>(
      src, n, d, total, d_pad, scale, out);
  return (int)cudaGetLastError();
}

// float32 rows: split parts of the padded tables (A scaled by -2).
extern "C" int ia_nn_argmin(const float* b_hi, const float* b_lo,
                            const float* a_hi, const float* a_lo,
                            const float* a_sq, int* idx_out, float* d_out,
                            int n_b, int n_b_pad, int n_a_pad, int d_pad,
                            cudaStream_t stream) {
  Params p{};
  p.b_hi = reinterpret_cast<const char*>(b_hi);
  p.b_lo = reinterpret_cast<const char*>(b_lo);
  p.a_hi = reinterpret_cast<const char*>(a_hi);
  p.a_lo = reinterpret_cast<const char*>(a_lo);
  p.a_sq = a_sq;
  p.idx_out = idx_out;
  p.d_out = d_out;
  p.n_b = n_b;
  return launch_any(true, p, n_b_pad, n_a_pad, d_pad, stream);
}

// bfloat16 rows: the padded tables (A scaled by -2).
extern "C" int ia_nn_argmin_bf16(const __nv_bfloat16* b,
                                 const __nv_bfloat16* a, const float* a_sq,
                                 int* idx_out, float* d_out, int n_b,
                                 int n_b_pad, int n_a_pad, int d_pad,
                                 cudaStream_t stream) {
  Params p{};
  p.b_hi = reinterpret_cast<const char*>(b);
  p.a_hi = reinterpret_cast<const char*>(a);
  p.a_sq = a_sq;
  p.idx_out = idx_out;
  p.d_out = d_out;
  p.n_b = n_b;
  return launch_any(false, p, n_b_pad, n_a_pad, d_pad, stream);
}
