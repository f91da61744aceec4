// Every frame's candidate tables for one tile sweep in one launch (kernel
// K5 of the port).
//
// Replaces no TPU kernel.  The JAX package builds K1's candidate tables
// as `jnp` under `jit` (image_analogies_tpu/kernels/patchmatch_tile.py
// `sample_candidates_blocked`), where XLA fuses the rolls, the clamps
// and the dedup.  Run eagerly, the port issued ~60 launches a frame and
// sweep for them, and one blocking copy of the search radii from host
// memory, which made the host wait for the card to drain once a frame
// and sweep.  This kernel computes what `sample_candidates_blocked`
// (kernels/patchmatch_tile.py) computes, for the F frames of a sweep:
//
//   slots  0-3   own samples: the compact state at the jittered 2 x 2
//                subgrid, (tile row + uy[a], tile column + ux[b]) for
//                slot 2a + b, uy[a] = (jitter[0] + (th / 2) a) mod th,
//                ux[b] = (jitter[1] + (tw / 2) b) mod tw;
//   slots  4-19  propagation: the four own samples of the tile
//                (ty - dy, tx - dx), wrapped around the tile grid as
//                `torch.roll` wraps, for (dy, dx) in (1, 0), (-1, 0),
//                (0, 1), (0, -1);
//   slots 20-31  local search: own sample s mod 4 plus the drawn
//                perturbation clamped to +-max(1, max(ha, wa) >> (s + 1))
//                for slot 20 + s;
//   slots 32-35  restarts: the drawn origin less the tile origin, or,
//                with the restart positions drawn ("coarse" mode), the
//                drawn position q plus the state's offset at q, less the
//                tile origin (`_field_restarts`);
//
// each slot's (y, x) computed in 64 bits and cut to 32 as the plain
// version's `.to(torch.int32)`; slot k is valid iff no earlier slot of
// its tile holds the same (y, x).  Integer arithmetic only: the tables
// equal the plain version's bit for bit.
//
// Bound.  A 1024^2 frame has 144 tiles; the launch reads 4 state
// samples a tile and the draws (~47 KB) and writes 3 x 144 x 36 int32
// (62 KB): ~0.03 us at 3.35 TB/s, so the launch itself (a few us) bounds
// it.
//
// Design.  One warp a (frame, tile), four tiles a block; lane l builds
// slots l and l + 32 (below 36), keeps them in shared memory, and after a
// warp barrier compares its slots with every earlier one (the 36 x 36
// dedup).  Each warp reads only its own tile's inputs and writes only its
// own tile's rows, so the result does not depend on the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_OWN = 4;
constexpr int K_PROP = 16;
constexpr int K_LOCAL = 12;
constexpr int K_GLOBAL = 4;
constexpr int K_TOTAL = K_OWN + K_PROP + K_LOCAL + K_GLOBAL;
constexpr int TILES_PER_BLOCK = 4;  // one warp a tile
constexpr int THREADS = 32 * TILES_PER_BLOCK;

struct Args {
  const int* off_y;  // (F, n_ty * th, n_tx * tw) compact state
  const int* off_x;
  const long long* jitter;   // (F, 2)
  const long long* pert;     // (F, 2, n_ty, n_tx, K_LOCAL)
  const long long* glob_y;   // (F, n_ty, n_tx, K_GLOBAL)
  const long long* glob_x;
  const long long* restart;  // (F, 4, n_ty, n_tx, K_GLOBAL) or null
  int n_f, n_ty, n_tx, th, tw;
  long long m;  // max(ha, wa)
  int* cand_y;  // (F, n_ty, n_tx, K_TOTAL)
  int* cand_x;
  int* cand_valid;
};

// Own sample j of tile (ty, tx) of frame f: the state at the jittered
// subgrid position (row j / 2, column j % 2).
__device__ __forceinline__ void own_sample(const Args& a, int f, int ty,
                                           int tx, int j, long long* y,
                                           long long* x) {
  const long long jy = a.jitter[2 * f], jx = a.jitter[2 * f + 1];
  const long long uy = (jy + (long long)(a.th / 2) * (j / 2)) % a.th;
  const long long ux = (jx + (long long)(a.tw / 2) * (j % 2)) % a.tw;
  const long long width = (long long)a.n_tx * a.tw;
  const long long at = (long long)f * a.n_ty * a.th * width +
                       ((long long)ty * a.th + uy) * width +
                       (long long)tx * a.tw + ux;
  *y = a.off_y[at];
  *x = a.off_x[at];
}

__device__ __forceinline__ void slot(const Args& a, int f, int ty, int tx,
                                     int k, long long* y, long long* x) {
  if (k < K_OWN) {
    own_sample(a, f, ty, tx, k, y, x);
  } else if (k < K_OWN + K_PROP) {
    const int s = (k - K_OWN) / K_OWN, j = (k - K_OWN) % K_OWN;
    const int dy = s == 0 ? 1 : (s == 1 ? -1 : 0);
    const int dx = s == 2 ? 1 : (s == 3 ? -1 : 0);
    const int sty = ((ty - dy) % a.n_ty + a.n_ty) % a.n_ty;
    const int stx = ((tx - dx) % a.n_tx + a.n_tx) % a.n_tx;
    own_sample(a, f, sty, stx, j, y, x);
  } else if (k < K_OWN + K_PROP + K_LOCAL) {
    const int s = k - K_OWN - K_PROP;
    own_sample(a, f, ty, tx, s % K_OWN, y, x);
    long long r = a.m >> (s + 1);
    if (r < 1) r = 1;
    const long long tile = ((long long)f * 2 * a.n_ty + ty) * a.n_tx + tx;
    const long long plane = (long long)a.n_ty * a.n_tx * K_LOCAL;
    long long py = a.pert[tile * K_LOCAL + s];
    long long px = a.pert[tile * K_LOCAL + plane + s];
    py = py < -r ? -r : (py > r ? r : py);
    px = px < -r ? -r : (px > r ? r : px);
    *y += py;
    *x += px;
  } else {
    const int g = k - K_OWN - K_PROP - K_LOCAL;
    const long long ty0 = (long long)ty * a.th, tx0 = (long long)tx * a.tw;
    if (a.restart == nullptr) {
      const long long at =
          (((long long)f * a.n_ty + ty) * a.n_tx + tx) * K_GLOBAL + g;
      *y = a.glob_y[at] - ty0;
      *x = a.glob_x[at] - tx0;
    } else {
      const long long plane = (long long)a.n_ty * a.n_tx * K_GLOBAL;
      const long long at =
          (long long)f * 4 * plane + ((long long)ty * a.n_tx + tx) * K_GLOBAL
          + g;
      const long long si = a.restart[at], sj = a.restart[at + plane];
      const long long su = a.restart[at + 2 * plane];
      const long long sv = a.restart[at + 3 * plane];
      const long long src_y = si * a.th + su, src_x = sj * a.tw + sv;
      const long long width = (long long)a.n_tx * a.tw;
      const long long q =
          (long long)f * a.n_ty * a.th * width + src_y * width + src_x;
      *y = src_y + a.off_y[q] - ty0;
      *x = src_x + a.off_x[q] - tx0;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    cand_tables_kernel(Args a) {
  __shared__ int sy[TILES_PER_BLOCK][K_TOTAL];
  __shared__ int sx[TILES_PER_BLOCK][K_TOTAL];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_tiles = (long long)a.n_f * a.n_ty * a.n_tx;
  const long long tile = (long long)blockIdx.x * TILES_PER_BLOCK + warp;
  if (tile >= n_tiles) return;  // the whole warp: it shares `tile`
  const int tx = (int)(tile % a.n_tx);
  const int ty = (int)((tile / a.n_tx) % a.n_ty);
  const int f = (int)(tile / ((long long)a.n_tx * a.n_ty));
  int ys[2], xs[2];
  for (int i = 0; i < 2; ++i) {
    const int k = lane + 32 * i;
    if (k >= K_TOTAL) break;
    long long y, x;
    slot(a, f, ty, tx, k, &y, &x);
    ys[i] = (int)y;
    xs[i] = (int)x;
    sy[warp][k] = ys[i];
    sx[warp][k] = xs[i];
  }
  __syncwarp();
  for (int i = 0; i < 2; ++i) {
    const int k = lane + 32 * i;
    if (k >= K_TOTAL) break;
    int valid = 1;
    for (int j = 0; j < k; ++j) {
      if (sy[warp][j] == ys[i] && sx[warp][j] == xs[i]) {
        valid = 0;
        break;
      }
    }
    const long long at = tile * K_TOTAL + k;
    a.cand_y[at] = ys[i];
    a.cand_x[at] = xs[i];
    a.cand_valid[at] = valid;
  }
}

}  // namespace

extern "C" int ia_cand_tables(const int* off_y, const int* off_x,
                              const long long* jitter, const long long* pert,
                              const long long* glob_y,
                              const long long* glob_x,
                              const long long* restart, int n_f, int n_ty,
                              int n_tx, int th, int tw, int ha, int wa,
                              int* cand_y, int* cand_x, int* cand_valid,
                              cudaStream_t stream) {
  if (n_f < 1 || n_ty < 1 || n_tx < 1 || th < 2 || tw < 2 || ha < 1 ||
      wa < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.off_y = off_y;
  a.off_x = off_x;
  a.jitter = jitter;
  a.pert = pert;
  a.glob_y = glob_y;
  a.glob_x = glob_x;
  a.restart = restart;
  a.n_f = n_f;
  a.n_ty = n_ty;
  a.n_tx = n_tx;
  a.th = th;
  a.tw = tw;
  a.m = ha > wa ? ha : wa;
  a.cand_y = cand_y;
  a.cand_x = cand_x;
  a.cand_valid = cand_valid;
  const long long n_tiles = (long long)n_f * n_ty * n_tx;
  const long long blocks = (n_tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cand_tables_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
