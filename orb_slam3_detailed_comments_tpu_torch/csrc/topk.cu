// Per-cell top-k (values descending, first index wins ties) for keypoint
// selection, for every pyramid level of a frame in one launch.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_topk.py:36 cell_topk
// (Pallas body _topk_kernel, :24), called once per pyramid level by
// ops/fast.py select_grid_topk on a padded, permuted [C, 1024] copy of the
// level's score map.
//
// Contract. A level is an NMS'd score map [h, w] cut into CH x CW cells,
// row major; cell c of level l is output row row0_l + c. The value the
// kernel sees at (y, x) is the score where y < h, x < w and the pixel lies
// inside [margin, content - margin) on both axes, and 0.0 elsewhere: the
// JAX package's zero pad followed by its border mask. Output: the k best
// (value, in-cell index CW * dy + dx) pairs of each cell, descending, the
// first index winning a tie, like lax.top_k. A [C, A] matrix is the
// one-level case: an image [C, A] of 1 x A cells with no mask (ops/topk.py
// passes a square A = CELL * CELL as the [CELL * C, CELL] image instead).
// The JAX package runs its kernel for every cell whose area is a multiple
// of 128 (ops/fast.py:118); so does ops/topk.py. Two kernels:
// * cell_topk_levels_kernel<CELL>, square cells of side 16 or 32 (the
//   OrbConfig cells in use): a lane holds its CELL * CELL / 32 values in
//   registers (design below);
// * cell_topk_levels_kernel_scan, any other cell: a warp per cell rescans
//   the cell from memory in each of the k rounds, keeping no state but the
//   last winner. Cells of 48, 64, 80, ... and rows of 128 m entries.
//
// Bound on the H100: memory. Each score is read once (1,132,928 pixels over
// the 8 levels of a 752x480 frame) and k = 8 pairs are written for each of
// its 1,182 cells; the compares are far below the bytes in cost.
//
// Design.
// * One launch a frame: the host passes a by-value table of up to 16 levels
//   and one flat grid walks all levels' cells, 4 warps a block, a warp to a
//   cell. The small upper levels no longer get grids of their own.
// * Lane l holds the cell's row-major entries f = 32 j + l, j = 0 ..
//   V - 1 with V = CELL * CELL / 32, in registers: for CELL = 32 that is
//   column l, one coalesced 128-byte load a row; for CELL = 16 two rows a
//   load. f is also the in-cell index, so the first f wins a tie.
// * A lane's V values form 4 chains (j = q, q + 4, ...). Each chain keeps
//   its best untaken value and the lane its best chain: V compares once,
//   in 4 independent chains.
// * Each of the k rounds is two warp reductions (__reduce_max_sync on the
//   order-preserving bits of the lane bests, then __reduce_min_sync on the
//   flat index among the lanes that hold that value) and one rescan of the
//   winner's chain only (V / 4 values), instead of a rescan of all V
//   values of every lane and a 10-shuffle reduction.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kChains = 4;
constexpr int MAX_LEVELS = 16;
constexpr unsigned FULL = 0xffffffffu;

struct Level {
  const float* map;
  int w;                  // row pitch of the map
  int y_lo, y_hi;         // rows that keep their score: [y_lo, y_hi)
  int x_lo, x_hi;         // columns that keep their score: [x_lo, x_hi)
  int ncx;                // cells per row of cells
  int row0;               // the level's first output row
};

struct Table {
  Level lv[MAX_LEVELS];
  int n_levels;
  int rows;               // cells of all levels
};

// unsigned bits that order as the floats do (-0.0 taken as +0.0, as the
// float compares take it)
__device__ __forceinline__ unsigned order_bits(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// a lane's V values and which of them the rounds have taken
template <int V>
struct LaneCells {
  static constexpr int kWords = (V + 31) / 32;
  float v[V];
  unsigned taken[kWords];

  __device__ __forceinline__ bool is_taken(int j) const {
    return taken[j >> 5] & (1u << (j & 31));
  }
  __device__ __forceinline__ void take(int j) {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      if (w == (j >> 5)) taken[w] |= 1u << (j & 31);
  }
};

// best untaken value of chain q: the first (lowest j) of equal values wins,
// since j ascends; cj = -1 when the chain has nothing left. cv starts as NaN
// so that the first untaken value is taken whatever it is (-inf included).
template <int q, int V>
__device__ __forceinline__ void scan_chain(const LaneCells<V>& c, float& cv,
                                           int& cj) {
  cv = CUDART_NAN_F;
  cj = -1;
#pragma unroll
  for (int t = 0; t < V / kChains; ++t) {
    const int j = q + t * kChains;
    if (!c.is_taken(j) && !(c.v[j] <= cv)) {
      cv = c.v[j];
      cj = j;
    }
  }
}

__device__ __forceinline__ void lane_best(const float (&cv)[kChains],
                                          const int (&cj)[kChains], float& bv,
                                          int& bj) {
  bv = cv[0];
  bj = cj[0];
#pragma unroll
  for (int q = 1; q < kChains; ++q) {
    const bool better = cj[q] >= 0 &&
        (bj < 0 || cv[q] > bv || (cv[q] == bv && cj[q] < bj));
    if (better) {
      bv = cv[q];
      bj = cj[q];
    }
  }
}

template <int CELL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cell_topk_levels_kernel(const __grid_constant__ Table T,
                        float* __restrict__ vals, int* __restrict__ idx,
                        int k) {
  constexpr int V = CELL * CELL / 32;
  static_assert(V % kChains == 0, "a lane's values split into 4 chains");
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T.rows) return;  // whole warp exits together
  int l = 0;
  while (l + 1 < T.n_levels && row >= T.lv[l + 1].row0) ++l;
  const int c = row - T.lv[l].row0;
  const int ncx = T.lv[l].ncx;
  const int cy = c / ncx;
  const int x0 = (c - cy * ncx) * CELL;
  const int y0 = cy * CELL;
  const int w = T.lv[l].w;
  const int y_lo = T.lv[l].y_lo, y_hi = T.lv[l].y_hi;
  const int x_lo = T.lv[l].x_lo, x_hi = T.lv[l].x_hi;
  const float* __restrict__ map = T.lv[l].map;

  LaneCells<V> cells;
#pragma unroll
  for (int w_ = 0; w_ < LaneCells<V>::kWords; ++w_) cells.taken[w_] = 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int f = j * 32 + lane;   // row-major in-cell index
    const int y = y0 + f / CELL;
    const int x = x0 + f % CELL;
    cells.v[j] = (x >= x_lo && x < x_hi && y >= y_lo && y < y_hi)
                     ? map[static_cast<size_t>(y) * w + x] : 0.0f;
  }
  float cv[kChains];
  int cj[kChains];
  scan_chain<0>(cells, cv[0], cj[0]);
  scan_chain<1>(cells, cv[1], cj[1]);
  scan_chain<2>(cells, cv[2], cj[2]);
  scan_chain<3>(cells, cv[3], cj[3]);
  float bv;
  int bj;
  lane_best(cv, cj, bv, bj);

  float* __restrict__ vo = vals + static_cast<size_t>(row) * k;
  int* __restrict__ io = idx + static_cast<size_t>(row) * k;
  for (int r = 0; r < k; ++r) {
    // k <= CELL * CELL values a cell, so some lane always has one left
    const unsigned key = bj >= 0 ? order_bits(bv) : 0u;
    const unsigned top = __reduce_max_sync(FULL, key);
    const int mine = (bj >= 0 && key == top) ? bj * 32 + lane : 0x7fffffff;
    const int win = __reduce_min_sync(FULL, mine);
    if ((win & 31) == lane) {
      vo[r] = bv;
      io[r] = win;
      cells.take(bj);
      switch (bj & (kChains - 1)) {
        case 0: scan_chain<0>(cells, cv[0], cj[0]); break;
        case 1: scan_chain<1>(cells, cv[1], cj[1]); break;
        case 2: scan_chain<2>(cells, cv[2], cj[2]); break;
        default: scan_chain<3>(cells, cv[3], cj[3]); break;
      }
      lane_best(cv, cj, bv, bj);
    }
  }
}

// Any cell of cell_h x cell_w. Round r takes the largest of the keys
// (order_bits(value), -index) below round r - 1's winner: the keys are
// distinct, so the rounds give the k best in lax.top_k's order with no
// record of what was taken. A key is compared as its two 32-bit halves,
// each reduced over the warp.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cell_topk_levels_kernel_scan(const __grid_constant__ Table T, int cell_h,
                             int cell_w, float* __restrict__ vals,
                             int* __restrict__ idx, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T.rows) return;  // whole warp exits together
  int l = 0;
  while (l + 1 < T.n_levels && row >= T.lv[l + 1].row0) ++l;
  const int c = row - T.lv[l].row0;
  const int ncx = T.lv[l].ncx;
  const int cy = c / ncx;
  const int x0 = (c - cy * ncx) * cell_w;
  const int y0 = cy * cell_h;
  const int w = T.lv[l].w;
  const int y_lo = T.lv[l].y_lo, y_hi = T.lv[l].y_hi;
  const int x_lo = T.lv[l].x_lo, x_hi = T.lv[l].x_hi;
  const float* __restrict__ map = T.lv[l].map;
  const int area = cell_h * cell_w;

  float* __restrict__ vo = vals + static_cast<size_t>(row) * k;
  int* __restrict__ io = idx + static_cast<size_t>(row) * k;
  unsigned prev_hi = 0u, prev_lo = 0u;   // round r - 1's winner
  for (int r = 0; r < k; ++r) {
    // this lane's best key below the last winner, over f = lane + 32 t
    bool has = false;
    unsigned hi = 0u, lo = 0u;
    float bv = 0.0f;
    for (int f = lane; f < area; f += 32) {
      const int dy = f / cell_w;
      const int y = y0 + dy;
      const int x = x0 + f - dy * cell_w;
      const float v = (x >= x_lo && x < x_hi && y >= y_lo && y < y_hi)
                          ? map[static_cast<size_t>(y) * w + x] : 0.0f;
      const unsigned kh = order_bits(v);
      const unsigned kl = ~static_cast<unsigned>(f);
      const bool below = r == 0 || kh < prev_hi ||
                         (kh == prev_hi && kl < prev_lo);
      if (below && (!has || kh > hi || (kh == hi && kl > lo))) {
        has = true;
        hi = kh;
        lo = kl;
        bv = v;
      }
    }
    // k <= area, so some lane always has a key left
    const unsigned top_hi = __reduce_max_sync(FULL, has ? hi : 0u);
    const bool in = has && hi == top_hi;
    const unsigned top_lo = __reduce_max_sync(FULL, in ? lo : 0u);
    if (in && lo == top_lo) {
      vo[r] = bv;
      io[r] = static_cast<int>(~top_lo);
    }
    prev_hi = top_hi;
    prev_lo = top_lo;
  }
}

template <int CELL>
void launch(const Table& T, float* vals, int* idx, int k,
            cudaStream_t stream) {
  const int blocks = (T.rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cell_topk_levels_kernel<CELL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      T, vals, idx, k);
}

}  // namespace

// maps: host array of n_levels device pointers; h, w, ch, cw: host arrays of
// n_levels ints (map shapes and content shapes); cells of cell_h x cell_w.
// The table travels to the kernel by value. vals [rows, k] float32 and idx
// [rows, k] int32, with rows the cells of all levels, sum of
// ceil(h / cell_h) * ceil(w / cell_w).
extern "C" int slam_cell_topk_levels(
    int n_levels, const void* const* maps, const int* h, const int* w,
    const int* ch, const int* cw, int margin, int cell_h, int cell_w,
    float* vals, int* idx, int k, void* stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS || cell_h <= 0 || cell_w <= 0 ||
      k <= 0 || static_cast<long long>(cell_h) * cell_w < k ||
      static_cast<long long>(cell_h) * cell_w > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Table T;
  int rows = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (h[l] <= 0 || w[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Level& L = T.lv[l];
    L.map = static_cast<const float*>(maps[l]);
    L.w = w[l];
    L.y_lo = margin > 0 ? margin : 0;
    L.y_hi = ch[l] - margin < h[l] ? ch[l] - margin : h[l];
    L.x_lo = L.y_lo;
    L.x_hi = cw[l] - margin < w[l] ? cw[l] - margin : w[l];
    L.ncx = (w[l] + cell_w - 1) / cell_w;
    L.row0 = rows;
    rows += L.ncx * ((h[l] + cell_h - 1) / cell_h);
  }
  for (int l = n_levels; l < MAX_LEVELS; ++l) T.lv[l] = T.lv[0];
  T.n_levels = n_levels;
  T.rows = rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell_h == 16 && cell_w == 16) {
    launch<16>(T, vals, idx, k, s);
  } else if (cell_h == 32 && cell_w == 32) {
    launch<32>(T, vals, idx, k, s);
  } else {
    const int blocks = (T.rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    cell_topk_levels_kernel_scan<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        T, cell_h, cell_w, vals, idx, k);
  }
  return static_cast<int>(cudaGetLastError());
}
