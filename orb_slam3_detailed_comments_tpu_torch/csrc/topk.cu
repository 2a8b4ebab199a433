// Per-cell top-k (values descending, first index wins ties) for keypoint
// selection, for every pyramid level of a frame in one launch.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_topk.py:36 cell_topk
// (Pallas body _topk_kernel, :24), called once per pyramid level by
// ops/fast.py select_grid_topk on a padded, permuted [C, 1024] copy of the
// level's score map.
//
// Contract. A level is an NMS'd score map [h, w] cut into 32x32 cells, row
// major; cell c of level l is output row row0_l + c. The value the kernel
// sees at (y, x) is the score where y < h, x < w and the pixel lies inside
// [margin, content - margin) on both axes, and 0.0 elsewhere: the JAX
// package's zero pad followed by its border mask. Output: the k best
// (value, in-cell index 32 * dy + dx) pairs of each cell, descending, the
// first index winning a tie, like lax.top_k. A [C, 1024] matrix is the
// one-level case: a [32 C, 32] image with no mask.
//
// Bound on the H100: memory. Each score is read once (1,132,928 pixels over
// the 8 levels of a 752x480 frame) and k = 8 pairs are written for each of
// its 1,182 cells; the compares are far below the bytes in cost.
//
// Design.
// * One launch a frame: the host passes a by-value table of up to 16 levels
//   and one flat grid walks all levels' cells, 4 warps a block, a warp to a
//   cell. The small upper levels no longer get grids of their own.
// * Lane l holds column dx = l of its cell, rows dy = 0..31 in registers
//   (one coalesced 128-byte load a row, straight from the score map).
// * A lane's 32 values form 4 chains (j = q, q + 4, ...). Each chain keeps
//   its best untaken value and the lane its best chain: 32 compares once,
//   in 4 independent chains.
// * Each of the k rounds is two warp reductions (__reduce_max_sync on the
//   order-preserving bits of the lane bests, then __reduce_min_sync on the
//   flat index among the lanes that hold that value) and one rescan of the
//   winner's chain only (8 values), instead of a rescan of all 32 values of
//   every lane and a 10-shuffle reduction.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int CELL = 32;             // cell side, one lane per column
constexpr int kWarpsPerBlock = 4;
constexpr int kChains = 4;
constexpr int kPerChain = CELL / kChains;
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

// best untaken value of chain q: the first (lowest j) of equal values wins,
// since j ascends; cj = -1 when the chain has nothing left. cv starts as NaN
// so that the first untaken value is taken whatever it is (-inf included).
template <int q>
__device__ __forceinline__ void scan_chain(const float (&v)[CELL],
                                           unsigned taken, float& cv,
                                           int& cj) {
  cv = CUDART_NAN_F;
  cj = -1;
#pragma unroll
  for (int t = 0; t < kPerChain; ++t) {
    const int j = q + t * kChains;
    if (!(taken & (1u << j)) && !(v[j] <= cv)) {
      cv = v[j];
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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cell_topk_levels_kernel(const __grid_constant__ Table T,
                        float* __restrict__ vals, int* __restrict__ idx,
                        int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T.rows) return;  // whole warp exits together
  int l = 0;
  while (l + 1 < T.n_levels && row >= T.lv[l + 1].row0) ++l;
  const int c = row - T.lv[l].row0;
  const int ncx = T.lv[l].ncx;
  const int cy = c / ncx;
  const int x = (c - cy * ncx) * CELL + lane;
  const int y0 = cy * CELL;
  const int w = T.lv[l].w;
  const int y_lo = T.lv[l].y_lo, y_hi = T.lv[l].y_hi;
  const bool col_in = x >= T.lv[l].x_lo && x < T.lv[l].x_hi;
  const float* __restrict__ col = T.lv[l].map + x;

  float v[CELL];
#pragma unroll
  for (int j = 0; j < CELL; ++j) {
    const int y = y0 + j;
    v[j] = (col_in && y >= y_lo && y < y_hi)
               ? col[static_cast<size_t>(y) * w] : 0.0f;
  }
  unsigned taken = 0u;
  float cv[kChains];
  int cj[kChains];
  scan_chain<0>(v, taken, cv[0], cj[0]);
  scan_chain<1>(v, taken, cv[1], cj[1]);
  scan_chain<2>(v, taken, cv[2], cj[2]);
  scan_chain<3>(v, taken, cv[3], cj[3]);
  float bv;
  int bj;
  lane_best(cv, cj, bv, bj);

  float* __restrict__ vo = vals + static_cast<size_t>(row) * k;
  int* __restrict__ io = idx + static_cast<size_t>(row) * k;
  for (int r = 0; r < k; ++r) {
    // k <= 1024 values a cell, so some lane always has one left
    const unsigned key = bj >= 0 ? order_bits(bv) : 0u;
    const unsigned top = __reduce_max_sync(FULL, key);
    const int mine = (bj >= 0 && key == top) ? bj * 32 + lane : 0x7fffffff;
    const int win = __reduce_min_sync(FULL, mine);
    if ((win & 31) == lane) {
      vo[r] = bv;
      io[r] = win;
      taken |= 1u << bj;
      switch (bj & (kChains - 1)) {
        case 0: scan_chain<0>(v, taken, cv[0], cj[0]); break;
        case 1: scan_chain<1>(v, taken, cv[1], cj[1]); break;
        case 2: scan_chain<2>(v, taken, cv[2], cj[2]); break;
        default: scan_chain<3>(v, taken, cv[3], cj[3]); break;
      }
      lane_best(cv, cj, bv, bj);
    }
  }
}

}  // namespace

// maps: host array of n_levels device pointers; h, w, ch, cw: host arrays of
// n_levels ints (map shapes and content shapes). The table travels to the
// kernel by value. vals [rows, k] float32 and idx [rows, k] int32, with rows
// the cells of all levels, sum of ceil(h / 32) * ceil(w / 32).
extern "C" int slam_cell_topk_levels(
    int n_levels, const void* const* maps, const int* h, const int* w,
    const int* ch, const int* cw, int margin, float* vals, int* idx, int k,
    void* stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS || k <= 0 || k > CELL * CELL)
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
    L.ncx = (w[l] + CELL - 1) / CELL;
    L.row0 = rows;
    rows += L.ncx * ((h[l] + CELL - 1) / CELL);
  }
  for (int l = n_levels; l < MAX_LEVELS; ++l) T.lv[l] = T.lv[0];
  T.n_levels = n_levels;
  T.rows = rows;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cell_topk_levels_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(T, vals, idx,
                                                                 k);
  return static_cast<int>(cudaGetLastError());
}
