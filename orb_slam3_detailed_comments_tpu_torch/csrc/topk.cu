// Per-row top-k (values descending, first index wins ties) for keypoint
// selection.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_topk.py:36 cell_topk
// (Pallas body _topk_kernel, :24), called once per pyramid level by
// ops/fast.py select_grid_topk.
//
// Bound on the H100: memory. The input is [C, A] float32 (A = 1024 cell
// pixels, C = 1182 cells over the 8 levels of a 752x480 frame); each value
// is read once and only k = 8 (value, index) pairs per row are written, so
// the least time is the input bytes over the HBM rate. The work is
// k * A compares per row, far below the bytes in cost.
//
// Design: one warp per row. Lane l holds elements l, l + 32, ... of the row
// in registers (coalesced loads, one pass over device memory). Each of the
// k rounds takes a lane-local best and a 5-step warp-shuffle reduction over
// (value descending, index ascending); the winner is marked taken in its
// lane's bit mask, so a row with fewer than k finite values still returns
// distinct, lowest-index-first entries exactly like a stable descending
// sort (the plain version) and lax.top_k.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 32;  // A <= 1024

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void cell_topk_kernel(const float* __restrict__ x,
                                 float* __restrict__ vals,
                                 int* __restrict__ idx, int rows, int cols,
                                 int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together
  const int per_lane = cols >> 5;
  const float* xr = x + static_cast<size_t>(row) * cols;
  float v[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    v[j] = j < per_lane ? xr[j * 32 + lane] : -CUDART_INF_F;
  unsigned taken = 0u;
  for (int r = 0; r < k; ++r) {
    // lane-local best among the elements not yet taken
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int i = j * 32 + lane;
      if (j < per_lane && !(taken & (1u << j)) && better(v[j], i, bv, bi)) {
        bv = v[j];
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    if (lane == 0) {
      vals[static_cast<size_t>(row) * k + r] = bv;
      idx[static_cast<size_t>(row) * k + r] = bi;
    }
  }
}

}  // namespace

extern "C" int slam_cell_topk(const float* x, float* vals, int* idx, int rows,
                              int cols, int k, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cell_topk_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, vals, idx, rows,
                                                          cols, k);
  return static_cast<int>(cudaGetLastError());
}
