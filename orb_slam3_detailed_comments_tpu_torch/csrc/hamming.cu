// Hamming best-2 searches over packed 256-bit ORB descriptors.
//
// Replaces:
//   orb_slam3_detailed_comments_tpu/ops/pallas_hamming.py:133
//     hamming_best2_windowed (Pallas body _windowed_best2_kernel, :93), the
//     projection search of both tracking stages (ops/matching.py:202-215);
//   orb_slam3_detailed_comments_tpu/ops/pallas_hamming.py:52
//     hamming_best2 (Pallas body _best2_kernel, :27), the unmasked branch of
//     ops/matching.py match_nn.
//
// Bound on the H100: integer operations, not bytes. A 4096 x 1024 search
// reads ~0.3 MB of inputs; its work is 8 gate operations a pair and, for a
// pair that passes, 8 XOR + popcount + add word steps on the CUDA cores
// (tensor cores have no popcount path). At these sizes that is a few
// microseconds, so what decides the time is how many SMs the search fills
// and how long its longest serial loop is.
//
// Design: targets across lanes. A warp owns one query; lane l scans targets
// l, l + 32, ... (32 steps for 1024 targets instead of 1024), keeps its own
// (d1, i1, d2) and the lanes merge by five rounds of shuffles. 5,120 queries
// are 5,120 warps in 640 blocks of 8 warps: several waves of full SMs. (A
// half-warp per query was timed and was slower.) A block stages the targets once in shared memory, in tiles of kTile rows:
// the descriptors word-major (s_desc[w][j], so lanes on neighbouring
// targets read neighbouring banks; the row pitch of kTile + 4 words also
// keeps the staging stores of 16-byte loads free of bank conflicts) and the
// gate data as x, y and the level with the target's validity folded in as
// the level kGated (12 bytes a target). A pair whose gates fail costs three
// shared loads and no descriptor load. The gates are evaluated in float32
// exactly as the Pallas kernel does (|du| <= r, |dv| <= r, level difference
// in [lo, hi], both validity masks); build without fast-math so the
// comparisons stay IEEE. hamming_best2 is the same kernel without the
// gates: there every valid pair passes, its cost is the popcounts, and the
// word-major layout matters most.
//
// Output contract (same as the Pallas kernels and the plain versions):
// a gated-out pair counts as BIG; d1 is the minimum, i1 the FIRST index of
// the minimum, d2 the minimum over every column except i1 (a tie elsewhere
// gives d2 == d1); a row with every target gated out returns
// d1 = d2 = BIG and i1 = 0. A distance is at most 256 < BIG, so a lane
// skips gated pairs and starts from (BIG, 0, BIG). The merge picks the
// least (d1, i1) pair in lexicographic order, so i1 is the first index of
// the minimum across lanes too; d2 is the least of all lanes' d2 and of the
// losing lanes' d1 (ops/hamming.py merge_lane_best2 is the same function in
// PyTorch, tested on ties).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 10000;
constexpr int kTile = 1024;          // targets staged at a time
constexpr int kPitch = kTile + 4;    // words between descriptor word rows
constexpr int kLanes = 32;           // a warp's lanes share a query
constexpr int kThreads = 256;
constexpr int kQueries = kThreads / kLanes;   // queries a block
constexpr int kGated = INT_MIN;      // staged level of an invalid target
constexpr unsigned kFull = 0xffffffffu;

struct Best2 {
  int d1, i1, d2;
};

// a lane walks its targets in ascending order, so "<" keeps the first index
__device__ __forceinline__ void push(Best2& b, int d, int j) {
  const bool lt = d < b.d1;
  b.d2 = lt ? b.d1 : min(b.d2, d);
  b.i1 = lt ? j : b.i1;
  b.d1 = min(b.d1, d);
}

__device__ __forceinline__ Best2 merge(const Best2& a, const Best2& b) {
  const bool a_wins = a.d1 < b.d1 || (a.d1 == b.d1 && a.i1 <= b.i1);
  Best2 r;
  r.d1 = a_wins ? a.d1 : b.d1;
  r.i1 = a_wins ? a.i1 : b.i1;
  r.d2 = min(min(a.d2, b.d2), a_wins ? b.d1 : a.d1);
  return r;
}

template <bool kWindowed>
__global__ void __launch_bounds__(kThreads) best2_kernel(
    const unsigned* __restrict__ qd, const float* __restrict__ quv,
    const int* __restrict__ qlv, const float* __restrict__ qr,
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const unsigned char* __restrict__ qv, int Q,
    const unsigned* __restrict__ td, const float* __restrict__ txy,
    const int* __restrict__ tlv, const unsigned char* __restrict__ tv, int K,
    int* __restrict__ d1o, int* __restrict__ i1o, int* __restrict__ d2o) {
  __shared__ unsigned s_desc[8][kPitch];
  __shared__ int s_lv[kTile];
  __shared__ float s_x[kWindowed ? kTile : 1];
  __shared__ float s_y[kWindowed ? kTile : 1];

  const int lane = threadIdx.x % kLanes;
  const int q = blockIdx.x * kQueries + threadIdx.x / kLanes;
  bool scan = q < Q;
  unsigned my[8];
  float u = 0.f, v = 0.f, r = 0.f;
  int lv = 0, lo = 0, hi = 0;
  if (scan) {
#pragma unroll
    for (int w = 0; w < 8; ++w) my[w] = qd[static_cast<size_t>(q) * 8 + w];
    if (kWindowed) {
      u = quv[2 * q];
      v = quv[2 * q + 1];
      r = qr[q];
      lv = qlv[q];
      lo = qlo[q];
      hi = qhi[q];
      scan = qv[q] != 0;
    }
  }
  Best2 best{kBig, 0, kBig};
  for (int base = 0; base < K; base += kTile) {
    const int n = min(kTile, K - base);
    __syncthreads();
    const unsigned* src = td + static_cast<size_t>(base) * 8;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
        const uint4 x = src4[e];
        const int j = e >> 1, w = (e & 1) * 4;
        s_desc[w][j] = x.x;
        s_desc[w + 1][j] = x.y;
        s_desc[w + 2][j] = x.z;
        s_desc[w + 3][j] = x.w;
      }
    } else {
      for (int e = threadIdx.x; e < 8 * n; e += kThreads)
        s_desc[e & 7][e >> 3] = src[e];
    }
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const bool ok = tv[base + e] != 0;
      if (kWindowed) {
        s_x[e] = txy[2 * (base + e)];
        s_y[e] = txy[2 * (base + e) + 1];
        s_lv[e] = ok ? tlv[base + e] : kGated;
      } else {
        s_lv[e] = ok ? 0 : kGated;
      }
    }
    __syncthreads();
    if (!scan) continue;
    for (int j = lane; j < n; j += kLanes) {
      const int tl = s_lv[j];
      bool ok = tl != kGated;
      if (kWindowed)
        ok = ok && fabsf(u - s_x[j]) <= r && fabsf(v - s_y[j]) <= r &&
             tl - lv >= lo && tl - lv <= hi;
      if (ok) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(my[w] ^ s_desc[w][j]);
        push(best, d, base + j);
      }
    }
  }
  // every lane of the warp takes part in the shuffles, whether its query
  // exists or not
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    Best2 other;
    other.d1 = __shfl_xor_sync(kFull, best.d1, off);
    other.i1 = __shfl_xor_sync(kFull, best.i1, off);
    other.d2 = __shfl_xor_sync(kFull, best.d2, off);
    best = merge(best, other);
  }
  if (lane == 0 && q < Q) {
    d1o[q] = best.d1;
    i1o[q] = best.i1;
    d2o[q] = best.d2;
  }
}

}  // namespace

// The lanes that share a query, for the wrapper to hold against its own.
extern "C" int slam_best2_lanes(int* out) {
  *out = kLanes;
  return 0;
}

extern "C" int slam_hamming_best2_windowed(
    const void* qd, const float* quv, const int* qlv, const float* qr,
    const int* qlo, const int* qhi, const unsigned char* qv, int Q,
    const void* td, const float* txy, const int* tlv, const unsigned char* tv,
    int K, int* d1, int* i1, int* d2, void* stream) {
  if (Q <= 0) return 0;
  const int blocks = (Q + kQueries - 1) / kQueries;
  best2_kernel<true><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(qd), quv, qlv, qr, qlo, qhi, qv, Q,
      static_cast<const unsigned*>(td), txy, tlv, tv, K, d1, i1, d2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slam_hamming_best2(const void* qd, int Q, const void* td,
                                  const unsigned char* tv, int K, int* d1,
                                  int* i1, int* d2, void* stream) {
  if (Q <= 0) return 0;
  const int blocks = (Q + kQueries - 1) / kQueries;
  best2_kernel<false><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(qd), nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, Q, static_cast<const unsigned*>(td), nullptr, nullptr,
      tv, K, d1, i1, d2);
  return static_cast<int>(cudaGetLastError());
}
