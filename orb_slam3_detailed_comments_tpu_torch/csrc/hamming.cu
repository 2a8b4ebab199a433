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
// reads ~0.3 MB of inputs but does 4096 * 1024 * 8 XOR + popcount + add
// word steps on the CUDA cores (tensor cores have no popcount path).
//
// Design: one thread per query; the block stages the targets through shared
// memory in tiles of kTile rows (descriptor words, position, level and
// validity: 48 bytes a row), so every target row is read from device memory
// once per block and then broadcast to all threads of the block. The gates
// are evaluated in float32 exactly as the Pallas kernel does (|du| <= r,
// |dv| <= r, level difference in [lo, hi], both validity masks); build
// without fast-math so the comparisons stay IEEE.
//
// Output contract (same as the Pallas kernels and the plain versions):
// a gated-out pair counts as BIG; d1 is the minimum, i1 the FIRST index of
// the minimum, d2 the minimum over every column except i1 (a tie elsewhere
// gives d2 == d1); a row with every target gated out returns
// d1 = d2 = BIG and i1 = 0.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 10000;
constexpr int kTile = 512;
constexpr int kThreads = 64;

struct Best2 {
  int d1 = INT_MAX;
  int i1 = 0;
  int d2 = kBig;
  __device__ __forceinline__ void push(int d, int j) {
    if (d < d1) {
      d2 = min(d2, d1);
      d1 = d;
      i1 = j;
    } else {
      d2 = min(d2, d);
    }
  }
};

__device__ __forceinline__ int hamming8(const unsigned* q, const unsigned* t) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) d += __popc(q[w] ^ t[w]);
  return d;
}

template <bool kWindowed>
__global__ void best2_kernel(
    const unsigned* __restrict__ qd, const float* __restrict__ quv,
    const int* __restrict__ qlv, const float* __restrict__ qr,
    const int* __restrict__ qlo, const int* __restrict__ qhi,
    const unsigned char* __restrict__ qv, int Q,
    const unsigned* __restrict__ td, const float* __restrict__ txy,
    const int* __restrict__ tlv, const unsigned char* __restrict__ tv, int K,
    int* __restrict__ d1o, int* __restrict__ i1o, int* __restrict__ d2o) {
  __shared__ unsigned s_desc[kTile][8];
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ int s_lv[kTile];
  __shared__ unsigned char s_ok[kTile];

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < Q;
  unsigned my[8];
  float u = 0.f, v = 0.f, r = 0.f;
  int lv = 0, lo = 0, hi = 0;
  bool qok = active;
  if (active) {
#pragma unroll
    for (int w = 0; w < 8; ++w) my[w] = qd[static_cast<size_t>(q) * 8 + w];
    if (kWindowed) {
      u = quv[2 * q];
      v = quv[2 * q + 1];
      r = qr[q];
      lv = qlv[q];
      lo = qlo[q];
      hi = qhi[q];
      qok = qv[q] != 0;
    }
  }
  Best2 best;
  for (int base = 0; base < K; base += kTile) {
    const int n = min(kTile, K - base);
    __syncthreads();
    for (int e = threadIdx.x; e < n * 8; e += blockDim.x)
      s_desc[e >> 3][e & 7] = td[static_cast<size_t>(base) * 8 + e];
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      s_ok[e] = tv[base + e];
      if (kWindowed) {
        s_x[e] = txy[2 * (base + e)];
        s_y[e] = txy[2 * (base + e) + 1];
        s_lv[e] = tlv[base + e];
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < n; ++j) {
      bool ok = s_ok[j] != 0;
      if (kWindowed) {
        const int dl = s_lv[j] - lv;
        ok = ok && qok && fabsf(u - s_x[j]) <= r && fabsf(v - s_y[j]) <= r &&
             dl >= lo && dl <= hi;
      }
      best.push(ok ? hamming8(my, s_desc[j]) : kBig, base + j);
    }
  }
  if (active) {
    d1o[q] = best.d1;
    i1o[q] = best.i1;
    d2o[q] = best.d2;
  }
}

}  // namespace

extern "C" int slam_hamming_best2_windowed(
    const void* qd, const float* quv, const int* qlv, const float* qr,
    const int* qlo, const int* qhi, const unsigned char* qv, int Q,
    const void* td, const float* txy, const int* tlv, const unsigned char* tv,
    int K, int* d1, int* i1, int* d2, void* stream) {
  if (Q <= 0) return 0;
  const int blocks = (Q + kThreads - 1) / kThreads;
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
  const int blocks = (Q + kThreads - 1) / kThreads;
  best2_kernel<false><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(qd), nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, Q, static_cast<const unsigned*>(td), nullptr, nullptr,
      tv, K, d1, i1, d2);
  return static_cast<int>(cudaGetLastError());
}
