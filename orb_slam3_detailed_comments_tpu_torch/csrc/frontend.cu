// Fused dense ORB front end for one pyramid level: NMS'd FAST-9/16 score,
// rounded 7x7 sigma=2 Gaussian blur and the intensity-centroid moment maps
// m10 / m01, all from one read of the level image.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_frontend.py:187
// dense_frontend (Pallas body _frontend_kernel, :177), called once per
// pyramid level by ops/extractor.py on its fused front end.
//
// Bound on the H100: operations, not bytes. A pixel moves 20 bytes (one
// f32 read, four f32 writes) but costs about 3,300 float operations: 709
// circular-patch taps of four operations each for the moments, 56
// multiply-adds for the blur and about 300 subtractions and compares for
// the two arc passes of the ring. Everything after the first read is served from shared
// memory, so the four maps never touch device memory as intermediates.
//
// Design: one block per 32x32 output tile. Its 256 threads stage the tile
// plus a 16-pixel halo (64x64 f32, 16 KiB) with clamped loads, which is the
// edge replication of the contract at all four borders. The FAST score is
// then computed on the tile plus a 1-pixel ring into a second shared array
// so that the 3x3 NMS can read its neighbours; a ring column outside the
// image takes the score of the nearest column inside (the JAX kernel pads
// the score map, not the image, along that axis), a ring row outside the
// image is computed from the replicated rows. Each thread then finishes four
// pixels of the tile. The strips, halo recompute and window doubling of the
// TPU kernel answer VMEM and Mosaic limits and are not carried over.
//
// Arithmetic: score is subtractions, min and max only (exact in any order).
// The blur's taps are written with __fmul_rn / __fadd_rn in the JAX order
// (acc = k0*x0; acc += ki*xi; horizontal, then vertical) so that nvcc cannot
// contract them into FMAs and the final rintf (half to even, as jnp.round)
// lands on the same integer. The moments subtract the pixel's own value
// before summing (the window is symmetric, so any constant cancels; this is
// only f32 conditioning) and are held to an absolute tolerance.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 16;
constexpr int SW = TILE + 2 * HALO;   // staged tile width and height
constexpr int RING = TILE + 2;        // score tile with its NMS ring
constexpr int BLOCK_Y = 8;
constexpr int THREADS = TILE * BLOCK_Y;

struct FrontendParams {
  float taps[7];   // 7-tap Gaussian, float32 bits as the host computed them
  int umax[16];    // half-width of the circular patch at row offset |dv|
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// FAST-9/16 score at tile position (r, c): the largest threshold at which
// nine contiguous ring pixels are all brighter, or all darker, than the
// centre. max_i min_{j<9} D[(i+j)%16] for brighter; for darker the same on
// -D, which is -(min_i max_{j<9} D).
__device__ __forceinline__ float fast_score_at(const float (*tile)[SW], int r,
                                               int c) {
  constexpr int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float ctr = tile[r][c];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = tile[r + DY[i]][c + DX[i]] - ctr;
  float brighter = -3.0e38f, darker = -3.0e38f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float mn = d[i], mx = d[i];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(i + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    brighter = fmaxf(brighter, mn);
    darker = fmaxf(darker, -mx);
  }
  return fmaxf(brighter, darker);
}

__global__ void __launch_bounds__(THREADS)
dense_frontend_kernel(const float* __restrict__ img, int H, int W,
                      FrontendParams P, float* __restrict__ score,
                      float* __restrict__ blur, float* __restrict__ m10,
                      float* __restrict__ m01) {
  __shared__ float tile[SW][SW];
  __shared__ float sc[RING][RING];
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;

  for (int e = tid; e < SW * SW; e += THREADS) {
    const int r = e / SW, c = e - r * SW;
    const int gy = clampi(y0 + r - HALO, 0, H - 1);
    const int gx = clampi(x0 + c - HALO, 0, W - 1);
    tile[r][c] = img[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  for (int e = tid; e < RING * RING; e += THREADS) {
    const int sy = e / RING, sx = e - sy * RING;
    const int gxc = clampi(x0 + sx - 1, 0, W - 1);
    sc[sy][sx] = fast_score_at(tile, sy - 1 + HALO, gxc - x0 + HALO);
  }
  __syncthreads();

#pragma unroll 1
  for (int k = 0; k < TILE / BLOCK_Y; ++k) {
    const int oy = threadIdx.y + BLOCK_Y * k;
    const int ox = threadIdx.x;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const size_t o = static_cast<size_t>(gy) * W + gx;
    const int ly = oy + HALO, lx = ox + HALO;

    // 3x3 NMS: keep a score that is >= its eight neighbours
    const int sy = oy + 1, sx = ox + 1;
    const float s = sc[sy][sx];
    float nb = sc[sy - 1][sx - 1];
    nb = fmaxf(nb, sc[sy - 1][sx]);
    nb = fmaxf(nb, sc[sy - 1][sx + 1]);
    nb = fmaxf(nb, sc[sy][sx - 1]);
    nb = fmaxf(nb, sc[sy][sx + 1]);
    nb = fmaxf(nb, sc[sy + 1][sx - 1]);
    nb = fmaxf(nb, sc[sy + 1][sx]);
    nb = fmaxf(nb, sc[sy + 1][sx + 1]);
    score[o] = s >= nb ? s : 0.0f;

    // separable blur, horizontal then vertical, taps added in index order
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const float* row = &tile[ly - 3 + i][lx - 3];
      float h = __fmul_rn(P.taps[0], row[0]);
#pragma unroll
      for (int t = 1; t < 7; ++t) h = __fadd_rn(h, __fmul_rn(P.taps[t], row[t]));
      v = i == 0 ? __fmul_rn(P.taps[0], h) : __fadd_rn(v, __fmul_rn(P.taps[i], h));
    }
    blur[o] = rintf(v);

    // circular-patch moments: m10 = sum u * f, m01 = sum dv * f
    const float ctr = tile[ly][lx];
    float a10 = 0.0f, a01 = 0.0f;
#pragma unroll 1
    for (int dv = -15; dv <= 15; ++dv) {
      const int w = P.umax[dv < 0 ? -dv : dv];
      const float* row = &tile[ly + dv][lx];
      float rs = 0.0f, ts = 0.0f;
      for (int u = -w; u <= w; ++u) {
        const float f = row[u] - ctr;
        rs += f;
        ts += static_cast<float>(u) * f;
      }
      a10 += ts;
      a01 += static_cast<float>(dv) * rs;
    }
    m10[o] = a10;
    m01[o] = a01;
  }
}

}  // namespace

// taps (7 floats) and umax (16 ints) are host pointers; they travel to the
// kernel by value.
extern "C" int slam_dense_frontend(const float* img, int H, int W,
                                   const float* taps, const int* umax,
                                   float* score, float* blur, float* m10,
                                   float* m01, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  FrontendParams P;
  for (int i = 0; i < 7; ++i) P.taps[i] = taps[i];
  for (int i = 0; i < 16; ++i) P.umax[i] = umax[i];
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
  const dim3 block(TILE, BLOCK_Y);
  dense_frontend_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, P, score, blur, m10, m01);
  return static_cast<int>(cudaGetLastError());
}
