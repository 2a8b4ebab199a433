// Fused dense ORB front end for all pyramid levels of a frame in one launch:
// NMS'd FAST-9/16 score, rounded 7x7 sigma=2 Gaussian blur and the
// intensity-centroid moment maps m10 / m01, from one read of each level.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_frontend.py:187
// dense_frontend (Pallas body _frontend_kernel, :177), called once per
// pyramid level by ops/extractor.py on its fused front end.
//
// Bound on the H100: bytes. A pixel moves 20 bytes (one f32 read, four f32
// writes); the cheapest form of the four maps needs about 375 float
// operations a pixel (running row sums for the moments, a separable blur,
// arc minima by window doubling), which at the card's float32 rate takes
// slightly less time than the 20 bytes at its memory rate. The kernel does
// not reach either: what it spends is shared-memory loads, scheduler slots
// and blocks in flight, and the design is about those three.
//
// Design.
// * One launch a frame. The host passes a by-value table of up to 16 levels
//   (five pointers, H, W, first tile index) and one flat grid walks all
//   levels' 64x64 tiles, so the small upper levels, each far under one wave
//   of the card's 132 SMs, run beside the large ones (blocks in flight).
// * A block of 128 threads stages its tile plus a 15-pixel halo (94x94 f32)
//   with clamped loads, which is the edge replication of the contract at
//   all four borders. Everything after that is served from shared memory.
// * FAST: the 9-long arc minima and maxima come from window doubling
//   (windows of 2, 4, 8, then 9: 4 x 16 min and max instead of 8 x 16). The
//   score is computed on the tile plus a 1-pixel ring so that the 3x3 NMS
//   can read its neighbours; a ring column outside the image takes the
//   score of the nearest column inside (the JAX kernel pads the score map,
//   not the image, along that axis), a ring row outside the image is
//   computed from the replicated rows.
// * Blur: one shared horizontal pass (7 loads a value), then the vertical
//   pass (7 loads a pixel), instead of 49 loads a pixel.
// * Moments: a thread owns one output column and a run of SEG output rows.
//   It walks down the staged rows of its column once. For each row it grows
//   the symmetric sums rs_w = sum_{|u|<=w} f and ts_w = sum u*f outward from
//   u = 0 to 15 (31 loads, neighbouring threads on neighbouring addresses,
//   no bank conflict) and then feeds the 31 outputs whose window holds that
//   row through a chain of 31 accumulator pairs held in registers: slot j
//   belongs to the output 15 - j rows below the current row, so its row
//   offset dv = j - 15 and its half-width umax(|dv|) are compile-time
//   constants, and "a[j] = a[j-1] + term(j)" both accumulates and moves the
//   partial sum one output on. Slot 30 is complete after each row. That is
//   (SEG + 30) / SEG x 31 = 60 loads and about 300 instructions a pixel at
//   SEG = 32, against 709 loads in the direct form, with a loop body of a
//   few hundred instructions (scheduler slots, instruction cache). Runs of
//   16 rows (more halo rows recomputed) and of 64 (half the threads in
//   flight) were timed and were slower.
//
// Arithmetic: score is subtractions, min and max only (exact in any order).
// The blur's taps are written with __fmul_rn / __fadd_rn in the JAX order
// (acc = k0*x0; acc += ki*xi; horizontal, then vertical) so that nvcc cannot
// contract them into FMAs and the final rintf (half to even, as jnp.round)
// lands on the same integer. In the moments ts_w sums differences f(u) -
// f(-u), so a constant cancels term by term; rs_w has one value per block
// (the tile's centre pixel) subtracted 2w+1 times, which cancels in m01 by
// symmetry and only keeps the f32 sums small. They are held to an absolute
// tolerance. No tensor cores: the moments need 5e-5 relative accuracy, which
// TF32 and bf16 inputs cannot give, and the rest is min/max and 7-tap sums.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;                 // output tile, width and height
constexpr int HALO = 15;                 // patch radius, the widest stencil
constexpr int SROWS = TILE + 2 * HALO;   // staged rows and columns
constexpr int SPITCH = 96;               // staged row pitch in floats
constexpr int RING = TILE + 2;           // score tile with its NMS ring
constexpr int HB_ROWS = TILE + 6;        // rows of the horizontal blur pass
constexpr int SEG = 32;                  // output rows a moment thread owns
static_assert(TILE % SEG == 0, "a tile is a whole number of row runs");
constexpr int THREADS = TILE * (TILE / SEG);
constexpr int MAX_LEVELS = 16;
constexpr int SCRATCH =
    RING * RING > HB_ROWS * TILE ? RING * RING : HB_ROWS * TILE;
constexpr size_t SMEM_BYTES = (SROWS * SPITCH + SCRATCH) * sizeof(float);

struct Level {
  const float* img;
  float* score;
  float* blur;
  float* m10;
  float* m01;
  int H, W;
  int tile0;     // index of the level's first tile in the flat grid
  int tiles_x;
};

struct Table {
  Level lv[MAX_LEVELS];
  int n_levels;
  float taps[7];   // 7-tap Gaussian, float32 bits as the host computed them
};

// half-width of the circular patch of radius 15 at row offset a = |dv|:
// floor(sqrt(15^2 - a^2)) (reference: ORBextractor's umax table)
__host__ __device__ constexpr int umax_of(int a) {
  return a == 0 ? 15 : a <= 5 ? 14 : a <= 7 ? 13 : a <= 9 ? 12 : a == 10 ? 11
       : a == 11 ? 10 : a == 12 ? 9 : a == 13 ? 7 : a == 14 ? 5 : 0;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// FAST-9/16 score at staged position (r, c): the largest threshold at which
// nine contiguous ring pixels are all brighter, or all darker, than the
// centre. max_i min_{j<9} D[(i+j)%16] for brighter; for darker the same on
// -D, which is -(min_i max_{j<9} D). The 9-long arc minima and maxima are
// built by doubling: windows of 2, 4 and 8, then one more element.
__device__ __forceinline__ float fast_score_at(const float* tile, int r, int c) {
  constexpr int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float* p = tile + r * SPITCH + c;
  const float ctr = p[0];
  float d[16], lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = p[DY[i] * SPITCH + DX[i]] - ctr;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(d[i], d[(i + 1) & 15]);
    hi2[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo4[i] = fminf(lo2[i], lo2[(i + 2) & 15]);
    hi4[i] = fmaxf(hi2[i], hi2[(i + 2) & 15]);
  }
  float brighter = -3.0e38f, darker = -3.0e38f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo9 =
        fminf(fminf(lo4[i], lo4[(i + 4) & 15]), d[(i + 8) & 15]);
    const float hi9 =
        fmaxf(fmaxf(hi4[i], hi4[(i + 4) & 15]), d[(i + 8) & 15]);
    brighter = fmaxf(brighter, lo9);
    darker = fmaxf(darker, -hi9);
  }
  return fmaxf(brighter, darker);
}

__global__ void __launch_bounds__(THREADS)
dense_frontend_kernel(const __grid_constant__ Table T) {
  extern __shared__ float smem[];
  float* tile = smem;                        // [SROWS][SPITCH]
  float* scratch = smem + SROWS * SPITCH;    // score ring, then blur rows

  int l = 0;
  while (l + 1 < T.n_levels && static_cast<int>(blockIdx.x) >= T.lv[l + 1].tile0)
    ++l;
  const float* __restrict__ img = T.lv[l].img;
  float* __restrict__ score = T.lv[l].score;
  float* __restrict__ blur = T.lv[l].blur;
  float* __restrict__ m10 = T.lv[l].m10;
  float* __restrict__ m01 = T.lv[l].m01;
  const int H = T.lv[l].H, W = T.lv[l].W;
  const int t = static_cast<int>(blockIdx.x) - T.lv[l].tile0;
  const int ty = t / T.lv[l].tiles_x;
  const int x0 = (t - ty * T.lv[l].tiles_x) * TILE;
  const int y0 = ty * TILE;
  const int tid = threadIdx.x;
  float k[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) k[i] = T.taps[i];

  for (int e = tid; e < SROWS * SROWS; e += THREADS) {
    const int r = e / SROWS, c = e - r * SROWS;
    const int gy = clampi(y0 + r - HALO, 0, H - 1);
    const int gx = clampi(x0 + c - HALO, 0, W - 1);
    tile[r * SPITCH + c] = img[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // FAST score on the tile and its 1-pixel ring
  for (int e = tid; e < RING * RING; e += THREADS) {
    const int sy = e / RING, sx = e - sy * RING;
    const int gxc = clampi(x0 + sx - 1, 0, W - 1);
    scratch[e] = fast_score_at(tile, sy - 1 + HALO, gxc - x0 + HALO);
  }
  __syncthreads();

  // 3x3 NMS: keep a score that is >= its eight neighbours
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int oy = e / TILE, ox = e - oy * TILE;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const float* s = scratch + (oy + 1) * RING + ox + 1;
    float nb = s[-RING - 1];
    nb = fmaxf(nb, s[-RING]);
    nb = fmaxf(nb, s[-RING + 1]);
    nb = fmaxf(nb, s[-1]);
    nb = fmaxf(nb, s[1]);
    nb = fmaxf(nb, s[RING - 1]);
    nb = fmaxf(nb, s[RING]);
    nb = fmaxf(nb, s[RING + 1]);
    score[static_cast<size_t>(gy) * W + gx] = s[0] >= nb ? s[0] : 0.0f;
  }
  __syncthreads();

  // separable blur, taps added in index order: the horizontal pass over the
  // tile's rows and three rows either side (each product and sum rounded),
  // shared by the vertical pass (each tap a fused multiply-add)
  for (int e = tid; e < HB_ROWS * TILE; e += THREADS) {
    const int hr = e / TILE, ox = e - hr * TILE;
    const float* row = tile + (hr + HALO - 3) * SPITCH + ox + HALO - 3;
    float h = __fmul_rn(k[0], row[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) h = __fadd_rn(h, __fmul_rn(k[i], row[i]));
    scratch[e] = h;
  }
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int oy = e / TILE, ox = e - oy * TILE;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const float* col = scratch + oy * TILE + ox;
    float v = __fmul_rn(k[0], col[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) v = __fmaf_rn(k[i], col[i * TILE], v);
    blur[static_cast<size_t>(gy) * W + gx] = rintf(v);
  }

  // circular-patch moments: m10 = sum u * f, m01 = sum dv * f. The tile is
  // only read from here on, so no barrier is needed after the blur.
  const int ox = tid % TILE;
  const int o0 = (tid / TILE) * SEG;        // the thread's first output row
  const int gx = x0 + ox;
  const int n_out = min(SEG, H - (y0 + o0));
  if (gx >= W || n_out <= 0) return;
  const float ctr = tile[(HALO + TILE / 2) * SPITCH + HALO + TILE / 2];
  float a10[31], a01[31];
#pragma unroll
  for (int j = 0; j < 31; ++j) a10[j] = a01[j] = 0.0f;
  // staged row o0 + y is the tile's row o0 + y - 15; after it, slot 30 holds
  // the finished sums of output row o0 + y - 30
  const float* colp = tile + o0 * SPITCH + ox + HALO;
#pragma unroll 1
  for (int y = 0; y < n_out + 2 * HALO; ++y) {
    const float* row = colp + y * SPITCH;
    float rs[16], ts[16];     // sums at half-width u; unused ones fold away
    float r = row[0], s = 0.0f;
    rs[0] = r - ctr;
    ts[0] = 0.0f;
#pragma unroll
    for (int u = 1; u <= HALO; ++u) {
      const float a = row[u], b = row[-u];
      r += a + b;
      s = fmaf(static_cast<float>(u), a - b, s);
      rs[u] = fmaf(-static_cast<float>(2 * u + 1), ctr, r);
      ts[u] = s;
    }
#pragma unroll
    for (int j = 30; j >= 0; --j) {
      const int dv = j - HALO;
      const int w = umax_of(dv < 0 ? -dv : dv);
      const float p10 = j > 0 ? a10[j > 0 ? j - 1 : 0] : 0.0f;
      const float p01 = j > 0 ? a01[j > 0 ? j - 1 : 0] : 0.0f;
      a10[j] = p10 + ts[w];
      a01[j] = fmaf(static_cast<float>(dv), rs[w], p01);
    }
    if (y >= 2 * HALO) {
      const size_t o = static_cast<size_t>(y0 + o0 + y - 2 * HALO) * W + gx;
      m10[o] = a10[30];
      m01[o] = a01[30];
    }
  }
}

}  // namespace

// The kernel's half-width table, for the wrapper to hold against its own.
extern "C" int slam_frontend_umax(int* out16) {
  for (int i = 0; i < 16; ++i) out16[i] = umax_of(i);
  return 0;
}

// img, score, blur, m10, m01: host arrays of n_levels device pointers; H, W:
// host arrays of n_levels ints; taps: 7 host floats. All travel to the
// kernel by value.
extern "C" int slam_dense_frontend_levels(
    int n_levels, const void* const* img, const int* H, const int* W,
    void* const* score, void* const* blur, void* const* m10, void* const* m01,
    const float* taps, void* stream) {
  if (n_levels <= 0 || n_levels > MAX_LEVELS)
    return static_cast<int>(cudaErrorInvalidValue);
  Table T;
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (H[l] <= 0 || W[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    Level& L = T.lv[l];
    L.img = static_cast<const float*>(img[l]);
    L.score = static_cast<float*>(score[l]);
    L.blur = static_cast<float*>(blur[l]);
    L.m10 = static_cast<float*>(m10[l]);
    L.m01 = static_cast<float*>(m01[l]);
    L.H = H[l];
    L.W = W[l];
    L.tile0 = tiles;
    L.tiles_x = (W[l] + TILE - 1) / TILE;
    tiles += L.tiles_x * ((H[l] + TILE - 1) / TILE);
  }
  for (int l = n_levels; l < MAX_LEVELS; ++l) T.lv[l] = T.lv[0];
  T.n_levels = n_levels;
  for (int i = 0; i < 7; ++i) T.taps[i] = taps[i];
  // more than 48 KB of shared memory a block has to be asked for, once on
  // each device
  static int asked_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != asked_on) {
    err = cudaFuncSetAttribute(
        dense_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err == cudaSuccess) asked_on = dev;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_frontend_kernel<<<tiles, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(T);
  return static_cast<int>(cudaGetLastError());
}
