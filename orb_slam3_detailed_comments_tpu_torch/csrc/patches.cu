// Per-keypoint patch gather from the images of a frame's pyramid levels, for
// every keypoint of a frame in one launch.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_patches.py:50
// gather_patches_atlas (Pallas body _gather_kernel, :34): [N, ph, pw]
// windows at int32 corners. The JAX package stacks the levels into one
// atlas; here a by-value table of up to 16 images takes its place, and a
// keypoint names its image by level, so the fused front end gathers its
// 37x37 blurred patches from the 8 blur maps where they lie. One atlas is
// the one-image case ("xla" front end, 31x31 raw and 37x37 blurred patches).
//
// Corner rule, per image: lax.dynamic_slice's (the JAX fallback
// gather_patches_atlas_xla): a negative start counts from the end, then the
// start is clamped so that the window lies inside the image.
//
// Bound on the H100: memory. Each output float is one read and one write:
// 1,024 patches of 37x37 a frame are 11.2 MB. The TPU kernel's aligned
// window and lane roll exist because TPU gathers run at about one element a
// cycle; on Hopper a copy along each patch row is already coalesced.
//
// Design: one block of 256 threads a patch. Thread t copies elements
// t, t + 256, ... of the patch in row-major order, so a warp's loads run
// along a patch row and its stores along the patch's contiguous span.
// Element e sits at row e / pw, column e % pw: a thread divides once and
// then steps by 256 elements as di rows and dj columns with one carry, so
// no element needs a division. The loads of a batch of up to 8 elements a
// thread (2,048 a patch, a 37x37 patch in one batch) are all issued before
// the first store, so a warp waits for memory once a batch, not once a
// row: a load followed by its store, row after row, kept one load in
// flight a warp.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;
constexpr int MAX_IMAGES = 16;

struct Image {
  const float* p;
  int H, W;
};

struct Table {
  Image im[MAX_IMAGES];
  int n_images;
};

__global__ void __launch_bounds__(kThreads)
gather_patches_levels_kernel(const __grid_constant__ Table T,
                             const int* __restrict__ level,
                             const int* __restrict__ rc, int ph, int pw,
                             float* __restrict__ out) {
  const int n = blockIdx.x;
  // an out-of-range level is clamped into the table (the wrapper's contract
  // is 0 <= level < n_images; this only keeps the reads inside memory)
  const int lv = level ? min(max(level[n], 0), T.n_images - 1) : 0;
  const float* __restrict__ img = T.im[lv].p;
  const int H = T.im[lv].H, W = T.im[lv].W;
  int r0 = rc[2 * n];
  int c0 = rc[2 * n + 1];
  r0 = min(max(r0 < 0 ? r0 + H : r0, 0), H - ph);
  c0 = min(max(c0 < 0 ? c0 + W : c0, 0), W - pw);
  const float* src = img + static_cast<size_t>(r0) * W + c0;
  const int area = ph * pw;
  float* dst = out + static_cast<size_t>(n) * area;
  const int di = kThreads / pw, dj = kThreads - di * pw;
  for (int base = threadIdx.x; base < area; base += kThreads * kBatch) {
    int i = base / pw, j = base - i * pw;
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (base + b * kThreads < area)
        v[b] = src[static_cast<size_t>(i) * W + j];
      i += di;
      j += dj;
      if (j >= pw) {
        j -= pw;
        ++i;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (base + b * kThreads < area) dst[base + b * kThreads] = v[b];
  }
}

}  // namespace

// img: host array of n_images device pointers; H, W: host arrays of
// n_images ints; level: n int32 on the device, or null for image 0 of a
// one-image table; rc: [n, 2] int32 corners (row, column) in the named
// image. Every image must be at least ph x pw.
extern "C" int slam_gather_patches_levels(
    int n_images, const void* const* img, const int* H, const int* W,
    const int* level, const int* rc, int n, int ph, int pw, float* out,
    void* stream) {
  if (n_images <= 0 || n_images > MAX_IMAGES || ph <= 0 || pw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Table T;
  for (int l = 0; l < n_images; ++l) {
    if (H[l] < ph || W[l] < pw) return static_cast<int>(cudaErrorInvalidValue);
    T.im[l].p = static_cast<const float*>(img[l]);
    T.im[l].H = H[l];
    T.im[l].W = W[l];
  }
  for (int l = n_images; l < MAX_IMAGES; ++l) T.im[l] = T.im[0];
  T.n_images = n_images;
  gather_patches_levels_kernel<<<n, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      T, level, rc, ph, pw, out);
  return static_cast<int>(cudaGetLastError());
}
