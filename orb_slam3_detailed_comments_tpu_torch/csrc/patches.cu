// Per-keypoint patch gather from a stacked pyramid atlas.
//
// Replaces: orb_slam3_detailed_comments_tpu/ops/pallas_patches.py:50
// gather_patches_atlas (Pallas body _gather_kernel, :34), called twice per
// frame by ops/extractor.py (31x31 raw patches for the orientation, 37x37
// blurred patches for rBRIEF).
//
// Bound on the H100: memory. Each output float is one read and one write;
// the 1024 keypoints of a frame move ~4 MB (31x31) and ~5.6 MB (37x37) each
// way. The TPU kernel's aligned-window + lane-roll trick exists because TPU
// gathers run at about one element per cycle; on Hopper a plain row-major
// copy is already coalesced along each patch row.
//
// Design: one block per keypoint; its threads walk the ph*pw window in
// row-major order, so consecutive threads read consecutive atlas columns
// and write consecutive output floats. The corner is placed exactly as
// lax.dynamic_slice places its start (the JAX fallback
// gather_patches_atlas_xla): a negative start counts from the end, then it
// is clamped into the atlas, so the output equals the plain version for
// any corner.
#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ atlas, int H,
                                      int W, const int* __restrict__ rc,
                                      int ph, int pw,
                                      float* __restrict__ out) {
  const int n = blockIdx.x;
  // lax.dynamic_slice: a negative start counts from the end, then the start
  // is clamped so the window lies inside the atlas
  int r0 = rc[2 * n];
  int c0 = rc[2 * n + 1];
  r0 = min(max(r0 < 0 ? r0 + H : r0, 0), H - ph);
  c0 = min(max(c0 < 0 ? c0 + W : c0, 0), W - pw);
  const int area = ph * pw;
  float* o = out + static_cast<size_t>(n) * area;
  for (int e = threadIdx.x; e < area; e += blockDim.x) {
    const int i = e / pw;
    const int j = e - i * pw;
    o[e] = atlas[static_cast<size_t>(r0 + i) * W + (c0 + j)];
  }
}

}  // namespace

extern "C" int slam_gather_patches(const float* atlas, int H, int W,
                                   const int* rc, int n, int ph, int pw,
                                   float* out, void* stream) {
  if (n <= 0) return 0;
  gather_patches_kernel<<<n, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      atlas, H, W, rc, ph, pw, out);
  return static_cast<int>(cudaGetLastError());
}
