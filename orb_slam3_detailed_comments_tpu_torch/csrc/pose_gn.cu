// Motion-only pose optimisation, one thread block a solve.
//
// Replaces no TPU kernel. The JAX package's pose_optimization
// (orb_slam3_detailed_comments_tpu/optim/pose_opt.py) is a jitted loop that
// XLA compiles into a few fused programs; run eagerly, its plain PyTorch
// twin (optim/pose_opt.pose_optimization_plain) is ~260 small kernels an
// iteration, ~11.3k a solve, which the host takes ~146 ms to dispatch while
// the card works a few microseconds on each. This kernel runs the twin's 4
// rounds x 10 Gauss-Newton iterations in one launch.
//
// Bound on the H100: latency. A solve is ~44 dependent passes over M
// observations (M = 1,280 on the main path: a few MFLOP, ~32 KB read once),
// each ending in a block-wide reduction and a 6x6 solve on one thread; no
// byte or operation rate comes near deciding its time. So the design cuts
// the chain, not the work: one block a solve (a batch of F solves is F
// blocks), each observation read from device memory once into shared
// memory (SoA, with its valid and inlier flags), every later pass reading
// it there; per pass one sweep, warp shuffles and a shared-memory sum of
// the 27 entries, one thread's solve, and the pose handed on in shared
// memory. A round stops once its step has converged (the twin freezes the
// pose from there, so the result is the same). Where M observations do not
// fit the block's shared memory the passes read them from device memory
// and keep the inlier flags in the output mask.
//
// Arithmetic, the twin's: each observation in float32 (the camera frame
// point, cameras.project / project_jac written out for both camera kinds,
// the twist Jacobian, the depth gate z > 0.05, chi2 and the Huber weight of
// reproj.huber_weight); the 21 entries of H and 6 of b summed in float64 in
// a fixed order (the result does not depend on the block's scheduling);
// H + 1e-5 I max(tr H / 6, 1) solved in float64 by LU with partial pivoting
// (as torch.linalg.solve_ex), the step rounded once to float32; se3.exp,
// the left composition, the done test on ||dx||^2 and so3.normalize in
// float32. Clamps keep a NaN as torch.clamp does (no fmaxf). Built without
// fast-math.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;           // H's upper triangle (21), then b (6)
constexpr float kChi2 = 5.991f;     // reproj.CHI2_MONO
constexpr float kTol = 1e-8f;       // a round ends once ||dx||^2 <= kTol
constexpr float kMinDepth = 0.05f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPinhole = 0;         // models/cameras.PINHOLE
constexpr int kFisheyeKB8 = 1;      // models/cameras.FISHEYE_KB8
constexpr int kObsBytes = 6 * sizeof(float) + 1;   // staged: x y z u v w, flags
constexpr unsigned char kValid = 1, kInlier = 2;

struct Cam {
  float fx, fy, cx, cy, d0, d1, d2, d3, d4;   // dist as in CameraParams
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;   // torch.clamp: a NaN stays NaN
}

// pixel (u, v) of a camera-frame point and, if kJac, d(u, v) / d(x, y, z)
template <int kKind, bool kJac>
__device__ __forceinline__ void project(const Cam& c, float x, float y,
                                        float z, float& u, float& v,
                                        float J[2][3]) {
  if (kKind == kPinhole) {
    const float k1 = c.d0, k2 = c.d1, p1 = c.d2, p2 = c.d3, k3 = c.d4;
    const bool clamped = fabsf(z) < 1e-6f;
    const float sz = clamped ? 1e-6f : z;
    {
      const float xn = x / sz, yn = y / sz;
      const float r2 = xn * xn + yn * yn;
      const float radial = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
      const float xd = xn * radial + 2.f * p1 * xn * yn +
                       p2 * (r2 + 2.f * xn * xn);
      const float yd = yn * radial + p1 * (r2 + 2.f * yn * yn) +
                       2.f * p2 * xn * yn;
      u = c.fx * xd + c.cx;
      v = c.fy * yd + c.cy;
    }
    if (kJac) {
      const float iz = 1.f / sz;
      const float xn = x * iz, yn = y * iz;
      const float r2 = xn * xn + yn * yn;
      const float radial = 1.f + r2 * (k1 + r2 * (k2 + r2 * k3));
      const float dR = k1 + r2 * (2.f * k2 + 3.f * k3 * r2);
      const float a00 = radial + 2.f * xn * xn * dR + 2.f * p1 * yn +
                        6.f * p2 * xn;
      const float a01 = 2.f * xn * yn * dR + 2.f * p1 * xn + 2.f * p2 * yn;
      const float a11 = radial + 2.f * yn * yn * dR + 6.f * p1 * yn +
                        2.f * p2 * xn;
      const float dzx = clamped ? 0.f : -xn * iz;
      const float dzy = clamped ? 0.f : -yn * iz;
      J[0][0] = c.fx * a00 * iz;
      J[0][1] = c.fx * a01 * iz;
      J[0][2] = c.fx * (a00 * dzx + a01 * dzy);
      J[1][0] = c.fy * a01 * iz;
      J[1][1] = c.fy * a11 * iz;
      J[1][2] = c.fy * (a01 * dzx + a11 * dzy);
    }
  } else {
    const float k1 = c.d0, k2 = c.d1, k3 = c.d2, k4 = c.d3;
    const float r = sqrtf(x * x + y * y);
    const float sr = clamp_min(r, 1e-9f);
    const float th = atan2f(r, z);
    const float t2 = th * th;
    const float thd = th * (1.f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))));
    const float s = thd / sr;
    u = c.fx * x * s + c.cx;
    v = c.fy * y * s + c.cy;
    if (kJac) {
      // s = theta_d(atan2(r, z)) / max(r, 1e-9): its derivative, written
      // out where the twin takes forward-mode autodiff
      const float D = r * r + z * z;
      const float dthd = 1.f + t2 * (3.f * k1 + t2 * (5.f * k2 +
                                     t2 * (7.f * k3 + t2 * 9.f * k4)));
      const float drx = x / r, dry = y / r;
      const float dsr = r >= 1e-9f ? 1.f : 0.f;   // the clamp's derivative
      const float g = dthd * (z / D);              // d theta_d / d r
      const float dsx = (g * drx - s * dsr * drx) / sr;
      const float dsy = (g * dry - s * dsr * dry) / sr;
      const float dsz = dthd * (-r / D) / sr;
      J[0][0] = c.fx * (s + x * dsx);
      J[0][1] = c.fx * x * dsy;
      J[0][2] = c.fx * x * dsz;
      J[1][0] = c.fy * y * dsx;
      J[1][1] = c.fy * (s + y * dsy);
      J[1][2] = c.fy * y * dsz;
    }
  }
}

// dx = (H + 1e-5 I max(tr H / 6, 1))^-1 b from the 27 sums, rounded to
// float32; then T <- exp(dx) T in place. Returns ||dx||^2 > tol, false for
// a non-finite step as the twin's test.
__device__ bool step(const double* s, float* pose) {
  double H[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = a; c < 6; ++c) {
      H[a][c] = s[k];
      H[c][a] = s[k];
      ++k;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) b[a] = s[21 + a];
  double tr = 0.0;
#pragma unroll
  for (int a = 0; a < 6; ++a) tr += H[a][a];
  double sc = tr / 6.0;
  sc = sc < 1.0 ? 1.0 : sc;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = 0; c < 6; ++c) H[a][c] += (a == c ? 1e-5 : 0.0) * sc;
  }
  // LU with partial pivoting (the first largest pivot), as LAPACK's getrf
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int p = c;
    double best = fabs(H[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (fabs(H[r][c]) > best) {
        best = fabs(H[r][c]);
        p = r;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const double tmp = H[c][j];
          H[c][j] = H[r][j];
          H[r][j] = tmp;
        }
        const double tmp = b[c];
        b[c] = b[r];
        b[r] = tmp;
      }
    }
    const double inv = 1.0 / H[c][c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const double l = H[r][c] * inv;
#pragma unroll
      for (int j = c + 1; j < 6; ++j) H[r][j] -= l * H[c][j];
      b[r] -= l * b[c];
    }
  }
  double dx64[6];
#pragma unroll
  for (int c = 5; c >= 0; --c) {
    double x = b[c];
#pragma unroll
    for (int j = c + 1; j < 6; ++j) x -= H[c][j] * dx64[j];
    dx64[c] = x / H[c][c];
  }
  float d[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) d[a] = static_cast<float>(dx64[a]);

  // se3.exp(d) = (so3.exp(phi), Jl(phi) rho), small-angle branches as so3
  const float p0 = d[3], p1 = d[4], p2 = d[5];
  const float th2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float th = sqrtf(clamp_min(th2, 0.f));
  const bool small = th2 < 1e-6f;
  const float st = small ? 1.f : th;
  const float sn = sinf(st), cs = cosf(st);
  const float A = small ? 1.f - th2 / 6.f : sn / st;
  const float B =
      small ? 0.5f - th2 / 24.f : (1.f - cs) / clamp_min(th2, 1e-12f);
  const float C = small ? 1.f / 6.f - th2 / 120.f
                        : (st - sn) / clamp_min(th2 * st, 1e-12f);
  const float W[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
  float W2[3][3], Rd[3][3], Jl[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.f : 0.f;
      Rd[i][j] = eye + A * W[i][j] + B * W2[i][j];
      Jl[i][j] = eye + B * W[i][j] + C * W2[i][j];
    }
  }
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = Rd[i][0] * pose[j] + Rd[i][1] * pose[3 + j] +
                     Rd[i][2] * pose[6 + j];
    t[i] = Rd[i][0] * pose[9] + Rd[i][1] * pose[10] + Rd[i][2] * pose[11] +
           (Jl[i][0] * d[0] + Jl[i][1] * d[1] + Jl[i][2] * d[2]);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) pose[i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) pose[9 + i] = t[i];
  float ss = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) ss += d[a] * d[a];
  return ss > kTol;
}

template <int kKind, bool kStaged>
__global__ void __launch_bounds__(kThreads) pose_gn_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0,
    const float* __restrict__ Xw, const float* __restrict__ uv,
    const float* __restrict__ inv_sigma2,
    const unsigned char* __restrict__ valid, int M, Cam cam, int iters,
    int rounds, float* __restrict__ R_out, float* __restrict__ t_out,
    unsigned char* __restrict__ inlier, long long* __restrict__ n_out) {
  extern __shared__ float s_obs[];   // kStaged: x, y, z, u, v, w [M]; flags
  __shared__ double s_part[kWarps][kSums];
  __shared__ double s_sum[kSums];
  __shared__ float s_pose[12];       // R row-major, then t
  __shared__ int s_more;             // the last step was above tolerance
  __shared__ int s_count[kWarps];

  const int f = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = static_cast<size_t>(f) * M;
  Xw += 3 * base;
  uv += 2 * base;
  inv_sigma2 += base;
  valid += base;
  inlier += base;
  float* sx = s_obs;
  float* sy = sx + M;
  float* sz = sy + M;
  float* su = sz + M;
  float* sv = su + M;
  float* sw = sv + M;
  unsigned char* sf = reinterpret_cast<unsigned char*>(sw + M);

  if (tid < 9) s_pose[tid] = R0[9 * f + tid];
  else if (tid < 12) s_pose[tid] = t0[3 * f + tid - 9];
  for (int i = tid; i < M; i += kThreads) {
    if (kStaged) {
      sx[i] = Xw[3 * i];
      sy[i] = Xw[3 * i + 1];
      sz[i] = Xw[3 * i + 2];
      su[i] = uv[2 * i];
      sv[i] = uv[2 * i + 1];
      sw[i] = inv_sigma2[i];
      sf[i] = (valid[i] ? kValid : 0) | kInlier;
    } else {
      inlier[i] = 1;
    }
  }
  __syncthreads();

  // observation i as this thread reads it on every pass
  auto load = [&](int i, float& x, float& y, float& z, float& u, float& v,
                  float& w, bool& ok, bool& in) {
    if (kStaged) {
      x = sx[i];
      y = sy[i];
      z = sz[i];
      u = su[i];
      v = sv[i];
      w = sw[i];
      ok = (sf[i] & kValid) != 0;
      in = (sf[i] & kInlier) != 0;
    } else {
      x = Xw[3 * i];
      y = Xw[3 * i + 1];
      z = Xw[3 * i + 2];
      u = uv[2 * i];
      v = uv[2 * i + 1];
      w = inv_sigma2[i];
      ok = valid[i] != 0;
      in = inlier[i] != 0;
    }
  };

  for (int round = 0; round < rounds; ++round) {
    bool more = true;
    for (int it = 0; it < iters && more; ++it) {
      float P[12];
#pragma unroll
      for (int a = 0; a < 12; ++a) P[a] = s_pose[a];
      double acc[kSums];
#pragma unroll
      for (int a = 0; a < kSums; ++a) acc[a] = 0.0;
      for (int i = tid; i < M; i += kThreads) {
        float X0, X1, X2, uo, vo, w;
        bool ok, in;
        load(i, X0, X1, X2, uo, vo, w, ok, in);
        const float x = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[9];
        const float y = P[3] * X0 + P[4] * X1 + P[5] * X2 + P[10];
        const float z = P[6] * X0 + P[7] * X1 + P[8] * X2 + P[11];
        float u, v, Jp[2][3];
        project<kKind, true>(cam, x, y, z, u, v, Jp);
        const float r0 = uo - u, r1 = vo - v;
        const float w_info = w * ((ok && in && z > kMinDepth) ? 1.f : 0.f);
        const float chi2 = (r0 * r0 + r1 * r1) * w;
        const float hub =
            chi2 <= kChi2 ? 1.f : sqrtf(kChi2 / clamp_min(chi2, 1e-12f));
        const double wt = static_cast<double>(w_info * hub);
        // d(u, v) / d(rho, phi) for T <- exp(rho, phi) T: Jp [I | -hat(pc)]
        float J[2][6];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          J[k][0] = Jp[k][0];
          J[k][1] = Jp[k][1];
          J[k][2] = Jp[k][2];
          J[k][3] = Jp[k][2] * y - Jp[k][1] * z;
          J[k][4] = Jp[k][0] * z - Jp[k][2] * x;
          J[k][5] = Jp[k][1] * x - Jp[k][0] * y;
        }
        int e = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const double wa0 = wt * J[0][a], wa1 = wt * J[1][a];
#pragma unroll
          for (int c = a; c < 6; ++c) {
            acc[e] += wa0 * J[0][c] + wa1 * J[1][c];
            ++e;
          }
          acc[21 + a] += wa0 * r0 + wa1 * r1;
        }
      }
#pragma unroll
      for (int a = 0; a < kSums; ++a) {
        double s = acc[a];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(kFull, s, off);
        if (lane == 0) s_part[warp][a] = s;
      }
      __syncthreads();
      if (tid < kSums) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) s += s_part[q][tid];
        s_sum[tid] = s;
      }
      __syncthreads();
      if (tid == 0) s_more = step(s_sum, s_pose) ? 1 : 0;
      __syncthreads();
      more = s_more != 0;
    }
    // reclassify at the chi2 gate with the depth and valid gates
    float P[12];
#pragma unroll
    for (int a = 0; a < 12; ++a) P[a] = s_pose[a];
    for (int i = tid; i < M; i += kThreads) {
      float X0, X1, X2, uo, vo, w;
      bool ok, in;
      load(i, X0, X1, X2, uo, vo, w, ok, in);
      const float x = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[9];
      const float y = P[3] * X0 + P[4] * X1 + P[5] * X2 + P[10];
      const float z = P[6] * X0 + P[7] * X1 + P[8] * X2 + P[11];
      float u, v, Jp[2][3];
      project<kKind, false>(cam, x, y, z, u, v, Jp);
      const float r0 = uo - u, r1 = vo - v;
      const float chi2 = (r0 * r0 + r1 * r1) * w;
      const bool keep = chi2 <= kChi2 && z > kMinDepth && ok;
      if (kStaged) sf[i] = (ok ? kValid : 0) | (keep ? kInlier : 0);
      else inlier[i] = keep ? 1 : 0;
    }
  }

  int n = 0;
  for (int i = tid; i < M; i += kThreads) {
    bool in;
    if (kStaged) {
      in = (sf[i] & kInlier) != 0;
      inlier[i] = in ? 1 : 0;
    } else {
      in = inlier[i] != 0;
    }
    n += in ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
  if (lane == 0) s_count[warp] = n;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int q = 0; q < kWarps; ++q) total += s_count[q];
    n_out[f] = total;
    // so3.normalize: Gram-Schmidt on the rows
    const float* P = s_pose;
    const float n0 = sqrtf(P[0] * P[0] + P[1] * P[1] + P[2] * P[2]);
    const float a0 = P[0] / n0, a1 = P[1] / n0, a2 = P[2] / n0;
    const float dot = a0 * P[3] + a1 * P[4] + a2 * P[5];
    float b0 = P[3] - dot * a0, b1 = P[4] - dot * a1, b2 = P[5] - dot * a2;
    const float n1 = sqrtf(b0 * b0 + b1 * b1 + b2 * b2);
    b0 /= n1;
    b1 /= n1;
    b2 /= n1;
    float* R = R_out + 9 * f;
    R[0] = a0;
    R[1] = a1;
    R[2] = a2;
    R[3] = b0;
    R[4] = b1;
    R[5] = b2;
    R[6] = a1 * b2 - a2 * b1;
    R[7] = a2 * b0 - a0 * b2;
    R[8] = a0 * b1 - a1 * b0;
    t_out[3 * f] = P[9];
    t_out[3 * f + 1] = P[10];
    t_out[3 * f + 2] = P[11];
  }
}

template <int kKind, bool kStaged>
int launch(const float* R0, const float* t0, const float* X, const float* uv,
           const float* w, const unsigned char* valid, int F, int M,
           const Cam& cam, int iters, int rounds, float* R_out, float* t_out,
           unsigned char* inlier, long long* n_out, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_gn_kernel<kKind, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  pose_gn_kernel<kKind, kStaged><<<F, kThreads, smem, stream>>>(
      R0, t0, X, uv, w, valid, M, cam, iters, rounds, R_out, t_out, inlier,
      n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F solves of M observations each: R0 [F, 3, 3], t0 [F, 3], X [F, M, 3],
// uv [F, M, 2], w [F, M], valid [F, M] (bytes 0 / 1); cam: fx, fy, cx, cy
// and the 5 distortion values of a CameraParams of the given kind (host
// memory). Writes R_out [F, 3, 3], t_out [F, 3], inlier [F, M] (bytes) and
// n_inliers [F] (int64).
extern "C" int slam_pose_gn(const float* R0, const float* t0, const float* X,
                            const float* uv, const float* w,
                            const unsigned char* valid, int F, int M,
                            int kind, const float* cam, int iters, int rounds,
                            float* R_out, float* t_out, unsigned char* inlier,
                            long long* n_inliers, void* stream) {
  if (F <= 0) return 0;
  if (M < 0 || (kind != kPinhole && kind != kFisheyeKB8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Cam c{cam[0], cam[1], cam[2], cam[3], cam[4],
              cam[5], cam[6], cam[7], cam[8]};
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the static shared arrays take ~2 KB beside the staged observations
  const size_t staged = static_cast<size_t>(M) * kObsBytes;
  const bool fits = staged + 4096 <= static_cast<size_t>(optin);
  const size_t smem = fits ? staged : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kPinhole) {
    return fits ? launch<kPinhole, true>(R0, t0, X, uv, w, valid, F, M, c,
                                         iters, rounds, R_out, t_out, inlier,
                                         n_inliers, smem, s)
                : launch<kPinhole, false>(R0, t0, X, uv, w, valid, F, M, c,
                                          iters, rounds, R_out, t_out,
                                          inlier, n_inliers, smem, s);
  }
  return fits ? launch<kFisheyeKB8, true>(R0, t0, X, uv, w, valid, F, M, c,
                                          iters, rounds, R_out, t_out,
                                          inlier, n_inliers, smem, s)
              : launch<kFisheyeKB8, false>(R0, t0, X, uv, w, valid, F, M, c,
                                           iters, rounds, R_out, t_out,
                                           inlier, n_inliers, smem, s);
}
