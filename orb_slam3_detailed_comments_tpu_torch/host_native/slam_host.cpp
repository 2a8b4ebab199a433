// Host-side map bookkeeping for the PyTorch port (reference: src/MapPoint.cc
// MapPoint::ComputeDistinctiveDescriptors / UpdateNormalAndDepth /
// MapPoint::Replace, src/KeyFrame.cc KeyFrame::UpdateConnections).
//
// The card owns the dense per-frame compute; this library owns the
// irregular map maintenance that is pointer-chasing by nature and slow in
// Python: per-point observation grouping, representative-descriptor
// selection (least median Hamming distance), viewing-normal / scale-range
// updates, point-fusion relinking and covisibility on incidence bitsets.
// The six entries are the JAX package's native/slam_host.cpp, unchanged;
// each has a numpy twin in plain.py that the tests hold it to.
//
// The median of an even number of distances is the upper middle one,
// dists[n / 2] (nth_element). ORB-SLAM3 takes the lower middle,
// vDists[0.5 * (N - 1)]; the port follows the JAX package, whose results
// the tests compare against.
//
// A plain C ABI loaded through ctypes; no PyTorch header. All matrices are
// row-major contiguous as numpy lays them out. Descriptors are 8 words of
// 32 bits, any sign: the port's int32 words are passed as uint32 views.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

static inline int popcount32(uint32_t x) {
#if defined(__GNUC__)
  return __builtin_popcount(x);
#else
  int c = 0;
  while (x) { x &= x - 1; ++c; }
  return c;
#endif
}

static inline int hamming256(const uint32_t* a, const uint32_t* b) {
  int d = 0;
  for (int w = 0; w < 8; ++w) d += popcount32(a[w] ^ b[w]);
  return d;
}

// Update statistics for a set of map points.
//
//  K, N:            keyframe capacity, features per keyframe
//  kf_valid [K]:    uint8 mask
//  kf_feat_point [K*N]: int32 point id per feature (-1 none)
//  kf_feat_desc  [K*N*8]: uint32 packed descriptors
//  kf_feat_level [K*N]: int32
//  kf_R [K*9], kf_t [K*3]: world->camera poses (row major)
//  pt_xyz [P*3]: point positions
//  pt_ref_kf [P]: int32 reference keyframe (updated if dead)
//  pids [M]: point ids to update
//  scale_factors [L]: pyramid scale per level; L = n_levels
// Outputs (written in place):
//  pt_desc [P*8], pt_normal [P*3], pt_min_dist [P], pt_max_dist [P]
// Returns number of points updated.
int update_point_stats(
    int K, int N, int P, int M, int L,
    const uint8_t* kf_valid,
    const int32_t* kf_feat_point,
    const uint32_t* kf_feat_desc,
    const int32_t* kf_feat_level,
    const float* kf_R, const float* kf_t,
    const float* pt_xyz,
    int32_t* pt_ref_kf,
    const int64_t* pids,
    const float* scale_factors,
    uint32_t* pt_desc, float* pt_normal,
    float* pt_min_dist, float* pt_max_dist) {
  // mark requested points
  std::vector<int32_t> slot_of(P, -1);
  for (int m = 0; m < M; ++m) {
    int64_t p = pids[m];
    if (p >= 0 && p < P) slot_of[p] = m;
  }
  // gather observations per requested point in one pass over [K, N]
  std::vector<std::vector<std::pair<int, int>>> obs(M);  // (kf, feat)
  for (int k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_feat_point + (size_t)k * N;
    for (int f = 0; f < N; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p < P && slot_of[p] >= 0) {
        obs[slot_of[p]].emplace_back(k, f);
      }
    }
  }

  int updated = 0;
  std::vector<int> dists;
  for (int m = 0; m < M; ++m) {
    int64_t p = pids[m];
    if (p < 0 || p >= P) continue;
    auto& o = obs[m];
    const int n = (int)o.size();
    if (n == 0) continue;
    ++updated;

    // representative descriptor: min median Hamming to the others
    if (n == 1) {
      const uint32_t* d =
          kf_feat_desc + ((size_t)o[0].first * N + o[0].second) * 8;
      std::memcpy(pt_desc + (size_t)p * 8, d, 8 * sizeof(uint32_t));
    } else {
      int best = 0, best_med = 1 << 30;
      for (int i = 0; i < n; ++i) {
        const uint32_t* di =
            kf_feat_desc + ((size_t)o[i].first * N + o[i].second) * 8;
        dists.clear();
        for (int j = 0; j < n; ++j) {
          const uint32_t* dj =
              kf_feat_desc + ((size_t)o[j].first * N + o[j].second) * 8;
          dists.push_back(hamming256(di, dj));
        }
        std::nth_element(dists.begin(), dists.begin() + n / 2, dists.end());
        int med = dists[n / 2];
        if (med < best_med) { best_med = med; best = i; }
      }
      const uint32_t* d =
          kf_feat_desc + ((size_t)o[best].first * N + o[best].second) * 8;
      std::memcpy(pt_desc + (size_t)p * 8, d, 8 * sizeof(uint32_t));
    }

    // viewing normal: mean of unit vectors camera-center -> point
    const float* X = pt_xyz + (size_t)p * 3;
    double nx = 0, ny = 0, nz = 0;
    int ref_idx = -1;
    for (int i = 0; i < n; ++i) {
      int k = o[i].first;
      if (k == pt_ref_kf[p]) ref_idx = i;
      const float* R = kf_R + (size_t)k * 9;
      const float* t = kf_t + (size_t)k * 3;
      // camera center c = -R^T t
      float cx = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
      float cy = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
      float cz = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
      float vx = X[0] - cx, vy = X[1] - cy, vz = X[2] - cz;
      float nrm = std::sqrt(vx * vx + vy * vy + vz * vz);
      if (nrm > 1e-9f) { nx += vx / nrm; ny += vy / nrm; nz += vz / nrm; }
    }
    double nn = std::sqrt(nx * nx + ny * ny + nz * nz);
    if (nn > 1e-9) { nx /= nn; ny /= nn; nz /= nn; }
    pt_normal[(size_t)p * 3 + 0] = (float)nx;
    pt_normal[(size_t)p * 3 + 1] = (float)ny;
    pt_normal[(size_t)p * 3 + 2] = (float)nz;

    // scale-invariance distances from the reference observation
    if (ref_idx < 0) { ref_idx = 0; pt_ref_kf[p] = o[0].first; }
    {
      int k = o[ref_idx].first, f = o[ref_idx].second;
      const float* R = kf_R + (size_t)k * 9;
      const float* t = kf_t + (size_t)k * 3;
      float cx = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
      float cy = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
      float cz = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
      float vx = X[0] - cx, vy = X[1] - cy, vz = X[2] - cz;
      float dist = std::sqrt(vx * vx + vy * vy + vz * vz);
      int lvl = kf_feat_level[(size_t)k * N + f];
      if (lvl < 0) lvl = 0;
      if (lvl >= L) lvl = L - 1;
      float mx = dist * scale_factors[lvl];
      pt_max_dist[p] = mx;
      pt_min_dist[p] = mx / scale_factors[L - 1];
    }
  }
  return updated;
}

// Fuse point `old_id` into `new_id`: relink observations, avoiding duplicate
// observation of new_id within one keyframe (reference: MapPoint::Replace).
// Returns number of relinked observations.
int replace_point(
    int K, int N,
    const uint8_t* kf_valid,
    int32_t* kf_feat_point,
    int32_t old_id, int32_t new_id) {
  int relinked = 0;
  for (int k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    int32_t* row = kf_feat_point + (size_t)k * N;
    bool has_new = false;
    int old_at = -1;
    for (int f = 0; f < N; ++f) {
      if (row[f] == new_id) has_new = true;
      if (row[f] == old_id) old_at = f;
    }
    if (old_at < 0) continue;
    if (has_new) {
      row[old_at] = -1;
    } else {
      row[old_at] = new_id;
      ++relinked;
    }
  }
  return relinked;
}

// ---------------------------------------------------------------------------
// Covisibility via incidence bitsets (reference: KeyFrame::UpdateConnections,
// src/KeyFrame.cc — the reference walks per-point observation maps; here the
// whole graph is AND+popcount over per-keyframe point bitsets, ~20x faster
// than the numpy [K,P] incidence matmul it replaces).
// ---------------------------------------------------------------------------

static inline int popcount64(uint64_t x) {
#if defined(__GNUC__)
  return __builtin_popcountll(x);
#else
  int c = 0;
  while (x) { x &= x - 1; ++c; }
  return c;
#endif
}

// Pack each live keyframe's observed-point set into a [K, Pw] bitset
// (Pw = ceil(P / 64)). Dead keyframes get empty rows.
void build_incidence_bits(
    int K, int N, int P,
    const uint8_t* kf_valid,
    const int32_t* kf_feat_point,
    uint64_t* bits /* [K * Pw], zeroed here */) {
  const int Pw = (P + 63) / 64;
  std::memset(bits, 0, sizeof(uint64_t) * (size_t)K * Pw);
  for (int k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_feat_point + (size_t)k * N;
    uint64_t* b = bits + (size_t)k * Pw;
    for (int f = 0; f < N; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p < P) b[p >> 6] |= (uint64_t)1 << (p & 63);
    }
  }
}

// Shared-point counts of M query keyframes against ALL keyframes:
// out[m * K + k] = |points(ks[m]) & points(k)|.
void covis_counts(
    int K, int Pw,
    const uint64_t* bits,
    const uint8_t* kf_valid,
    int M, const int64_t* ks,
    int32_t* out) {
  for (int m = 0; m < M; ++m) {
    const uint64_t* q = bits + (size_t)ks[m] * Pw;
    int32_t* o = out + (size_t)m * K;
    for (int k = 0; k < K; ++k) {
      if (!kf_valid[k]) { o[k] = 0; continue; }
      const uint64_t* b = bits + (size_t)k * Pw;
      int c = 0;
      for (int w = 0; w < Pw; ++w) c += popcount64(q[w] & b[w]);
      o[k] = c;
    }
  }
}

// Which keyframes observe ANY point of a given point set (bitset form)?
// Replaces `incidence()[:, pt_ids].any(axis=1)` for the local-BA frontier.
void observers_of(
    int K, int Pw,
    const uint64_t* bits,
    const uint8_t* kf_valid,
    const uint64_t* pt_bits /* [Pw] */,
    uint8_t* out /* [K] */) {
  for (int k = 0; k < K; ++k) {
    out[k] = 0;
    if (!kf_valid[k]) continue;
    const uint64_t* b = bits + (size_t)k * Pw;
    for (int w = 0; w < Pw; ++w) {
      if (b[w] & pt_bits[w]) { out[k] = 1; break; }
    }
  }
}

// Per-point observation counts over live keyframes.
void observation_counts(
    int K, int N, int P,
    const uint8_t* kf_valid,
    const int32_t* kf_feat_point,
    int32_t* counts) {
  std::memset(counts, 0, sizeof(int32_t) * (size_t)P);
  for (int k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_feat_point + (size_t)k * N;
    for (int f = 0; f < N; ++f) {
      int32_t p = row[f];
      if (p >= 0 && p < P) counts[p]++;
    }
  }
}

}  // extern "C"
