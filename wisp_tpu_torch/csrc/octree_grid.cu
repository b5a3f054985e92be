// K15 — octree-grid (NGLOD) multi-LOD trilinear interpolation.
//
// Replaces wisp_tpu/models/grids/octree_grid.py OctreeGrid._interpolate (:96) and
// interpolate (:115), with the blend of ops/grid.py grid_interpolate (:393, K14's blend).
// Per point and LOD i: the cell index p (column col0 + i of the query's pidx; -1 = empty
// cell, zero features), the cell's 8 dual-vertex rows trinkets[p] (corner c at offset
// (c>>2, (c>>1)&1, c&1), z fastest), the fraction frac = clip((x+1)*(res/2) - cell, 0, 1)
// per axis, and sum_c feats[row_c] * w_c with w_c the product of frac or 1-frac over the
// axes. 'sum' adds the LODs in order into [N, F]; 'cat' writes [N, F*L], LOD-major.
//
// Bound on this card: bytes, gathered. Per point and LOD it reads one 32-byte trinket row
// and 8 feature rows of F floats (64 bytes at F = 16) at scattered addresses; at the NGLOD
// width (6 LODs, 161,505 rows of 16 floats, 10.3 MB, and 2.5 MB of trinkets) all of it
// stays in L2, so L2 sector traffic and the compulsory bytes (coords and pidx in, features
// out) bound it. Design: F lanes a point, one lane a feature, so each 64-byte feature row is
// read by 16 neighbouring lanes at once (coalesced) and the output row is written
// contiguously; the lanes of a point read the same trinket row (one broadcast). LOD
// pointers and levels travel in the kernel's argument block. The library is built without
// fused multiply-add, so the fractions equal the plain version's and the blend differs only
// by the order of its float sums.
#include "common.cuh"

namespace {

constexpr int kMaxLods = 16;

struct Lods {
  const int* trinkets[kMaxLods];
  const float* feats[kMaxLods];
  int level[kMaxLods];
};

__device__ __forceinline__ void cell_frac(float c, int level, float& frac) {
  const int res = 1 << level;
  const float half_res = (float)res / 2.0f;
  const float x = (c + 1.0f) * half_res;
  int q = (int)floorf(x);
  q = min(max(q, 0), res - 1);
  frac = fminf(fmaxf(x - (float)q, 0.0f), 1.0f);
}

__global__ void octree_interp_kernel(const float* __restrict__ coords,
                                     const int* __restrict__ pidx, long long N, int P,
                                     int col0, int n_lods, int F, Lods lods, int sum,
                                     float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * F) return;
  const long long n = tid / F;
  const int f = (int)(tid % F);
  const float x = coords[3 * n], y = coords[3 * n + 1], z = coords[3 * n + 2];
  float acc = 0.0f;
  for (int i = 0; i < n_lods; ++i) {
    const int p = __ldg(pidx + n * P + col0 + i);
    float fs = 0.0f;
    if (p >= 0) {
      float fx, fy, fz;
      cell_frac(x, lods.level[i], fx);
      cell_frac(y, lods.level[i], fy);
      cell_frac(z, lods.level[i], fz);
      const int* tr = lods.trinkets[i] + 8LL * p;
      const float* feats = lods.feats[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float wx = (c & 4) ? fx : 1.0f - fx;
        const float wy = (c & 2) ? fy : 1.0f - fy;
        const float wz = (c & 1) ? fz : 1.0f - fz;
        const float w = wx * wy * wz;
        fs += __ldg(feats + (long long)__ldg(tr + c) * F + f) * w;
      }
    }
    if (sum) {
      acc += fs;
    } else {
      out[n * (long long)F * n_lods + (long long)i * F + f] = fs;
    }
  }
  if (sum) out[n * F + f] = acc;
}

}  // namespace

// trinkets, feats: host arrays of n_lods device pointers; levels: host array of n_lods ints.
WISP_EXPORT int wisp_octree_interp(const float* coords, const int* pidx, long long N, int P,
                                   int col0, int n_lods, int F, const int* const* trinkets,
                                   const float* const* feats, const int* levels, int sum,
                                   float* out, void* stream) {
  if (n_lods < 1 || n_lods > kMaxLods || F < 1) return (int)cudaErrorInvalidValue;
  Lods lods = {};
  for (int i = 0; i < n_lods; ++i) {
    lods.trinkets[i] = trinkets[i];
    lods.feats[i] = feats[i];
    lods.level[i] = levels[i];
  }
  const long long total = N * (long long)F;
  if (total > 0) {
    const int threads = 256;
    octree_interp_kernel<<<wisp::ceil_div(total, threads), threads, 0,
                           (cudaStream_t)stream>>>(coords, pidx, N, P, col0, n_lods, F, lods,
                                                   sum, out);
  }
  return (int)cudaGetLastError();
}
