// The earlier design of K15's forward (octree_interp), kept as the yardstick of the
// redesign in ../octree_grid.cu: chip_smoke.py builds this file into its own library beside
// the kernel library and reports its time on the same inputs as the K15 forward row's
// ``was_ms`` and in its "octree grid" step. Nothing in the package calls it.
//
// Design: one thread a (point, feature), F lanes a point. Each lane walks the LODs in a loop
// of run-time length; per LOD it loads the cell index, then the cell's 8 trinket ints, then
// the 8 corner features, one dependent 4-byte load after another. Entry point:
// wisp_octree_interp_v1, with the arguments of the kernel library's wisp_octree_interp
// before the redesign.
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
WISP_EXPORT int wisp_octree_interp_v1(const float* coords, const int* pidx, long long N,
                                      int P, int col0, int n_lods, int F,
                                      const int* const* trinkets, const float* const* feats,
                                      const int* levels, int sum, float* out, void* stream) {
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
