// The earlier design of K15's backward (octree_interp_bwd), kept as the yardstick of the
// redesign in ../octree_grid.cu: chip_smoke.py builds this file into its own library beside
// the kernel library and reports its time on the same inputs (with the earlier wrapper's
// zero fill, one table a LOD) as the K15 backward row's ``was_ms`` and in its "march and
// octree grad" step. Nothing in the package calls it.
//
// Design: one thread a (point, feature), F lanes a point. Each thread walks the LODs in
// series: cell index, trinket row, then 8 scalar atomicAdds of w_c * g into the LOD's
// zero-filled table. Entry point: wisp_octree_interp_bwd_v1, with the arguments of the
// kernel library's wisp_octree_interp_bwd before the redesign.
#include "common.cuh"

namespace {

constexpr int kMaxLods = 16;

__device__ __forceinline__ void cell_frac(float c, int level, float& frac) {
  const int res = 1 << level;
  const float half_res = (float)res / 2.0f;
  const float x = (c + 1.0f) * half_res;
  int q = (int)floorf(x);
  q = min(max(q, 0), res - 1);
  frac = fminf(fmaxf(x - (float)q, 0.0f), 1.0f);
}

struct LodGrads {
  const int* trinkets[kMaxLods];
  float* grads[kMaxLods];
  int level[kMaxLods];
};

__global__ void octree_interp_bwd_kernel(const float* __restrict__ coords,
                                         const int* __restrict__ pidx, long long N, int P,
                                         int col0, int n_lods, int F, LodGrads lods, int sum,
                                         const float* __restrict__ grad_out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * F) return;
  const long long n = tid / F;
  const int f = (int)(tid % F);
  const float x = coords[3 * n], y = coords[3 * n + 1], z = coords[3 * n + 2];
  for (int i = 0; i < n_lods; ++i) {
    const int p = __ldg(pidx + n * P + col0 + i);
    if (p < 0) continue;
    const float g = sum ? __ldg(grad_out + n * F + f)
                        : __ldg(grad_out + n * (long long)F * n_lods + (long long)i * F + f);
    float fx, fy, fz;
    cell_frac(x, lods.level[i], fx);
    cell_frac(y, lods.level[i], fy);
    cell_frac(z, lods.level[i], fz);
    const int* tr = lods.trinkets[i] + 8LL * p;
    float* grad = lods.grads[i];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wx = (c & 4) ? fx : 1.0f - fx;
      const float wy = (c & 2) ? fy : 1.0f - fy;
      const float wz = (c & 1) ? fz : 1.0f - fz;
      const float w = wx * wy * wz;
      atomicAdd(grad + (long long)__ldg(tr + c) * F + f, w * g);
    }
  }
}

}  // namespace

// trinkets, grads: host arrays of n_lods device pointers (grads zero-filled by the caller);
// levels: host array of n_lods ints. grad_out is [N, F] ('sum') or [N, F * n_lods].
WISP_EXPORT int wisp_octree_interp_bwd_v1(const float* coords, const int* pidx, long long N,
                                          int P, int col0, int n_lods, int F,
                                          const int* const* trinkets, float* const* grads,
                                          const int* levels, int sum, const float* grad_out,
                                          void* stream) {
  if (n_lods < 1 || n_lods > kMaxLods || F < 1) return (int)cudaErrorInvalidValue;
  LodGrads lods = {};
  for (int i = 0; i < n_lods; ++i) {
    lods.trinkets[i] = trinkets[i];
    lods.grads[i] = grads[i];
    lods.level[i] = levels[i];
  }
  const long long total = N * (long long)F;
  if (total > 0) {
    const int threads = 256;
    octree_interp_bwd_kernel<<<wisp::ceil_div(total, threads), threads, 0,
                               (cudaStream_t)stream>>>(coords, pidx, N, P, col0, n_lods, F,
                                                       lods, sum, grad_out);
  }
  return (int)cudaGetLastError();
}
