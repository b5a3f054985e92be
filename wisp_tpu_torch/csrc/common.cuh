// Shared helpers of the wisp_tpu_torch kernels (plain C interface, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WISP_EXPORT extern "C" __attribute__((visibility("default")))

namespace wisp {

constexpr unsigned kFullMask = 0xffffffffu;

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// A direction component kept away from 0, as aabb_intersect and raytrace take it
__device__ __forceinline__ float safe_dir(float d) { return fabsf(d) > 1e-9f ? d : 1e-9f; }

// The slab test against [-1,1]^3 (accelstructs/octree_as.py aabb_intersect): the ray's
// entry and exit depths, clamped to [dist_min, dist_max]; t_near > t_far is a miss.
__device__ __forceinline__ void slab_test(const float o[3], const float d[3], float dist_min,
                                          float dist_max, float& t_near, float& t_far) {
  t_near = -INFINITY;
  t_far = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float inv = 1.0f / safe_dir(d[a]);
    const float t0 = (-1.0f - o[a]) * inv;
    const float t1 = (1.0f - o[a]) * inv;
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
  t_near = fmaxf(t_near, dist_min);
  t_far = fminf(t_far, dist_max);
}

// Exclusive scan of one int per thread over a block of blockDim.x threads (a multiple of
// 32, at most 1024). ``total`` receives the block's sum. All threads must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int ws = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFullMask, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < nwarps) warp_sums[lane] = ws;
  }
  __syncthreads();
  const int warp_prefix = wid > 0 ? warp_sums[wid - 1] : 0;
  total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return warp_prefix + x - v;
}

}  // namespace wisp
