// The earlier design of K11 (free_space_distance), kept as the yardstick of the redesign in
// ../octree.cu: chip_smoke.py builds this file into its own library beside the kernel
// library and reports its time on the same inputs as the K11 row's ``was_ms`` and in its
// "octree grid" step. Nothing in the package calls it.
//
// Design: the exact Chebyshev transform, capped at `cap`, in three separable passes of one
// thread a cell over byte grids: pass z scans its z line outward (up to `cap` cells each
// way) for the nearest occupied cell; passes y and x take min over the line of
// max(|offset|, previous pass), scanning outward until the offset reaches the best value
// found; the x pass quantizes (0, the largest power of two not above the distance, or
// `cap`) and writes int32. Three launches and 2 * res^3 bytes of scratch. Entry point:
// wisp_free_space_distance_v1, with the arguments of the kernel library's
// wisp_free_space_distance before the redesign.
#include "common.cuh"

namespace {

// 1-D distance along z to the nearest occupied cell, capped.
__global__ void fsd_pass_z(const uint8_t* __restrict__ occ, int res, int cap,
                           uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)res * res * res;
  if (i >= total) return;
  const int z = (int)(i % res);
  const uint8_t* line = occ + (i - z);
  int best = cap;
  for (int k = 0; k < cap; ++k) {
    if ((z - k >= 0 && line[z - k]) || (z + k < res && line[z + k])) {
      best = k;
      break;
    }
  }
  out[i] = (uint8_t)best;
}

// min over the line of axis `stride` (res for y, res*res for x) of max(|k|, in): exact
// Chebyshev distance over the axes seen so far. The last pass quantizes into `dist`.
__global__ void fsd_pass_minmax(const uint8_t* __restrict__ in, int res, long long stride,
                                int cap, uint8_t* __restrict__ out, int* __restrict__ dist) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)res * res * res;
  if (i >= total) return;
  const int c = (int)((i / stride) % res);
  const uint8_t* line = in + (i - (long long)c * stride);
  int best = line[(long long)c * stride];
  for (int k = 1; k < best; ++k) {
    if (c - k >= 0) best = min(best, max(k, (int)line[(long long)(c - k) * stride]));
    if (c + k < res) best = min(best, max(k, (int)line[(long long)(c + k) * stride]));
  }
  if (dist == nullptr) {
    out[i] = (uint8_t)best;
  } else {
    int q = best;
    if (best > 0 && best < cap) q = 1 << (31 - __clz(best));
    dist[i] = q;
  }
}

}  // namespace

// scratch: 2 * res^3 bytes.
WISP_EXPORT int wisp_free_space_distance_v1(const uint8_t* occ, int level, int cap,
                                            uint8_t* scratch, int* dist, void* stream) {
  const int res = 1 << level;
  const long long total = (long long)res * res * res;
  const int threads = 256;
  const int blocks = wisp::ceil_div(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* a = scratch;
  uint8_t* b = scratch + total;
  fsd_pass_z<<<blocks, threads, 0, s>>>(occ, res, cap, a);
  fsd_pass_minmax<<<blocks, threads, 0, s>>>(a, res, (long long)res, cap, b, nullptr);
  fsd_pass_minmax<<<blocks, threads, 0, s>>>(b, res, (long long)res * res, cap, nullptr, dist);
  return (int)cudaGetLastError();
}
