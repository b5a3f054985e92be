// The octree's cell lookup by route, shared by K9 (octree.cu), K10 (octree.cu), K13
// (sphere_trace.cu) and the fused query of octree_grid.cu: one level's cell index from the
// cell's integer coordinates, by the route the wrapper chose for the level
// (OctreeAS.query_routes; the routes of wisp_tpu/accelstructs/octree_as.py query :199-240
// and raytrace's occupied() :349-369), and K9's quantization and box test.
#pragma once

#include "common.cuh"

namespace wisp {

constexpr int kMaxLevels = 11;

// 0 pidx map (int32 [8^l], -1 = empty), 1 sorted morton codes (int32 [len], searched),
// 2 dense (every cell, index = morton code; no table), 3 bitfield (occupancy bytes [8^l]:
// index = morton code where occupied)
enum Route { kMap = 0, kSearch = 1, kDense = 2, kBitfield = 3 };

// 10 bits to every third bit (ops/spc/core.py _part1by2)
__device__ __forceinline__ unsigned part1by2(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x30000FFu;
  v = (v | (v << 8)) & 0x300F00Fu;
  v = (v | (v << 4)) & 0x30C30C3u;
  v = (v | (v << 2)) & 0x9249249u;
  return v;
}

__device__ __forceinline__ unsigned morton3(int x, int y, int z) {
  return part1by2((unsigned)x) | (part1by2((unsigned)y) << 1) | (part1by2((unsigned)z) << 2);
}

// jnp.searchsorted (side 'left') of `code` in the sorted table, clipped to the table; the
// index where the table holds the code, else -1
__device__ __forceinline__ int search_code(const int* __restrict__ table, long long n,
                                           unsigned code) {
  const int c = (int)code;            // codes below 2^30: int32 order is code order
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(table + mid) < c) lo = mid + 1;
    else hi = mid;
  }
  const long long i = min(lo, n - 1);
  return __ldg(table + i) == c ? (int)i : -1;
}

// K9's quantization of a coordinate at `level`: floor((v + 1) * res / 2) clipped to
// [0, res) (ops/spc/core.py quantize_points)
__device__ __forceinline__ int quantize(float v, int level) {
  const int res = 1 << level;
  const float half_res = (float)res / 2.0f;
  return min(max((int)floorf((v + 1.0f) * half_res), 0), res - 1);
}

// K9's box test, [-1, 1] on every axis, bounds included: a point outside gets -1 at every
// level
__device__ __forceinline__ bool in_query_box(float x, float y, float z) {
  return x >= -1.0f && x <= 1.0f && y >= -1.0f && y <= 1.0f && z >= -1.0f && z <= 1.0f;
}

// The index of cell (x, y, z), each in [0, 2^l), at level l by `route`; -1 = not occupied.
__device__ __forceinline__ int lookup_cell(int route, const void* table, long long len, int l,
                                           int x, int y, int z) {
  const long long res_l = 1LL << l;
  const long long flat = ((long long)x * res_l + y) * res_l + z;
  switch (route) {
    case kMap:
      return __ldg((const int*)table + flat);
    case kSearch:
      return search_code((const int*)table, len, morton3(x, y, z));
    case kDense:
      return (int)morton3(x, y, z);
    default:  // kBitfield
      return ((const uint8_t*)table)[flat] ? (int)morton3(x, y, z) : -1;
  }
}

}  // namespace wisp
