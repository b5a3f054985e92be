// K9 — octree point query.
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS.query (:199), the dense pidx-map
// route, with ops/spc/core.py quantize_points_jnp (:93) and morton3d (:86): quantize the
// point at the query level, then for each level l of the chain (or the query level alone)
// take the parent cell q >> (level - l) and gather its index from level l's dense map
// (flat (x*res_l + y)*res_l + z, -1 = not occupied). A point outside [-1,1]^3 (inclusive,
// as JAX has it) gets -1 at every level. The morton code of JAX's version is only used to
// derive parents by shifts; shifting each coordinate gives the same parents.
//
// Bound on this card: bytes. Per point 12 bytes in, 4 bytes a level out, and one 4-byte
// gather a level from maps of 9.6 MB at level 7 that stay in L2. Design: one thread a point,
// the levels in a loop; the maps' pointers travel in the kernel's argument block, so the
// wrapper concatenates nothing.
//
// K11 — the free-space distance field.
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS.free_space_distance (:254): the
// Chebyshev (L-inf) distance from each max-level cell to the nearest occupied cell, as JAX
// quantizes it with its log-doubling max-dilations (radii 1, 2, 4, ... with zero padding,
// cumulative radii 1, 3, 7, 15, 31): 0 on occupied cells, the largest power of two not above
// the distance where a dilation reached the cell, and `cap` (one more than the last
// cumulative radius; 32 at max_k 31) elsewhere. A cube dilation of half-width s reaches
// exactly the cells at Chebyshev distance <= s inside the box, so computing the exact
// distance (capped) and quantizing it gives JAX's integers.
//
// Bound on this card: bytes (2 MB of occupancy in, 8 MB out at level 7; the passes' scratch
// stays in L2). Design: the exact transform in three separable passes, one thread a cell:
// pass z takes the 1-D distance to the nearest occupied cell on the cell's z line; passes y
// and x take min over the line of max(|offset|, previous pass), scanning outward and
// stopping once the offset reaches the best value found. Values are capped at `cap`
// (uint8 scratch); the x pass quantizes and writes int32. One entry point, three launches.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 11;

struct MapPtrs {
  const int* m[kMaxLevels];
};

__device__ __forceinline__ int quantize(float v, float half_res, int res) {
  int q = (int)floorf((v + 1.0f) * half_res);
  return min(max(q, 0), res - 1);
}

__global__ void octree_query_kernel(const float* __restrict__ coords, long long N, int level,
                                    MapPtrs maps, int with_parents, int* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float x = coords[3 * n], y = coords[3 * n + 1], z = coords[3 * n + 2];
  const bool inside = x >= -1.0f && x <= 1.0f && y >= -1.0f && y <= 1.0f && z >= -1.0f &&
                      z <= 1.0f;
  const int res = 1 << level;
  const float half_res = (float)res / 2.0f;
  const int qx = quantize(x, half_res, res), qy = quantize(y, half_res, res),
            qz = quantize(z, half_res, res);
  const int first = with_parents ? 0 : level;
  int* row = out + n * (long long)(level - first + 1);
  for (int l = first; l <= level; ++l) {
    int pidx = -1;
    if (inside) {
      const int s = level - l;
      const long long res_l = 1LL << l;
      const long long flat = (((long long)(qx >> s)) * res_l + (qy >> s)) * res_l + (qz >> s);
      pidx = __ldg(maps.m[l] + flat);
    }
    row[l - first] = pidx;
  }
}

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

// maps: a host array of level+1 device pointers (the maps of levels 0..level).
WISP_EXPORT int wisp_octree_query(const float* coords, long long N, int level,
                                  const int* const* maps, int with_parents, int* out,
                                  void* stream) {
  if (level < 0 || level >= kMaxLevels) return (int)cudaErrorInvalidValue;
  MapPtrs p = {};
  for (int l = 0; l <= level; ++l) p.m[l] = maps[l];
  if (N > 0) {
    const int threads = 256;
    octree_query_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        coords, N, level, p, with_parents, out);
  }
  return (int)cudaGetLastError();
}

// scratch: 2 * res^3 bytes.
WISP_EXPORT int wisp_free_space_distance(const uint8_t* occ, int level, int cap,
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
