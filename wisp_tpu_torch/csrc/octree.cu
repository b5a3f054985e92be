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
// The other routes of the same query (octree_as.py:199-240), branches of the same launch,
// chosen per level by the wrapper:
// * search (:228-233), the levels above the pidx maps (PIDX_MAP_MAX_LEVEL = 7): the cell's
//   morton code c at level l (the parent's coordinates interleaved, x in the lowest bit:
//   ops/spc/core.py morton3d, which JAX shifts right by 3*(level - l)) is looked up by a
//   lower-bound binary search in level l's sorted code table (int32, uploaded once when the
//   octree is built); i is clipped to the table, and the cell is found iff table[i] == c,
//   else -1 (jnp.searchsorted, side 'left'). Bound: bytes. ~log2(n) dependent 4-byte reads
//   a point (18 at the 256^3 shell's ~250,000 cells); the top of the search tree is read by
//   every point and stays in L1/L2, the last few steps touch one or two 32-byte sectors.
// * dense (:212-213), a make_dense octree: every cell exists and its index is c.
// * bitfield (:214-221), a carved make_dense octree (no level tables): c where the
//   max-level occupancy holds, else -1; the wrapper allows it at the max level only, as JAX.
// Integers only: the result equals JAX's and the plain version's exactly.
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

// per level: 0 pidx map (int32 [8^l]), 1 sorted code table (int32 [len]), 2 dense (no
// table), 3 bitfield (occupancy bytes [8^l])
enum Route { kMap = 0, kSearch = 1, kDense = 2, kBitfield = 3 };

struct LevelIndex {
  int route[kMaxLevels];
  const void* table[kMaxLevels];
  long long len[kMaxLevels];
};

__device__ __forceinline__ int quantize(float v, float half_res, int res) {
  int q = (int)floorf((v + 1.0f) * half_res);
  return min(max(q, 0), res - 1);
}

// 10 bits to every third bit (ops/spc/core.py _part1by2)
__device__ __forceinline__ unsigned part1by2(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x30000FFu;
  v = (v | (v << 8)) & 0x300F00Fu;
  v = (v | (v << 4)) & 0x30C30C3u;
  v = (v | (v << 2)) & 0x9249249u;
  return v;
}

__device__ __forceinline__ int search(const int* __restrict__ table, long long n,
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

__global__ void octree_query_kernel(const float* __restrict__ coords, long long N, int level,
                                    LevelIndex index, int with_parents,
                                    int* __restrict__ out) {
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
      const int px = qx >> s, py = qy >> s, pz = qz >> s;
      const long long flat = ((long long)px * res_l + py) * res_l + pz;
      const unsigned code = part1by2(px) | (part1by2(py) << 1) | (part1by2(pz) << 2);
      switch (index.route[l]) {
        case kMap:
          pidx = __ldg((const int*)index.table[l] + flat);
          break;
        case kSearch:
          pidx = search((const int*)index.table[l], index.len[l], code);
          break;
        case kDense:
          pidx = (int)code;
          break;
        default:  // kBitfield
          pidx = ((const uint8_t*)index.table[l])[flat] ? (int)code : -1;
          break;
      }
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

// routes, tables, lens: host arrays of level+1 entries (levels 0..level): each level's
// route (see Route), its device table (null for dense) and the table's length (search).
WISP_EXPORT int wisp_octree_query(const float* coords, long long N, int level,
                                  const int* routes, const void* const* tables,
                                  const long long* lens, int with_parents, int* out,
                                  void* stream) {
  if (level < 0 || level >= kMaxLevels) return (int)cudaErrorInvalidValue;
  LevelIndex index = {};
  for (int l = 0; l <= level; ++l) {
    if (routes[l] < kMap || routes[l] > kBitfield) return (int)cudaErrorInvalidValue;
    if (routes[l] == kSearch && lens[l] < 1) return (int)cudaErrorInvalidValue;
    index.route[l] = routes[l];
    index.table[l] = tables[l];
    index.len[l] = lens[l];
  }
  if (N > 0) {
    const int threads = 256;
    octree_query_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        coords, N, level, index, with_parents, out);
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
