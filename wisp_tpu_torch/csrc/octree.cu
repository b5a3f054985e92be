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
//
// K10 — the octree's DDA raytrace.
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS.raytrace (:308-412): per ray the
// slab test, t_near clamped at 0, then a 3-D DDA through the cells of `level` from the cell
// of o + (t_near + 1e-6) d (clipped into the grid), for max_steps steps. A step looks up
// the current cell by the level's route (octree_lookup.cuh, the routes of JAX's
// occupied()), and an occupied cell's (pidx, entry depth, exit depth) goes to the next free
// slot of the ray's row, or sets its overflow flag when the `capacity` slots are full. The
// exit depth is min(t_max[axis], t_far) on the axis of the smallest t_max (the first one on
// a tie, as jnp.argmin); the ray lives while that depth is below t_far and the cell is in
// the grid. Float operations follow trace_one (:371-409) in its order: d_safe, true
// divisions by d_safe for t_max and t_delta, the boundary (iv + (step > 0)) * voxel - 1,
// no fused multiply-add, so depths agree bit for bit with the plain version.
//
// Bound on this card: bytes, the output. 13 bytes a slot ([R, capacity] int32 pidx, two
// float32 depths, a bool mask) against 24 bytes of ray in; at level 7 (capacity 386) a
// 65,536-ray chunk writes 329 MB. Design: one entry point, two launches. A fill pass writes
// every slot's empty value (-1, 0, 0, false) coalesced; then one thread a ray runs its DDA
// in registers and writes only its occupied cells. A dead ray stops (JAX's masks freeze
// it, so the result is the same).
#include "octree_lookup.cuh"

namespace {

using wisp::kMaxLevels;

struct LevelIndex {
  int route[kMaxLevels];
  const void* table[kMaxLevels];
  long long len[kMaxLevels];
};

__device__ __forceinline__ int quantize(float v, float half_res, int res) {
  int q = (int)floorf((v + 1.0f) * half_res);
  return min(max(q, 0), res - 1);
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
      pidx = wisp::lookup_cell(index.route[l], index.table[l], index.len[l], l, qx >> s,
                               qy >> s, qz >> s);
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


// K10: fill the interval buffers with JAX's empty slot (pidx -1, depths 0, mask 0).
__global__ void raytrace_fill_kernel(long long total, int* __restrict__ pidx,
                                     float* __restrict__ t_entry, float* __restrict__ t_exit,
                                     uint8_t* __restrict__ mask) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  pidx[i] = -1;
  t_entry[i] = 0.0f;
  t_exit[i] = 0.0f;
  mask[i] = 0;
}

// K10: one ray's DDA at `level`, the occupied cells' intervals into its row.
__global__ void raytrace_kernel(const float* __restrict__ origins,
                                const float* __restrict__ dirs, long long R, float dist_min,
                                float dist_max, int level, int route, const void* table,
                                long long len, int capacity, int max_steps,
                                int* __restrict__ pidx_out, float* __restrict__ t_entry,
                                float* __restrict__ t_exit, uint8_t* __restrict__ mask,
                                uint8_t* __restrict__ overflow) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float o[3] = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2]};
  const float d[3] = {dirs[3 * r], dirs[3 * r + 1], dirs[3 * r + 2]};
  float tn, tf;
  wisp::slab_test(o, d, dist_min, dist_max, tn, tf);
  tn = fmaxf(tn, 0.0f);
  const int res = 1 << level;
  const float voxel = 2.0f / (float)res;
  const float t_start = tn + 1e-6f;
  int iv[3], step[3];
  float t_max[3], t_delta[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ds = wisp::safe_dir(d[a]);
    const float start = o[a] + t_start * d[a];
    // floor, then JAX's saturating int32 cast and clip (the float is clamped first)
    const float cell = fminf(fmaxf(floorf((start + 1.0f) / voxel), -1.0f), (float)res);
    iv[a] = min(max((int)cell, 0), res - 1);
    step[a] = ds > 0.0f ? 1 : -1;
    const float next_bound = (float)(iv[a] + (step[a] > 0 ? 1 : 0)) * voxel - 1.0f;
    t_max[a] = (next_bound - o[a]) / ds;
    t_delta[a] = fabsf(voxel / ds);
  }
  int* row_p = pidx_out + r * capacity;
  float* row_in = t_entry + r * capacity;
  float* row_out = t_exit + r * capacity;
  uint8_t* row_m = mask + r * capacity;
  float t_cur = tn;
  bool alive = tf > tn;
  bool ovf = false;
  int ptr = 0;
  // JAX's masks freeze a ray once it is dead, so the loop may stop there
  for (int s = 0; s < max_steps && alive; ++s) {
    int axis = 0;                      // jnp.argmin: the first index on a tie
    if (t_max[1] < t_max[axis]) axis = 1;
    if (t_max[2] < t_max[axis]) axis = 2;
    const float t_next = fminf(t_max[axis], tf);
    const int pidx = wisp::lookup_cell(route, table, len, level, iv[0], iv[1], iv[2]);
    if (pidx >= 0) {
      if (ptr < capacity) {
        row_p[ptr] = pidx;
        row_in[ptr] = t_cur;
        row_out[ptr] = t_next;
        row_m[ptr] = 1;
        ++ptr;
      } else {
        ovf = true;
      }
    }
    iv[axis] += step[axis];
    t_max[axis] = t_max[axis] + t_delta[axis];
    alive = t_next < tf && iv[axis] >= 0 && iv[axis] < res;
    t_cur = t_next;
  }
  overflow[r] = (uint8_t)ovf;
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
    if (routes[l] < wisp::kMap || routes[l] > wisp::kBitfield) return (int)cudaErrorInvalidValue;
    if (routes[l] == wisp::kSearch && lens[l] < 1) return (int)cudaErrorInvalidValue;
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

// K10. route/table/len: the traced level's lookup (see wisp::Route); outputs [R, capacity]
// pidx, t_entry, t_exit, mask and [R] overflow, all written here.
WISP_EXPORT int wisp_raytrace(const float* origins, const float* dirs, long long R,
                              float dist_min, float dist_max, int level, int route,
                              const void* table, long long len, int capacity, int max_steps,
                              int* pidx, float* t_entry, float* t_exit, uint8_t* mask,
                              uint8_t* overflow, void* stream) {
  if (level < 0 || level >= kMaxLevels || route < wisp::kMap || route > wisp::kBitfield ||
      capacity < 1 || (route == wisp::kSearch && len < 1))
    return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const int threads = 256;
    cudaStream_t s = (cudaStream_t)stream;
    const long long total = R * capacity;
    raytrace_fill_kernel<<<wisp::ceil_div(total, threads), threads, 0, s>>>(
        total, pidx, t_entry, t_exit, mask);
    raytrace_kernel<<<wisp::ceil_div(R, threads), threads, 0, s>>>(
        origins, dirs, R, dist_min, dist_max, level, route, table, len, capacity, max_steps,
        pidx, t_entry, t_exit, mask, overflow);
  }
  return (int)cudaGetLastError();
}
