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
// cumulative radii s_j = 2^(j+1) - 1 = 1, 3, 7, 15, 31 for j < J, J the thresholds that
// `cap` = 2^J implies): 0 on occupied cells, s_(j-1) + 1 = 2^j for the first threshold j
// whose dilation reaches the cell, and `cap` elsewhere (32 at max_k 31). The dilation of
// half-width s_j reaches exactly the cells at Chebyshev distance <= s_j inside the box.
//
// Bound on this card: bytes: the res^3 occupancy bytes in (2 MB at level 7) and the int32
// field out (8 MB), written once; the earlier design (csrc/baselines/free_space_v1.cu)
// scanned byte grids cell by cell in three launches. Design: the occupancy packed into
// bits, a z line of res cells in max(1, res/32) words (bit b of word w is z = 32w + b), and
// "distance <= s_j" as a separable OR-dilation of the bit grid by s_j along each axis, made
// by JAX's doubling: a grid dilated by 2^j - 1 along an axis, ORed with itself shifted by
// +2^j and -2^j along it, is dilated by 2^(j+1) - 1 = s_j. Two launches. fsd_zy_kernel, a
// block an x plane: packs the plane's bytes (16-byte loads) in shared memory, dilates along
// z (shifts within and across words) and y (ORs of lines), threshold after threshold, and
// stores the plane's bits and its J z-y dilations (J + 1 bit grids of res^3/8 bytes of
// scratch, which stay in L2). fsd_x_kernel, a block 4 words of every plane: loads those
// columns of the J + 1 grids into shared memory, dilates grid j along x by the same
// doubling (a warp a word), and writes each cell's value, 0 if occupied and else 2 to the
// number of thresholds that miss it, as 16-byte stores of 4 cells. Bits beyond a line that
// is shorter than a word may be set by a left shift: they belong to the dilation of the
// unbounded grid, which equals the zero-padded one inside the box, so no cell reads them
// wrongly. Integers only: the result equals JAX's and the plain version's exactly.
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

__global__ void octree_query_kernel(const float* __restrict__ coords, long long N, int level,
                                    LevelIndex index, int with_parents,
                                    int* __restrict__ out) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float x = coords[3 * n], y = coords[3 * n + 1], z = coords[3 * n + 2];
  const bool inside = wisp::in_query_box(x, y, z);
  const int qx = wisp::quantize(x, level), qy = wisp::quantize(y, level),
            qz = wisp::quantize(z, level);
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

// K11: bit grids of res <= 256 (level 8), J <= 7 thresholds (cap <= 128)
constexpr int kFsdMaxRes = 256;
constexpr int kFsdMaxThresholds = 7;
constexpr int kFsdWords = 4;       // words of a plane a block of fsd_x_kernel takes
constexpr int kFsdXThreads = 256;  // its threads: 8 warps, 2 on each word's cells

// 16 bytes of 0/1 (any nonzero byte counts as 1) -> 16 bits, byte k to bit k
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t b = w[k] | (w[k] >> 4);
    b |= b >> 2;
    b |= b >> 1;
    b &= 0x01010101u;
    bits |= ((b & 1u) | ((b >> 7) & 2u) | ((b >> 14) & 4u) | ((b >> 21) & 8u)) << (4 * k);
  }
  return bits;
}

// word w of a z line shifted by +r (bit z takes bit z - r) or -r (bit z takes bit z + r)
__device__ __forceinline__ uint32_t shift_up(const uint32_t* line, int w, int W, int r) {
  const int i = w - (r >> 5), s = r & 31;
  const uint32_t hi = i >= 0 ? line[i] : 0u;
  if (s == 0) return hi;
  const uint32_t lo = i >= 1 ? line[i - 1] : 0u;
  return (hi << s) | (lo >> (32 - s));
}

__device__ __forceinline__ uint32_t shift_down(const uint32_t* line, int w, int W, int r) {
  const int i = w + (r >> 5), s = r & 31;
  const uint32_t lo = i < W ? line[i] : 0u;
  if (s == 0) return lo;
  const uint32_t hi = i + 1 < W ? line[i + 1] : 0u;
  return (lo >> s) | (hi << (32 - s));
}

// One block an x plane: its bits (grid 0) and their z-y dilations at the J thresholds
// (grids 1..J) into `bits`, grid g of plane x at bits + (g * res + x) * res * W.
__global__ void fsd_zy_kernel(const uint8_t* __restrict__ occ, int level, int J,
                              uint32_t* __restrict__ bits) {
  __shared__ uint32_t a[kFsdMaxRes * (kFsdMaxRes / 32)];
  __shared__ uint32_t b[kFsdMaxRes * (kFsdMaxRes / 32)];
  const int res = 1 << level;
  const int lw = level > 5 ? level - 5 : 0;  // log2 of the words a line
  const int W = 1 << lw, nw = res << lw;
  const int x = blockIdx.x;
  const size_t grid = (size_t)res * nw;
  uint32_t* plane = bits + (size_t)x * nw;
  const uint8_t* src = occ + (size_t)x * res * res;
  const bool vec = res >= 32 && (reinterpret_cast<uintptr_t>(occ) & 15) == 0;
  for (int e = threadIdx.x; e < nw; e += blockDim.x) {
    const uint8_t* line = src + (size_t)(e >> lw) * res;
    uint32_t word = 0;
    if (vec) {
      const uint4* p = reinterpret_cast<const uint4*>(line + 32 * (e & (W - 1)));
      word = pack16(__ldg(p)) | (pack16(__ldg(p + 1)) << 16);
    } else {
      const int z0 = 32 * (e & (W - 1));
      for (int z = 0; z < min(32, res); ++z) word |= (uint32_t)(line[z0 + z] != 0) << z;
    }
    a[e] = word;
    plane[e] = word;
  }
  __syncthreads();
  for (int j = 0; j < J; ++j) {
    const int r = 1 << j;
    for (int e = threadIdx.x; e < nw; e += blockDim.x) {
      const int w = e & (W - 1);
      const uint32_t* line = a + (e - w);
      b[e] = a[e] | shift_up(line, w, W, r) | shift_down(line, w, W, r);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nw; e += blockDim.x) {
      const int y = e >> lw;
      uint32_t v = b[e];
      if (y >= r) v |= b[e - (r << lw)];
      if (y + r < res) v |= b[e + (r << lw)];
      a[e] = v;
      plane[(j + 1) * grid + e] = v;
    }
    __syncthreads();
  }
}

// One block kFsdWords consecutive words of every plane: warp k dilates word k's column of
// grids 1..J along x, then every warp writes cells of the columns, 0 where grid 0 holds the
// cell and else 2 to the number of grids that miss it. Launched with kFsdXThreads threads.
__global__ void fsd_x_kernel(const uint32_t* __restrict__ bits, int level, int J,
                             int* __restrict__ dist) {
  __shared__ uint32_t col[kFsdMaxThresholds + 1][kFsdWords][kFsdMaxRes];
  const int res = 1 << level;
  const int lw = level > 5 ? level - 5 : 0;
  const int nw = res << lw;
  const size_t grid = (size_t)res * nw;
  const int g0 = blockIdx.x * kFsdWords;
  for (int e = threadIdx.x; e < (J + 1) * res; e += blockDim.x) {
    const int g = e >> level, x = e & (res - 1);
    const uint32_t* src = bits + g * grid + (size_t)x * nw + g0;
    if (g0 + kFsdWords <= nw) {  // nw is then a multiple of 4: 16-byte aligned
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
      col[g][0][x] = v.x;
      col[g][1][x] = v.y;
      col[g][2][x] = v.z;
      col[g][3][x] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < kFsdWords; ++k) col[g][k][x] = g0 + k < nw ? src[k] : 0u;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kFsdWords) {
    constexpr int kSlots = kFsdMaxRes / 32;
    for (int g = 1; g <= J; ++g) {
      uint32_t* c = col[g][warp];
      for (int step = 0; step < g; ++step) {
        const int r = 1 << step;
        uint32_t v[kSlots];
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int x = 32 * i + lane;
          if (x < res) {
            v[i] = c[x];
            if (x >= r) v[i] |= c[x - r];
            if (x + r < res) v[i] |= c[x + r];
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (32 * i + lane < res) c[32 * i + lane] = v[i];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  constexpr int kPasses = kFsdXThreads / (32 * kFsdWords);  // warps on each word
  const int k = warp % kFsdWords, word = g0 + k;
  if (word >= nw) return;
  const int y = word >> lw;
  if (res >= 32) {
    // the word's 32 cells of a plane x are 128 contiguous bytes: 8 lanes a plane, 4 cells a
    // lane, 4 planes a warp at a time
    const int sh = 4 * (lane & 7);
    const int z0 = 32 * (word & ((1 << lw) - 1)) + sh;
    for (int x = (lane >> 3) + 4 * (warp / kFsdWords); x < res; x += 4 * kPasses) {
      int miss[4] = {0, 0, 0, 0};
      for (int g = 1; g <= J; ++g) {
        const uint32_t d = col[g][k][x] >> sh;
#pragma unroll
        for (int q = 0; q < 4; ++q) miss[q] += (int)((~d >> q) & 1u);
      }
      const uint32_t o = col[0][k][x] >> sh;
      int4 out;
      out.x = (o & 1u) ? 0 : 1 << miss[0];
      out.y = (o & 2u) ? 0 : 1 << miss[1];
      out.z = (o & 4u) ? 0 : 1 << miss[2];
      out.w = (o & 8u) ? 0 : 1 << miss[3];
      *reinterpret_cast<int4*>(dist + ((size_t)x * res + y) * res + z0) = out;
    }
  } else {
    // a line shorter than a word: the word is the line (y = word), a lane a cell
    for (int e = lane + 32 * (warp / kFsdWords); e < res * res; e += 32 * kPasses) {
      const int x = e >> level, z = e & (res - 1);
      int miss = 0;
      for (int g = 1; g <= J; ++g) miss += (int)((~col[g][k][x] >> z) & 1u);
      dist[((size_t)x * res + y) * res + z] = ((col[0][k][x] >> z) & 1u) ? 0 : 1 << miss;
    }
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

// cap = 2^J (J <= 7, the thresholds); bits: (J + 1) * res^2 * max(1, res/32) words of
// scratch (octree_as.py free_space_layout).
WISP_EXPORT int wisp_free_space_distance(const uint8_t* occ, int level, int cap,
                                         uint32_t* bits, int* dist, void* stream) {
  int J = 0;
  while ((1 << J) < cap) ++J;
  if (level < 0 || (1 << level) > kFsdMaxRes || cap < 1 || (1 << J) != cap ||
      J > kFsdMaxThresholds)
    return (int)cudaErrorInvalidValue;
  const int res = 1 << level;
  const int nw = res * (res >= 32 ? res / 32 : 1);
  cudaStream_t s = (cudaStream_t)stream;
  fsd_zy_kernel<<<res, 256, 0, s>>>(occ, level, J, bits);
  fsd_x_kernel<<<wisp::ceil_div(nw, kFsdWords), kFsdXThreads, 0, s>>>(bits, level, J, dist);
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
