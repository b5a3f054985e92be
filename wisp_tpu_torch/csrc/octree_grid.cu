// K15 — octree-grid (NGLOD) multi-LOD trilinear interpolation.
//
// Replaces wisp_tpu/models/grids/octree_grid.py OctreeGrid._interpolate (:96) and
// interpolate (:115), with the blend of ops/grid.py grid_interpolate (:393, K14's blend).
// Per point and LOD i: the cell index p (column col0 + i of the query's pidx; -1 = empty
// cell, zero features), the cell's 8 dual-vertex rows trinkets[p] (corner c at offset
// (c>>2, (c>>1)&1, c&1), z fastest), the fraction frac = clip((x+1)*(res/2) - cell, 0, 1)
// per axis, and sum_c feats[row_c] * w_c with w_c the product of frac or 1-frac over the
// axes, the corners added in order c = 0..7. 'sum' adds the LODs in LOD order into [N, F];
// 'cat' writes [N, F*L], LOD-major.
//
// Bound on this card: bytes, gathered, and the latency of the chain that reaches them. Per
// point and LOD it reads one 32-byte trinket row and 8 feature rows of F floats (64 bytes
// at F = 16) at scattered addresses; at the NGLOD width (6 LODs, 161,505 rows of 16 floats,
// 10.3 MB, and 2.5 MB of trinkets) all of it stays in L2, and the compulsory bytes (coords
// and pidx in, features out) are tiny, so an SDF chunk (16,384 points) is set by how many
// dependent L2 round trips a thread waits on and how many load instructions the L1 issues.
// Design: F/V lanes a point, V features a lane: V = 4 (16-byte loads and stores, 4 lanes a
// point at F = 16, 8 points a warp) where F % 4 == 0 and every feature table starts on 16
// bytes, else V = 1 (a lane a feature; the octree NeRF's F = 5); the wrapper picks V. The
// LODs go in batches of kLodBatch = 4, unrolled with predication: a thread first issues the
// batch's cell indices, then their 32-byte trinket rows (two 16-byte loads each), then the
// feature gathers, so it waits on about three round trips a batch instead of three a LOD
// (six instead of eighteen at the NGLOD width's 6 LODs).
// The lanes of a point load the same index and trinket row (one broadcast). The library is
// built without fused multiply-add, so the fractions equal the plain version's and the
// blend differs only by the order of its float sums.
//
// The octree query folded into K15's forward (octree_query_interp).
//
// Replaces the same interpolate with its query: wisp_tpu/accelstructs/octree_as.py
// OctreeAS.query (:199, K9) with parents, whose pidx [N, level + 1] goes to K15 and nowhere
// else. The batch's first load becomes each LOD's cell lookup (octree_lookup.cuh
// lookup_cell, every route: map, binary search, dense, bitfield) of the point's parent cell
// q >> (query_level - level) at the LOD's level, q the point quantized at the query level,
// and -1 at every LOD outside [-1, 1]^3 (bounds included): exactly K9's with_parents
// column. The lanes of a point make the same lookup (broadcast loads, as they load the same
// trinket row). Where the features need a gradient the cells [N, LODs] are written (by the
// point's first lane) for K15's backward, which takes them as its pidx.
//
// Bound on this card: as K15's forward, less K9's pidx round trip through memory (4 bytes a
// LOD written and read again) and its launch. Design: K15's, the lookups issued together
// for a batch of 4 LODs in place of its pidx loads; one launch instead of two.
//
// K12's step folded in front of it (sphere_iter).
//
// Replaces one iteration of wisp_tpu/tracers/packed_sdf_tracer.py sphere_loop (:136-150) up
// to the decoder: the step on the previous iteration's field (sphere_walker.cuh, the code of
// sphere_step), the point o + t*d (product, then sum, as the plain version), then the fused
// query and interpolation there, into the decoder's input row: the features, then the
// point where the field takes the raw position (NeuralSDF's position_input with no
// embedder); the row stride is the caller's (padded to 16 bytes for V = 4). A flag skips
// the step (the loop's first iteration). A point's lanes form a group of a power of two
// lanes (F/V rounded up) inside one warp: its first lane steps the ray and makes the point,
// and the group takes them by shuffle, so no lane reads t after another wrote it. A ray
// that is not alive after the step gets a row of zeros and no gathers: nothing reads that
// row, since its t, alive and hit stay frozen (JAX's loop masks them). t, alive and hit
// equal sphere_step's bit for bit.
//
// Bound on this card: as octree_query_interp at the live rays' points, plus 24 bytes of
// ray, 10 of state and the field's 4 a ray, and one gather of the free-space field (8 MB at
// level 7, in L2).
//
// K15 backward (octree_interp_bwd) replaces the feature gradient of the same JAX function:
// octree_grid.py:87 _index_features -> ops/grid.py:37 gather_rows, whose custom VJP
// (:55 _gather_rows_bwd) scatter-adds the corner cotangents into each LOD's table, one
// column at a time (a TPU layout trick). Per (point, LOD, corner, feature) it adds w_c *
// g[n, f] into the zero-filled table grad_l [V_l, F]: 'sum' hands every LOD the same g
// [N, F], 'cat' hands LOD i its slice of g [N, F*L]. The weights are recomputed from coords
// exactly as the forward computes them (nothing is saved but coords and pidx), and a point
// in an empty cell adds nothing (JAX gathers row 0 for it and masks the blend, so its
// gradient there is zero too).
//
// Bound on this card: bytes, the tables written whole (the wrapper's one zero fill). What
// sets the time is the adds. Measured on an H100 (80GB HBM3, 700 W; chip_atomics_bench.py
// for the rates, chip_smoke.py's "march and octree grad" step for the counts): an atomic
// add at a random address costs the same as a float or a float4 (~87 G/s), lanes of one
// instruction on one row share their L2 requests (five lanes on a 20-byte row: ~212 G
// floats/s), adds to one address serialise (~11 G/s over 128 addresses), and a shared-
// memory float atomicAdd is a compare-and-swap loop (~335 G/s over the card). The octree
// NeRF's F = 5 call (187,360 points, levels 4-7) puts up to ~6,900 adds on one level-4 row
// and ~1,000 on a level-5 one; its points come step by step from the compaction, not ray
// by ray, so neighbouring lanes seldom share a cell. An NGLOD batch is 512 points.
// Design: blockIdx.y is the LOD, so a point's LODs run in parallel (the earlier design
// walked them in series). Lanes take (point, V features) items in a grid-stride loop, F/V
// lanes a point, so the lanes of one corner row add to adjacent addresses in one
// instruction (V = 4: float4 atomics where F % 4 == 0 and the tables and g start on 16
// bytes; else V = 1, five lanes on a 20-byte row at F = 5). A LOD whose table fits in
// kBwdSharedBytes and whose adds average many a row (the wrapper's bwd_shared_lods: levels
// 4 and 5 at F = 5, none at the NGLOD batch) is summed first in a block-private copy of its
// table and flushed with one global add a touched entry a block, so a hot row takes one add
// a block instead of one a point. Sums differ from the plain version's only in their order.
#include "common.cuh"
#include "octree_lookup.cuh"
#include "sphere_walker.cuh"

namespace {

constexpr int kMaxLods = 16;

// The LODs' tables. The fused query (kQuery, kRays) also reads each LOD's cell lookup at
// its level: route (wisp::Route), table and length. Every forward entry point takes this
// struct whole from the host (octree_grid.py's _LodTables, built once a set of tables)
struct Lods {
  const int* trinkets[kMaxLods];
  const float* feats[kMaxLods];
  const void* table[kMaxLods];
  long long len[kMaxLods];
  int level[kMaxLods];
  int route[kMaxLods];
};

__device__ __forceinline__ void cell_frac(float c, int level, float& frac) {
  const int res = 1 << level;
  const float half_res = (float)res / 2.0f;
  const float x = (c + 1.0f) * half_res;
  int q = (int)floorf(x);
  q = min(max(q, 0), res - 1);
  frac = fminf(fmaxf(x - (float)q, 0.0f), 1.0f);
}

// LODs whose index and trinket loads are issued together: 4 keeps the V = 1 route at 64
// registers; 8 took it past 100, and the occupancy lost cost more than the round trips
// saved (the octree NeRF's F = 5 call ran slower than the earlier design)
constexpr int kLodBatch = 4;
// the forward's block. The kernel is compiled for it with at least one block an SM
// (__launch_bounds__(128, 1)); on an H100 the same code ran slower at the F = 5 call and at
// the SDF chunk compiled without bounds or with the thread count alone
constexpr int kInterpThreads = 128;

template <int V>
struct Feat;
template <>
struct Feat<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, T v) { *p = v; }
  __device__ static void axpy(T& acc, T v, float w) { acc += v * w; }
  __device__ static void add(T& acc, T v) { acc += v; }
  __device__ static void add_shared(float* p, T g, float w) { atomicAdd(p, w * g); }
  __device__ static void add_global(float* p, T g, float w) { atomicAdd(p, w * g); }
  __device__ static void flush(float* p, const float* s) {
    if (*s != 0.0f) atomicAdd(p, *s);
  }
};
template <>
struct Feat<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static T load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void store(float* p, T v) { *reinterpret_cast<float4*>(p) = v; }
  __device__ static void axpy(T& acc, T v, float w) {
    acc.x += v.x * w;
    acc.y += v.y * w;
    acc.z += v.z * w;
    acc.w += v.w * w;
  }
  __device__ static void add(T& acc, T v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __device__ static void add_shared(float* p, T g, float w) {
    atomicAdd(p, w * g.x);
    atomicAdd(p + 1, w * g.y);
    atomicAdd(p + 2, w * g.z);
    atomicAdd(p + 3, w * g.w);
  }
  __device__ static void add_global(float* p, T g, float w) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
  }
  __device__ static void flush(float* p, const float* s) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
      atomicAdd(reinterpret_cast<float4*>(p), v);
  }
};

// The 8 corner rows of cell p: two 16-byte loads where the table starts on 16 bytes (a row
// is 32 bytes, so every row then does), else 8 scalar ones.
__device__ __forceinline__ void trinket_row(const int* table, int p, int rows[8]) {
  const int* row = table + 8LL * p;
  if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(row));
    const int4 b = __ldg(reinterpret_cast<const int4*>(row) + 1);
    rows[0] = a.x; rows[1] = a.y; rows[2] = a.z; rows[3] = a.w;
    rows[4] = b.x; rows[5] = b.y; rows[6] = b.z; rows[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) rows[c] = __ldg(row + c);
  }
}

// Where the forward finds a point's cells: the given pidx columns (K15), the point's own
// query (kQuery: K9 folded in) or a ray's point after its sphere step (kRays)
enum Mode { kGivenCells = 0, kQuery = 1, kRays = 2 };

struct FwdArgs {
  const float* coords;        // kGivenCells, kQuery: [N, 3]
  const int* pidx;            // kGivenCells: [N, P], LOD i in column col0 + i
  int P, col0;
  long long N;
  int F, n_lods, sum;
  int query_level;            // kQuery, kRays: the level the point is quantized at
  int group;                  // kRays: lanes a point (a power of two that divides 32)
  float* out;                 // row n at out + n * out_stride: F ('sum') or F * n_lods floats
  long long out_stride;
  int xyz_col;                // kRays: the point's column in the row, or -1
  int* cells;                 // kQuery: the looked-up cells [N, n_lods], or null
  // kRays: the rays, their state (t, alive, hit: updated by the step) and the previous
  // iteration's field, read in column 0 of d (row stride d_stride)
  const float* origins;
  const float* dirs;
  float* t;
  uint8_t* alive;
  uint8_t* hit;
  const float* t_far;
  const float* d;
  long long d_stride;
  const int* free_dist;
  int level, do_step;
  float step_size, min_dis;
};

// kRays: ray r's sphere step (where do_step) and its point; false where the ray is not alive
// after it (its t, alive and hit as sphere_step leaves them)
__device__ __forceinline__ bool ray_point(const FwdArgs& a, long long r, float& px, float& py,
                                          float& pz) {
  if (!a.alive[r]) return false;
  wisp::Walker w;
  w.init(a.origins, a.dirs, r, a.level);
  float t = a.t[r];
  if (a.do_step) {
    if (w.step(a.free_dist, t, __ldg(a.d + r * a.d_stride), a.step_size, a.min_dis)) {
      a.hit[r] = 1;
      a.alive[r] = 0;
      return false;
    }
    a.t[r] = t;
    if (!(t <= a.t_far[r])) {
      a.alive[r] = 0;
      return false;
    }
  }
  w.point(t, px, py, pz);
  return true;
}

template <int V, int MODE>
__global__ void __launch_bounds__(kInterpThreads, 1)
    octree_interp_kernel(const FwdArgs a, const Lods lods) {
  using Fv = Feat<V>;
  const int F = a.F, n_lods = a.n_lods;
  const int group = MODE == kRays ? a.group : F / V;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = tid / group;
  const int f = (int)(tid - n * group) * V;
  float* orow = a.out + n * a.out_stride;
  float x, y, z;
  if (MODE == kRays) {
    // the first lane of a point's group steps its ray and makes the point; the group lies in
    // one warp and takes them by shuffle (every lane of the warp reaches the shuffles)
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    int live = 0;
    if (f == 0 && n < a.N) live = ray_point(a, n, px, py, pz);
    const int src = (threadIdx.x & 31) & ~(group - 1);
    x = __shfl_sync(wisp::kFullMask, px, src);
    y = __shfl_sync(wisp::kFullMask, py, src);
    z = __shfl_sync(wisp::kFullMask, pz, src);
    live = __shfl_sync(wisp::kFullMask, live, src);
    if (n >= a.N || f >= F) return;
    if (!live) {
      // nothing reads the row of a ray that is not alive (its t, alive and hit stay frozen):
      // zeros, no gathers
      const int slots = a.sum ? 1 : n_lods;
      for (int i = 0; i < slots; ++i) Fv::store(orow + (long long)i * F + f, Fv::zero());
      if (a.xyz_col >= 0 && f == 0) {
        orow[a.xyz_col] = 0.0f;
        orow[a.xyz_col + 1] = 0.0f;
        orow[a.xyz_col + 2] = 0.0f;
      }
      return;
    }
  } else {
    if (n >= a.N) return;
    x = __ldg(a.coords + 3 * n);
    y = __ldg(a.coords + 3 * n + 1);
    z = __ldg(a.coords + 3 * n + 2);
  }
  bool inside = true;
  int qx = 0, qy = 0, qz = 0;
  if (MODE != kGivenCells) {
    inside = wisp::in_query_box(x, y, z);
    qx = wisp::quantize(x, a.query_level);
    qy = wisp::quantize(y, a.query_level);
    qz = wisp::quantize(z, a.query_level);
  }
  typename Fv::T acc = Fv::zero();
  // the batches unrolled, so that every LOD slot's index into `lods` is a constant
#pragma unroll
  for (int base = 0; base < kMaxLods; base += kLodBatch) {
    if (base < n_lods) {
      // the batch's first load: each LOD's cell, from pidx or by the lookup of K9's
      // with_parents column (the parent cell q >> (query_level - level) at its level)
      int p[kLodBatch];
#pragma unroll
      for (int j = 0; j < kLodBatch; ++j) {
        const int i = base + j;
        if (i >= n_lods) {
          p[j] = -1;
        } else if (MODE == kGivenCells) {
          p[j] = __ldg(a.pidx + n * a.P + a.col0 + i);
        } else {
          const int s = a.query_level - lods.level[i];
          p[j] = inside ? wisp::lookup_cell(lods.route[i], lods.table[i], lods.len[i],
                                            lods.level[i], qx >> s, qy >> s, qz >> s)
                        : -1;
          if (MODE == kQuery && a.cells != nullptr && f == 0) a.cells[n * n_lods + i] = p[j];
        }
      }
      int rows[kLodBatch][8];
#pragma unroll
      for (int j = 0; j < kLodBatch; ++j) {
        if (p[j] >= 0) trinket_row(lods.trinkets[base + j], p[j], rows[j]);
      }
#pragma unroll
      for (int j = 0; j < kLodBatch; ++j) {
        const int i = base + j;
        if (i < n_lods) {
          typename Fv::T fs = Fv::zero();
          if (p[j] >= 0) {
            float fx, fy, fz;
            cell_frac(x, lods.level[i], fx);
            cell_frac(y, lods.level[i], fy);
            cell_frac(z, lods.level[i], fz);
            const float* feats = lods.feats[i] + f;
            typename Fv::T v[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) v[c] = Fv::load(feats + (long long)rows[j][c] * F);
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float wx = (c & 4) ? fx : 1.0f - fx;
              const float wy = (c & 2) ? fy : 1.0f - fy;
              const float wz = (c & 1) ? fz : 1.0f - fz;
              Fv::axpy(fs, v[c], wx * wy * wz);
            }
          }
          if (a.sum) {
            Fv::add(acc, fs);
          } else {
            Fv::store(orow + (long long)i * F + f, fs);
          }
        }
      }
    }
  }
  if (a.sum) Fv::store(orow + f, acc);
  if (MODE == kRays && a.xyz_col >= 0 && f == 0) {
    orow[a.xyz_col] = x;
    orow[a.xyz_col + 1] = y;
    orow[a.xyz_col + 2] = z;
  }
}

template <int MODE>
cudaError_t launch_fwd(const FwdArgs& a, const Lods& lods, int vec, cudaStream_t stream) {
  const long long threads = a.N * (MODE == kRays ? a.group : a.F / vec);
  if (threads > 0) {
    const int blocks = wisp::ceil_div(threads, kInterpThreads);
    if (vec == 4) {
      octree_interp_kernel<4, MODE><<<blocks, kInterpThreads, 0, stream>>>(a, lods);
    } else {
      octree_interp_kernel<1, MODE><<<blocks, kInterpThreads, 0, stream>>>(a, lods);
    }
  }
  return cudaGetLastError();
}

// The forward's checks of the LODs and the output: n_lods LODs, F features, vec 4 only where
// F % 4 == 0 and every table, the output and its row stride are on 16 bytes
bool fwd_ok(const Lods& lods, int n_lods, int F, int vec, const float* out,
            long long out_stride) {
  if (n_lods < 1 || n_lods > kMaxLods || F < 1 || (vec != 1 && vec != 4) || F % vec)
    return false;
  if (vec == 4) {
    if ((reinterpret_cast<uintptr_t>(out) & 15) || out_stride % 4) return false;
    for (int i = 0; i < n_lods; ++i)
      if (reinterpret_cast<uintptr_t>(lods.feats[i]) & 15) return false;
  }
  return true;
}

// The fused query's checks of each LOD's lookup and level: a route, a search table that is
// not empty, levels at most the query level
bool query_ok(const Lods& lods, int n_lods, int query_level) {
  if (query_level < 0 || query_level >= wisp::kMaxLevels) return false;
  for (int i = 0; i < n_lods; ++i) {
    const int r = lods.route[i];
    if (r < wisp::kMap || r > wisp::kBitfield || (r == wisp::kSearch && lods.len[i] < 1) ||
        lods.level[i] < 0 || lods.level[i] > query_level)
      return false;
  }
  return true;
}

struct LodGrads {
  const int* trinkets[kMaxLods];
  float* grads[kMaxLods];
  int level[kMaxLods];
  int lod[kMaxLods];           // the LOD that blockIdx.y works in this launch
  int shared_rows[kMaxLods];   // its rows where it is summed in shared memory, else 0
};

// The backward's launch. Where no LOD is summed in shared memory: blocks of 128 threads,
// about 16 on each of 132 SMs over all the LODs, each looping over its items. Where some are
// (the LODs that the wrapper's bwd_shared_lods picks: hot, and small enough for a
// block-private copy of up to kBwdSharedBytes): one launch of blocks of 1024 threads, two
// on each SM, the shared LODs' blocks first, so that an SM's two blocks tend to be one of
// each and the shared adds (bound by the SM) overlap the direct ones (bound by L2).
constexpr int kBwdThreads = 128;
constexpr int kBwdBlocks = 2112;
constexpr int kBwdSharedThreads = 1024;
constexpr int kBwdSharedBlocks = 264;
constexpr int kBwdSharedBytes = 112 * 1024;

template <int V>
__global__ void __launch_bounds__(kBwdSharedThreads)
    octree_interp_bwd_kernel(const float* __restrict__ coords, const int* __restrict__ pidx,
                             long long N, int P, int col0, int n_lods, int F, LodGrads lods,
                             int sum, const float* __restrict__ grad_out) {
  extern __shared__ __align__(16) float table_s[];
  using Fv = Feat<V>;
  const int lod = lods.lod[blockIdx.y];
  const int lanes = F / V;
  const long long items = N * lanes;
  const int level = lods.level[blockIdx.y];
  const int* __restrict__ trinkets = lods.trinkets[blockIdx.y];
  float* __restrict__ grad = lods.grads[blockIdx.y];
  const int n_s = lods.shared_rows[blockIdx.y] * F;   // > 0: summed in shared memory first
  for (int i = threadIdx.x; i < n_s; i += blockDim.x) table_s[i] = 0.0f;
  if (n_s > 0) __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
       it += stride) {
    const long long n = it / lanes;
    const int f = (int)(it - n * lanes) * V;
    const int p = __ldg(pidx + n * P + col0 + lod);
    if (p < 0) continue;
    const typename Fv::T g = Fv::load(
        grad_out + (sum ? n * F : n * (long long)F * n_lods + (long long)lod * F) + f);
    int rows[8];
    trinket_row(trinkets, p, rows);
    float fx, fy, fz;
    cell_frac(__ldg(coords + 3 * n), level, fx);
    cell_frac(__ldg(coords + 3 * n + 1), level, fy);
    cell_frac(__ldg(coords + 3 * n + 2), level, fz);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wx = (c & 4) ? fx : 1.0f - fx;
      const float wy = (c & 2) ? fy : 1.0f - fy;
      const float wz = (c & 1) ? fz : 1.0f - fz;
      const float w = wx * wy * wz;
      const long long at = (long long)rows[c] * F + f;
      if (n_s > 0) Fv::add_shared(table_s + at, g, w);
      else Fv::add_global(grad + at, g, w);
    }
  }
  if (n_s > 0) {
    __syncthreads();
    for (int i = threadIdx.x * V; i < n_s; i += blockDim.x * V) Fv::flush(grad + i, table_s + i);
  }
}

template <int V>
cudaError_t launch_bwd(const float* coords, const int* pidx, long long N, int P, int col0,
                       int n_lods, int F, const LodGrads& lods, int smem, int sum,
                       const float* grad_out, cudaStream_t stream) {
  const bool shared = smem > 0;
  const int threads = shared ? kBwdSharedThreads : kBwdThreads;
  const int per_lod = max(1, (shared ? kBwdSharedBlocks : kBwdBlocks) / n_lods);
  const long long items = N * (long long)(F / V);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        octree_interp_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)min((long long)per_lod, (items + threads - 1) / threads), n_lods);
  octree_interp_bwd_kernel<V><<<grid, threads, smem, stream>>>(coords, pidx, N, P, col0,
                                                               n_lods, F, lods, sum, grad_out);
  return cudaGetLastError();
}

}  // namespace

// K15 at given cells. lods_host: the host's Lods (the LODs' tables and levels; its lookups
// are not read). vec: features a lane, 4 (F % 4 == 0 and every feats[i] and out on 16 bytes)
// or 1.
WISP_EXPORT int wisp_octree_interp(const float* coords, const int* pidx, long long N, int P,
                                   int col0, int n_lods, int F, const void* lods_host, int sum,
                                   int vec, float* out, void* stream) {
  const Lods& lods = *static_cast<const Lods*>(lods_host);
  FwdArgs a = {};
  a.coords = coords;
  a.pidx = pidx;
  a.P = P;
  a.col0 = col0;
  a.N = N;
  a.F = F;
  a.n_lods = n_lods;
  a.sum = sum;
  a.out = out;
  a.out_stride = sum ? F : (long long)F * n_lods;
  if (!fwd_ok(lods, n_lods, F, vec, out, a.out_stride)) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<kGivenCells>(a, lods, vec, (cudaStream_t)stream);
}

// The octree query folded into K15 (octree_query_interp). lods_host: the host's Lods (the
// LODs' tables, levels and lookups); the point is quantized at query_level, and LOD i's
// cell is K9's with_parents column lods.level[i]. out: [N, F] ('sum') or [N, F * n_lods]; cells:
// [N, n_lods] int32, or null.
WISP_EXPORT int wisp_octree_query_interp(const float* coords, long long N, int query_level,
                                         int n_lods, int F, const void* lods_host, int sum,
                                         int vec, float* out, int* cells, void* stream) {
  const Lods& lods = *static_cast<const Lods*>(lods_host);
  FwdArgs a = {};
  a.coords = coords;
  a.N = N;
  a.F = F;
  a.n_lods = n_lods;
  a.sum = sum;
  a.query_level = query_level;
  a.out = out;
  a.out_stride = sum ? F : (long long)F * n_lods;
  a.cells = cells;
  if (!fwd_ok(lods, n_lods, F, vec, out, a.out_stride) || !query_ok(lods, n_lods, query_level))
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<kQuery>(a, lods, vec, (cudaStream_t)stream);
}

// K12's step folded in front of the query and interpolation (sphere_iter): per ray, where
// do_step, one sphere_step on t, alive and hit given column 0 of d (row stride d_stride);
// then, for a ray still alive, the features at o + t*d into row r of out (row stride
// out_stride) and, where xyz_col >= 0, the point at columns xyz_col..xyz_col + 2; a ray that
// is not alive gets a row of zeros. free_dist and level: the max level's free-space field.
// group: a ray's lanes, the host's (octree_grid.py ray_lanes): a power of two of at most 32
// with group * vec >= F.
WISP_EXPORT int wisp_sphere_iter(const float* origins, const float* dirs, float* t,
                                 uint8_t* alive, uint8_t* hit, const float* t_far,
                                 const float* d, long long d_stride, const int* free_dist,
                                 long long N, int level, float step_size, float min_dis,
                                 int do_step, int query_level, int n_lods, int F,
                                 const void* lods_host, int sum, int vec, int group,
                                 float* out, long long out_stride, int xyz_col,
                                 void* stream) {
  const Lods& lods = *static_cast<const Lods*>(lods_host);
  FwdArgs a = {};
  a.N = N;
  a.F = F;
  a.n_lods = n_lods;
  a.sum = sum;
  a.query_level = query_level;
  a.out = out;
  a.out_stride = out_stride;
  a.xyz_col = xyz_col;
  a.origins = origins;
  a.dirs = dirs;
  a.t = t;
  a.alive = alive;
  a.hit = hit;
  a.t_far = t_far;
  a.d = d;
  a.d_stride = d_stride;
  a.free_dist = free_dist;
  a.level = level;
  a.do_step = do_step;
  a.step_size = step_size;
  a.min_dis = min_dis;
  a.group = group;
  const long long width = sum ? F : (long long)F * n_lods;
  if (!fwd_ok(lods, n_lods, F, vec, out, out_stride) || !query_ok(lods, n_lods, query_level)
      || group < 1 || group > 32 || (group & (group - 1)) || (long long)group * vec < F
      || level < 0 || level >= wisp::kMaxLevels
      || (do_step && (d == nullptr || d_stride < 1))
      || out_stride < width + (xyz_col >= 0 ? 3 : 0)
      || (xyz_col >= 0 && xyz_col != width))
    return (int)cudaErrorInvalidValue;
  return (int)launch_fwd<kRays>(a, lods, vec, (cudaStream_t)stream);
}

// trinkets, grads: host arrays of n_lods device pointers (grads zero-filled by the caller);
// levels: host array of n_lods ints; shared_rows: host array of n_lods ints, a LOD's table
// rows where it is summed in shared memory first, else 0 (at most kBwdSharedBytes in all
// of one table). grad_out is [N, F] ('sum') or [N, F * n_lods]. vec: features a lane, 4 (F
// % 4 == 0 and every grads[i] and grad_out on 16 bytes) or 1.
WISP_EXPORT int wisp_octree_interp_bwd(const float* coords, const int* pidx, long long N,
                                       int P, int col0, int n_lods, int F,
                                       const int* const* trinkets, float* const* grads,
                                       const int* levels, const int* shared_rows, int sum,
                                       int vec, const float* grad_out, void* stream) {
  if (n_lods < 1 || n_lods > kMaxLods || F < 1 || (vec != 1 && vec != 4) || F % vec
      || (vec == 4 && (reinterpret_cast<uintptr_t>(grad_out) & 15)))
    return (int)cudaErrorInvalidValue;
  // the launch's LOD slots: the shared LODs first
  LodGrads lods = {};
  long long smem = 0;
  int k = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < n_lods; ++i) {
      if (vec == 4 && (reinterpret_cast<uintptr_t>(grads[i]) & 15))
        return (int)cudaErrorInvalidValue;
      const int rows = shared_rows != nullptr ? shared_rows[i] : 0;
      if ((rows > 0) != (pass == 0)) continue;
      lods.trinkets[k] = trinkets[i];
      lods.grads[k] = grads[i];
      lods.level[k] = levels[i];
      lods.lod[k] = i;
      lods.shared_rows[k++] = rows;
      smem = max(smem, (long long)rows * F * (long long)sizeof(float));
    }
  }
  if (smem > kBwdSharedBytes) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      vec == 4 ? launch_bwd<4>(coords, pidx, N, P, col0, n_lods, F, lods, (int)smem, sum,
                               grad_out, s)
               : launch_bwd<1>(coords, pidx, N, P, col0, n_lods, F, lods, (int)smem, sum,
                               grad_out, s);
  return (int)e;
}
