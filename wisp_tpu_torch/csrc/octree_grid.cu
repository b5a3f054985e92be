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

template <int V>
__global__ void __launch_bounds__(kInterpThreads, 1)
    octree_interp_kernel(const float* __restrict__ coords, const int* __restrict__ pidx,
                         long long N, int P, int col0, int n_lods, int F, Lods lods, int sum,
                         float* __restrict__ out) {
  using Fv = Feat<V>;
  const int lanes = F / V;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * lanes) return;
  const long long n = tid / lanes;
  const int f = (int)(tid - n * lanes) * V;
  const float x = __ldg(coords + 3 * n), y = __ldg(coords + 3 * n + 1),
              z = __ldg(coords + 3 * n + 2);
  const int* prow = pidx + n * P + col0;
  typename Fv::T acc = Fv::zero();
  // the batches unrolled, so that every LOD slot's index into `lods` is a constant
#pragma unroll
  for (int base = 0; base < kMaxLods; base += kLodBatch) {
    if (base < n_lods) {
      int p[kLodBatch];
#pragma unroll
      for (int j = 0; j < kLodBatch; ++j)
        p[j] = base + j < n_lods ? __ldg(prow + base + j) : -1;
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
          if (sum) {
            Fv::add(acc, fs);
          } else {
            Fv::store(out + n * (long long)F * n_lods + (long long)i * F + f, fs);
          }
        }
      }
    }
  }
  if (sum) Fv::store(out + n * F + f, acc);
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

// trinkets, feats: host arrays of n_lods device pointers; levels: host array of n_lods ints.
// vec: features a lane, 4 (F % 4 == 0 and every feats[i] and out on 16 bytes) or 1.
WISP_EXPORT int wisp_octree_interp(const float* coords, const int* pidx, long long N, int P,
                                   int col0, int n_lods, int F, const int* const* trinkets,
                                   const float* const* feats, const int* levels, int sum,
                                   int vec, float* out, void* stream) {
  if (n_lods < 1 || n_lods > kMaxLods || F < 1 || (vec != 1 && vec != 4) || F % vec)
    return (int)cudaErrorInvalidValue;
  Lods lods = {};
  for (int i = 0; i < n_lods; ++i) {
    if (vec == 4 && (reinterpret_cast<uintptr_t>(feats[i]) & 15))
      return (int)cudaErrorInvalidValue;
    lods.trinkets[i] = trinkets[i];
    lods.feats[i] = feats[i];
    lods.level[i] = levels[i];
  }
  if (vec == 4 && (reinterpret_cast<uintptr_t>(out) & 15)) return (int)cudaErrorInvalidValue;
  const long long total = N * (long long)(F / vec);
  if (total > 0) {
    const int blocks = wisp::ceil_div(total, kInterpThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (vec == 4) {
      octree_interp_kernel<4><<<blocks, kInterpThreads, 0, s>>>(coords, pidx, N, P, col0,
                                                               n_lods, F, lods, sum, out);
    } else {
      octree_interp_kernel<1><<<blocks, kInterpThreads, 0, s>>>(coords, pidx, N, P, col0,
                                                               n_lods, F, lods, sum, out);
    }
  }
  return (int)cudaGetLastError();
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
