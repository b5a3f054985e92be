// K1 (forward) — multi-resolution hash-grid interpolation.
//
// Replaces the forward of wisp_tpu/ops/grid.py hashgrid (:335) -> _hashgrid_impl (:301)
// -> _lod_features (:143) with gather_rows (:37). Per LOD: x = clip((c+1)*(res/2), 0,
// res-1-1e-5) per axis, the 2^d cell corners (corner bit k toggles axis d-1-k), their
// table rows (dense row-major index x + y*res + z*res^2 when res^d fits the table, else the
// uint32 hash x*1 ^ y*2654435761 ^ z*805459861 mod 2^bitwidth), and the tri/bilinear blend.
// The output is [N, out_lods*F], features fastest; LODs at or above n_lods are written as
// zeros (the tracer's LOD truncation and the 'cat' LOD quirk). Every product and sum is
// rounded as the plain version rounds it (corner order, no fused multiply-add), so the
// cells and corners agree exactly and the features to float32 rounding.
//
// Bound on this card: the compulsory bytes are coords in and features out (at the
// flagship, 128 B of output a sample), but each (sample, LOD) gathers 2^d rows at hashed
// addresses of a 42 MB table, so the gathers' L1 wavefronts (one a distinct 128-byte line
// that a warp's load touches) and L2 sectors set the time. Design: one thread a sample,
// looping over the LODs, so a warp works on one LOD at a time: its 32 samples take the
// same dense or hash branch (no divergence), and where neighbouring samples are close in
// space (a render chunk's step-major samples are neighbouring pixels at one step) their
// corner rows fall in the same lines and one wavefront serves many lanes. No division or
// modulo: the sample is the thread, the hash's modulo is a mask by 2^bitwidth - 1, and row
// indices are 32-bit. With F = 2, the x-neighbour corners whose rows are the two halves of
// one aligned 16-byte pair (a dense LOD's x, x+1 at an even row; a hashed LOD's even x,
// whose rows differ in bit 0 only) are read with one 16-byte load. Each thread writes its
// output row into a shared-memory tile; the block then stores the tile one row a warp,
// coalesced, evict-first (the output is not read again by this kernel, and the table
// should stay in L2). A short call (under 32,768 samples), where one thread's chain of
// LODs would set the time, takes one thread a (sample, LOD) instead, a sample's LODs on
// consecutive threads (one 32-bit division a thread).
//
// K1 (backward) — the exact table gradient, replacing wisp_tpu/ops/grid.py
// _gather_rows_bwd (:55), the scatter-add of w*g into the 2^d corner rows of every
// (sample, LOD). Coords get no gradient (they are not parameters). Bound on this card:
// bytes, the coords and the cotangent read once and the whole [T, F] table gradient
// written (the wrapper zero-fills it; 41.7 MB at the flagship); the time is set by the
// atomics, a read-modify-write in L2 for every (sample, LOD, corner). Design: one thread
// a sample, looping over the LODs, with the same corners and weights as the forward.
// - The coarse dense LODs take many samples a row (the flagship's res-16 LOD: ~255 corner
//   updates a row a step), so their atomics contend in L2. The leading LODs that
//   ops/grid.py shared_lods picks (n_shared, a prefix of dense LODs whose rows fit its
//   budget of a block's shared memory) are privatized: the grid is persistent (as many
//   blocks as are resident at once, each over a contiguous range of samples), each block
//   accumulates those LODs in shared memory with shared atomics and adds its copy's
//   non-zero rows to the gradient once at the end, one vector atomic a row, consecutive
//   threads on consecutive rows. A float atomicAdd to shared memory is a compare-and-swap
//   loop on sm_90, and a large copy leaves few blocks resident, so the budget is small
//   (LOD 0 at the flagship; PERF.md, section 6).
// - The other LODs make one vector atomicAdd a corner row (float2 at F = 2, float4 at
//   F = 4, two at F = 8; native on sm_90) in place of F scalar ones, and at F = 2 the
//   x-neighbour rows that are one aligned 16-byte pair (as in the forward) take one float4
//   atomic for both. The time is then set by the L2's atomic operations, whatever their
//   width.
// - A short call (under 65,536 samples) spreads each sample's LODs over several threads
//   and privatizes none.
// The summation order changes from run to run, so the result matches the plain version to
// float32 rounding, not bit for bit.
//
// K1 (stochastic backward) — replaces wisp_tpu/ops/grid.py interp_rows_stoch (:66) with
// its backward _irs_bwd (:94), the corner draw of _lod_features (:182-191), the per-sample
// uniforms of _hashgrid_impl (:309-317) and _fold_u (:295). On a LOD flagged stochastic the
// whole cotangent row g of a (sample, LOD) goes to ONE corner, drawn with probability equal
// to its trilinear weight: u0 = frac(|sin(12.9898x + 78.233y + 37.719z)| * 43758.5453) (or
// the caller's u0), u = frac(u0 + 0.61803398875 (l+1)), the weights' running sum wcum in
// corner order, chosen = #{c : wcum[c] < u * wcum[last]}, clamped. That is one row update
// a (sample, LOD) against the exact backward's 2^d. LODs not flagged take the exact branch
// above, so one launch covers the mixed LOD set of JAX's dense_lod_matmul rule. The entry
// point is the exact backward's: a null flag array selects the template instantiation
// without the draw, which keeps the exact kernel's code. Privatized LODs take their draws
// in shared memory too. CUDA's sinf is not XLA's or torch's sin on the CPU, and the hash
// multiplies the phase's last bits by 4e4, so the drawn corners agree across
// implementations only through an injected u0; the in-kernel hash is held statistically
// (uniform, unbiased).
//
// The earlier design (one thread a (sample, LOD), scalar atomics) is kept in
// baselines/hashgrid_v1.cu as the yardstick.
//
// K14 — the raw corner-feature query, hashgrid_query.
//
// Replaces wisp_tpu/ops/grid.py hashgrid_query (:369-390): for every point and LOD 0..lod
// the feature rows of the 2^d cell corners, no blend: [N, L, 2^d, F], any F >= 1. JAX's
// body, not K1's: x = clip((c + 1) / 2 * res, 0, res-1-1e-5) per axis (K1 scales by res/2
// instead), the corners floor(x) + _corner_offsets, their rows by hash_index (the same dense
// row-major index or uint32 hash as K1) into the LOD's slice of the table; a row at or past
// the slice's end reads NaN, as jnp.take's default fill mode does (a dense LOD whose clip
// rounds up to res-1 in float32). Bound on this card: bytes, the [N, L, 2^d, F] output (1 KB
// a point at the flagship's 16 LODs, F 2: 5 GB at a uniform render chunk's kept samples)
// and the rows read. Design: a block takes 32 points, one a lane, and a group of LODs, one
// a warp at a time (a loop), so a lane computes its point's (c + 1) / 2 once and each
// (point, LOD) cell once, in 32-bit arithmetic with no division; a warp's 32 points share
// one LOD (one dense or hash branch, per-LOD constants from the argument block), and where
// neighbouring points are close in space (a render chunk's step-major samples) their corner
// rows fall in the same lines. A lane issues its 2^d row loads (vectors for F in 1, 2, 4, 8;
// scalars for any other F; an L2 evict-last policy) before it writes them, as 16-byte
// chunks, into the block's staging tile in shared memory (each point's run of LODs padded
// to 128-byte lines, a chunk's place in its line XORed with the point so that neither the
// writes nor the reads conflict); the block then writes the tile one point's contiguous run
// a warp, 16-byte streaming stores (st.global.cs, evict-first: the output is not read again
// here, and the table should stay in L2). A group holds as many LODs as fit the staging
// budget; a (point, LOD) wider than the budget (F > 48 in 3D) is written straight from its
// lane.
// The earlier design (one thread a (point, LOD, corner)) is kept in
// baselines/hashgrid_query_v1.cu as the yardstick.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxLods = 32;
constexpr int kBwdThreads = 512;
constexpr int kSharedBytesMax = 232448;   // a block's shared memory on sm_90 (227 KB)
// A short call is not to be bound by one thread's chain of LODs. Below kShortFwd samples the
// forward takes one thread a (sample, output LOD), a sample's LODs on consecutive threads so
// that a warp's stores are contiguous. Below kSpreadBwd samples the backward gives each
// sample G = ceil(kSpreadBwd / N) threads (at most one a LOD; gridDim.y = G), each over every
// G-th LOD, and privatizes no LOD.
constexpr int kShortFwd = 32768;
constexpr int kSpreadBwd = 65536;

// the backward's LOD groups over N samples
inline int lod_groups(int N, int n_lods) {
  return N >= kSpreadBwd ? 1 : std::min(n_lods, (kSpreadBwd + N - 1) / N);
}

struct LodTable {
  int n_lods;                    // LODs computed
  int out_lods;                  // LODs in the output row (the rest are zeros)
  int res[kMaxLods];
  float scale[kMaxLods];         // res / 2
  float hi[kMaxLods];            // res - 1 - 1e-5
  unsigned begin[kMaxLods];      // first table row of the LOD
  int dense[kMaxLods];           // 1: row-major index, 0: spatial hash
  unsigned hash_mask;            // 2^bitwidth - 1
  int n_shared;                  // backward: LODs 0..n_shared-1 accumulate in shared memory
  unsigned sbegin[kMaxLods + 1]; // ... LOD l from shared row sbegin[l]; sbegin[n_shared] rows
};

// one LOD's cell: the terms of the row index at the cell's low and high corner along
// each axis, and the fractions; ``dense`` is the LOD's branch, uniform across a warp (a
// literal at most call sites, which the compiler folds)
template <int D>
struct Cell {
  unsigned lo[D], up[D];
  float frac[D], omf[D];     // frac and 1 - frac
};

template <int D>
__device__ __forceinline__ Cell<D> lod_cell(const float (&c)[D], int l, const LodTable& t,
                                            bool dense) {
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  const unsigned res = (unsigned)t.res[l];
  Cell<D> cell;
  unsigned stride = 1u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float x = (c[d] + 1.0f) * t.scale[l];
    x = fminf(fmaxf(x, 0.0f), t.hi[l]);
    const float fl = floorf(x);
    const unsigned c0 = (unsigned)(int)fl;
    cell.frac[d] = x - fl;
    cell.omf[d] = 1.0f - cell.frac[d];
    if (dense) {
      cell.lo[d] = c0 * stride;
      cell.up[d] = (c0 + 1u) * stride;
      stride *= res;
    } else {
      cell.lo[d] = c0 * primes[d];
      cell.up[d] = (c0 + 1u) * primes[d];
    }
  }
  return cell;
}

// corner k's table row (k may be a runtime value: no array is indexed by it)
template <int D>
__device__ __forceinline__ unsigned corner_row(const Cell<D>& cell, int k, int l,
                                               const LodTable& t, bool dense) {
  unsigned idx = 0u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const unsigned term = (k >> (D - 1 - d)) & 1 ? cell.up[d] : cell.lo[d];
    idx = d == 0 ? term : (dense ? idx + term : idx ^ term);
  }
  return t.begin[l] + (dense ? idx : (idx & t.hash_mask));
}

// corner k's weight, the axes' factors multiplied in axis order
template <int D>
__device__ __forceinline__ float corner_weight(const Cell<D>& cell, int k) {
  float w = 1.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float wd = (k >> (D - 1 - d)) & 1 ? cell.frac[d] : cell.omf[d];
    w = d == 0 ? wd : w * wd;
  }
  return w;
}

// one LOD's corner rows and weights, in corner order and the plain version's float order
template <int D>
__device__ __forceinline__ void lod_corners(const float (&c)[D], int l, const LodTable& t,
                                            bool dense, unsigned (&row)[1 << D],
                                            float (&w)[1 << D]) {
  const Cell<D> cell = lod_cell<D>(c, l, t, dense);
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    row[k] = corner_row<D>(cell, k, l, t, dense);
    w[k] = corner_weight<D>(cell, k);
  }
}

template <int F>
__device__ __forceinline__ void gather_row(const float* __restrict__ table, unsigned r,
                                         float (&v)[F]) {
  if constexpr (F == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(table) + r);
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (F == 4 || F == 8) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(table) + (size_t)r * (F / 4) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
    v[0] = __ldg(table + r);
  }
}

// the 2^d corner rows; at F = 2 an x-neighbour pair that is one aligned 16-byte pair of
// rows (rows 2k and 2k+1) is read with one load
template <int D, int F>
__device__ __forceinline__ void load_corners(const float* __restrict__ table,
                                             const unsigned (&row)[1 << D],
                                             float (&v)[1 << D][F]) {
  constexpr int X = 1 << (D - 1);   // the corner bit of the x axis
#pragma unroll
  for (int k = 0; k < X; ++k) {
    const unsigned a = row[k], b = row[k | X];
    if constexpr (F == 2) {
      if ((a ^ b) == 1u) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(table) + (a >> 1));
        const bool odd = a & 1u;
        v[k][0] = odd ? q.z : q.x;
        v[k][1] = odd ? q.w : q.y;
        v[k | X][0] = odd ? q.x : q.z;
        v[k | X][1] = odd ? q.y : q.w;
        continue;
      }
    }
    gather_row<F>(table, a, v[k]);
    gather_row<F>(table, b, v[k | X]);
  }
}

template <int D, int F>
__device__ __forceinline__ void lod_features(const float (&c)[D], int l, const LodTable& t,
                                             bool dense, const float* __restrict__ table,
                                             float* o) {
  unsigned row[1 << D];
  float w[1 << D];
  lod_corners<D>(c, l, t, dense, row, w);
  float v[1 << D][F];
  load_corners<D, F>(table, row, v);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += v[k][f] * w[k];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = acc[f];
}

// one thread a sample; the block's output rows go through a shared tile of blockDim.x rows
// of width + 1 floats (the odd pitch keeps a warp's stores to it on distinct banks)
template <int D, int F>
__global__ void __launch_bounds__(128) hashgrid_fwd_kernel(const float* __restrict__ coords,
                                                           const float* __restrict__ table,
                                                           int N,
                                                           const __grid_constant__ LodTable t,
                                                           float* __restrict__ out) {
  extern __shared__ float tile[];
  const int width = t.out_lods * F;
  const int pitch = width + 1;
  const int n0 = blockIdx.x * blockDim.x;
  const int n = n0 + (int)threadIdx.x;
  if (n < N) {
    float c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = coords[(size_t)n * D + d];
    float* my = tile + threadIdx.x * pitch;
    for (int l = 0; l < t.n_lods; ++l) {
      if (t.dense[l]) {
        lod_features<D, F>(c, l, t, true, table, my + l * F);
      } else {
        lod_features<D, F>(c, l, t, false, table, my + l * F);
      }
    }
    for (int j = t.n_lods * F; j < width; ++j) my[j] = 0.0f;
  }
  __syncthreads();
  const int rows = min((int)blockDim.x, N - n0);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float* o = out + (size_t)(n0 + r) * width;
    const float* s = tile + r * pitch;
    for (int j = lane; j < width; j += 32) {
      __stcs(o + j, s[j]);
    }
  }
}

// a short call (N < kShortFwd): one thread a (sample, output LOD), LOD fastest
template <int D, int F>
__global__ void __launch_bounds__(256) hashgrid_fwd_short_kernel(
    const float* __restrict__ coords, const float* __restrict__ table, int N,
    const __grid_constant__ LodTable t, float* __restrict__ out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * t.out_lods) return;
  const int n = tid / t.out_lods;
  const int l = tid - n * t.out_lods;
  float* o = out + (size_t)tid * F;
  if (l >= t.n_lods) {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = 0.0f;
    return;
  }
  float c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = coords[(size_t)n * D + d];
  if (t.dense[l]) {
    lod_features<D, F>(c, l, t, true, table, o);
  } else {
    lod_features<D, F>(c, l, t, false, table, o);
  }
}

// per-LOD flags of the stochastic backward: stoch[l] != 0 draws one corner, ushift[l] is
// float32(0.61803398875 * (l + 1)), the golden-ratio shift of _fold_u as JAX rounds it
struct StochTable {
  int stoch[kMaxLods];
  float ushift[kMaxLods];
};

// the per-sample uniform of _hashgrid_impl: phase summed left to right, no fused multiply-add
template <int D>
__device__ __forceinline__ float sin_hash_u0(const float (&c)[D]) {
  float phase = c[0] * 12.9898f + c[1] * 78.233f;
  if constexpr (D == 3) phase = phase + c[2] * 37.719f;
  const float u = fabsf(sinf(phase)) * 43758.5453f;
  return u - floorf(u);
}

// the F floats of table row r += v
template <int F>
__device__ __forceinline__ void add_row_global(float* __restrict__ grad, unsigned r,
                                               const float (&v)[F]) {
  float* p = grad + (size_t)r * F;
  if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else if constexpr (F == 4 || F == 8) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(p) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// LOD l's row r (a table row) += v: in the block's shared copy when the LOD is privatized
template <int F>
__device__ __forceinline__ void add_row(float* priv, float* __restrict__ grad, int l,
                                        const LodTable& t, unsigned r, const float (&v)[F]) {
  if (l < t.n_shared) {
    float* p = priv + (size_t)(r - t.begin[l] + t.sbegin[l]) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(p + f, v[f]);
  } else {
    add_row_global<F>(grad, r, v);
  }
}

template <int D, int F, bool STOCH>
__device__ __forceinline__ void lod_backward(const float (&c)[D], int l, const LodTable& t,
                                             bool dense, const StochTable& s, float u0,
                                             const float (&g)[F], float* priv,
                                             float* __restrict__ grad) {
  constexpr int C = 1 << D;
  const Cell<D> cell = lod_cell<D>(c, l, t, dense);
  if (STOCH && s.stoch[l]) {
    float w[C];
#pragma unroll
    for (int k = 0; k < C; ++k) w[k] = corner_weight<D>(cell, k);
    // the running weight sum in corner order, twice (its total first)
    float total = w[0];
#pragma unroll
    for (int k = 1; k < C; ++k) total = total + w[k];
    float u = u0 + s.ushift[l];
    u = u - floorf(u);
    const float target = u * total;
    int chosen = 0;
    float wcum = 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      wcum = k == 0 ? w[0] : wcum + w[k];
      chosen += wcum < target ? 1 : 0;
    }
    add_row<F>(priv, grad, l, t, corner_row<D>(cell, min(chosen, C - 1), l, t, dense), g);
    return;
  }
  constexpr int X = 1 << (D - 1);   // the corner bit of the x axis
#pragma unroll
  for (int k = 0; k < X; ++k) {
    const unsigned a = corner_row<D>(cell, k, l, t, dense);
    const unsigned b = corner_row<D>(cell, k | X, l, t, dense);
    float va[F], vb[F];
    const float wa = corner_weight<D>(cell, k), wb = corner_weight<D>(cell, k | X);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      va[f] = g[f] * wa;
      vb[f] = g[f] * wb;
    }
    if constexpr (F == 2) {
      // x-neighbour rows that are one aligned 16-byte pair: one float4 atomic for both
      if (l >= t.n_shared && (a ^ b) == 1u) {
        const bool odd = a & 1u;
        atomicAdd(reinterpret_cast<float4*>(grad) + (a >> 1),
                  odd ? make_float4(vb[0], vb[1], va[0], va[1])
                      : make_float4(va[0], va[1], vb[0], vb[1]));
        continue;
      }
    }
    add_row<F>(priv, grad, l, t, a, va);
    add_row<F>(priv, grad, l, t, b, vb);
  }
}

// STOCH false: the exact backward. STOCH true: LODs flagged in ``s`` draw one corner from
// u0_in (or the sin hash when it is null); u0_out, when given, receives each sample's u0.
// Block (b, g) takes samples [b * per_block, (b + 1) * per_block), one thread a sample,
// and LODs g, g + gridDim.y, ...
template <int D, int F, bool STOCH>
__global__ void __launch_bounds__(kBwdThreads) hashgrid_bwd_kernel(
    const float* __restrict__ coords, const float* __restrict__ grad_out,
    const float* __restrict__ u0_in, float* __restrict__ u0_out, int N, int per_block,
    const __grid_constant__ LodTable t, const __grid_constant__ StochTable s,
    float* __restrict__ grad_table) {
  extern __shared__ float4 priv4[];
  float* priv = reinterpret_cast<float*>(priv4);
  if (t.n_shared > 0) {
    const int n4 = ((int)t.sbegin[t.n_shared] * F + 3) / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) priv4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  const int width = t.out_lods * F;
  const long long first = (long long)blockIdx.x * per_block;
  const int last = (int)min((long long)N, first + per_block);
  for (int n = (int)first + (int)threadIdx.x; n < last; n += blockDim.x) {
    float c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = coords[(size_t)n * D + d];
    float u0 = 0.0f;
    if (STOCH) {
      if (u0_in != nullptr) {
        u0 = u0_in[n];
      } else {
        u0 = sin_hash_u0<D>(c);
        if (u0_out != nullptr && blockIdx.y == 0) u0_out[n] = u0;
      }
    }
    const float* g = grad_out + (size_t)n * width;
    for (int l = blockIdx.y; l < t.n_lods; l += gridDim.y) {
      float gv[F];
      bool any = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        gv[f] = g[l * F + f];
        any = any || gv[f] != 0.0f;
      }
      if (!any) continue;   // a zero cotangent adds nothing
      if (t.dense[l]) {
        lod_backward<D, F, STOCH>(c, l, t, true, s, u0, gv, priv, grad_table);
      } else {
        lod_backward<D, F, STOCH>(c, l, t, false, s, u0, gv, priv, grad_table);
      }
    }
  }
  if (t.n_shared > 0) {
    __syncthreads();
    for (int l = 0; l < t.n_shared; ++l) {
      const unsigned s0 = t.sbegin[l], s1 = t.sbegin[l + 1];
      for (unsigned r = s0 + threadIdx.x; r < s1; r += blockDim.x) {
        float v[F];
        bool any = false;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          v[f] = priv[(size_t)r * F + f];
          any = any || v[f] != 0.0f;
        }
        if (any) add_row_global<F>(grad_table, t.begin[l] + (r - s0), v);
      }
    }
  }
}

template <int D, int F>
cudaError_t launch_fwd(const float* coords, const float* table, int N, const LodTable& t,
                       float* out, cudaStream_t st) {
  if (N == 0) return cudaGetLastError();
  const int width = t.out_lods * F;
  // the tile (threads x (width + 1) floats) stays within the 48 KB of static shared memory
  if (N < kShortFwd) {
    hashgrid_fwd_short_kernel<D, F><<<wisp::ceil_div((long long)N * t.out_lods, 256), 256, 0,
                                      st>>>(coords, table, N, t, out);
    return cudaGetLastError();
  }
  const int threads = width <= 95 ? 128 : width <= 191 ? 64 : 32;
  const size_t smem = (size_t)threads * (width + 1) * sizeof(float);
  hashgrid_fwd_kernel<D, F><<<wisp::ceil_div(N, threads), threads, smem, st>>>(coords, table,
                                                                            N, t, out);
  return cudaGetLastError();
}

// the SMs of the current device, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <int D, int F, bool STOCH>
cudaError_t launch_bwd(const float* coords, const float* grad_out, const float* u0_in,
                       float* u0_out, int N, LodTable t, const StochTable& s,
                       float* grad_table, cudaStream_t st) {
  if (N == 0) return cudaGetLastError();
  auto kernel = hashgrid_bwd_kernel<D, F, STOCH>;
  const int groups = lod_groups(N, t.n_lods);
  if (groups > 1) t.n_shared = 0;
  const int smem = ((int)t.sbegin[t.n_shared] * F * (int)sizeof(float) + 15) / 16 * 16;
  int blocks = wisp::ceil_div(N, kBwdThreads);
  if (t.n_shared > 0) {
    // persistent: as many blocks as are resident at once, so that each block's shared copy
    // gathers as many samples as it can before it is added to the gradient. The occupancy
    // of the last shared size is kept, so a train run asks the runtime once.
    static int last_smem = -1, last_per_sm = 0;
    if (smem != last_smem) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
      if (e != cudaSuccess) return e;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      last_smem = smem;
      last_per_sm = per_sm;
    }
    const int resident = last_per_sm * sm_count();
    if (resident < 1) return cudaErrorInvalidConfiguration;
    blocks = std::min(blocks, resident);
  }
  const int per_block = wisp::ceil_div(N, blocks);
  kernel<<<dim3(blocks, groups), kBwdThreads, smem, st>>>(coords, grad_out, u0_in, u0_out, N,
                                                          per_block, t, s, grad_table);
  return cudaGetLastError();
}

// backward: `table` is the cotangent [N, out_lods*F] and `out` the table gradient; `s` is
// null for the exact backward
template <int D, int F>
cudaError_t launch(bool backward, const float* coords, const float* table, int N,
                   const LodTable& t, const StochTable* s, const float* u0_in, float* u0_out,
                   float* out, cudaStream_t st) {
  if (!backward) return launch_fwd<D, F>(coords, table, N, t, out, st);
  if (s == nullptr)
    return launch_bwd<D, F, false>(coords, table, nullptr, nullptr, N, t, StochTable{}, out,
                                   st);
  return launch_bwd<D, F, true>(coords, table, u0_in, u0_out, N, t, *s, out, st);
}

template <int D>
cudaError_t dispatch_f(int F, bool backward, const float* coords, const float* table, int N,
                       const LodTable& t, const StochTable* s, const float* u0_in,
                       float* u0_out, float* out, cudaStream_t st) {
  switch (F) {
    case 1: return launch<D, 1>(backward, coords, table, N, t, s, u0_in, u0_out, out, st);
    case 2: return launch<D, 2>(backward, coords, table, N, t, s, u0_in, u0_out, out, st);
    case 4: return launch<D, 4>(backward, coords, table, N, t, s, u0_in, u0_out, out, st);
    case 8: return launch<D, 8>(backward, coords, table, N, t, s, u0_in, u0_out, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// K14's per-LOD constants and its launch's shape (query_launch)
struct QueryTable {
  int n_lods;
  int f_dim;                  // F
  int res[kMaxLods];
  float hi[kMaxLods];         // res - 1 - 1e-5
  unsigned begin[kMaxLods];   // first table row of the LOD
  unsigned rows[kMaxLods];    // rows of the LOD's slice: a row at or past it reads NaN
  int dense[kMaxLods];        // 1: row-major index, 0: spatial hash
  unsigned hash_mask;         // 2^bitwidth - 1
  int lod_group;              // LODs a block writes; blockIdx.y is the group
  int run_stride;             // 16-byte chunks of the tile a point's run takes; 0: no tile
};

constexpr int kQueryPoints = 32;          // a block's points, one a lane
constexpr int kQueryStageBytes = 49152;   // a block's staging tile at most

// the place of chunk j of point p's run in its 128-byte line
__device__ __forceinline__ int query_swizzle(int j, int p) { return j ^ (p & 7); }

// the 2^d corner rows of one (point, LOD), u = (c + 1) / 2 per axis: x = clip(u * res, 0,
// res-1-1e-5) rounded as JAX rounds it, the corners floor(x) + corner bits (bit k toggles
// axis d-1-k), their rows by hash_index; in[k] is false where the row is at or past the
// LOD's slice
template <int D>
__device__ __forceinline__ void query_corners(const float (&u)[D], int l, const QueryTable& q,
                                              unsigned (&row)[1 << D], bool (&in)[1 << D]) {
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  const bool dense = q.dense[l];
  const unsigned res = (unsigned)q.res[l];
  unsigned lo[D], up[D];
  unsigned stride = 1u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = fminf(fmaxf(u[d] * (float)q.res[l], 0.0f), q.hi[l]);
    const unsigned c0 = (unsigned)(int)floorf(x);
    const unsigned m = dense ? stride : primes[d];
    lo[d] = c0 * m;
    up[d] = (c0 + 1u) * m;
    stride *= res;
  }
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    unsigned idx = 0u;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const unsigned term = (k >> (D - 1 - d)) & 1 ? up[d] : lo[d];
      idx = d == 0 ? term : (dense ? idx + term : idx ^ term);
    }
    if (!dense) idx &= q.hash_mask;
    in[k] = idx < q.rows[l];
    row[k] = q.begin[l] + idx;
  }
}

// K14 reads the table with an L2 evict-last policy: the output's write stream passes
// through the L2 too, and the table's rows are read again by neighbouring points
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ float ldg_last(const float* p, unsigned long long policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float2 ldg_last(const float2* p, unsigned long long policy) {
  float2 v;
  asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
      : "=f"(v.x), "=f"(v.y) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ float4 ldg_last(const float4* p, unsigned long long policy) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(policy));
  return v;
}

// one corner's row (F in 1, 2, 4, 8: one or two vector loads), or NaN past its LOD's slice
template <int F>
__device__ __forceinline__ void query_row(const float* __restrict__ table, unsigned r, bool in,
                                          unsigned long long policy, float (&v)[F]) {
  if (!in) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __int_as_float(0x7fc00000);
  } else if constexpr (F == 1) {
    v[0] = ldg_last(table + r, policy);
  } else if constexpr (F == 2) {
    const float2 x = ldg_last(reinterpret_cast<const float2*>(table) + r, policy);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = ldg_last(reinterpret_cast<const float4*>(table) + (size_t)r * (F / 4) + q,
                                policy);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
}

// FT: F where it is 1, 2, 4 or 8 (vector loads, the rows in registers), 0 for any other F
// (q.f_dim: a feature at a time, scalar loads and tile writes)
template <int D, int FT>
__global__ void __launch_bounds__(256) hashgrid_query_kernel(
    const float* __restrict__ coords, const float* __restrict__ table, int N,
    const __grid_constant__ QueryTable q, float* __restrict__ out) {
  constexpr int C = 1 << D;
  extern __shared__ float4 query_tile[];
  const int F = FT > 0 ? FT : q.f_dim;
  const int pair4 = C * F / 4;                 // 16-byte chunks of a (point, LOD)
  const int l0 = blockIdx.y * q.lod_group;
  const int l1 = min(l0 + q.lod_group, q.n_lods);
  const int p0 = blockIdx.x * kQueryPoints;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n = p0 + lane;
  const bool staged = q.run_stride > 0;
  const unsigned long long policy = evict_last_policy();
  if (n < N) {
    float u[D];
#pragma unroll
    for (int d = 0; d < D; ++d) u[d] = (coords[(size_t)n * D + d] + 1.0f) / 2.0f;
    float4* mine = query_tile + lane * q.run_stride;
    for (int l = l0 + warp; l < l1; l += warps) {
      unsigned row[C];
      bool in[C];
      query_corners<D>(u, l, q, row, in);
      const int j0 = (l - l0) * pair4;
      if constexpr (FT > 0) {
        float v[C][FT];
#pragma unroll
        for (int k = 0; k < C; ++k) query_row<FT>(table, row[k], in[k], policy, v[k]);
#pragma unroll
        for (int j = 0; j < C * FT / 4; ++j) {
          float4 x;
          x.x = v[(4 * j) / FT][(4 * j) % FT];
          x.y = v[(4 * j + 1) / FT][(4 * j + 1) % FT];
          x.z = v[(4 * j + 2) / FT][(4 * j + 2) % FT];
          x.w = v[(4 * j + 3) / FT][(4 * j + 3) % FT];
          mine[query_swizzle(j0 + j, lane)] = x;
        }
      } else {
        float* direct = out + ((size_t)n * q.n_lods + l) * (C * F);
        for (int f = 0; f < F; ++f) {
          float v[C];
#pragma unroll
          for (int k = 0; k < C; ++k)
            v[k] = in[k] ? ldg_last(table + (size_t)row[k] * F + f, policy)
                         : __int_as_float(0x7fc00000);
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int e = k * F + f;
            if (staged) {
              float* w = reinterpret_cast<float*>(mine + query_swizzle(j0 + (e >> 2), lane));
              w[e & 3] = v[k];
            } else {
              __stcs(direct + e, v[k]);
            }
          }
        }
      }
    }
  }
  if (!staged) return;
  __syncthreads();
  // the tile out: a warp a point's run of the group's LODs, contiguous in the output
  const int points = min(kQueryPoints, N - p0);
  const int run = (l1 - l0) * pair4;
  for (int p = warp; p < points; p += warps) {
    float4* o = reinterpret_cast<float4*>(out + ((size_t)(p0 + p) * q.n_lods + l0) * (C * F));
    const float4* s = query_tile + p * q.run_stride;
    for (int j = lane; j < run; j += 32) __stcs(o + j, s[query_swizzle(j, p)]);
  }
}

// The LOD group: as many LODs as the block's tile holds in kQueryStageBytes (32 points, each
// point's run padded to 128-byte lines), spread evenly over the groups; a (point, LOD) wider
// than the budget writes straight from its lane (run_stride 0). A warp a LOD of the group,
// at most 8.
template <int D, int FT>
cudaError_t query_launch(const float* coords, const float* table, int N, QueryTable& q,
                         float* out, cudaStream_t st) {
  const int pair4 = (1 << D) * q.f_dim / 4;
  int g = q.n_lods;
  while (g > 0 && (long long)kQueryPoints * ((g * pair4 + 7) / 8 * 8) * 16 > kQueryStageBytes)
    --g;
  if (g == 0) {
    q.lod_group = q.n_lods;
    q.run_stride = 0;
  } else {
    const int groups = (q.n_lods + g - 1) / g;
    q.lod_group = (q.n_lods + groups - 1) / groups;
    q.run_stride = (q.lod_group * pair4 + 7) / 8 * 8;
  }
  const int warps = std::min(8, q.lod_group);
  const size_t smem = (size_t)kQueryPoints * q.run_stride * 16;
  const dim3 grid(wisp::ceil_div(N, kQueryPoints), wisp::ceil_div(q.n_lods, q.lod_group));
  hashgrid_query_kernel<D, FT><<<grid, 32 * warps, smem, st>>>(coords, table, N, q, out);
  return cudaGetLastError();
}

template <int D>
cudaError_t query_dispatch(const float* coords, const float* table, int N, QueryTable& q,
                           float* out, cudaStream_t st) {
  switch (q.f_dim) {
    case 1: return query_launch<D, 1>(coords, table, N, q, out, st);
    case 2: return query_launch<D, 2>(coords, table, N, q, out, st);
    case 4: return query_launch<D, 4>(coords, table, N, q, out, st);
    case 8: return query_launch<D, 8>(coords, table, N, q, out, st);
    default: return query_launch<D, 0>(coords, table, N, q, out, st);
  }
}

// The LOD table of both directions, checked: the hash modulo is a mask (codebook_size a
// power of two), every LOD's rows end below 2^32 (32-bit row indices), and the privatized
// LODs are dense, their float32 clip stays below res - 1 (so no corner leaves the LOD's
// rows) and their rows fit a block's shared memory.
cudaError_t make_table(int dim, int F, int n_lods, int out_lods, const int* res,
                       const float* scale, const float* hi, const long long* begin,
                       const int* dense, unsigned codebook_size, int n_shared, LodTable& t) {
  if (n_lods < 1 || n_lods > kMaxLods || out_lods > kMaxLods || n_lods > out_lods ||
      codebook_size == 0 || (codebook_size & (codebook_size - 1)) != 0 || n_shared < 0 ||
      n_shared > n_lods)
    return cudaErrorInvalidValue;
  t.n_lods = n_lods;
  t.out_lods = out_lods;
  t.hash_mask = codebook_size - 1u;
  t.n_shared = n_shared;
  t.sbegin[0] = 0u;
  for (int l = 0; l < n_lods; ++l) {
    long long rows = dense[l] ? 1 : (long long)codebook_size;
    if (dense[l]) {
      for (int d = 0; d < dim; ++d) rows *= res[l];
    }
    if (res[l] < 1 || begin[l] < 0 || begin[l] + rows > 0xffffffffLL)
      return cudaErrorInvalidValue;
    t.res[l] = res[l];
    t.scale[l] = scale[l];
    t.hi[l] = hi[l];
    t.begin[l] = (unsigned)begin[l];
    t.dense[l] = dense[l];
    if (l < n_shared) {
      if (!dense[l] || !(hi[l] < (float)(res[l] - 1))) return cudaErrorInvalidValue;
      t.sbegin[l + 1] = t.sbegin[l] + (unsigned)rows;
      if ((long long)t.sbegin[l + 1] * F * (long long)sizeof(float) > kSharedBytesMax)
        return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

int run(bool backward, const float* coords, const float* table, long long N, int dim,
        int F, int n_lods, int out_lods, const int* res, const float* scale, const float* hi,
        const long long* begin, const int* dense, unsigned codebook_size, int n_shared,
        float* out, void* stream, const StochTable* s = nullptr,
        const float* u0_in = nullptr, float* u0_out = nullptr) {
  // the kernels index samples with int and read the table (forward) and add to the
  // gradient (backward) in 16-byte vectors
  const float* vec = backward ? out : table;
  if (N < 0 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(vec) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  LodTable t;
  const cudaError_t e = make_table(dim, F, n_lods, out_lods, res, scale, hi, begin, dense,
                                   codebook_size, n_shared, t);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 2: return (int)dispatch_f<2>(F, backward, coords, table, (int)N, t, s, u0_in, u0_out,
                                      out, st);
    case 3: return (int)dispatch_f<3>(F, backward, coords, table, (int)N, t, s, u0_in, u0_out,
                                      out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// res/scale/hi/begin/dense: host arrays of n_lods entries. table: 16-byte aligned.
WISP_EXPORT int wisp_hashgrid_fwd(const float* coords, const float* table, long long N,
                                  int dim, int F, int n_lods, int out_lods, const int* res,
                                  const float* scale, const float* hi,
                                  const long long* begin, const int* dense,
                                  unsigned codebook_size, float* out, void* stream) {
  return run(false, coords, table, N, dim, F, n_lods, out_lods, res, scale, hi, begin,
             dense, codebook_size, 0, out, stream);
}

// grad_out: [N, out_lods*F] cotangent of the forward's output; grad_table: the [T, F]
// table gradient, zeroed by the caller and 16-byte aligned, into which LODs 0..n_lods-1
// accumulate. stoch: null for the exact backward, else a host array of n_lods flags,
// stoch[l] != 0 sending the whole cotangent row of LOD l to one drawn corner. u0_in: [N]
// uniforms, or null for the in-kernel sin hash; u0_out: null, or [N] to receive the hash's
// uniforms (u0_in must then be null); both are null in the exact backward. n_shared: LODs
// 0..n_shared-1 (dense) are accumulated in each block's shared memory (ops/grid.py
// shared_lods), 0 for none; a launch over fewer than kSpreadBwd samples privatizes none.
WISP_EXPORT int wisp_hashgrid_bwd(const float* coords, const float* grad_out,
                                  const float* u0_in, float* u0_out, long long N, int dim,
                                  int F, int n_lods, int out_lods, const int* res,
                                  const float* scale, const float* hi,
                                  const long long* begin, const int* dense, const int* stoch,
                                  int n_shared, unsigned codebook_size, float* grad_table,
                                  void* stream) {
  if (n_lods > kMaxLods || (u0_in != nullptr && u0_out != nullptr) ||
      (stoch == nullptr && (u0_in != nullptr || u0_out != nullptr)))
    return (int)cudaErrorInvalidValue;
  StochTable s{};
  if (stoch != nullptr) {
    for (int l = 0; l < n_lods; ++l) {
      s.stoch[l] = stoch[l];
      s.ushift[l] = (float)(0.61803398875 * (double)(l + 1));
    }
  }
  return run(true, coords, grad_out, N, dim, F, n_lods, out_lods, res, scale, hi, begin,
             dense, codebook_size, n_shared, grad_table, stream,
             stoch != nullptr ? &s : nullptr, u0_in, u0_out);
}

// K14. res/hi/begin/rows/dense: host arrays of n_lods entries (rows: each LOD's slice of the
// table, begin + rows below 2^32); codebook_size: 2^bitwidth; out: [N, n_lods, 2^dim, F],
// 16-byte aligned; table: aligned to its row loads (8 bytes at F = 2, 16 at F = 4 or 8).
WISP_EXPORT int wisp_hashgrid_query(const float* coords, const float* table, long long N,
                                    int dim, int F, int n_lods, const int* res,
                                    const float* hi, const long long* begin,
                                    const long long* rows, const int* dense,
                                    unsigned codebook_size, float* out, void* stream) {
  if (N < 0 || N > 0x7fffffffLL || F < 1 || F > (1 << 20) || n_lods < 1 ||
      n_lods > kMaxLods || codebook_size == 0 || (codebook_size & (codebook_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = F == 2 ? 8 : (F == 4 || F == 8) ? 16 : 4;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(table) % align != 0)
    return (int)cudaErrorMisalignedAddress;
  QueryTable q;
  q.n_lods = n_lods;
  q.f_dim = F;
  q.hash_mask = codebook_size - 1u;
  for (int l = 0; l < n_lods; ++l) {
    if (res[l] < 1 || begin[l] < 0 || rows[l] < 0 || begin[l] + rows[l] > 0xffffffffLL)
      return (int)cudaErrorInvalidValue;
    q.res[l] = res[l];
    q.hi[l] = hi[l];
    q.begin[l] = (unsigned)begin[l];
    q.rows[l] = (unsigned)rows[l];
    q.dense[l] = dense[l];
  }
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 2: return (int)query_dispatch<2>(coords, table, (int)N, q, out, st);
    case 3: return (int)query_dispatch<3>(coords, table, (int)N, q, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
