// K1 (forward) — multi-resolution hash-grid interpolation.
//
// Replaces the forward of wisp_tpu/ops/grid.py hashgrid (:335) -> _hashgrid_impl (:301)
// -> _lod_features (:143) with gather_rows (:37). Per LOD: x = clip((c+1)*(res/2), 0,
// res-1-1e-5) per axis, the 2^d cell corners (corner bit k toggles axis d-1-k), their
// table rows (dense row-major index x + y*res + z*res^2 when res^d fits the table, else the
// uint32 hash x*1 ^ y*2654435761 ^ z*805459861 mod 2^bitwidth), and the tri/bilinear blend.
// The output is [N, out_lods*F], features fastest; LODs at or above n_lods are written as
// zeros (the tracer's LOD truncation and the 'cat' LOD quirk).
//
// Bound on this card: random reads. Each (sample, LOD) reads 2^d table rows at hashed
// addresses; the flagship table (5.2M rows x 2 floats, 42 MB) mostly fits the 50 MB L2,
// so the kernel is bound by L2 sector traffic and by its compulsory bytes (coords in,
// features out). Design: one thread per (sample, LOD), so neighbouring threads touch
// neighbouring LODs of one sample and write one contiguous output row together; each row
// is loaded as one float2 when F == 2. LOD parameters travel in the kernel's argument
// block (no device table, no constant-memory copy).
//
// K1 (backward) — the exact table gradient, replacing wisp_tpu/ops/grid.py
// _gather_rows_bwd (:55), the scatter-add of w*g into the 2^d corner rows of every
// (sample, LOD). Coords get no gradient (they are not parameters). Bound on this card: the
// same random row traffic as the forward, now as read-modify-write atomics into L2. Design:
// one thread per (sample, computed LOD); it recomputes the corners and weights exactly as
// the forward does (same float order, no fused multiply-add) and atomicAdds w*g into the F
// floats of each corner row of a table gradient the wrapper zeroed. The coarse dense LODs
// (res 16: 4,096 rows) take many samples per row, so their atomics contend; warp
// aggregation or shared-memory accumulation of those LODs is later work. The summation
// order changes from run to run, so the result matches the plain version to float32
// rounding, not bit for bit.
//
// K1 (stochastic backward) — replaces wisp_tpu/ops/grid.py interp_rows_stoch (:66) with
// its backward _irs_bwd (:94), the corner draw of _lod_features (:182-191), the per-sample
// uniforms of _hashgrid_impl (:309-317) and _fold_u (:295). On a LOD flagged stochastic the
// whole cotangent row g of a (sample, LOD) goes to ONE corner, drawn with probability equal
// to its trilinear weight: u0 = frac(|sin(12.9898x + 78.233y + 37.719z)| * 43758.5453) (or
// the caller's u0), u = frac(u0 + 0.61803398875 (l+1)), the weights' running sum wcum in
// corner order, chosen = #{c : wcum[c] < u * wcum[last]}, clamped. That is F atomics a
// (sample, LOD) against the exact backward's 2^d * F. LODs not flagged take the exact
// branch above, so one launch covers the mixed LOD set of JAX's dense_lod_matmul rule. The
// entry point is the exact backward's: a null flag array selects the template instantiation
// without the draw, which keeps the exact kernel's code. Bound on this card: the cotangent
// read (N * L * F floats) and the scattered row updates; the hash LODs' rows are spread over
// 42 MB, so the atomics land in L2 almost without contention. CUDA's sinf is not XLA's or
// torch's sin on the CPU, and the hash multiplies the phase's last bits by 4e4, so the drawn
// corners agree across implementations only through an injected u0; the in-kernel hash is
// held statistically (uniform, unbiased).
//
// K14 — the raw corner-feature query, hashgrid_query.
//
// Replaces wisp_tpu/ops/grid.py hashgrid_query (:369-390): for every point and LOD 0..lod
// the feature rows of the 2^d cell corners, no blend: [N, L, 2^d, F]. JAX's body, not K1's:
// x = clip((c + 1) / 2 * res, 0, res-1-1e-5) per axis (K1 scales by res/2 instead), the
// corners floor(x) + _corner_offsets, their rows by hash_index (the same dense row-major
// index or uint32 hash as K1) into the LOD's slice of the table; a row at or past the
// slice's end reads NaN, as jnp.take's default fill mode does (a dense LOD whose clip
// rounds up to res-1 in float32). Bound on this card: bytes, the [N, L, 2^d, F] output
// (1 KB a point at the flagship's 16 LODs, F 2) and the rows read. Design: one thread a
// (point, LOD, corner), so a warp writes 32 consecutive rows of the output; the per-LOD
// constants travel in the argument block.
#include "common.cuh"

namespace {

constexpr int kMaxLods = 32;

struct LodTable {
  int n_lods;                 // LODs computed
  int out_lods;               // LODs in the output row (the rest are zeros)
  int res[kMaxLods];
  float scale[kMaxLods];      // res / 2
  float hi[kMaxLods];         // res - 1 - 1e-5
  long long begin[kMaxLods];  // first table row of the LOD
  int dense[kMaxLods];        // 1: row-major index, 0: spatial hash
  unsigned codebook_size;     // 2^bitwidth
};

template <int F>
struct Row { float v[F]; };

template <int F>
__device__ __forceinline__ Row<F> load_row(const float* __restrict__ table, long long row) {
  Row<F> out;
  if constexpr (F == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(table) + row);
    out.v[0] = x.x;
    out.v[1] = x.y;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) out.v[f] = __ldg(table + row * F + f);
  }
  return out;
}

template <int D, int F>
__global__ void hashgrid_fwd_kernel(const float* __restrict__ coords,
                                    const float* __restrict__ table, long long N,
                                    LodTable t, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * t.out_lods) return;
  const long long n = tid / t.out_lods;
  const int l = (int)(tid % t.out_lods);
  float* o = out + tid * F;
  if (l >= t.n_lods) {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = 0.0f;
    return;
  }
  const int res = t.res[l];
  unsigned c0[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float x = (coords[n * D + d] + 1.0f) * t.scale[l];
    x = fminf(fmaxf(x, 0.0f), t.hi[l]);
    const float fl = floorf(x);
    c0[d] = (unsigned)(int)fl;
    frac[d] = x - fl;
  }
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float w = 1.0f;
    unsigned idx = 0u, stride = 1u;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const unsigned bit = (c >> (D - 1 - d)) & 1u;
      const unsigned cc = c0[d] + bit;
      const float wd = bit ? frac[d] : 1.0f - frac[d];
      w = d == 0 ? wd : w * wd;
      if (t.dense[l]) {
        idx += cc * stride;
        stride *= (unsigned)res;
      } else {
        idx = d == 0 ? cc * primes[0] : idx ^ (cc * primes[d]);
      }
    }
    if (!t.dense[l]) idx %= t.codebook_size;
    const Row<F> row = load_row<F>(table, t.begin[l] + (long long)idx);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += row.v[f] * w;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = acc[f];
}

// per-LOD flags of the stochastic backward: stoch[l] != 0 draws one corner, ushift[l] is
// float32(0.61803398875 * (l + 1)), the golden-ratio shift of _fold_u as JAX rounds it
struct StochTable {
  int stoch[kMaxLods];
  float ushift[kMaxLods];
};

// the per-sample uniform of _hashgrid_impl: phase summed left to right, no fused multiply-add
template <int D>
__device__ __forceinline__ float sin_hash_u0(const float* __restrict__ c) {
  float phase = c[0] * 12.9898f + c[1] * 78.233f;
  if (D == 3) phase = phase + c[2] * 37.719f;
  const float u = fabsf(sinf(phase)) * 43758.5453f;
  return u - floorf(u);
}

// corner c's table row (within its LOD) and trilinear weight, in the forward's float order
template <int D>
__device__ __forceinline__ void corner_row(int c, const unsigned* c0, const float* frac,
                                           int res, bool dense, unsigned codebook_size,
                                           unsigned& idx, float& w) {
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  unsigned stride = 1u;
  idx = 0u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const unsigned bit = (c >> (D - 1 - d)) & 1u;
    const unsigned cc = c0[d] + bit;
    const float wd = bit ? frac[d] : 1.0f - frac[d];
    w = d == 0 ? wd : w * wd;
    if (dense) {
      idx += cc * stride;
      stride *= (unsigned)res;
    } else {
      idx = d == 0 ? cc * primes[0] : idx ^ (cc * primes[d]);
    }
  }
  if (!dense) idx %= codebook_size;
}

// STOCH false: the exact backward. STOCH true: LODs flagged in ``s`` draw one corner from
// u0_in (or the sin hash when it is null); u0_out, when given, receives each sample's u0.
template <int D, int F, bool STOCH>
__global__ void hashgrid_bwd_kernel(const float* __restrict__ coords,
                                    const float* __restrict__ grad_out,
                                    const float* __restrict__ u0_in,
                                    float* __restrict__ u0_out, long long N, LodTable t,
                                    StochTable s, float* __restrict__ grad_table) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * t.n_lods) return;
  const long long n = tid / t.n_lods;
  const int l = (int)(tid % t.n_lods);
  if (STOCH && u0_out != nullptr && l == 0) u0_out[n] = sin_hash_u0<D>(coords + n * D);
  const float* g = grad_out + (n * t.out_lods + l) * F;
  float gv[F];
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    gv[f] = g[f];
    any = any || gv[f] != 0.0f;
  }
  if (!any) return;  // a zero cotangent adds nothing
  const int res = t.res[l];
  const bool dense = t.dense[l] != 0;
  unsigned c0[D];
  float frac[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float x = (coords[n * D + d] + 1.0f) * t.scale[l];
    x = fminf(fmaxf(x, 0.0f), t.hi[l]);
    const float fl = floorf(x);
    c0[d] = (unsigned)(int)fl;
    frac[d] = x - fl;
  }
  if (STOCH && s.stoch[l]) {
    float wcum[1 << D];
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      unsigned idx;
      float w;
      corner_row<D>(c, c0, frac, res, dense, t.codebook_size, idx, w);
      wcum[c] = c == 0 ? w : wcum[c - 1] + w;
    }
    const float u0 = u0_in != nullptr ? u0_in[n] : sin_hash_u0<D>(coords + n * D);
    float u = u0 + s.ushift[l];
    u = u - floorf(u);
    const float target = u * wcum[(1 << D) - 1];
    int chosen = 0;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) chosen += wcum[c] < target ? 1 : 0;
    chosen = min(chosen, (1 << D) - 1);
    unsigned idx;
    float w;
    corner_row<D>(chosen, c0, frac, res, dense, t.codebook_size, idx, w);
    float* row = grad_table + (t.begin[l] + (long long)idx) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(row + f, gv[f]);
    return;
  }
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    unsigned idx;
    float w;
    corner_row<D>(c, c0, frac, res, dense, t.codebook_size, idx, w);
    float* row = grad_table + (t.begin[l] + (long long)idx) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(row + f, gv[f] * w);
  }
}

template <int D, int F>
cudaError_t launch_bwd(const float* coords, const float* grad_out, long long N,
                       const LodTable& t, const StochTable* s, const float* u0_in,
                       float* u0_out, float* grad_table, cudaStream_t st) {
  const long long n = N * t.n_lods;
  if (n > 0) {
    const int threads = 256;
    if (s == nullptr) {
      hashgrid_bwd_kernel<D, F, false><<<wisp::ceil_div(n, threads), threads, 0, st>>>(
          coords, grad_out, nullptr, nullptr, N, t, StochTable{}, grad_table);
    } else {
      hashgrid_bwd_kernel<D, F, true><<<wisp::ceil_div(n, threads), threads, 0, st>>>(
          coords, grad_out, u0_in, u0_out, N, t, *s, grad_table);
    }
  }
  return cudaGetLastError();
}

template <int D, int F>
cudaError_t launch(const float* coords, const float* table, long long N, const LodTable& t,
                   float* out, cudaStream_t st) {
  const long long n = N * t.out_lods;
  if (n > 0) {
    const int threads = 256;
    hashgrid_fwd_kernel<D, F><<<wisp::ceil_div(n, threads), threads, 0, st>>>(
        coords, table, N, t, out);
  }
  return cudaGetLastError();
}

// the backward's stochastic part: the per-LOD flags and the caller's uniforms
struct StochArgs {
  const StochTable* table;  // null: the exact backward
  const float* u0_in;
  float* u0_out;
};

// backward: `table` is the cotangent [N, out_lods*F] and `out` the table gradient
template <int D>
cudaError_t dispatch_f(int F, bool backward, const float* coords, const float* table,
                       long long N, const LodTable& t, const StochArgs& sa, float* out,
                       cudaStream_t st) {
  switch (F) {
    case 1: return backward ? launch_bwd<D, 1>(coords, table, N, t, sa.table, sa.u0_in,
                                               sa.u0_out, out, st)
                            : launch<D, 1>(coords, table, N, t, out, st);
    case 2: return backward ? launch_bwd<D, 2>(coords, table, N, t, sa.table, sa.u0_in,
                                               sa.u0_out, out, st)
                            : launch<D, 2>(coords, table, N, t, out, st);
    case 4: return backward ? launch_bwd<D, 4>(coords, table, N, t, sa.table, sa.u0_in,
                                               sa.u0_out, out, st)
                            : launch<D, 4>(coords, table, N, t, out, st);
    case 8: return backward ? launch_bwd<D, 8>(coords, table, N, t, sa.table, sa.u0_in,
                                               sa.u0_out, out, st)
                            : launch<D, 8>(coords, table, N, t, out, st);
    default: return cudaErrorInvalidValue;
  }
}


// K14's per-LOD constants.
struct QueryTable {
  int n_lods;
  int res[kMaxLods];
  float hi[kMaxLods];         // res - 1 - 1e-5
  long long begin[kMaxLods];  // first table row of the LOD
  long long rows[kMaxLods];   // rows of the LOD's slice
  int dense[kMaxLods];
  unsigned codebook_size;
};

template <int D, int F>
__global__ void hashgrid_query_kernel(const float* __restrict__ coords,
                                      const float* __restrict__ table, long long N,
                                      QueryTable q, float* __restrict__ out) {
  constexpr int C = 1 << D;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * q.n_lods * C) return;
  const int c = (int)(tid % C);
  const int l = (int)((tid / C) % q.n_lods);
  const long long n = tid / ((long long)C * q.n_lods);
  const unsigned primes[3] = {1u, 2654435761u, 805459861u};
  const unsigned res = (unsigned)q.res[l];
  unsigned idx = 0u, stride = 1u;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float x = (coords[n * D + d] + 1.0f) / 2.0f * (float)q.res[l];
    x = fminf(fmaxf(x, 0.0f), q.hi[l]);
    const unsigned cc = (unsigned)(int)floorf(x) + ((c >> (D - 1 - d)) & 1u);
    if (q.dense[l]) {
      idx += cc * stride;
      stride *= res;
    } else {
      idx = d == 0 ? cc * primes[0] : idx ^ (cc * primes[d]);
    }
  }
  if (!q.dense[l]) idx %= q.codebook_size;
  float* o = out + tid * F;
  if ((long long)idx >= q.rows[l]) {
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = __int_as_float(0x7fc00000);   // NaN
    return;
  }
  const Row<F> row = load_row<F>(table, q.begin[l] + (long long)idx);
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = row.v[f];
}

template <int D>
cudaError_t query_dispatch(int F, const float* coords, const float* table, long long N,
                           const QueryTable& q, float* out, cudaStream_t st) {
  const long long total = N * q.n_lods * (1 << D);
  if (total == 0) return cudaGetLastError();
  const int threads = 256;
  const int blocks = wisp::ceil_div(total, threads);
  switch (F) {
    case 1: hashgrid_query_kernel<D, 1><<<blocks, threads, 0, st>>>(coords, table, N, q, out);
            break;
    case 2: hashgrid_query_kernel<D, 2><<<blocks, threads, 0, st>>>(coords, table, N, q, out);
            break;
    case 4: hashgrid_query_kernel<D, 4><<<blocks, threads, 0, st>>>(coords, table, N, q, out);
            break;
    case 8: hashgrid_query_kernel<D, 8><<<blocks, threads, 0, st>>>(coords, table, N, q, out);
            break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int run(bool backward, const float* coords, const float* table, long long N, int dim,
        int F, int n_lods, int out_lods, const int* res, const float* scale, const float* hi,
        const long long* begin, const int* dense, unsigned codebook_size, float* out,
        void* stream, const StochArgs& sa = StochArgs{nullptr, nullptr, nullptr}) {
  if (n_lods > kMaxLods || out_lods > kMaxLods || n_lods > out_lods)
    return (int)cudaErrorInvalidValue;
  LodTable t;
  t.n_lods = n_lods;
  t.out_lods = out_lods;
  t.codebook_size = codebook_size;
  for (int l = 0; l < n_lods; ++l) {
    t.res[l] = res[l];
    t.scale[l] = scale[l];
    t.hi[l] = hi[l];
    t.begin[l] = begin[l];
    t.dense[l] = dense[l];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 2: return (int)dispatch_f<2>(F, backward, coords, table, N, t, sa, out, st);
    case 3: return (int)dispatch_f<3>(F, backward, coords, table, N, t, sa, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// res/scale/hi/begin/dense: host arrays of n_lods entries.
WISP_EXPORT int wisp_hashgrid_fwd(const float* coords, const float* table, long long N,
                                  int dim, int F, int n_lods, int out_lods, const int* res,
                                  const float* scale, const float* hi,
                                  const long long* begin, const int* dense,
                                  unsigned codebook_size, float* out, void* stream) {
  return run(false, coords, table, N, dim, F, n_lods, out_lods, res, scale, hi, begin,
             dense, codebook_size, out, stream);
}

// grad_out: [N, out_lods*F] cotangent of the forward's output; grad_table: the [T, F]
// table gradient, zeroed by the caller, into which LODs 0..n_lods-1 accumulate. stoch: null
// for the exact backward, else a host array of n_lods flags, stoch[l] != 0 sending the whole
// cotangent row of LOD l to one drawn corner. u0_in: [N] uniforms, or null for the in-kernel
// sin hash; u0_out: null, or [N] to receive the hash's uniforms (u0_in must then be null);
// both are null in the exact backward.
WISP_EXPORT int wisp_hashgrid_bwd(const float* coords, const float* grad_out,
                                  const float* u0_in, float* u0_out, long long N, int dim,
                                  int F, int n_lods, int out_lods, const int* res,
                                  const float* scale, const float* hi,
                                  const long long* begin, const int* dense, const int* stoch,
                                  unsigned codebook_size, float* grad_table, void* stream) {
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
             dense, codebook_size, grad_table, stream,
             StochArgs{stoch != nullptr ? &s : nullptr, u0_in, u0_out});
}

// K14. res/hi/begin/rows/dense: host arrays of n_lods entries (rows: each LOD's slice of the
// table); out: [N, n_lods, 2^dim, F].
WISP_EXPORT int wisp_hashgrid_query(const float* coords, const float* table, long long N,
                                    int dim, int F, int n_lods, const int* res,
                                    const float* hi, const long long* begin,
                                    const long long* rows, const int* dense,
                                    unsigned codebook_size, float* out, void* stream) {
  if (n_lods < 1 || n_lods > kMaxLods) return (int)cudaErrorInvalidValue;
  QueryTable q;
  q.n_lods = n_lods;
  q.codebook_size = codebook_size;
  for (int l = 0; l < n_lods; ++l) {
    q.res[l] = res[l];
    q.hi[l] = hi[l];
    q.begin[l] = begin[l];
    q.rows[l] = rows[l];
    q.dense[l] = dense[l];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (dim) {
    case 2: return (int)query_dispatch<2>(F, coords, table, N, q, out, st);
    case 3: return (int)query_dispatch<3>(F, coords, table, N, q, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
