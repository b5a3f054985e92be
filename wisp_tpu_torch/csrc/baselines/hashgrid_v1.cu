// The earlier design of K1 forward and backward (exact and stochastic), kept as the yardstick
// of the redesign in ../hashgrid.cu: chip_smoke.py builds this file into its own library
// beside the kernel library and reports its time on the same inputs as the K1 rows'
// ``was_ms``. Nothing in the package calls it.
//
// Design: one thread a (sample, LOD). The forward gathers the 2^d corner rows of its
// (sample, LOD) and writes F floats of the output row; the backward recomputes the corners
// and atomicAdds w*g into the F floats of each corner row, one scalar atomic a float; on a
// LOD flagged stochastic it sends the whole cotangent row to one corner drawn by weight.
// Entry points: wisp_hashgrid_v1_fwd and wisp_hashgrid_v1_bwd, with the arguments of the
// kernel library's wisp_hashgrid_fwd and wisp_hashgrid_bwd before the redesign.
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
WISP_EXPORT int wisp_hashgrid_v1_fwd(const float* coords, const float* table, long long N,
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
WISP_EXPORT int wisp_hashgrid_v1_bwd(const float* coords, const float* grad_out,
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
