// The earlier design of K14 (hashgrid_query), kept as the yardstick of the redesign in
// ../hashgrid.cu: chip_smoke.py builds this file into its own library beside the kernel
// library and reports its time on the same inputs as the K14 row's ``was_ms``. Nothing in
// the package calls it.
//
// Design: one thread a (point, LOD, corner), so a warp writes 32 consecutive rows of the
// [N, L, 2^d, F] output; each thread splits its flat index into (point, LOD, corner) with
// 64-bit divisions, reloads its point's coords and recomputes every axis of the cell, and
// writes its row as F scalar stores. F in {1, 2, 4, 8}. Entry point:
// wisp_hashgrid_query_v1, with the arguments of the kernel library's wisp_hashgrid_query.
#include "common.cuh"

namespace {

constexpr int kMaxLods = 32;

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

}  // namespace

// res/hi/begin/rows/dense: host arrays of n_lods entries (rows: each LOD's slice of the
// table); out: [N, n_lods, 2^dim, F].
WISP_EXPORT int wisp_hashgrid_query_v1(const float* coords, const float* table, long long N,
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
