// K3 — step-major sample compaction and scatter-back.
//
// Replaces wisp_tpu/ops/compaction.py masked_compact_indices (:23) together with the
// tracer's step-major remap, gathers and scatter-back (wisp_tpu/tracers/
// packed_rf_tracer.py:188-222). The valid samples of an [R, S] mask are packed in
// step-major order (position p = s*R + r) into a budget of B slots: slot k holds the flat
// row-major index r*S + s of the k-th valid sample, so when more than B samples are valid
// the latest steps across all rays are dropped. Only the first min(count, B) slots are
// written: the tracer reads no other (JAX fills the rest with R*S and the last sample, and
// so does the plain version, which the CPU parity tests hold against JAX). The point and
// the ray direction of every kept slot are gathered in the same pass. scatter_back writes
// per-slot rows [K, C] back into a zero-filled [R*S, C].
//
// Bound on this card: bytes. The mask is read once per pass (1 byte per sample; it stays
// in L2 between passes), and each kept sample costs a 12-byte read of its point and
// 8 + 24 bytes of writes. Design: a
// three-pass prefix sum, which needs no cross-block ordering: (1) each block of 256
// threads counts the valid samples of its 4,096 consecutive step-major positions;
// (2) one block scans the block counts and writes the total; (3) each block scans its
// positions again, 256 at a time in order, and writes its slots. Consecutive threads read
// consecutive rays of one step, so mask reads are strided by S bytes; the 8 MB mask of a
// 16,384 x 512 chunk stays in L2. A decoupled look-back scan would fuse the passes.
//
// K6a — the live cull of the segmented trace (wisp_tpu/tracers/packed_rf_tracer.py
// _trace_segmented :338-343): with a per-ray carried optical depth acc_tau [R] and a cap
// tau_cap = -log(eps), position p is valid iff mask[r*S+s] && acc_tau[r] < tau_cap, so the
// samples of rays whose transmittance fell to eps or below are neither counted nor kept.
// The order, the kept-slot contract and the returned count are those of K3. Bound: bytes,
// K3's plus 4 bytes a ray of acc_tau; the cull is one more load (L1-resident: a block's
// 4,096 positions span at most 4,096 / R + 1 steps of consecutive rays) and a compare.
//
// K12 compaction — the SDF tracer's active-ray compaction (wisp_tpu/tracers/
// packed_sdf_tracer.py:168-220, over wisp_tpu/ops/compaction.py masked_compact_indices on
// an [R, 1] mask): K3's count, scan and write passes with S = 1, so the kept rays keep
// their order. The payload of a kept slot is its ray's row: origin and direction (3
// floats each), its walk depth t and its exit t_far. Unlike K3, every one of the B slots
// is defined, as JAX defines them: a fourth pass fills the slots past the count with
// index R and the payload of ray R-1 (JAX's jnp.minimum(idx, R - 1) gather), so the
// sphere loop can run on all B slots with the empty ones masked dead. The mid-loop
// re-compaction is the same entry point on the first pass's B slots. Bound on this card:
// bytes: 1 byte of mask a ray read twice (L2-resident), 32 bytes read and 8 + 32 written
// a slot.
//
// scatter_rows — the tracer's scatter-back of the compacted slots (`.at[idx].set(v,
// mode="drop")` onto a given base, packed_sdf_tracer.py:207-217): out[idx[k]] = v[k] for
// the first K slots whose index is below P, rows of any width in bytes (t, xyz, normal and
// extras as floats, hit as bytes). Bound: bytes, one 8-byte index and one row read and one
// row written a kept slot. Design: one thread a (slot, 4-byte word), or a (slot, byte)
// where the row width is not a multiple of 4.
//
// scatter_back backward (the autodiff of packed_rf_tracer.py:214, the `.at[idx].set`
// scatter): a gather of the cotangent rows at the slots' sample indices,
// grad_v[k, c] = grad_out[idx[k], c] (0 for an empty slot). Bound on this card: bytes, one
// 8-byte index and C floats read and C floats written per kept slot. Design: one thread per
// (slot, column), so a warp reads the index of a few slots and C consecutive floats of
// each row; the result is exact.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

// acc_tau null: no cull (K3); else the sample's ray must have acc_tau < tau_cap (K6a)
__device__ __forceinline__ int mask_at(const uint8_t* __restrict__ mask,
                                       const float* __restrict__ acc_tau, float tau_cap,
                                       long long p, int R, int S, long long P) {
  if (p >= P) return 0;
  const long long r = p % R;
  const long long s = p / R;
  return mask[r * S + s] != 0 && (acc_tau == nullptr || acc_tau[r] < tau_cap);
}

__global__ void count_kernel(const uint8_t* __restrict__ mask,
                             const float* __restrict__ acc_tau, float tau_cap, int R, int S,
                             int* __restrict__ block_counts) {
  const long long P = (long long)R * S;
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    c += mask_at(mask, acc_tau, tau_cap, base + k * kThreads + threadIdx.x, R, S, P);
  int total;
  wisp::block_exclusive_scan(c, total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void scan_kernel(const int* __restrict__ block_counts, int nb,
                            int* __restrict__ block_offsets, long long* __restrict__ count) {
  long long carry = 0;
  for (int i0 = 0; i0 < nb; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int v = i < nb ? block_counts[i] : 0;
    int total;
    const int excl = wisp::block_exclusive_scan(v, total);
    if (i < nb) block_offsets[i] = (int)(carry + excl);
    carry += total;
  }
  if (threadIdx.x == 0) count[0] = carry;
}

__global__ void write_kernel(const uint8_t* __restrict__ mask,
                             const float* __restrict__ acc_tau, float tau_cap,
                             const float* __restrict__ samples,
                             const float* __restrict__ dirs, int R, int S, long long budget,
                             const int* __restrict__ block_offsets,
                             long long* __restrict__ idx, float* __restrict__ cflat,
                             float* __restrict__ cray_d) {
  const long long P = (long long)R * S;
  const long long base = (long long)blockIdx.x * kTile;
  long long slot0 = block_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long p = base + k * kThreads + threadIdx.x;
    const int m = mask_at(mask, acc_tau, tau_cap, p, R, S, P);
    int total;
    const int excl = wisp::block_exclusive_scan(m, total);
    const long long slot = slot0 + excl;
    if (m && slot < budget) {
      const long long r = p % R;
      const long long q = r * S + p / R;
      idx[slot] = q;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cflat[3 * slot + a] = samples[3 * q + a];
        cray_d[3 * slot + a] = dirs[3 * r + a];
      }
    }
    slot0 += total;
  }
}

// the write pass of K12 compaction: S = 1, a ray's row as payload
__global__ void write_rays_kernel(const uint8_t* __restrict__ mask, int R, long long budget,
                                  const int* __restrict__ block_offsets,
                                  const float* __restrict__ origins,
                                  const float* __restrict__ dirs, const float* __restrict__ t,
                                  const float* __restrict__ t_far,
                                  long long* __restrict__ idx, float* __restrict__ o_c,
                                  float* __restrict__ d_c, float* __restrict__ t_c,
                                  float* __restrict__ tf_c) {
  const long long base = (long long)blockIdx.x * kTile;
  long long slot0 = block_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long r = base + k * kThreads + threadIdx.x;
    const int m = mask_at(mask, nullptr, 0.0f, r, R, 1, R);
    int total;
    const int excl = wisp::block_exclusive_scan(m, total);
    const long long slot = slot0 + excl;
    if (m && slot < budget) {
      idx[slot] = r;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o_c[3 * slot + a] = origins[3 * r + a];
        d_c[3 * slot + a] = dirs[3 * r + a];
      }
      t_c[slot] = t[r];
      tf_c[slot] = t_far[r];
    }
    slot0 += total;
  }
}

// slots past the count: index R and ray R-1's row (JAX's fill and clipped gather)
__global__ void fill_rays_kernel(int R, long long budget, const long long* __restrict__ count,
                                 const float* __restrict__ origins,
                                 const float* __restrict__ dirs, const float* __restrict__ t,
                                 const float* __restrict__ t_far, long long* __restrict__ idx,
                                 float* __restrict__ o_c, float* __restrict__ d_c,
                                 float* __restrict__ t_c, float* __restrict__ tf_c) {
  const long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= budget || slot < count[0]) return;
  const long long r = R - 1;
  idx[slot] = R;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o_c[3 * slot + a] = origins[3 * r + a];
    d_c[3 * slot + a] = dirs[3 * r + a];
  }
  t_c[slot] = t[r];
  tf_c[slot] = t_far[r];
}

template <typename T>
__global__ void scatter_rows_kernel(const T* __restrict__ v, const long long* __restrict__ idx,
                                    long long K, int width, long long P, T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * width) return;
  const long long k = i / width;
  const int c = (int)(i % width);
  const long long q = idx[k];
  if (q < P) out[q * width + c] = v[i];
}

__global__ void zero_kernel(float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = 0.0f;
}

__global__ void gather_kernel(const float* __restrict__ grad_out,
                              const long long* __restrict__ idx, long long K, int C,
                              long long P, float* __restrict__ grad_v) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * C) return;
  const long long k = t / C;
  const int c = (int)(t % C);
  const long long q = idx[k];
  grad_v[t] = q < P ? grad_out[q * C + c] : 0.0f;
}

}  // namespace

// block_counts / block_offsets: int32 scratch of ceil(R*S / 4096) entries; count: one
// int64, the number of valid samples (not capped by the budget). acc_tau [R] may be null
// (K3); else only the samples of rays with acc_tau < tau_cap are valid (K6a).
WISP_EXPORT int wisp_compact(const uint8_t* mask, const float* acc_tau, float tau_cap,
                             const float* samples, const float* dirs,
                             int R, int S, long long budget, int* block_counts,
                             int* block_offsets, long long* count, long long* idx,
                             float* cflat, float* cray_d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = wisp::ceil_div((long long)R * S, kTile);
  if (nb == 0) return (int)cudaErrorInvalidValue;
  count_kernel<<<nb, kThreads, 0, st>>>(mask, acc_tau, tau_cap, R, S, block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, 1024, 0, st>>>(block_counts, nb, block_offsets, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_kernel<<<nb, kThreads, 0, st>>>(mask, acc_tau, tau_cap, samples, dirs, R, S,
                                        budget, block_offsets, idx, cflat, cray_d);
  return (int)cudaGetLastError();
}

WISP_EXPORT int wisp_scatter_back(const float* v, const long long* idx, long long K, int C,
                                  long long P, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = P * C;
  if (n > 0) {
    const int blocks = (int)(n < 132LL * 8 * 256 ? wisp::ceil_div(n, 256) : 132 * 8);
    zero_kernel<<<blocks, 256, 0, st>>>(out, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (K * C > 0) {   // the floats' bits, as scatter_rows moves them
    scatter_rows_kernel<uint32_t><<<wisp::ceil_div(K * C, 256), 256, 0, st>>>(
        (const uint32_t*)v, idx, K, C, P, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// grad_out: [P, C] cotangent of scatter_back's output; grad_v: [K, C].
WISP_EXPORT int wisp_scatter_back_bwd(const float* grad_out, const long long* idx,
                                      long long K, int C, long long P, float* grad_v,
                                      void* stream) {
  if (K * C > 0) {
    gather_kernel<<<wisp::ceil_div(K * C, 256), 256, 0, (cudaStream_t)stream>>>(
        grad_out, idx, K, C, P, grad_v);
  }
  return (int)cudaGetLastError();
}

// K12 compaction. mask [R] (bytes); origins, dirs [R, 3], t, t_far [R]; block_counts /
// block_offsets: int32 scratch of ceil(R / 4096) entries; count: one int64, the number of
// set mask entries (not capped by the budget); idx [B] int64, o_c, d_c [B, 3], t_c,
// tf_c [B]: every slot written.
WISP_EXPORT int wisp_compact_rays(const uint8_t* mask, int R, long long budget,
                                  const float* origins, const float* dirs, const float* t,
                                  const float* t_far, int* block_counts, int* block_offsets,
                                  long long* count, long long* idx, float* o_c, float* d_c,
                                  float* t_c, float* tf_c, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = wisp::ceil_div(R, kTile);
  if (nb == 0 || budget < 1) return (int)cudaErrorInvalidValue;
  count_kernel<<<nb, kThreads, 0, st>>>(mask, nullptr, 0.0f, R, 1, block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, 1024, 0, st>>>(block_counts, nb, block_offsets, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_rays_kernel<<<nb, kThreads, 0, st>>>(mask, R, budget, block_offsets, origins, dirs,
                                             t, t_far, idx, o_c, d_c, t_c, tf_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fill_rays_kernel<<<wisp::ceil_div(budget, 256), 256, 0, st>>>(
      R, budget, count, origins, dirs, t, t_far, idx, o_c, d_c, t_c, tf_c);
  return (int)cudaGetLastError();
}

// out[idx[k]] = v[k] for k < K where idx[k] < P; rows of row_bytes bytes; out is given.
WISP_EXPORT int wisp_scatter_rows(const void* v, const long long* idx, long long K,
                                  int row_bytes, long long P, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K > 0 && row_bytes > 0) {
    if (row_bytes % 4 == 0) {
      const int w = row_bytes / 4;
      scatter_rows_kernel<uint32_t><<<wisp::ceil_div(K * w, 256), 256, 0, st>>>(
          (const uint32_t*)v, idx, K, w, P, (uint32_t*)out);
    } else {
      scatter_rows_kernel<uint8_t><<<wisp::ceil_div(K * row_bytes, 256), 256, 0, st>>>(
          (const uint8_t*)v, idx, K, row_bytes, P, (uint8_t*)out);
    }
  }
  return (int)cudaGetLastError();
}
