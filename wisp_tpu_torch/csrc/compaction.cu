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

__global__ void zero_kernel(float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = 0.0f;
}

__global__ void scatter_kernel(const float* __restrict__ v, const long long* __restrict__ idx,
                               long long K, int C, long long P, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * C) return;
  const long long k = t / C;
  const int c = (int)(t % C);
  const long long q = idx[k];
  if (q < P) out[q * C + c] = v[t];
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
  if (K * C > 0) {
    scatter_kernel<<<wisp::ceil_div(K * C, 256), 256, 0, st>>>(v, idx, K, C, P, out);
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
