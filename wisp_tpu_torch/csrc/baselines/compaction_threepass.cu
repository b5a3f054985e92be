// The earlier design of wisp_compact (K3, K6a) and wisp_compact_rays (K12), kept as a
// yardstick: chip_smoke.py builds this file on its own (it is not part of the package's
// kernel library) and times it beside the redesigned kernels on the same inputs, as the
// rows' "was_ms". Same contracts and results as ../compaction.cu.
//
// Design: a three-pass prefix sum over tiles of 4,096 consecutive step-major positions
// (p = s*R + r): (1) each block of 256 threads counts the valid samples of its tile;
// (2) one block of 1,024 threads scans the block counts and writes the total; (3) each
// block scans its positions again, 256 at a time in order, and writes its slots.
// Consecutive threads read consecutive rays of one step, so the mask reads are strided by
// S bytes. K12 runs the same passes with S = 1 and a fourth launch that fills the slots
// past the count with index R and ray R-1's row.
#include "../common.cuh"

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

}  // namespace

// block_counts / block_offsets: int32 scratch of ceil(R*S / 4096) entries; count: one
// int64, the number of valid samples (not capped by the budget). acc_tau [R] may be null
// (K3); else only the samples of rays with acc_tau < tau_cap are valid (K6a).
WISP_EXPORT int wisp_compact_threepass(const uint8_t* mask, const float* acc_tau,
                                       float tau_cap, const float* samples, const float* dirs,
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

// K12 compaction. mask [R] (bytes); origins, dirs [R, 3], t, t_far [R]; block_counts /
// block_offsets: int32 scratch of ceil(R / 4096) entries; count: one int64, the number of
// set mask entries (not capped by the budget); idx [B] int64, o_c, d_c [B, 3], t_c,
// tf_c [B]: every slot written.
WISP_EXPORT int wisp_compact_rays_threepass(const uint8_t* mask, int R, long long budget,
                                            const float* origins, const float* dirs,
                                            const float* t, const float* t_far,
                                            int* block_counts, int* block_offsets,
                                            long long* count, long long* idx, float* o_c,
                                            float* d_c, float* t_c, float* tf_c,
                                            void* stream) {
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

