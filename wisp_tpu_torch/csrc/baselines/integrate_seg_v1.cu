// The earlier design of K6b (integrate_seg_fwd), kept as the yardstick of the redesign in
// ../integrate.cu: chip_smoke.py builds this file into its own library beside the kernel
// library and reports its time on the same inputs as the K6b row's ``was_ms`` and in its
// "scatter and segment" step. Nothing in the package calls it.
//
// Design: K4's forward with the carried optical depth A = acc_tau[r] inside the exponent.
// One warp a ray walks the segment's S steps 32 at a time, one step a lane: a load, a
// 5-shuffle inclusive scan, the carry broadcast and two expf a round, so a segment of 128
// steps takes four dependent rounds. Entry point: wisp_integrate_seg_fwd_v1, with the
// arguments of the kernel library's wisp_integrate_seg_fwd.
#include "common.cuh"

namespace {

constexpr int kMaxExtra = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(wisp::kFullMask, v, o);
  return v;
}

__global__ void integrate_seg_fwd_v1_kernel(const float* __restrict__ density,
                                            const float* __restrict__ deltas,
                                            const float* __restrict__ depths,
                                            const uint8_t* __restrict__ mask,
                                            const float* __restrict__ color,
                                            const float* __restrict__ extra,
                                            const float* __restrict__ acc_tau, int R, int S,
                                            int Ce, float* __restrict__ rgb,
                                            float* __restrict__ alpha,
                                            float* __restrict__ depth,
                                            float* __restrict__ extra_out,
                                            float* __restrict__ acc_out) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = gtid >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warps leave together: a warp never straddles two rays
  const float delta = deltas[r];
  const float A = acc_tau[r];
  float carry = 0.0f;
  float a = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  float ex[kMaxExtra];
#pragma unroll
  for (int k = 0; k < kMaxExtra; ++k) ex[k] = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const long long o = r * S + s;
    float tau = 0.0f;
    if (s < S) tau = density[o] * delta * (float)mask[o];
    float incl = tau;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(wisp::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    incl += carry;
    carry = __shfl_sync(wisp::kFullMask, incl, 31);
    if (s < S) {
      const float sum_prev = incl - tau;
      const float w = expf(-(A + sum_prev)) * (1.0f - expf(-tau));
      a += w;
      c0 += w * color[3 * o];
      c1 += w * color[3 * o + 1];
      c2 += w * color[3 * o + 2];
      if (depth != nullptr) dep += w * depths[o];
      for (int k = 0; k < Ce; ++k) ex[k] += w * extra[o * Ce + k];
    }
  }
  a = warp_sum(a);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  dep = warp_sum(dep);
  for (int k = 0; k < Ce; ++k) ex[k] = warp_sum(ex[k]);
  if (lane == 0) {
    alpha[r] = a;
    rgb[3 * r] = c0;
    rgb[3 * r + 1] = c1;
    rgb[3 * r + 2] = c2;
    acc_out[r] = A + carry;
    if (depth != nullptr) depth[r] = dep;
    for (int k = 0; k < Ce; ++k) extra_out[r * Ce + k] = ex[k];
  }
}

}  // namespace

WISP_EXPORT int wisp_integrate_seg_fwd_v1(const float* density, const float* deltas,
                                          const float* depths, const uint8_t* mask,
                                          const float* color, const float* extra,
                                          const float* acc_tau, int R, int S, int Ce,
                                          float* rgb, float* alpha, float* depth,
                                          float* extra_out, float* acc_out, void* stream) {
  if (Ce < 0 || Ce > kMaxExtra) return (int)cudaErrorInvalidValue;
  const long long threads_total = (long long)R * 32;
  if (threads_total > 0) {
    const int threads = 256;
    integrate_seg_fwd_v1_kernel<<<wisp::ceil_div(threads_total, threads), threads, 0,
                                  (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, extra, acc_tau, R, S, Ce, rgb, alpha, depth,
        extra_out, acc_out);
  }
  return (int)cudaGetLastError();
}
