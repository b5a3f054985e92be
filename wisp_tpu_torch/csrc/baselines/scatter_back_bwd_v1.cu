// The earlier design of K3's scatter-back backward, kept as the yardstick of the redesign
// in ../compaction.cu (wisp_scatter_back_bwd_many): chip_smoke.py builds this file into its
// own library beside the kernel library and reports its launch a channel (colour, then
// density through the select view's backward, a zero fill and a copy) as the K3
// scatter-back backward row's ``was_ms`` and in its "feedback and gather" step. Nothing in
// the package calls it.
//
// Design: a launch a channel, one thread a (slot, column): each thread divides its flat
// index by C (64-bit) for its slot and column, reads the slot's 8-byte index and copies
// one float of the cotangent row (0 for an empty slot, index P). Entry point:
// wisp_scatter_back_bwd_v1(grad_out, idx, K, C, P, grad_v, stream): grad_out [P, C],
// grad_v [K, C].
#include "common.cuh"

namespace {

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

WISP_EXPORT int wisp_scatter_back_bwd_v1(const float* grad_out, const long long* idx,
                                         long long K, int C, long long P, float* grad_v,
                                         void* stream) {
  if (K * C > 0) {
    gather_kernel<<<wisp::ceil_div(K * C, 256), 256, 0, (cudaStream_t)stream>>>(
        grad_out, idx, K, C, P, grad_v);
  }
  return (int)cudaGetLastError();
}
