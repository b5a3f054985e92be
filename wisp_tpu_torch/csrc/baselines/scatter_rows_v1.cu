// The earlier design of K12's scatter-back (scatter_rows), kept as the yardstick of the
// redesign in ../compaction.cu (wisp_scatter_rows_many): chip_smoke.py builds this file into
// its own library beside the kernel library and reports the per-channel sequence of its
// launches on the same channels as the K12 scatter-back rows' ``was_ms`` and in its "scatter
// and segment" step. Nothing in the package calls it.
//
// Design: a launch a channel. One thread a (slot, 4-byte word) of the channel's rows, or a
// (slot, byte) where the row width is not a multiple of 4; each thread reads its slot's
// 8-byte index. Entry point: wisp_scatter_rows_v1(v, idx, K, row_bytes, P, out, stream):
// out[idx[k]] = v[k] for k < K where idx[k] < P; rows of row_bytes bytes; out is given.
#include "common.cuh"

namespace {

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

}  // namespace

WISP_EXPORT int wisp_scatter_rows_v1(const void* v, const long long* idx, long long K,
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
