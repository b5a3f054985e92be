// The earlier design of K5, the density-feedback scatter-max, kept as the yardstick of the
// redesign in ../scatter_max.cu (wisp_scatter_max_points): chip_smoke.py builds this file
// into its own library beside the kernel library and reports it, with the cell lookup's
// PyTorch launches in front of it (ops/density_grid.py cell_ids, and the drop of masked
// samples), as the K5 rows' ``was_ms`` and in its "feedback and gather" step. Nothing in
// the package calls it.
//
// Design: the caller computes each sample's int64 cell id; one thread a sample drops an id
// outside [0, size) and does one atomicMax on the int bits of its float value into a
// zeroed or carried grid (the NaN and -0.0 rules of ../scatter_max.cu). Entry point:
// wisp_scatter_max_v1(ids, values, K, size, grid, stream).
#include "common.cuh"

namespace {

__global__ void scatter_max_kernel(const long long* __restrict__ ids,
                                   const float* __restrict__ values, long long K,
                                   long long size, int* __restrict__ grid) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long id = ids[k];
  if (id < 0 || id >= size) return;
  const float v = values[k];
  const int bits = isnan(v) ? 0x7fffffff : __float_as_int(v);
  if (bits > 0) atomicMax(grid + id, bits);
}

}  // namespace

// grid: `size` floats, zeroed by the caller or carried from earlier calls, updated in
// place.
WISP_EXPORT int wisp_scatter_max_v1(const long long* ids, const float* values, long long K,
                                    long long size, float* grid, void* stream) {
  if (K > 0) {
    scatter_max_kernel<<<wisp::ceil_div(K, 256), 256, 0, (cudaStream_t)stream>>>(
        ids, values, K, size, reinterpret_cast<int*>(grid));
  }
  return (int)cudaGetLastError();
}
