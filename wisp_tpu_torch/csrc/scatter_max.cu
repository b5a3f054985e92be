// K5 — density-feedback scatter-max.
//
// Replaces the sample-fed keep-score update of wisp_tpu/tracers/packed_rf_tracer.py
// (:237-256): `zeros(res^3).at[ids].max(density, mode="drop")`, the per-cell maximum of the
// densities of a step's training samples. Ids outside [0, size) are dropped.
//
// Bound on this card: bytes, one 8-byte id and one float read per sample and one atomic
// into a 8 MB grid (128^3 floats) that stays in L2. Design: one thread per sample and one
// atomicMax on the int bits of the value, on a grid the wrapper zeroed. For floats >= 0
// the order of the int bits is the order of the values, so the result is exact whatever
// the order of the atomics. Densities are relu'd, so no value is below 0; a negative value
// (or -0.0) loses to the zero the cell starts from, as it does in the plain version. A NaN
// is written as the largest positive NaN pattern, so any NaN turns its cell into NaN, as a
// max that propagates NaN does.
//
// Accumulated (the segmented trace's carried grid, wisp_tpu/tracers/packed_rf_tracer.py
// _trace_segmented :376-384): the same kernel maxes into a grid that earlier calls filled,
// one call a segment, so the segments of a trace share one grid as JAX's carried `fb` does.
// Its cells hold values >= 0 (or the NaN pattern), so the int order still holds.
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
WISP_EXPORT int wisp_scatter_max(const long long* ids, const float* values, long long K,
                                 long long size, float* grid, void* stream) {
  if (K > 0) {
    scatter_max_kernel<<<wisp::ceil_div(K, 256), 256, 0, (cudaStream_t)stream>>>(
        ids, values, K, size, reinterpret_cast<int*>(grid));
  }
  return (int)cudaGetLastError();
}
