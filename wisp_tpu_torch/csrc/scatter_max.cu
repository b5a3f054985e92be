// K5 — density-feedback scatter-max, with the cell lookup.
//
// Replaces the sample-fed keep-score update of wisp_tpu/tracers/packed_rf_tracer.py
// (:237-256, and the carried grid of _trace_segmented :376-384), which JAX computes as one
// inline function: each sample's point quantized to its cell at the octree's level
// (quantize_points_jnp: floor((x + 1) * (res / 2)), clipped to [0, res - 1]), the cell's
// flat id (qx * res + qy) * res + qz, the drop of samples off the mask, and
// `zeros(res^3).at[ids].max(density, mode="drop")`, the per-cell maximum of the densities
// of a step's training samples.
//
// Design: one launch a call, one thread a sample. A sample whose byte of the optional keep
// mask is 0 returns before any other load. The others load their point (12 bytes) and
// their density (float32 or bfloat16, at any element stride: the field's density column
// as it comes), compute the cell exactly as quantize_points does (the product with a power
// of two is exact, and the build has --fmad=false, so (x + 1) is rounded once before it),
// widen the density to float32 (exact) and do one atomicMax on its int bits into a grid
// that the wrapper zeroed (a trace) or that earlier calls filled (the segments of one
// segmented trace share one grid, as JAX's carried `fb` does). For floats >= 0 the order
// of the int bits is the order of the values, so the result is exact whatever the order
// of the atomics. Densities are relu'd, so no value is below 0; a negative value (or -0.0)
// loses to the zero the cell starts from, as it does in the plain version. A NaN is
// written as the largest positive NaN pattern, so any NaN turns its cell into NaN, as a
// max that propagates NaN does. A carried grid's cells hold values >= 0 (or that NaN
// pattern), so the int order still holds.
//
// The earlier design (baselines/scatter_max_v1.cu) took ready int64 ids, which the tracer
// computed with ~9 elementwise PyTorch launches a call. The samples come step-major from
// the compaction, so neighbouring lanes mostly hit different cells: nothing merges equal
// cells within a warp.
//
// Bound on this card: bytes, 12 bytes of point and 4 or 2 of density (1 of mask) a sample
// and 4 bytes a touched cell; the grid (8 MB at level 7) stays in L2.
#include "common.cuh"

namespace {

__device__ __forceinline__ long long cell_coord(float x, float half, long long res) {
  const long long q = (long long)floorf((x + 1.0f) * half);
  return q < 0 ? 0 : (q > res - 1 ? res - 1 : q);
}

template <bool kBf16>
__global__ void scatter_max_points_kernel(const float* __restrict__ points,
                                          const void* __restrict__ density,
                                          long long stride, const uint8_t* __restrict__ keep,
                                          long long K, int level, int* __restrict__ grid) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  if (keep != nullptr && keep[k] == 0) return;
  const float x = points[3 * k], y = points[3 * k + 1], z = points[3 * k + 2];
  float v;
  if (kBf16) {
    const unsigned short b = static_cast<const unsigned short*>(density)[k * stride];
    v = __uint_as_float((unsigned)b << 16);
  } else {
    v = static_cast<const float*>(density)[k * stride];
  }
  const int bits = isnan(v) ? 0x7fffffff : __float_as_int(v);
  if (bits <= 0) return;
  const long long res = 1LL << level;
  const float half = (float)res * 0.5f;
  const long long id =
      (cell_coord(x, half, res) * res + cell_coord(y, half, res)) * res +
      cell_coord(z, half, res);
  atomicMax(grid + id, bits);
}

}  // namespace

// points [K, 3] float32; density: K values, float32 (bf16 = 0) or bfloat16 (bf16 = 1), the
// k-th at density + k * stride elements; keep: K bytes or null; grid: 8^level floats,
// zeroed by the caller or carried from earlier calls, updated in place.
WISP_EXPORT int wisp_scatter_max_points(const float* points, const void* density,
                                        long long stride, int bf16, const uint8_t* keep,
                                        long long K, int level, float* grid, void* stream) {
  if (K < 0 || level < 0 || level > 10) return (int)cudaErrorInvalidValue;
  if (K > 0) {
    const int blocks = wisp::ceil_div(K, 256);
    cudaStream_t st = (cudaStream_t)stream;
    int* g = reinterpret_cast<int*>(grid);
    if (bf16)
      scatter_max_points_kernel<true><<<blocks, 256, 0, st>>>(points, density, stride, keep,
                                                              K, level, g);
    else
      scatter_max_points_kernel<false><<<blocks, 256, 0, st>>>(points, density, stride, keep,
                                                               K, level, g);
  }
  return (int)cudaGetLastError();
}
