// The earlier design of K2/K8 (wisp_raymarch_ray, the 'ray' and 'uniform' marches), kept as
// the yardstick of the redesign in ../raymarch.cu: chip_smoke.py builds this file into its
// own library beside the kernel library and reports its time on the same inputs as the K2
// and K8 rows' ``was_ms`` and in its "march and octree grad" step. Nothing in the package
// calls it.
//
// Design: one thread a (ray, strided sample). Every thread loads its ray and repeats the
// slab test, makes the one or two strided occupancy tests its samples need and writes its
// `stride` samples with scalar stores (lanes 24 bytes apart in the points, 8 in depths and
// densities, 2 in the mask). Entry point: wisp_raymarch_ray_v1, with the arguments of the
// kernel library's wisp_raymarch_ray.
#include "common.cuh"

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float t_near, t_far, span;
  bool hit;
};

__device__ __forceinline__ Ray load_ray(const float* origins, const float* dirs, int r,
                                        float dist_min, float dist_max) {
  Ray ray;
  ray.ox = origins[3 * r]; ray.oy = origins[3 * r + 1]; ray.oz = origins[3 * r + 2];
  ray.dx = dirs[3 * r]; ray.dy = dirs[3 * r + 1]; ray.dz = dirs[3 * r + 2];
  const float o[3] = {ray.ox, ray.oy, ray.oz};
  const float d[3] = {ray.dx, ray.dy, ray.dz};
  float t_near, t_far;
  wisp::slab_test(o, d, dist_min, dist_max, t_near, t_far);
  t_near = fmaxf(t_near, 0.0f);
  ray.t_near = t_near;
  ray.t_far = t_far;
  ray.span = fmaxf(t_far - t_near, 0.0f);
  ray.hit = t_far > t_near;
  return ray;
}

// u_row: the ray's [S] jitter, or null for midpoints. ustep > 0 selects the 'uniform'
// march (K8): t_near + (j + u) * ustep; else the 'ray' march: t_near + span * ((j + u) / S).
__device__ __forceinline__ void sample_at(const Ray& ray, int j, int S, float ustep,
                                          const float* __restrict__ u_row, float& t, float& x,
                                          float& y, float& z) {
  const float uj = (float)j + (u_row != nullptr ? u_row[j] : 0.5f);
  t = ustep > 0.0f ? ray.t_near + uj * ustep : ray.t_near + ray.span * (uj / (float)S);
  x = ray.ox + ray.dx * t;
  y = ray.oy + ray.dy * t;
  z = ray.oz + ray.dz * t;
}

__device__ __forceinline__ bool inside_box(float x, float y, float z) {
  return x >= -1.0f && x < 1.0f && y >= -1.0f && y < 1.0f && z >= -1.0f && z < 1.0f;
}

__device__ __forceinline__ int quantize(float v, float half_res, int res) {
  int q = (int)floorf((v + 1.0f) * half_res);
  return min(max(q, 0), res - 1);
}

// Field value at sample j: -1 outside the box or in an empty cell.
__device__ __forceinline__ float field_at(const Ray& ray, int j, int S, float ustep,
                                          const float* __restrict__ u_row,
                                          const float* __restrict__ cell_density, int res,
                                          float half_res) {
  float t, x, y, z;
  sample_at(ray, j, S, ustep, u_row, t, x, y, z);
  if (!inside_box(x, y, z)) return -1.0f;
  const long long flat = ((long long)quantize(x, half_res, res) * res
                          + quantize(y, half_res, res)) * res + quantize(z, half_res, res);
  return __ldg(cell_density + flat);
}

__global__ void raymarch_ray_kernel(const float* __restrict__ origins,
                                    const float* __restrict__ dirs,
                                    const float* __restrict__ jitter, int R, int S,
                                    int stride, float ustep, float dist_min, float dist_max,
                                    const float* __restrict__ cell_density, int level,
                                    float* __restrict__ samples, float* __restrict__ depths,
                                    uint8_t* __restrict__ mask, float* __restrict__ dens,
                                    float* __restrict__ deltas) {
  const int nc = (S + stride - 1) / stride;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)R * nc) return;
  const int r = (int)(tid / nc);
  const int g = (int)(tid % nc);
  const Ray ray = load_ray(origins, dirs, r, dist_min, dist_max);
  if (g == 0) deltas[r] = ustep > 0.0f ? ustep : ray.span / (float)S;
  const float* u_row = jitter != nullptr ? jitter + (long long)r * S : nullptr;

  const int res = 1 << level;
  const float half_res = (float)res / 2.0f;
  bool occ = true;
  float val = 0.0f;
  if (cell_density != nullptr) {
    val = field_at(ray, g * stride, S, ustep, u_row, cell_density, res, half_res);
    occ = val >= 0.0f;
    if (stride > 1 && g + 1 < nc) {
      occ = occ || field_at(ray, (g + 1) * stride, S, ustep, u_row, cell_density, res,
                            half_res) >= 0.0f;
    }
  }
  const float dval = fmaxf(val, 0.0f);
  for (int k = 0; k < stride; ++k) {
    const int j = g * stride + k;
    if (j >= S) break;
    float t, x, y, z;
    sample_at(ray, j, S, ustep, u_row, t, x, y, z);
    const long long o = (long long)r * S + j;
    samples[3 * o] = x;
    samples[3 * o + 1] = y;
    samples[3 * o + 2] = z;
    depths[o] = t;
    // 'ray' masks a ray that misses the box, 'uniform' a sample past the exit
    mask[o] = (uint8_t)(occ && inside_box(x, y, z) && (ustep > 0.0f ? t < ray.t_far
                                                                     : ray.hit));
    if (dens != nullptr) dens[o] = dval;
  }
}

}  // namespace

// jitter: [R, S] uniforms in [0, 1), or null for midpoint samples; ustep: 0 for the 'ray'
// march (K2), float32(2*sqrt(3)/S) for the 'uniform' march (K8).
WISP_EXPORT int wisp_raymarch_ray_v1(const float* origins, const float* dirs,
                                     const float* jitter, int R, int S,
                                     int stride, float ustep, float dist_min, float dist_max,
                                     const float* cell_density, int level, float* samples,
                                     float* depths, uint8_t* mask, float* dens, float* deltas,
                                     void* stream) {
  const int nc = (S + stride - 1) / stride;
  const long long n = (long long)R * nc;
  if (n > 0) {
    const int threads = 256;
    raymarch_ray_kernel<<<wisp::ceil_div(n, threads), threads, 0, (cudaStream_t)stream>>>(
        origins, dirs, jitter, R, S, stride, ustep, dist_min, dist_max, cell_density, level,
        samples, depths, mask, dens, deltas);
  }
  return (int)cudaGetLastError();
}
