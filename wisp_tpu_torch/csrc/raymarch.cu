// K2 — occupancy ray march, 'ray' mode.
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS._raymarch_ray (:492) with
// _sample_grid (:443, strided path :454-481) and aabb_intersect (:291). Per ray: slab
// test against [-1,1]^3, depths t_near + span*((i+u_i)/S) with u_i = 0.5 (midpoints) or,
// in training, a uniform jitter u [R,S] the caller draws (octree_as.py:499-504), sample points
// o + d*t, and the occupancy test against the fused cell-density field (-1 = empty).
// With stride k only every k-th sample is tested, and each sample is marked occupied when
// its own strided test or the next one hit (the JAX OR-broadcast); stride 1 tests every
// sample alone. A dense blas (no field) tests only the box.
//
// Bound on this card: bytes. The march writes 16-17 bytes per sample (point, depth, mask,
// density) and reads one field value per strided sample, from a field of 128^3 floats
// (8 MB) that stays in L2. Design: one thread per (ray, strided sample); it computes the
// two strided tests its samples need and writes its `stride` samples, so the gathers are
// issued once per strided sample and every output is written exactly once. The order of
// float operations is the plain version's, and the library is built without fused
// multiply-add, so points, cells and masks agree bit for bit.
//
// K8 — occupancy ray march, 'uniform' mode, a mode of the same kernel (ustep > 0).
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS._raymarch_uniform (:612) with the
// same _sample_grid (:443). The depths take one global step over the box's diagonal
// instead of the ray's span: t_near + (i + u_i) * step, step = float32(2*sqrt(3) / S), in
// JAX's order (u times step, then the sum); the deltas are that step; a sample is valid
// where the strided occupancy test holds, it lies in the box and its depth is below the
// ray's exit (JAX masks `depths < t_far` in place of K2's whole-ray hit). Bound and design
// are K2's: the same bytes a sample, the same thread per strided sample.
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
WISP_EXPORT int wisp_raymarch_ray(const float* origins, const float* dirs,
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

// K7 — occupancy ray march, 'voxel' mode.
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS._raymarch_voxel (:512-610). Per
// ray: the slab test (as K2), then `nc` coarse segments of one voxel at `level` (voxel =
// 2 / 2^level): segment i has its midpoint at tc = t_near + (i + 0.5) * voxel and is
// occupied when that point lies in the box, its start lies before t_far, and the
// occupancy at `max_level` (the fused density field, -1 = empty, or the boolean grid; a
// dense octree tests the box alone) holds. With a density field and early_stop > 0 the
// segments the ray can no longer see are dropped first: T_i = exp(-(cumsum(tau)_i - tau_i))
// with tau = density * voxel on occupied segments, kept while T_i > early_stop. The first
// K occupied segments in ray order fill the slots, then the others in index order (the
// stable argsort of JAX); a ray with more than K occupied segments adds one to
// `num_overflow`. Each slot k takes S depths seg_t0 + (j + u) * (voxel / S), seg_t0 =
// t_near + order_k * voxel, masked by its segment's occupancy and depth < t_far, and its
// segment's density.
//
// Bound on this card: bytes. The march writes 17-21 bytes per fine slot (point, depth,
// mask, density) and reads one occupancy value per coarse segment, from a field of
// 2 MB (bool) or 8 MB (float) at level 7 that stays in L2. Design: one warp a ray. Pass 1
// takes the segments 32 at a time, one a lane; `__ballot_sync` gives the occupied ones of
// each group, whose bits are kept in shared memory, and their count. The transmittance
// cull adds the group's taus to the running sum in ray order, lane by lane, as the plain
// version's cumsum does. Pass 2 gives each segment its place in `order` from the counts of
// occupied segments before it (`__popc`). Pass 3 writes the K*S slots, lane-contiguous so
// that the warp's stores coalesce. Float operations follow the plain version's order and
// the library is built without fused multiply-add, so depths, points and masks agree bit
// for bit.
namespace {

struct VoxelGeom {
  int nc, K, S, max_res;
  float voxel, step, half_max_res, early_stop;
};

// Coarse segment i of the ray: occupancy `cm` and the density estimate `cd` (0 without a
// field).
__device__ __forceinline__ void coarse_segment(const Ray& ray, int i, const VoxelGeom& g,
                                               const uint8_t* __restrict__ occ,
                                               const float* __restrict__ cell_density,
                                               bool& cm, float& cd) {
  const float tc = ray.t_near + ((float)i + 0.5f) * g.voxel;
  const float x = ray.ox + ray.dx * tc;
  const float y = ray.oy + ray.dy * tc;
  const float z = ray.oz + ray.dz * tc;
  const bool inside = inside_box(x, y, z);
  const bool span_valid = (tc - 0.5f * g.voxel) < ray.t_far;
  cd = 0.0f;
  if (occ == nullptr && cell_density == nullptr) {
    cm = inside && span_valid;
    return;
  }
  float val = -1.0f;
  bool o = false;
  if (inside) {
    const long long flat = ((long long)quantize(x, g.half_max_res, g.max_res) * g.max_res
                            + quantize(y, g.half_max_res, g.max_res)) * g.max_res
                           + quantize(z, g.half_max_res, g.max_res);
    if (cell_density != nullptr) val = __ldg(cell_density + flat);
    else o = __ldg(occ + flat) != 0;
  }
  if (cell_density != nullptr) {
    cm = val >= 0.0f && span_valid;
    cd = fmaxf(val, 0.0f);
  } else {
    cm = o && span_valid;
  }
}

__global__ void raymarch_voxel_kernel(const float* __restrict__ origins,
                                      const float* __restrict__ dirs,
                                      const float* __restrict__ jitter, int R, VoxelGeom g,
                                      float dist_min, float dist_max,
                                      const uint8_t* __restrict__ occ,
                                      const float* __restrict__ cell_density,
                                      float* __restrict__ samples, float* __restrict__ depths,
                                      uint8_t* __restrict__ mask, float* __restrict__ dens,
                                      float* __restrict__ num_overflow) {
  extern __shared__ uint32_t smem[];
  const int warps = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nchunks = (g.nc + 31) / 32;
  uint32_t* sel_bits = smem + wid * (nchunks + 2 * g.K);
  int* order = reinterpret_cast<int*>(sel_bits + nchunks);
  float* odens = reinterpret_cast<float*>(order + g.K);
  const int r = blockIdx.x * warps + wid;
  if (r >= R) return;  // the same for every lane of the warp
  const Ray ray = load_ray(origins, dirs, r, dist_min, dist_max);
  const bool cull = cell_density != nullptr && g.early_stop > 0.0f;
  const unsigned below = (1u << lane) - 1u;

  // pass 1: occupied (and visible) segments, 32 at a time
  int count = 0;
  float carry = 0.0f;
  for (int c = 0; c < nchunks; ++c) {
    const int i = c * 32 + lane;
    bool cm = false;
    float cd = 0.0f;
    if (i < g.nc) coarse_segment(ray, i, g, occ, cell_density, cm, cd);
    if (cull) {
      const float tau = cd * g.voxel * (cm ? 1.0f : 0.0f);
      float incl = carry;
      for (int j = 0; j < 32; ++j) {  // the running sum in ray order
        const float v = __shfl_sync(wisp::kFullMask, tau, j);
        if (j <= lane) incl += v;
      }
      const float t_seg = expf(-(incl - tau));
      cm = cm && t_seg > g.early_stop;
      carry = __shfl_sync(wisp::kFullMask, incl, 31);
    }
    const unsigned bits = __ballot_sync(wisp::kFullMask, cm);
    if (lane == 0) sel_bits[c] = bits;
    count += __popc(bits);
  }
  __syncwarp();
  if (lane == 0 && count > g.K) atomicAdd(num_overflow, 1.0f);

  // pass 2: each segment's place in the stable order (occupied first, both in index order)
  int before = 0;
  for (int c = 0; c < nchunks; ++c) {
    const int i = c * 32 + lane;
    const unsigned bits = sel_bits[c];
    const int lower = __popc(bits & below);
    if (i < g.nc) {
      const bool sel = (bits >> lane) & 1u;
      const int pos = sel ? before + lower : count + (i - (before + lower));
      if (pos < g.K) {
        order[pos] = i;
        if (dens != nullptr) {
          bool cm;
          float cd;
          coarse_segment(ray, i, g, occ, cell_density, cm, cd);
          odens[pos] = cd;
        }
      }
    }
    before += __popc(bits);
  }
  __syncwarp();

  // pass 3: S fine depths in each of the K slots
  const long long ks = (long long)g.K * g.S;
  const long long base = (long long)r * ks;
  for (long long idx = lane; idx < ks; idx += 32) {
    const int k = (int)(idx / g.S);
    const int j = (int)(idx - (long long)k * g.S);
    const int seg = order[k];
    const bool sel = (sel_bits[seg >> 5] >> (seg & 31)) & 1u;
    const float u = (float)j + (jitter != nullptr ? jitter[base + idx] : 0.5f);
    const float seg_t0 = ray.t_near + (float)seg * g.voxel;
    const float t = seg_t0 + u * g.step;
    const long long o = base + idx;
    samples[3 * o] = ray.ox + ray.dx * t;
    samples[3 * o + 1] = ray.oy + ray.dy * t;
    samples[3 * o + 2] = ray.oz + ray.dz * t;
    depths[o] = t;
    mask[o] = (uint8_t)(sel && t < ray.t_far);
    if (dens != nullptr) dens[o] = odens[k];
  }
}

}  // namespace

// K coarse slots of S samples a ray over nc segments of `voxel`; occ [8^max_level] bool or
// cell_density [8^max_level] float (at most one; neither = a dense octree); jitter
// [R, K, S] uniforms in [0, 1), or null for midpoints; step = float32(voxel / S);
// num_overflow: one zeroed float. dens is written when cell_density is given.
WISP_EXPORT int wisp_raymarch_voxel(const float* origins, const float* dirs,
                                    const float* jitter, int R, int S, int K, int nc,
                                    float voxel, float step, float dist_min, float dist_max,
                                    const uint8_t* occ, const float* cell_density,
                                    int max_level, float early_stop, float* samples,
                                    float* depths, uint8_t* mask, float* dens,
                                    float* num_overflow, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  VoxelGeom g;
  g.nc = nc;
  g.K = K;
  g.S = S;
  g.max_res = 1 << max_level;
  g.voxel = voxel;
  g.step = step;
  g.half_max_res = (float)g.max_res / 2.0f;
  g.early_stop = early_stop;
  const int per_warp = ((nc + 31) / 32 + 2 * K) * (int)sizeof(uint32_t);
  const int max_smem = 48 * 1024;
  if (per_warp > max_smem) return (int)cudaErrorInvalidValue;
  const int warps = min(4, max_smem / per_warp);
  raymarch_voxel_kernel<<<wisp::ceil_div(R, warps), warps * 32, warps * per_warp,
                          (cudaStream_t)stream>>>(origins, dirs, jitter, R, g, dist_min,
                                                  dist_max, occ, cell_density, samples,
                                                  depths, mask, dens, num_overflow);
  return (int)cudaGetLastError();
}
