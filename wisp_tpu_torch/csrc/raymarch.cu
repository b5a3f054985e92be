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
// K8 — occupancy ray march, 'uniform' mode, a mode of the same kernel (ustep > 0).
//
// Replaces wisp_tpu/accelstructs/octree_as.py OctreeAS._raymarch_uniform (:612) with the
// same _sample_grid (:443). The depths take one global step over the box's diagonal
// instead of the ray's span: t_near + (i + u_i) * step, step = float32(2*sqrt(3) / S), in
// JAX's order (u times step, then the sum); the deltas are that step; a sample is valid
// where the strided occupancy test holds, it lies in the box and its depth is below the
// ray's exit (JAX masks `depths < t_far` in place of K2's whole-ray hit).
//
// Bound on this card: bytes. The march writes 21 bytes a sample (point 12, depth 4, mask 1,
// density 4) and reads one field value a strided sample, from a field of 128^3 floats
// (8 MB) that stays in L2. Design: a block takes a tile of kMarchTile consecutive flat
// samples (whole rays and pieces of rays, in any place of a ray). (1) The tile's ray
// constants (loads, slab test, t_near, span, hit) are computed once a ray into shared memory;
// the block that holds a ray's first sample writes its delta. (2) The strided tests of the
// tile's samples, and the next test of its last sample (which may lie in the next tile; it
// is computed here, not read from there), are made once each into shared memory. (3) Each
// thread takes 4 consecutive samples: depths and densities go out as one 16-byte store a
// thread (a warp writes 512 contiguous bytes), points and masks into shared memory, from
// which the block copies the tile's points as one flat float run and its masks 16 to a
// store, both in 16-byte stores. The outputs must start on 16 bytes (the entry point
// refuses others; the wrapper allocates them so). The order of float operations is the
// plain version's, and the library is built without fused multiply-add, so points, depths,
// masks and densities agree bit for bit.
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

// K2/K8's block: 256 threads of 4 consecutive samples each, compiled for 8 blocks an SM (32
// registers, against 40 unbounded: the render chunk ran slower with 6 blocks). A tile needs
// the shared memory of march_smem_bytes: its points (12 KB), masks (1 KB), strided tests
// (4 KB) and ray constants (40 bytes a ray: 3 rays at S = 512, at most 1,025 at S = 1).
constexpr int kMarchThreads = 256;
constexpr int kMarchTile = 4 * kMarchThreads;

__host__ __device__ constexpr int march_val_bytes() {
  return ((kMarchTile + 1) * 4 + 15) / 16 * 16;
}

__host__ __device__ constexpr int march_smem_bytes(int max_rays) {
  return kMarchTile * 12 + kMarchTile + march_val_bytes() + max_rays * (int)sizeof(Ray);
}

// a / b for a >= 0, in 32 bits where a fits
__device__ __forceinline__ long long div_nonneg(long long a, int b) {
  return a < 0x7fffffffLL ? (long long)((unsigned)a / (unsigned)b) : a / b;
}

__global__ void __launch_bounds__(kMarchThreads, 8)
    raymarch_tile_kernel(const float* __restrict__ origins, const float* __restrict__ dirs,
                         const float* __restrict__ jitter, int R, int S, int stride,
                         float ustep, float dist_min, float dist_max,
                         const float* __restrict__ cell_density, int level,
                         float* __restrict__ samples, float* __restrict__ depths,
                         uint8_t* __restrict__ mask, float* __restrict__ dens,
                         float* __restrict__ deltas) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  float* xyz_s = reinterpret_cast<float*>(tile_smem);
  uint8_t* mask_s = tile_smem + kMarchTile * 12;
  float* val_s = reinterpret_cast<float*>(tile_smem + kMarchTile * 13);
  Ray* rays_s = reinterpret_cast<Ray*>(tile_smem + kMarchTile * 13 + march_val_bytes());

  const long long total = (long long)R * S;
  const long long o0 = (long long)blockIdx.x * kMarchTile;
  const int n = (int)min((long long)kMarchTile, total - o0);
  const int r0 = (int)div_nonneg(o0, S);
  const int j0 = (int)(o0 - (long long)r0 * S);    // the tile's first sample in ray r0
  const int nr = (j0 + n - 1) / S + 1;
  const int nc = (S + stride - 1) / stride;
  const bool field = cell_density != nullptr;

  // (1) ray constants, once a ray
  for (int i = threadIdx.x; i < nr; i += kMarchThreads) {
    const Ray ray = load_ray(origins, dirs, r0 + i, dist_min, dist_max);
    rays_s[i] = ray;
    if (i > 0 || j0 == 0) deltas[r0 + i] = ustep > 0.0f ? ustep : ray.span / (float)S;
  }
  __syncthreads();

  // (2) the strided tests: local index (r - r0) * nc + g - qb
  const int qb = j0 / stride;
  if (field) {
    const int jl = j0 + n - 1 - (nr - 1) * S;      // the last sample, in ray r0 + nr - 1
    const int gl = jl / stride;
    const int nq = (nr - 1) * nc + gl - qb + 1 + ((stride > 1 && gl + 1 < nc) ? 1 : 0);
    const int res = 1 << level;
    const float half_res = (float)res / 2.0f;
    for (int i = threadIdx.x; i < nq; i += kMarchThreads) {
      const int qi = qb + i;
      const int ri = qi / nc;
      const int g = qi - ri * nc;
      const float* u_row = jitter != nullptr ? jitter + (long long)(r0 + ri) * S : nullptr;
      val_s[i] = field_at(rays_s[ri], g * stride, S, ustep, u_row, cell_density, res,
                          half_res);
    }
  }
  __syncthreads();

  // (3) four consecutive samples a thread. One quad a thread fills the tile; written as a
  // loop, it compiles with fewer spills under the 8-block bound and ran faster on the card
  for (int l0 = 4 * threadIdx.x; l0 < n; l0 += 4 * kMarchThreads) {
    int ri = (j0 + l0) / S;                          // the ray, from r0
    int j = j0 + l0 - ri * S;
    int g = j / stride;
    int k = j - g * stride;
    float xyz[12], t4[4], d4[4];
    uint32_t m4 = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xyz[3 * e] = xyz[3 * e + 1] = xyz[3 * e + 2] = t4[e] = d4[e] = 0.0f;
      if (l0 + e < n) {
        const Ray& ray = rays_s[ri];
        const float* u_row =
            jitter != nullptr ? jitter + (long long)(r0 + ri) * S : nullptr;
        float t, x, y, z;
        sample_at(ray, j, S, ustep, u_row, t, x, y, z);
        bool occ = true;
        float val = 0.0f;
        if (field) {
          const int qi = ri * nc + g - qb;
          val = val_s[qi];
          occ = val >= 0.0f;
          if (stride > 1 && g + 1 < nc) occ = occ || val_s[qi + 1] >= 0.0f;
        }
        xyz[3 * e] = x;
        xyz[3 * e + 1] = y;
        xyz[3 * e + 2] = z;
        t4[e] = t;
        d4[e] = fmaxf(val, 0.0f);
        // 'ray' masks a ray that misses the box, 'uniform' a sample past the exit
        const bool m = occ && inside_box(x, y, z) && (ustep > 0.0f ? t < ray.t_far : ray.hit);
        m4 |= (uint32_t)m << (8 * e);
      }
      if (++j == S) {
        j = g = k = 0;
        ++ri;
      } else if (++k == stride) {
        k = 0;
        ++g;
      }
    }
    const long long o = o0 + l0;
    if (l0 + 4 <= n) {
      float4* xs = reinterpret_cast<float4*>(xyz_s + 3 * l0);
      xs[0] = make_float4(xyz[0], xyz[1], xyz[2], xyz[3]);
      xs[1] = make_float4(xyz[4], xyz[5], xyz[6], xyz[7]);
      xs[2] = make_float4(xyz[8], xyz[9], xyz[10], xyz[11]);
      *reinterpret_cast<float4*>(depths + o) = make_float4(t4[0], t4[1], t4[2], t4[3]);
      if (dens != nullptr)
        *reinterpret_cast<float4*>(dens + o) = make_float4(d4[0], d4[1], d4[2], d4[3]);
    } else {                                         // the last quad of the last tile
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (l0 + e < n) {
          xyz_s[3 * (l0 + e)] = xyz[3 * e];
          xyz_s[3 * (l0 + e) + 1] = xyz[3 * e + 1];
          xyz_s[3 * (l0 + e) + 2] = xyz[3 * e + 2];
          depths[o + e] = t4[e];
          if (dens != nullptr) dens[o + e] = d4[e];
        }
      }
    }
    *reinterpret_cast<uint32_t*>(mask_s + l0) = m4;
  }
  __syncthreads();

  // (4) the tile's points as one flat float run and its masks, in 16-byte stores
  const int nf = 3 * n;
  float* gx = samples + 3 * o0;
  for (int i = threadIdx.x; i < nf / 4; i += kMarchThreads)
    reinterpret_cast<float4*>(gx)[i] = reinterpret_cast<const float4*>(xyz_s)[i];
  for (int i = nf / 4 * 4 + threadIdx.x; i < nf; i += kMarchThreads) gx[i] = xyz_s[i];
  uint8_t* gm = mask + o0;
  for (int i = threadIdx.x; i < n / 16; i += kMarchThreads)
    reinterpret_cast<uint4*>(gm)[i] = reinterpret_cast<const uint4*>(mask_s)[i];
  for (int i = n / 16 * 16 + threadIdx.x; i < n; i += kMarchThreads) gm[i] = mask_s[i];
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// jitter: [R, S] uniforms in [0, 1), or null for midpoint samples; ustep: 0 for the 'ray'
// march (K2), float32(2*sqrt(3)/S) for the 'uniform' march (K8). samples, depths, mask and
// dens must start on 16 bytes.
WISP_EXPORT int wisp_raymarch_ray(const float* origins, const float* dirs,
                                  const float* jitter, int R, int S,
                                  int stride, float ustep, float dist_min, float dist_max,
                                  const float* cell_density, int level, float* samples,
                                  float* depths, uint8_t* mask, float* dens, float* deltas,
                                  void* stream) {
  if (R < 0 || S < 1 || stride < 1 || misaligned(samples) || misaligned(depths)
      || misaligned(mask) || (dens != nullptr && misaligned(dens)))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)R * S;
  if (total > 0) {
    // a tile of kMarchTile samples spans at most (kMarchTile - 1) / S + 2 rays
    const int max_rays = (int)min((long long)R, (long long)((kMarchTile - 1) / S + 2));
    const int smem = march_smem_bytes(max_rays);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          raymarch_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    raymarch_tile_kernel<<<wisp::ceil_div(total, kMarchTile), kMarchThreads, smem,
                           (cudaStream_t)stream>>>(origins, dirs, jitter, R, S, stride, ustep,
                                                   dist_min, dist_max, cell_density, level,
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
