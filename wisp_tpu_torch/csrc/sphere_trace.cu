// K12 — the NGLOD sphere tracer's walk and step.
//
// Replaces wisp_tpu/tracers/packed_sdf_tracer.py PackedSDFTracer.trace (:84): the
// occupancy-only walk walk_body (:121-129) and one iteration of sphere_loop's body
// (:136-150), with fsd_at (:101), free_step (:111) and ops/geometric.py voxel_boundary_step
// (:93). fsd_at: the point o + t*d, its max-level cell's free-space distance k (2^30 outside
// [-1,1)^3). free_step: max((k-1)*voxel, the distance to the next cell plane plus
// 1e-3*voxel).
//
// sdf_walk: per ray, num_steps iterations of: if alive and k > 0, t += free_step; then
// alive &= t <= t_far. A ray whose cell is occupied (k == 0) or that died is frozen by
// JAX's masks, so the kernel stops there and the result is the same.
// sphere_step: one iteration given the field d at the ray's point: in an occupied cell a
// live ray hits when |d| < min_dis, else steps max(d*step_size, 0); in free space it takes
// the free step; a live ray past t_far dies. t, alive and hit are updated in place.
//
// Bound on this card: bytes. Per ray 24 bytes of ray, t, t_far, the flags and d, and one
// 4-byte gather of the free-space field (8 MB at level 7, in L2) a step. Design: one thread
// a ray; the walk keeps its state in registers for all its steps. The float operations are
// the plain version's, in its order (true divisions, no fused multiply-add), so t agrees bit
// for bit.
#include "common.cuh"

namespace {

constexpr int kOutside = 1 << 30;

struct Walker {
  float ox, oy, oz, dx, dy, dz;
  int level, res;
  float half_res, voxel, eps_step;

  __device__ void init(const float* origins, const float* dirs, long long r, int lvl) {
    ox = origins[3 * r]; oy = origins[3 * r + 1]; oz = origins[3 * r + 2];
    dx = dirs[3 * r]; dy = dirs[3 * r + 1]; dz = dirs[3 * r + 2];
    level = lvl;
    res = 1 << lvl;
    half_res = (float)res / 2.0f;
    voxel = 2.0f / (float)res;
    eps_step = (float)(1e-3 * (double)voxel);
  }

  // free-space distance at depth t; writes the point
  __device__ int fsd(const int* __restrict__ free_dist, float t, float& px, float& py,
                     float& pz) const {
    px = ox + t * dx;
    py = oy + t * dy;
    pz = oz + t * dz;
    const bool inside = px >= -1.0f && px < 1.0f && py >= -1.0f && py < 1.0f &&
                        pz >= -1.0f && pz < 1.0f;
    if (!inside) return kOutside;
    const int qx = min(max((int)floorf((px + 1.0f) * half_res), 0), res - 1);
    const int qy = min(max((int)floorf((py + 1.0f) * half_res), 0), res - 1);
    const int qz = min(max((int)floorf((pz + 1.0f) * half_res), 0), res - 1);
    return __ldg(free_dist + ((long long)qx * res + qy) * res + qz);
  }

  __device__ float plane_dt(float p, float d) const {
    const float q = floorf((p + 1.0f) / voxel);
    const float next_plane = -1.0f + (q + (d > 0.0f ? 1.0f : 0.0f)) * voxel;
    const float dt = fabsf(d) > 1e-12f ? (next_plane - p) / d : INFINITY;
    return fmaxf(dt, 0.0f);
  }

  __device__ float free_step(int k, float px, float py, float pz) const {
    const float skip = ((float)k - 1.0f) * voxel;
    const float dt = fminf(fminf(plane_dt(px, dx), plane_dt(py, dy)), plane_dt(pz, dz));
    return fmaxf(skip, dt + eps_step);
  }
};

__global__ void sdf_walk_kernel(const float* __restrict__ origins,
                                const float* __restrict__ dirs, float* __restrict__ t_io,
                                uint8_t* __restrict__ alive_io,
                                const float* __restrict__ t_far_in,
                                const int* __restrict__ free_dist, long long N, int level,
                                int num_steps) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  if (!alive_io[r]) return;
  Walker w;
  w.init(origins, dirs, r, level);
  const float t_far = t_far_in[r];
  float t = t_io[r];
  bool alive = true;
  for (int i = 0; i < num_steps; ++i) {
    float px, py, pz;
    const int k = w.fsd(free_dist, t, px, py, pz);
    if (k <= 0) break;
    t = t + w.free_step(k, px, py, pz);
    if (!(t <= t_far)) {
      alive = false;
      break;
    }
  }
  t_io[r] = t;
  alive_io[r] = (uint8_t)alive;
}

__global__ void sphere_step_kernel(const float* __restrict__ origins,
                                   const float* __restrict__ dirs, float* __restrict__ t_io,
                                   uint8_t* __restrict__ alive_io, uint8_t* __restrict__ hit_io,
                                   const float* __restrict__ t_far_in,
                                   const float* __restrict__ d_in,
                                   const int* __restrict__ free_dist, long long N, int level,
                                   float step_size, float min_dis) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  if (!alive_io[r]) return;
  Walker w;
  w.init(origins, dirs, r, level);
  const float t = t_io[r];
  const float d = d_in[r];
  float px, py, pz;
  const int k = w.fsd(free_dist, t, px, py, pz);
  const bool in_occ = k == 0;
  if (in_occ && fabsf(d) < min_dis) {
    hit_io[r] = 1;
    alive_io[r] = 0;
    return;
  }
  float step;
  if (in_occ) {
    const float v = d * step_size;
    step = v < 0.0f ? 0.0f : v;   // max(v, 0), NaN kept as JAX's maximum keeps it
  } else {
    step = w.free_step(k, px, py, pz);
  }
  const float t_new = t + step;
  t_io[r] = t_new;
  alive_io[r] = (uint8_t)(t_new <= t_far_in[r]);
}

}  // namespace

WISP_EXPORT int wisp_sdf_walk(const float* origins, const float* dirs, float* t,
                              uint8_t* alive, const float* t_far, const int* free_dist,
                              long long N, int level, int num_steps, void* stream) {
  if (N > 0) {
    const int threads = 128;
    sdf_walk_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        origins, dirs, t, alive, t_far, free_dist, N, level, num_steps);
  }
  return (int)cudaGetLastError();
}

WISP_EXPORT int wisp_sphere_step(const float* origins, const float* dirs, float* t,
                                 uint8_t* alive, uint8_t* hit, const float* t_far,
                                 const float* d, const int* free_dist, long long N, int level,
                                 float step_size, float min_dis, void* stream) {
  if (N > 0) {
    const int threads = 256;
    sphere_step_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        origins, dirs, t, alive, hit, t_far, d, free_dist, N, level, step_size, min_dis);
  }
  return (int)cudaGetLastError();
}
