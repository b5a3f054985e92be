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
//
// K13 — the SPC tracer's first-hit walk, fused.
//
// Replaces wisp_tpu/tracers/packed_spc_tracer.py PackedSPCTracer.trace (:50-93): the slab
// test, t = max(t_near, 0) + 1e-6, alive = t_far > t; the walk walk_body (:62-73), which is
// K12's walk (the same Walker, the same steps); then at the final point o + t*d the
// occupancy test (occupancy_at: in [-1,1)^3 and, where the octree has one, the max-level
// occupancy), has_hit = alive & occupied, the cell index of a hit by the max level's route
// (query(pos).pidx through octree_lookup.cuh, K9's lookup), else -1, and the ray's share of
// num_overflow (alive and not in an occupied cell: the walk's budget ran out) added to one
// float. Outputs: t, hit and pidx a ray.
//
// Bound on this card: bytes. Per ray 24 bytes of ray in, 9 bytes out, and one 4-byte gather
// of the free-space field a walk step (8 MB at level 7, in L2); the occupancy and the index
// map add one gather each. Design: one thread a ray, the walk in registers; the overflow
// count takes one atomic per overflowing ray.
#include "common.cuh"
#include "octree_lookup.cuh"
#include "sphere_walker.cuh"

namespace {

using wisp::Walker;

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
  float t = t_io[r];
  if (w.step(free_dist, t, d_in[r], step_size, min_dis)) {
    hit_io[r] = 1;
    alive_io[r] = 0;
    return;
  }
  t_io[r] = t;
  alive_io[r] = (uint8_t)(t <= t_far_in[r]);
}


__global__ void spc_trace_kernel(const float* __restrict__ origins,
                                 const float* __restrict__ dirs, long long N, float dist_min,
                                 float dist_max, const int* __restrict__ free_dist,
                                 const uint8_t* __restrict__ occ, int level, int num_steps,
                                 int route, const void* table, long long len,
                                 float* __restrict__ t_out, uint8_t* __restrict__ hit_out,
                                 int* __restrict__ pidx_out, float* __restrict__ num_overflow) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  Walker w;
  w.init(origins, dirs, r, level);
  const float o[3] = {w.ox, w.oy, w.oz};
  const float d[3] = {w.dx, w.dy, w.dz};
  float t_near, t_far;
  wisp::slab_test(o, d, dist_min, dist_max, t_near, t_far);
  float t = fmaxf(t_near, 0.0f) + 1e-6f;
  bool alive = t_far > t;
  float px, py, pz;
  if (alive) {
    for (int i = 0; i < num_steps; ++i) {
      const int k = w.fsd(free_dist, t, px, py, pz);
      if (k <= 0) break;
      t = t + w.free_step(k, px, py, pz);
      if (!(t <= t_far)) {
        alive = false;
        break;
      }
    }
  }
  w.point(t, px, py, pz);
  const bool inside = px >= -1.0f && px < 1.0f && py >= -1.0f && py < 1.0f && pz >= -1.0f &&
                      pz < 1.0f;
  int qx = 0, qy = 0, qz = 0;
  bool in_occ = inside;
  if (inside) {
    qx = min(max((int)floorf((px + 1.0f) * w.half_res), 0), w.res - 1);
    qy = min(max((int)floorf((py + 1.0f) * w.half_res), 0), w.res - 1);
    qz = min(max((int)floorf((pz + 1.0f) * w.half_res), 0), w.res - 1);
    if (occ != nullptr) in_occ = occ[((long long)qx * w.res + qy) * w.res + qz] != 0;
  }
  const bool hit = alive && in_occ;
  if (alive && !in_occ) atomicAdd(num_overflow, 1.0f);
  t_out[r] = t;
  hit_out[r] = (uint8_t)hit;
  pidx_out[r] = hit ? wisp::lookup_cell(route, table, len, level, qx, qy, qz) : -1;
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

// K13. occ: the max-level occupancy bytes [8^level], or null (a dense octree, or none: the
// box alone); route/table/len: the max level's lookup (see wisp::Route); num_overflow: one
// zeroed float.
WISP_EXPORT int wisp_spc_trace(const float* origins, const float* dirs, long long N,
                               float dist_min, float dist_max, const int* free_dist,
                               const uint8_t* occ, int level, int num_steps, int route,
                               const void* table, long long len, float* t, uint8_t* hit,
                               int* pidx, float* num_overflow, void* stream) {
  if (level < 0 || level >= wisp::kMaxLevels || route < wisp::kMap ||
      route > wisp::kBitfield || (route == wisp::kSearch && len < 1))
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    const int threads = 128;
    spc_trace_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        origins, dirs, N, dist_min, dist_max, free_dist, occ, level, num_steps, route, table,
        len, t, hit, pidx, num_overflow);
  }
  return (int)cudaGetLastError();
}
