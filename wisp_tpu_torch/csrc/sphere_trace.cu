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
// Bound on this card: by bytes 24 bytes of ray, t, t_far, the flags and d a ray, and one
// 4-byte gather of the free-space field (8 MB at level 7, in L2) a step; far below a launch.
// What sets the time is the walk's chain: one thread a ray (a 16,384-ray chunk is about one
// warp a scheduler), so a launch lasts as long as its longest walk times the latency of one
// step, and nothing hides that latency. Design: the walk in registers, and a short step
// (sphere_walker.cuh): one floor an axis for both the cell and the cell plane, and no
// division where the skip (k-1)*voxel is known to be the larger candidate (one product
// and a compare). The results are the plain version's bit for bit (its order, IEEE
// divisions, no fused multiply-add). The earlier design is baselines/sphere_trace_v1.cu.
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
// Bound on this card: by bytes 24 bytes of ray in, 9 bytes out, and one 4-byte gather of the
// free-space field a walk step (8 MB at level 7, in L2), the occupancy and the index map one
// gather each; as K12's walk, the longest walk's chain sets the time. Design: K12's short
// step; after the walk, a ray whose last step found its cell occupied keeps that step's
// point and cell; the occupancy byte and the route's lookup are issued together (the lookup
// used only where the ray hit); the overflowing rays are counted with one atomic a warp (a
// ballot's population count: integers below 2^24, so the float total is the plain
// version's sum of 0/1 floats exactly).
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
    float px, py, pz, qx, qy, qz;
    const int k = w.fsd(free_dist, t, px, py, pz, qx, qy, qz);
    if (k <= 0) break;
    t = t + w.free_step(k, px, py, pz, qx, qy, qz);
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
  // every lane of a warp reaches the ballot below: a lane past N takes no ray
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < N;
  bool alive = false, hit = false, overflow = false;
  float t = 0.0f;
  int pidx = -1;
  if (valid) {
    Walker w;
    w.init(origins, dirs, r, level);
    const float o[3] = {w.ox, w.oy, w.oz};
    const float d[3] = {w.dx, w.dy, w.dz};
    float t_near, t_far;
    wisp::slab_test(o, d, dist_min, dist_max, t_near, t_far);
    t = fmaxf(t_near, 0.0f) + 1e-6f;
    alive = t_far > t;
    float px, py, pz, qx, qy, qz;
    bool at_point = false;   // the last step found the cell at t occupied: p and q are t's
    if (alive) {
      for (int i = 0; i < num_steps; ++i) {
        const int k = w.fsd(free_dist, t, px, py, pz, qx, qy, qz);
        if (k <= 0) {
          at_point = true;
          break;
        }
        t = t + w.free_step(k, px, py, pz, qx, qy, qz);
        if (!(t <= t_far)) {
          alive = false;
          break;
        }
      }
    }
    if (alive) {             // a ray that died neither hits nor overflows
      if (!at_point) {
        w.point(t, px, py, pz);
        qx = w.plane_index(px);
        qy = w.plane_index(py);
        qz = w.plane_index(pz);
      }
      const bool inside = px >= -1.0f && px < 1.0f && py >= -1.0f && py < 1.0f &&
                          pz >= -1.0f && pz < 1.0f;
      bool in_occ = inside;
      if (inside) {
        const int cx = w.cell_coord(qx), cy = w.cell_coord(qy), cz = w.cell_coord(qz);
        // both loads in flight together; the lookup is kept only where the ray hits
        const uint8_t occupied =
            occ != nullptr ? occ[((long long)cx * w.res + cy) * w.res + cz] : (uint8_t)1;
        const int cand = wisp::lookup_cell(route, table, len, level, cx, cy, cz);
        in_occ = occupied != 0;
        if (in_occ) pidx = cand;
      }
      hit = in_occ;
      overflow = !in_occ;
    }
  }
  const unsigned over = __ballot_sync(wisp::kFullMask, overflow);
  if ((threadIdx.x & 31) == 0 && over != 0u) atomicAdd(num_overflow, (float)__popc(over));
  if (!valid) return;
  t_out[r] = t;
  hit_out[r] = (uint8_t)hit;
  pidx_out[r] = pidx;
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
