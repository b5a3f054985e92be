// K12's ray walker and sphere step, shared by sphere_trace.cu (K12's walk and step, K13) and
// octree_grid.cu (the sphere iteration, which takes the step at its head).
//
// fsd: the point o + t*d and its max-level cell's free-space distance k (kOutside outside
// [-1,1)^3), wisp_tpu/tracers/packed_sdf_tracer.py fsd_at (:101). free_step: max((k-1)*voxel,
// the distance to the next cell plane plus 1e-3*voxel), free_step (:111) and
// ops/geometric.py voxel_boundary_step (:93). step: one iteration of sphere_loop's body
// (:136-150) for a live ray. The float operations are the plain version's, in its order
// (true divisions; the library is built without fused multiply-add), so t agrees bit for
// bit.
#pragma once

#include "common.cuh"

namespace wisp {

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

  // the point at depth t: the product, then the sum (o + t * d, as the plain version)
  __device__ void point(float t, float& px, float& py, float& pz) const {
    px = ox + t * dx;
    py = oy + t * dy;
    pz = oz + t * dz;
  }

  // free-space distance at depth t; writes the point
  __device__ int fsd(const int* __restrict__ free_dist, float t, float& px, float& py,
                     float& pz) const {
    point(t, px, py, pz);
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

  // One sphere step of a live ray at depth t given the field d at its point: in an occupied
  // cell it hits when |d| < min_dis (t kept), else steps max(d*step_size, 0); in free space
  // it takes the free step. Returns whether it hit; t is updated where it did not.
  __device__ bool step(const int* __restrict__ free_dist, float& t, float d, float step_size,
                       float min_dis) const {
    float px, py, pz;
    const int k = fsd(free_dist, t, px, py, pz);
    const bool in_occ = k == 0;
    if (in_occ && fabsf(d) < min_dis) return true;
    float s;
    if (in_occ) {
      const float v = d * step_size;
      s = v < 0.0f ? 0.0f : v;   // max(v, 0), NaN kept as JAX's maximum keeps it
    } else {
      s = free_step(k, px, py, pz);
    }
    t = t + s;
    return false;
  }
};

}  // namespace wisp
