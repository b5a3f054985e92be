// K12's ray walker and sphere step, shared by sphere_trace.cu (K12's walk and step, K13) and
// octree_grid.cu (the sphere iteration, which takes the step at its head).
//
// fsd: the point o + t*d and its max-level cell's free-space distance k (kOutside outside
// [-1,1)^3), wisp_tpu/tracers/packed_sdf_tracer.py fsd_at (:101). free_step: max((k-1)*voxel,
// the distance to the next cell plane plus 1e-3*voxel), free_step (:111) and
// ops/geometric.py voxel_boundary_step (:93). step: one iteration of sphere_loop's body
// (:136-150) for a live ray. t agrees bit for bit with the plain version: its products and
// sums are made in its order (the library is built without fused multiply-add), its
// divisions are IEEE divisions, and the two rules below change no result.
//
// A step is one dependent chain (the point, the cell, the field's gather, the step, the new
// t), and a walk is that chain repeated, so the walker keeps the chain short:
//
// (a) One floor an axis. The plain version floors (p + 1) * half_res for the cell and
//     (p + 1) / voxel for the cell plane below p. voxel = 2^(1 - level) and half_res =
//     2^(level - 1) are powers of two with voxel * half_res = 1, so the quotient and the
//     product are the same real number, and IEEE arithmetic rounds both to the same float.
//     fsd computes q = floor((p + 1) * half_res) once: clamped to [0, res) it is the cell,
//     as it is it is the plane's index. Three divisions and three floors fewer a step.
//
// (b) No division for a far step. For a point in the box and a ray whose largest moving
//     |d_a| is m (|d_a| > 1e-12, as the plain version's test), the step is the skip
//     s = (k - 1) * voxel, and the three (next_plane - p) / d are not computed, where
//     fl(fl(s - eps_step) * m) >= v (1 + 2^-10): a product and a compare a step, and no
//     division (a bound precomputed once a ray would cost one, which a kernel that takes a
//     single step does not earn back; such a kernel takes the full step, see step()). Proof that the plain version's
//     max(s, fl(dt + eps_step)) is then s, at levels 0-10 (voxel v >= 2^-9), on each axis
//     with p in [-1, 1):
//     1. s_p = fl(p + 1) lies in [0, 2], within 2^-24 of p + 1 (half an ulp of a float
//        below 2); it may round up onto a plane.
//     2. q = floor(s_p / v), so q v <= s_p < (q + 1) v, with q an integer in [0, 2^level].
//     3. next_plane = -1 + (q + b) v, b in {0, 1}, is exact: (q + b) v is a multiple of
//        2^-9 no larger than 4, and so is -1 plus it.
//     4. next_plane - p = ((q + b) v - s_p) + (s_p - (p + 1)): (q + 1) v - s_p lies in
//        (0, v] and q v - s_p in (-v, 0], so |next_plane - p| <= v + 2^-24 <= v (1 + 2^-15).
//     5. Rounding the difference and dividing it by d_a each scale it by at most 1 + 2^-24,
//        so |dt_a| <= v (1 + 2^-15)(1 + 2^-24)^2 / |d_a|, or dt_a is a subnormal (a
//        difference that rounds to a subnormal is exact).
//     6. dt, the least of max(dt_a, 0) over the moving axes, is at most that of the axis
//        with |d_a| = m: dt <= v (1 + 2^-15)(1 + 2^-22) / m, or below 2^-126.
//     7. The test passes only with fl(s - eps_step) > 0, and rounding the difference and the
//        product each scale by at most 1 + 2^-24 (an overflow to +inf only where the exact
//        product is larger still), so s - eps_step >= v (1 + 2^-10)(1 - 2^-23) / m, which is
//        above v (1 + 2^-15)(1 + 2^-22) / m; and s - eps_step, at least 0.998 v (k >= 2),
//        is above 2^-126.
//        So s > dt + eps_step, and as s is a float, s >= fl(dt + eps_step).
//     A ray with no moving axis (m = 0; a NaN component does not move) never passes the
//     test; a point outside the box (k = kOutside), where step 1 does not hold, takes the
//     full step. K11's distances are powers of two up to 32, so with a unit direction
//     (m >= 1/sqrt(3)) every step with k >= 4 takes this path.
#pragma once

#include "common.cuh"

namespace wisp {

constexpr int kOutside = 1 << 30;
constexpr float kFarSlack = 1.0f + 0x1p-10f;   // rule (b)'s 1 + 2^-10

// |d|, or 0 where the axis does not move (|d| <= 1e-12 or NaN)
__device__ __forceinline__ float moving_abs(float d) {
  return fabsf(d) > 1e-12f ? fabsf(d) : 0.0f;
}

struct Walker {
  float ox, oy, oz, dx, dy, dz;
  int level, res;
  float half_res, voxel, eps_step;
  float m, far_min;   // rule (b): the largest moving |d_a|, and v (1 + 2^-10)

  __device__ void init(const float* origins, const float* dirs, long long r, int lvl) {
    ox = origins[3 * r]; oy = origins[3 * r + 1]; oz = origins[3 * r + 2];
    dx = dirs[3 * r]; dy = dirs[3 * r + 1]; dz = dirs[3 * r + 2];
    level = lvl;
    res = 1 << lvl;
    half_res = (float)res / 2.0f;
    voxel = 2.0f / (float)res;
    eps_step = (float)(1e-3 * (double)voxel);
    m = fmaxf(fmaxf(moving_abs(dx), moving_abs(dy)), moving_abs(dz));
    far_min = voxel * kFarSlack;
  }

  // the point at depth t: the product, then the sum (o + t * d, as the plain version)
  __device__ void point(float t, float& px, float& py, float& pz) const {
    px = ox + t * dx;
    py = oy + t * dy;
    pz = oz + t * dz;
  }

  // rule (a)'s q of one coordinate
  __device__ float plane_index(float p) const { return floorf((p + 1.0f) * half_res); }

  __device__ int cell_coord(float q) const { return min(max((int)q, 0), res - 1); }

  __device__ long long cell(float qx, float qy, float qz) const {
    return ((long long)cell_coord(qx) * res + cell_coord(qy)) * res + cell_coord(qz);
  }

  // free-space distance at depth t; writes the point and its plane indices q
  __device__ int fsd(const int* __restrict__ free_dist, float t, float& px, float& py,
                     float& pz, float& qx, float& qy, float& qz) const {
    point(t, px, py, pz);
    qx = plane_index(px);
    qy = plane_index(py);
    qz = plane_index(pz);
    const bool inside = px >= -1.0f && px < 1.0f && py >= -1.0f && py < 1.0f &&
                        pz >= -1.0f && pz < 1.0f;
    if (!inside) return kOutside;
    return __ldg(free_dist + cell(qx, qy, qz));
  }

  __device__ float plane_dt(float p, float q, float d) const {
    const float next_plane = -1.0f + (q + (d > 0.0f ? 1.0f : 0.0f)) * voxel;
    const float dt = fabsf(d) > 1e-12f ? (next_plane - p) / d : INFINITY;
    return fmaxf(dt, 0.0f);
  }

  // the plain version's free step, max(skip, dt + eps_step)
  __device__ float full_step(float skip, float px, float py, float pz, float qx, float qy,
                             float qz) const {
    const float dt =
        fminf(fminf(plane_dt(px, qx, dx), plane_dt(py, qy, dy)), plane_dt(pz, qz, dz));
    return fmaxf(skip, dt + eps_step);
  }

  // a walk's free step: rule (b), else the full step
  __device__ float free_step(int k, float px, float py, float pz, float qx, float qy,
                             float qz) const {
    const float skip = ((float)k - 1.0f) * voxel;
    if (k != kOutside && (skip - eps_step) * m >= far_min) return skip;   // rule (b)
    return full_step(skip, px, py, pz, qx, qy, qz);
  }

  // One sphere step of a live ray at depth t given the field d at its point: in an occupied
  // cell it hits when |d| < min_dis (t kept), else steps max(d*step_size, 0); in free space
  // it takes the full free step: rule (b)'s product and branch, taken once a launch, cost
  // the sphere iteration more than the divisions they save. Returns whether it hit; t is
  // updated where it did not.
  __device__ bool step(const int* __restrict__ free_dist, float& t, float d, float step_size,
                       float min_dis) const {
    float px, py, pz, qx, qy, qz;
    const int k = fsd(free_dist, t, px, py, pz, qx, qy, qz);
    const bool in_occ = k == 0;
    if (in_occ && fabsf(d) < min_dis) return true;
    float s;
    if (in_occ) {
      const float v = d * step_size;
      s = v < 0.0f ? 0.0f : v;   // max(v, 0), NaN kept as JAX's maximum keeps it
    } else {
      s = full_step(((float)k - 1.0f) * voxel, px, py, pz, qx, qy, qz);
    }
    t = t + s;
    return false;
  }
};

}  // namespace wisp
