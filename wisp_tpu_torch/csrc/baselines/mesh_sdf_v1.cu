// The earlier design of K16 (wisp_mesh_sdf) and K17 (wisp_closest_point), kept as the
// yardstick of the redesign in ../mesh_sdf.cu: chip_smoke.py builds this file into its own
// library beside the kernel library and reports its time on the same inputs as the K16 and
// K17 rows' ``was_ms`` and in its "mesh" step. Nothing in the package calls it.
//
// Design: one thread a point, 256 threads a block; the block stages tiles of 256 rows of
// the [T, 15] triangle table through shared memory (scalar loads), and every pair
// recomputes the triangle's own terms and divides by IEEE division. K16 makes two passes
// over the triangles: the minimum squared distance, then the pseudonormal vote of the
// triangles in its band, each pair's closest point computed again. K17 is the first pass
// with the argument kept. Entry points: wisp_mesh_sdf_v1 and wisp_closest_point_v1, with
// the arguments of the kernel library's wisp_mesh_sdf and wisp_closest_point.
#include "common.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kTriFloats = 15;  // va, vb, vc, face normal, the three vertex angles
constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* s) { return {s[0], s[1], s[2]}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float d2_to(V3 p, V3 q) {
  const V3 e = sub(p, q);
  return dot(e, e);
}

__device__ __forceinline__ V3 edge_proj(V3 p, V3 e0, V3 e1) {
  const V3 d = sub(e1, e0);
  float t = dot(sub(p, e0), d) / fmaxf(dot(d, d), 1e-20f);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return {e0.x + t * d.x, e0.y + t * d.y, e0.z + t * d.z};
}

// closest_point_on_triangle of ops/mesh/ops.py, operation for operation.
__device__ __forceinline__ V3 closest_point(V3 p, V3 a, V3 b, V3 c) {
  const V3 cand_ab = edge_proj(p, a, b);
  const V3 cand_bc = edge_proj(p, b, c);
  const V3 cand_ca = edge_proj(p, c, a);
  const V3 ab = sub(b, a), ac = sub(c, a);
  const V3 n = cross(ab, ac);
  const float nn = fmaxf(dot(n, n), 1e-20f);
  const float dist_plane = dot(sub(p, a), n) / nn;
  const V3 proj = {p.x - dist_plane * n.x, p.y - dist_plane * n.y, p.z - dist_plane * n.z};
  const V3 v2 = sub(proj, a);
  const float d00 = dot(ab, ab), d01 = dot(ab, ac), d11 = dot(ac, ac);
  const float d20 = dot(v2, ab), d21 = dot(v2, ac);
  const float denom = fmaxf(d00 * d11 - d01 * d01, 1e-20f);
  const float v = (d11 * d20 - d01 * d21) / denom;
  const float w = (d00 * d21 - d01 * d20) / denom;
  const bool inside = (v >= 0.0f) && (w >= 0.0f) && (v + w <= 1.0f);
  if (inside) return proj;
  V3 best = cand_ab;
  if (d2_to(p, cand_bc) < d2_to(p, best)) best = cand_bc;
  if (d2_to(p, cand_ca) < d2_to(p, best)) best = cand_ca;
  return best;
}

// The vote of one triangle whose d^2 lies in the band (compute_sdf.py:56-93).
__device__ __forceinline__ float vote(V3 p, V3 cp, const float* tri) {
  const V3 va = load3(tri), vb = load3(tri + 3), vc = load3(tri + 6);
  const V3 nrm = load3(tri + 9);
  const V3 v0 = sub(vb, va), v1 = sub(vc, va), v2 = sub(cp, va);
  const float d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  const float d20 = dot(v2, v0), d21 = dot(v2, v1);
  const float denom = fmaxf(d00 * d11 - d01 * d01, 1e-20f);
  const float bv = (d11 * d20 - d01 * d21) / denom;
  const float bw = (d00 * d21 - d01 * d20) / denom;
  const float bu = 1.0f - bv - bw;
  const float eb = 1e-4f;
  const bool at_a = (bv < eb) && (bw < eb);
  const bool at_b = (bu < eb) && (bw < eb);
  const bool at_c = (bu < eb) && (bv < eb);
  const bool on_vertex = at_a || at_b || at_c;
  const bool on_edge = !on_vertex && ((bu < eb) || (bv < eb) || (bw < eb));
  const float vertex_angle = at_a ? tri[12] : (at_b ? tri[13] : tri[14]);
  const float alpha = on_vertex ? vertex_angle : (on_edge ? kPi : kTwoPi);
  return alpha * dot(sub(p, cp), nrm);
}

__device__ __forceinline__ void stage(float* tile, const float* __restrict__ tris, int t0,
                                      int nt) {
  __syncthreads();
  for (int k = threadIdx.x; k < nt * kTriFloats; k += blockDim.x)
    tile[k] = __ldg(tris + (long long)t0 * kTriFloats + k);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    mesh_sdf_kernel(const float* __restrict__ points, long long P,
                    const float* __restrict__ tris, int T, float* __restrict__ out) {
  __shared__ float tile[kTile * kTriFloats];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < P;
  const V3 p = active ? V3{points[3 * i], points[3 * i + 1], points[3 * i + 2]}
                      : V3{0.0f, 0.0f, 0.0f};
  // pass 1: the minimum squared distance
  float d2min = INFINITY;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    stage(tile, tris, t0, nt);
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const float* tri = tile + t * kTriFloats;
        const V3 cp = closest_point(p, load3(tri), load3(tri + 3), load3(tri + 6));
        d2min = fminf(d2min, d2_to(p, cp));
      }
    }
  }
  // pass 2: the pseudonormal vote of the triangles in the band
  const float limit = d2min + (1e-8f + 1e-4f * d2min);
  float s = 0.0f;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    stage(tile, tris, t0, nt);
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const float* tri = tile + t * kTriFloats;
        const V3 cp = closest_point(p, load3(tri), load3(tri + 3), load3(tri + 6));
        if (d2_to(p, cp) <= limit) s += vote(p, cp, tri);
      }
    }
  }
  if (active) out[i] = s < 0.0f ? -sqrtf(d2min) : sqrtf(d2min);
}

__global__ void __launch_bounds__(kThreads)
    closest_point_kernel(const float* __restrict__ points, long long P,
                         const float* __restrict__ tris, int T, float* __restrict__ dist,
                         float* __restrict__ nearest, long long* __restrict__ tidx) {
  __shared__ float tile[kTile * kTriFloats];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < P;
  const V3 p = active ? V3{points[3 * i], points[3 * i + 1], points[3 * i + 2]}
                      : V3{0.0f, 0.0f, 0.0f};
  float d2min = INFINITY;
  V3 best = {0.0f, 0.0f, 0.0f};
  int best_t = 0;
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    stage(tile, tris, t0, nt);
    if (active) {
      for (int t = 0; t < nt; ++t) {
        const float* tri = tile + t * kTriFloats;
        const V3 cp = closest_point(p, load3(tri), load3(tri + 3), load3(tri + 6));
        const float d2 = d2_to(p, cp);
        if (d2 < d2min) {
          d2min = d2;
          best = cp;
          best_t = t0 + t;
        }
      }
    }
  }
  if (active) {
    dist[i] = sqrtf(d2min);
    nearest[3 * i] = best.x;
    nearest[3 * i + 1] = best.y;
    nearest[3 * i + 2] = best.z;
    tidx[i] = best_t;
  }
}

}  // namespace

// K17. points [P, 3]; tris [T, 15] (K16's table; the corners are read); dist [P],
// nearest [P, 3], tidx [P].
WISP_EXPORT int wisp_closest_point_v1(const float* points, long long P, const float* tris,
                                      int T, float* dist, float* nearest, long long* tidx,
                                      void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    closest_point_kernel<<<wisp::ceil_div(P, kThreads), kThreads, 0,
                           (cudaStream_t)stream>>>(points, P, tris, T, dist, nearest, tidx);
  }
  return (int)cudaGetLastError();
}

// points [P, 3]; tris [T, 15] (va, vb, vc, unit face normal, interior angles at a, b, c);
// out [P].
WISP_EXPORT int wisp_mesh_sdf_v1(const float* points, long long P, const float* tris, int T,
                                 float* out, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    mesh_sdf_kernel<<<wisp::ceil_div(P, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
        points, P, tris, T, out);
  }
  return (int)cudaGetLastError();
}
