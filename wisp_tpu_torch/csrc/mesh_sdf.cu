// K16 — exact point-to-mesh signed distance.
//
// Replaces wisp_tpu/ops/mesh/compute_sdf.py _dist_chunk (:48) and _sign_chunk (:56), driven
// by _compute_sdf_host (:111): the distance from each point to its closest triangle,
// signed by the angle-weighted pseudonormal vote. The distance is sqrt(d2min), the least
// squared distance over all triangles; the vote sums alpha_t * dot(n_t, p - cp_t) over the
// triangles whose d^2 lies within the band d2min + (1e-8 + 1e-4 * d2min), in ascending
// triangle order, alpha_t being the interior angle at a vertex, pi on an edge and 2 pi
// inside the face (classified by the barycentrics of cp_t with a margin of 1e-4). The sign
// is -1 iff the sum is below 0.
//
// One pass over the triangles. JAX runs two passes over [points x triangles] tiles,
// because the band needs the global d2min. Here a thread keeps, for each of its points,
// the running minimum m and a list of up to kCandidates (triangle, d^2) pairs: every
// triangle whose d^2 was within the band of the running minimum when it was visited, in
// ascending order. This is exact. The band's limit is monotone in m (each of its three
// float operations is) and m only falls, so a triangle of the final band was inside the
// band of the running minimum when it was visited and was taken; a candidate outside the
// band of the current m is outside the final band too, so dropping it loses nothing.
// Candidates are dropped when the list is full (the list a drop at every new minimum
// would keep). At the end the candidates still inside d2min's band vote in ascending
// order, their closest points made again from their rows of the (L2-resident) table. The
// list lives in the thread's column of two shared arrays: held in registers with static
// indices, it cost the pair loop registers, blocks an SM and time on the H100.
//
// Overflow is a path, not a fallback. A point whose band of the running minimum ever
// holds more than kCandidates triangles when one more arrives (a vertex of valence above
// 8, a point on the medial axis: a sphere's centre, a bipyramid's axis) sets a flag; if
// any point of a block did, the block stages the tiles again and runs the second pass of
// the earlier design for its flagged points only: every triangle's closest point and d^2
// again, and the vote of those in the band, in ascending order. The result is the same
// either way.
//
// The triangle's own terms are made once a tile. While a block stages a tile of kTile
// triangles into shared memory, a thread a triangle derives the terms of closest_point
// that depend on the triangle alone (edge vectors, each edge's clamped dot(d, d), the
// normal n and nn, d00, d01, d11, denom) in the operations and order in which the plain
// version makes them for every pair, so they are the same bits, and the correctly rounded
// reciprocal of each of the five divisors (edge ca's direction, -ac bit for bit, is not
// stored). A triangle is 9 float4s of the tile, read by every thread of a warp at once (a
// broadcast). The pair loop does only the arithmetic that depends on the point. Each of
// its six quotients num / den is q = num * rcp corrected by one residual step,
// q + fma(-q, den, num) * rcp (Markstein's scheme; an explicit fma, which --fmad=false
// leaves alone): the correctly rounded quotient away from underflow and overflow, so the
// plain version's IEEE division. The rest is the plain version's arithmetic
// (ops/mesh/ops.py closest_point_on_triangle) in the same float order, built without fused
// multiply-add, so the distance and every closest point equal the plain version's bit for
// bit, and the vote differs only by the order in which PyTorch sums it.
//
// Bound on this card: float32 operations, not bytes (a point reads 12 bytes and writes
// 4), counted as the function needs them: one closest point and its d^2 a point-triangle
// pair (129 operations, the triangle's own terms left out), the vote only for the pairs in
// the band (a handful a point), the triangle's terms once a triangle. The earlier design's
// bound counted ~290 a pair over two passes. The pair loop issues ~150 instructions a pair
// (no division, no triangle term, 9 shared loads). Blocks of 128 threads, compiled for at
// least 4 blocks an SM; two points a thread where the call fills every SM with two blocks
// of them (each shared load then feeds two pairs), else one, so that a small call still
// spreads over the card.
//
// K17 — the nearest surface point.
//
// Replaces wisp_tpu/ops/mesh/compute_sdf.py closest_point (:144), the [points x triangles]
// brute force of the texture path (closest_tex): for each point, the closest point cp_t on
// every triangle (closest_point_on_triangle, ops/mesh/ops.py:144), its squared distance,
// and the first triangle of least distance (jnp.argmin's rule: a strict < over triangles
// in ascending order). Outputs: the distance sqrt(d2min) [P], the point cp [P, 3] and the
// triangle [P] int64. It is K16's pass with the argument kept: the same tiles of triangle
// terms, the same pair routine and the same points a thread; the thread keeps (d^2,
// triangle) and makes the closest point of its triangle again at the end, so the result
// equals the plain version's unless two triangles tie within rounding. Bound: float32
// operations (129 a pair), not bytes (a point reads 12 bytes and writes 24).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;     // threads a block, and triangles a tile (one each)
constexpr int kTile = kThreads;
constexpr int kTriFloats = 15;    // a row of the table: va, vb, vc, face normal, 3 angles
constexpr int kTermVecs = 9;      // float4s of a triangle's terms in the tile
constexpr int kCandidates = 8;    // K16's list a point (compute_sdf.py MESH_SDF_CANDIDATES)
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ldg3(const float* s) {
  return {__ldg(s), __ldg(s + 1), __ldg(s + 2)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float d2_to(V3 p, V3 q) {
  const V3 e = sub(p, q);
  return dot(e, e);
}

// The terms of closest_point that depend on the triangle alone. Edge ca's direction a - c
// is -ac bit for bit (rounding to nearest is symmetric), so it is not stored.
struct Tri {
  V3 a, b, c;
  V3 ab, bc, ac;               // b - a, c - b, c - a
  V3 n;                        // cross(ab, ac)
  float dd_ab, dd_bc, dd_ca;   // fmaxf(dot(d, d), 1e-20) of each edge's direction d
  float r_ab, r_bc, r_ca;      // their reciprocals, correctly rounded
  float nn, r_nn;              // fmaxf(dot(n, n), 1e-20) and its reciprocal
  float d00, d01, d11;         // dot(ab, ab), dot(ab, ac), dot(ac, ac)
  float denom, r_denom;        // fmaxf(d00 * d11 - d01 * d01, 1e-20) and its reciprocal
};

// A row of the table -> its terms, in the plain version's operations and order.
__device__ __forceinline__ Tri derive(const float* __restrict__ row) {
  Tri t;
  t.a = ldg3(row);
  t.b = ldg3(row + 3);
  t.c = ldg3(row + 6);
  t.ab = sub(t.b, t.a);
  t.bc = sub(t.c, t.b);
  t.ac = sub(t.c, t.a);
  const V3 ca = neg(t.ac);
  t.dd_ab = fmaxf(dot(t.ab, t.ab), 1e-20f);
  t.dd_bc = fmaxf(dot(t.bc, t.bc), 1e-20f);
  t.dd_ca = fmaxf(dot(ca, ca), 1e-20f);
  t.n = cross(t.ab, t.ac);
  t.nn = fmaxf(dot(t.n, t.n), 1e-20f);
  t.d00 = dot(t.ab, t.ab);
  t.d01 = dot(t.ab, t.ac);
  t.d11 = dot(t.ac, t.ac);
  t.denom = fmaxf(t.d00 * t.d11 - t.d01 * t.d01, 1e-20f);
  t.r_ab = __frcp_rn(t.dd_ab);
  t.r_bc = __frcp_rn(t.dd_bc);
  t.r_ca = __frcp_rn(t.dd_ca);
  t.r_nn = __frcp_rn(t.nn);
  t.r_denom = __frcp_rn(t.denom);
  return t;
}

__device__ __forceinline__ void pack(float4* s, const Tri& t) {
  s[0] = make_float4(t.a.x, t.a.y, t.a.z, t.b.x);
  s[1] = make_float4(t.b.y, t.b.z, t.c.x, t.c.y);
  s[2] = make_float4(t.c.z, t.ab.x, t.ab.y, t.ab.z);
  s[3] = make_float4(t.bc.x, t.bc.y, t.bc.z, t.ac.x);
  s[4] = make_float4(t.ac.y, t.ac.z, t.n.x, t.n.y);
  s[5] = make_float4(t.n.z, t.dd_ab, t.dd_bc, t.dd_ca);
  s[6] = make_float4(t.r_ab, t.r_bc, t.r_ca, t.nn);
  s[7] = make_float4(t.r_nn, t.d00, t.d01, t.d11);
  s[8] = make_float4(t.denom, t.r_denom, 0.0f, 0.0f);
}

__device__ __forceinline__ Tri unpack(const float4* s) {
  const float4 q0 = s[0], q1 = s[1], q2 = s[2], q3 = s[3], q4 = s[4], q5 = s[5], q6 = s[6],
               q7 = s[7], q8 = s[8];
  Tri t;
  t.a = {q0.x, q0.y, q0.z};
  t.b = {q0.w, q1.x, q1.y};
  t.c = {q1.z, q1.w, q2.x};
  t.ab = {q2.y, q2.z, q2.w};
  t.bc = {q3.x, q3.y, q3.z};
  t.ac = {q3.w, q4.x, q4.y};
  t.n = {q4.z, q4.w, q5.x};
  t.dd_ab = q5.y;
  t.dd_bc = q5.z;
  t.dd_ca = q5.w;
  t.r_ab = q6.x;
  t.r_bc = q6.y;
  t.r_ca = q6.z;
  t.nn = q6.w;
  t.r_nn = q7.x;
  t.d00 = q7.y;
  t.d01 = q7.z;
  t.d11 = q7.w;
  t.denom = q8.x;
  t.r_denom = q8.y;
  return t;
}

// num / den, correctly rounded, from den's correctly rounded reciprocal: one residual step
__device__ __forceinline__ float quot(float num, float den, float rcp) {
  const float q = num * rcp;
  return __fmaf_rn(__fmaf_rn(-q, den, num), rcp, q);
}

// The clamped projection of p on the edge from e0 along d (pe = p - e0).
__device__ __forceinline__ V3 edge_proj(V3 pe, V3 e0, V3 d, float dd, float rcp) {
  float t = quot(dot(pe, d), dd, rcp);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return {e0.x + t * d.x, e0.y + t * d.y, e0.z + t * d.z};
}

// closest_point_on_triangle of ops/mesh/ops.py, operation for operation: the closest point
// cp of triangle t to p, and its squared distance. The one pair routine of K16 and K17.
__device__ __forceinline__ float closest(V3 p, const Tri& t, V3& cp) {
  const V3 pa = sub(p, t.a), pb = sub(p, t.b), pc = sub(p, t.c);
  const V3 cand_ab = edge_proj(pa, t.a, t.ab, t.dd_ab, t.r_ab);
  const V3 cand_bc = edge_proj(pb, t.b, t.bc, t.dd_bc, t.r_bc);
  const V3 cand_ca = edge_proj(pc, t.c, neg(t.ac), t.dd_ca, t.r_ca);
  const float dist_plane = quot(dot(pa, t.n), t.nn, t.r_nn);
  const V3 proj = {p.x - dist_plane * t.n.x, p.y - dist_plane * t.n.y,
                   p.z - dist_plane * t.n.z};
  const V3 v2 = sub(proj, t.a);
  const float d20 = dot(v2, t.ab), d21 = dot(v2, t.ac);
  const float v = quot(t.d11 * d20 - t.d01 * d21, t.denom, t.r_denom);
  const float w = quot(t.d00 * d21 - t.d01 * d20, t.denom, t.r_denom);
  const bool inside = (v >= 0.0f) && (w >= 0.0f) && (v + w <= 1.0f);
  float d2 = d2_to(p, cand_ab);
  cp = cand_ab;
  const float d2_bc = d2_to(p, cand_bc);
  if (d2_bc < d2) {
    d2 = d2_bc;
    cp = cand_bc;
  }
  const float d2_ca = d2_to(p, cand_ca);
  if (d2_ca < d2) {
    d2 = d2_ca;
    cp = cand_ca;
  }
  if (inside) {
    cp = proj;
    d2 = d2_to(p, proj);
  }
  return d2;
}

// The vote of one triangle whose d^2 lies in the band (compute_sdf.py:56-93), from its row.
__device__ __forceinline__ float vote(V3 p, V3 cp, const float* __restrict__ row) {
  const V3 va = ldg3(row), vb = ldg3(row + 3), vc = ldg3(row + 6);
  const V3 nrm = ldg3(row + 9);
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
  const float vertex_angle = __ldg(row + (at_a ? 12 : (at_b ? 13 : 14)));
  const float alpha = on_vertex ? vertex_angle : (on_edge ? kPi : kTwoPi);
  return alpha * dot(sub(p, cp), nrm);
}

// Derive the terms of triangles t0 .. t0 + nt - 1 into the tile, a thread a triangle.
__device__ __forceinline__ void stage(float4 (*tile)[kTermVecs],
                                      const float* __restrict__ tris, int t0, int nt) {
  const int t = threadIdx.x;
  __syncthreads();
  if (t < nt) pack(tile[t], derive(tris + (long long)(t0 + t) * kTriFloats));
  __syncthreads();
}

__device__ __forceinline__ V3 load_point(const float* __restrict__ points, long long i) {
  return {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
}

// A point's running minimum and its candidate list. The list lives in the thread's
// column of two shared arrays, [kCandidates][kThreads] (no bank conflict), so that the
// pair loop keeps its registers.
struct Band {
  float m, limit;              // the running minimum and its band's limit
  int n;                       // candidates held
  bool over;                   // the band once held more than kCandidates
  int* t;                      // the candidates' triangles, stride kThreads
  float* d2;                   // and their d^2
};

// Triangle ``tri`` at ``d2`` lies within the band of the running minimum: lower the
// minimum if it is below, then take the triangle, first dropping the candidates outside
// the band if the list is full; if none can go, the point overflows.
__device__ __forceinline__ void admit(Band& b, int tri, float d2) {
  if (d2 < b.m) {
    b.m = d2;
    b.limit = b.m + (1e-8f + 1e-4f * b.m);
  }
  if (b.over) return;
  if (b.n == kCandidates) {
    int w = 0;
    for (int k = 0; k < kCandidates; ++k) {
      const float dk = b.d2[k * kThreads];
      if (dk <= b.limit) {
        b.t[w * kThreads] = b.t[k * kThreads];
        b.d2[w * kThreads] = dk;
        ++w;
      }
    }
    b.n = w;
    if (w == kCandidates) {
      b.over = true;
      return;
    }
  }
  b.t[b.n * kThreads] = tri;
  b.d2[b.n * kThreads] = d2;
  b.n += 1;
}

// PPT points a thread: points blockIdx.x * kThreads * PPT + threadIdx.x + k * kThreads.
template <int PPT>
__global__ void __launch_bounds__(kThreads, 4)
    mesh_sdf_kernel(const float* __restrict__ points, long long P,
                    const float* __restrict__ tris, int T, float* __restrict__ out) {
  __shared__ float4 tile[kTile][kTermVecs];
  __shared__ int cand_t[PPT][kCandidates][kThreads];
  __shared__ float cand_d2[PPT][kCandidates][kThreads];
  const long long first = (long long)blockIdx.x * (kThreads * PPT) + threadIdx.x;
  V3 p[PPT];
  Band band[PPT];
  bool over = false;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long i = first + k * kThreads;
    const bool active = i < P;
    p[k] = active ? load_point(points, i) : V3{0.0f, 0.0f, 0.0f};
    band[k].m = INFINITY;
    band[k].limit = active ? INFINITY : -1.0f;   // a missing point takes no triangle
    band[k].n = 0;
    band[k].over = false;
    band[k].t = &cand_t[k][0][threadIdx.x];
    band[k].d2 = &cand_d2[k][0][threadIdx.x];
  }
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    stage(tile, tris, t0, nt);
    for (int j = 0; j < nt; ++j) {
      const Tri tri = unpack(tile[j]);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        V3 cp;
        const float d2 = closest(p[k], tri, cp);
        if (d2 <= band[k].limit) admit(band[k], t0 + j, d2);
      }
    }
  }
  float s[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    s[k] = 0.0f;
    over = over || band[k].over;
  }
  if (__syncthreads_or(over)) {
    // the overflow path: every triangle again for the flagged points
    for (int t0 = 0; t0 < T; t0 += kTile) {
      const int nt = min(kTile, T - t0);
      stage(tile, tris, t0, nt);
      for (int j = 0; j < nt; ++j) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!band[k].over) continue;
          V3 cp;
          if (closest(p[k], unpack(tile[j]), cp) <= band[k].limit)
            s[k] += vote(p[k], cp, tris + (long long)(t0 + j) * kTriFloats);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (!band[k].over) {
      for (int c = 0; c < band[k].n; ++c) {
        if (band[k].d2[c * kThreads] <= band[k].limit) {
          const float* row = tris + (long long)band[k].t[c * kThreads] * kTriFloats;
          V3 cp;
          closest(p[k], derive(row), cp);
          s[k] += vote(p[k], cp, row);
        }
      }
    }
    const long long i = first + k * kThreads;
    if (i < P) out[i] = s[k] < 0.0f ? -sqrtf(band[k].m) : sqrtf(band[k].m);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 4)
    closest_point_kernel(const float* __restrict__ points, long long P,
                         const float* __restrict__ tris, int T, float* __restrict__ dist,
                         float* __restrict__ nearest, long long* __restrict__ tidx) {
  __shared__ float4 tile[kTile][kTermVecs];
  const long long first = (long long)blockIdx.x * (kThreads * PPT) + threadIdx.x;
  V3 p[PPT];
  float d2min[PPT];
  int best[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long i = first + k * kThreads;
    p[k] = i < P ? load_point(points, i) : V3{0.0f, 0.0f, 0.0f};
    d2min[k] = INFINITY;
    best[k] = -1;
  }
  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int nt = min(kTile, T - t0);
    stage(tile, tris, t0, nt);
    for (int j = 0; j < nt; ++j) {
      const Tri tri = unpack(tile[j]);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        V3 cp;
        const float d2 = closest(p[k], tri, cp);
        if (d2 < d2min[k]) {
          d2min[k] = d2;
          best[k] = t0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const long long i = first + k * kThreads;
    if (i >= P) continue;
    V3 cp = {0.0f, 0.0f, 0.0f};
    if (best[k] >= 0) closest(p[k], derive(tris + (long long)best[k] * kTriFloats), cp);
    dist[i] = sqrtf(d2min[k]);
    nearest[3 * i] = cp.x;
    nearest[3 * i + 1] = cp.y;
    nearest[3 * i + 2] = cp.z;
    tidx[i] = best[k] >= 0 ? best[k] : 0;
  }
}

// Points a thread of K16 and K17: two where the call fills every SM with at least two
// blocks of them, else one, so that a small call still spreads over the card.
cudaError_t points_per_thread(long long P, int* ppt) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *ppt = wisp::ceil_div(P, 2 * kThreads) >= 2 * sms ? 2 : 1;
  return cudaSuccess;
}

}  // namespace

// K17. points [P, 3]; tris [T, 15] (K16's table; the corners are read); dist [P],
// nearest [P, 3], tidx [P].
WISP_EXPORT int wisp_closest_point(const float* points, long long P, const float* tris, int T,
                                   float* dist, float* nearest, long long* tidx,
                                   void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    int ppt = 1;
    const cudaError_t e = points_per_thread(P, &ppt);
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t s = (cudaStream_t)stream;
    if (ppt == 2)
      closest_point_kernel<2><<<wisp::ceil_div(P, 2 * kThreads), kThreads, 0, s>>>(
          points, P, tris, T, dist, nearest, tidx);
    else
      closest_point_kernel<1><<<wisp::ceil_div(P, kThreads), kThreads, 0, s>>>(
          points, P, tris, T, dist, nearest, tidx);
  }
  return (int)cudaGetLastError();
}

// points [P, 3]; tris [T, 15] (va, vb, vc, unit face normal, interior angles at a, b, c);
// out [P].
WISP_EXPORT int wisp_mesh_sdf(const float* points, long long P, const float* tris, int T,
                              float* out, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if (P > 0) {
    int ppt = 1;
    const cudaError_t e = points_per_thread(P, &ppt);
    if (e != cudaSuccess) return (int)e;
    const cudaStream_t s = (cudaStream_t)stream;
    if (ppt == 2)
      mesh_sdf_kernel<2><<<wisp::ceil_div(P, 2 * kThreads), kThreads, 0, s>>>(points, P, tris,
                                                                              T, out);
    else
      mesh_sdf_kernel<1><<<wisp::ceil_div(P, kThreads), kThreads, 0, s>>>(points, P, tris, T,
                                                                          out);
  }
  return (int)cudaGetLastError();
}
