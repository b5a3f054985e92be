// The earlier design of K12's walk (sdf_walk) and of K13 (spc_trace), kept as the yardstick
// of the redesign in ../sphere_trace.cu: chip_smoke.py builds this file into its own library
// beside the kernel library and reports its time on the same inputs as the K12 walk and K13
// rows' ``was_ms`` and in its "walks" step. Nothing in the package calls it. It carries its
// own frozen copies of the walker (../sphere_walker.cuh before the redesign) and of the
// route lookup (../octree_lookup.cuh), so that later edits of those headers do not move it.
//
// Design: one thread a ray, the walk in registers. A step: the point o + t*d, the box test,
// the quantization floor((p + 1) * half_res) and the int32 gather of the free-space field;
// then the free step max((k-1)*voxel, dt + 1e-3*voxel), dt the least over the axes of
// (next_plane - p) / d with next_plane from floor((p + 1) / voxel): two IEEE divisions in
// series an axis, six a step, whatever k is. K13 then tests the final point's occupancy byte,
// looks its cell up by the route where it hit, and adds each overflowing ray to the count
// with one float atomic a ray. Entry points: wisp_sdf_walk_v1 and wisp_spc_trace_v1, with
// the arguments of the kernel library's wisp_sdf_walk and wisp_spc_trace.
#include "common.cuh"

namespace {

constexpr int kOutside = 1 << 30;
constexpr int kMaxLevels = 11;
enum Route { kMap = 0, kSearch = 1, kDense = 2, kBitfield = 3 };

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

  __device__ void point(float t, float& px, float& py, float& pz) const {
    px = ox + t * dx;
    py = oy + t * dy;
    pz = oz + t * dz;
  }

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
};

__device__ __forceinline__ unsigned part1by2(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x30000FFu;
  v = (v | (v << 8)) & 0x300F00Fu;
  v = (v | (v << 4)) & 0x30C30C3u;
  v = (v | (v << 2)) & 0x9249249u;
  return v;
}

__device__ __forceinline__ unsigned morton3(int x, int y, int z) {
  return part1by2((unsigned)x) | (part1by2((unsigned)y) << 1) | (part1by2((unsigned)z) << 2);
}

__device__ __forceinline__ int search_code(const int* __restrict__ table, long long n,
                                           unsigned code) {
  const int c = (int)code;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(table + mid) < c) lo = mid + 1;
    else hi = mid;
  }
  const long long i = min(lo, n - 1);
  return __ldg(table + i) == c ? (int)i : -1;
}

__device__ __forceinline__ int lookup_cell(int route, const void* table, long long len, int l,
                                           int x, int y, int z) {
  const long long res_l = 1LL << l;
  const long long flat = ((long long)x * res_l + y) * res_l + z;
  switch (route) {
    case kMap:
      return __ldg((const int*)table + flat);
    case kSearch:
      return search_code((const int*)table, len, morton3(x, y, z));
    case kDense:
      return (int)morton3(x, y, z);
    default:  // kBitfield
      return ((const uint8_t*)table)[flat] ? (int)morton3(x, y, z) : -1;
  }
}

__global__ void sdf_walk_v1_kernel(const float* __restrict__ origins,
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

__global__ void spc_trace_v1_kernel(const float* __restrict__ origins,
                                    const float* __restrict__ dirs, long long N,
                                    float dist_min, float dist_max,
                                    const int* __restrict__ free_dist,
                                    const uint8_t* __restrict__ occ, int level, int num_steps,
                                    int route, const void* table, long long len,
                                    float* __restrict__ t_out, uint8_t* __restrict__ hit_out,
                                    int* __restrict__ pidx_out,
                                    float* __restrict__ num_overflow) {
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
  pidx_out[r] = hit ? lookup_cell(route, table, len, level, qx, qy, qz) : -1;
}
}  // namespace

WISP_EXPORT int wisp_sdf_walk_v1(const float* origins, const float* dirs, float* t,
                                 uint8_t* alive, const float* t_far, const int* free_dist,
                                 long long N, int level, int num_steps, void* stream) {
  if (N > 0) {
    const int threads = 128;
    sdf_walk_v1_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        origins, dirs, t, alive, t_far, free_dist, N, level, num_steps);
  }
  return (int)cudaGetLastError();
}

WISP_EXPORT int wisp_spc_trace_v1(const float* origins, const float* dirs, long long N,
                                  float dist_min, float dist_max, const int* free_dist,
                                  const uint8_t* occ, int level, int num_steps, int route,
                                  const void* table, long long len, float* t, uint8_t* hit,
                                  int* pidx, float* num_overflow, void* stream) {
  if (level < 0 || level >= kMaxLevels || route < kMap || route > kBitfield ||
      (route == kSearch && len < 1))
    return (int)cudaErrorInvalidValue;
  if (N > 0) {
    const int threads = 128;
    spc_trace_v1_kernel<<<wisp::ceil_div(N, threads), threads, 0, (cudaStream_t)stream>>>(
        origins, dirs, N, dist_min, dist_max, free_dist, occ, level, num_steps, route, table,
        len, t, hit, pidx, num_overflow);
  }
  return (int)cudaGetLastError();
}
