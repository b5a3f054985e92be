// The earlier design of K18 (the triplane sample, forward and backward), kept as the
// yardstick of the redesign in ../triplane.cu: chip_smoke.py builds this file into its own
// library beside the kernel library (kernels.py's nvcc and flags, at first use) and reports
// its time on the same inputs as the K18 rows' ``was_ms``. Nothing in the package calls it.
//
// Design: one thread a (point, plane, chunk of 4 features, or 1 where F % 4 != 0 or a table
// is not on 16 bytes), the chunk fastest, then the plane, so a warp holds ~11 points on all
// three planes; a thread walks the LODs in a loop of runtime trip count, loading each
// LOD's four corner chunks (float4 where it can), and writes its chunk once ('sum') or
// once a LOD ('cat', zeros past the given LODs). The backward is the same walk, adding
// (g (1-fy)) (1-fx) and its three siblings into the zeroed plane gradients with one float4
// (or float) atomic a corner. The arithmetic is JAX's, in JAX's order (--fmad=false); see
// ../triplane.cu for it. Entry points: wisp_triplane_v1_fwd and wisp_triplane_v1_bwd, with
// the arguments of the kernel library's wisp_triplane_fwd and wisp_triplane_bwd.
#include "common.cuh"

namespace {

constexpr int kMaxLods = 16;
constexpr int kThreads = 256;

struct Planes {
  const float* p[3 * kMaxLods];  // fmx, fmy, fmz of LOD 0, then of LOD 1, ...: [W, W, F]
  int w[kMaxLods];               // W of each LOD
};

// JAX's _reflect(x, -1, 1)
__device__ __forceinline__ float reflect(float x) {
  const float lo = -1.0f, span = 2.0f, period = 4.0f;
  float m = fmodf(x - lo, period);
  if (m != 0.0f && (m < 0.0f) != (period < 0.0f)) m += period;
  return fabsf(m - span) + lo;
}

// A LOD's corner rows and fractions at the folded coordinates (u, v) of a plane of width w
struct Corners {
  long long r00, r01, r10, r11;
  float fx, fy;
};

__device__ __forceinline__ Corners corners(float u, float v, int w) {
  const float x = (u + 1.0f) * 0.5f * (float)(w - 1);
  const float y = (v + 1.0f) * 0.5f * (float)(w - 1);
  int x0 = (int)floorf(x), y0 = (int)floorf(y);
  x0 = min(max(x0, 0), w - 1);
  y0 = min(max(y0, 0), w - 1);
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, w - 1);
  Corners c;
  c.fx = x - (float)x0;
  c.fy = y - (float)y0;
  c.r00 = (long long)y0 * w + x0;
  c.r01 = (long long)y0 * w + x1;
  c.r10 = (long long)y1 * w + x0;
  c.r11 = (long long)y1 * w + x1;
  return c;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

template <int V>
__device__ __forceinline__ void add(float* p, float w, const float (&g)[V], float a) {
  // (g * w) * a for each feature: the order of autodiff's products
  if (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(g[0] * w * a, g[1] * w * a, g[2] * w * a, g[3] * w * a));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) atomicAdd(p + j, g[j] * w * a);
  }
}

// The (u, v) of a plane: fmx at (y, z), fmy at (x, z), fmz at (x, y)
__device__ __forceinline__ void plane_uv(const float* c, int plane, float& u, float& v) {
  u = plane == 0 ? c[1] : c[0];
  v = plane == 2 ? c[1] : c[2];
}

template <int V>
__global__ void __launch_bounds__(kThreads) triplane_fwd_kernel(
    const float* __restrict__ coords, long long N, int n_lods, int out_lods, int F,
    const Planes planes, int sum, float* __restrict__ out) {
  const int chunks = F / V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * 3 * chunks) return;
  const int chunk = (int)(t % chunks);
  const int plane = (int)((t / chunks) % 3);
  const long long n = t / (3LL * chunks);
  float u, v;
  plane_uv(coords + 3 * n, plane, u, v);
  u = reflect(u);
  v = reflect(v);
  const int f0 = chunk * V;
  const long long width = 3LL * F * (sum ? 1 : out_lods);
  float* o = out + n * width + (long long)plane * F + f0;
  float acc[V];
  for (int l = 0; l < n_lods; ++l) {
    const int w = planes.w[l];
    const Corners c = corners(u, v, w);
    const float* p = planes.p[3 * l + plane] + f0;
    float a[V], b[V], d[V], e[V];
    load<V>(p + c.r00 * F, a);
    load<V>(p + c.r01 * F, b);
    load<V>(p + c.r10 * F, d);
    load<V>(p + c.r11 * F, e);
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    float s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] = a[j] * gx * gy + b[j] * c.fx * gy;
      s[j] = s[j] + d[j] * gx * c.fy;
      s[j] = s[j] + e[j] * c.fx * c.fy;
    }
    if (sum) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = l == 0 ? s[j] : acc[j] + s[j];
    } else {
      store<V>(o + (long long)l * 3 * F, s);
    }
  }
  if (sum) {
    store<V>(o, acc);
  } else {
    float z[V];
#pragma unroll
    for (int j = 0; j < V; ++j) z[j] = 0.0f;
    for (int l = n_lods; l < out_lods; ++l) store<V>(o + (long long)l * 3 * F, z);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) triplane_bwd_kernel(
    const float* __restrict__ coords, long long N, int n_lods, int out_lods, int F,
    const Planes grads, int sum, const float* __restrict__ grad_out) {
  const int chunks = F / V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * 3 * chunks) return;
  const int chunk = (int)(t % chunks);
  const int plane = (int)((t / chunks) % 3);
  const long long n = t / (3LL * chunks);
  float u, v;
  plane_uv(coords + 3 * n, plane, u, v);
  u = reflect(u);
  v = reflect(v);
  const int f0 = chunk * V;
  const long long width = 3LL * F * (sum ? 1 : out_lods);
  const float* go = grad_out + n * width + (long long)plane * F + f0;
  float g[V];
  if (sum) load<V>(go, g);
  for (int l = 0; l < n_lods; ++l) {
    if (!sum) load<V>(go + (long long)l * 3 * F, g);
    const int w = grads.w[l];
    const Corners c = corners(u, v, w);
    float* p = const_cast<float*>(grads.p[3 * l + plane]) + f0;
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    add<V>(p + c.r00 * F, gy, g, gx);
    add<V>(p + c.r01 * F, gy, g, c.fx);
    add<V>(p + c.r10 * F, c.fy, g, gx);
    add<V>(p + c.r11 * F, c.fy, g, c.fx);
  }
}

bool valid(long long N, int n_lods, int out_lods, int F, int vec, const Planes* planes) {
  if (N < 0 || n_lods < 1 || n_lods > out_lods || out_lods > kMaxLods || F < 1) return false;
  if (vec != 1 && !(vec == 4 && F % 4 == 0)) return false;
  for (int l = 0; l < n_lods; ++l)
    if (planes->w[l] < 1) return false;
  return true;
}

}  // namespace

// coords [N, 3] float32; planes: the host block of n_lods LODs' planes [W_l, W_l, F] float32;
// out [N, 3F] (sum = 1) or [N, 3F * out_lods] (sum = 0; columns of LODs >= n_lods are
// zeroed); vec: features a thread (4 needs F % 4 == 0 and 16-byte aligned planes and out).
WISP_EXPORT int wisp_triplane_v1_fwd(const float* coords, long long N, int n_lods,
                                     int out_lods, int F, const void* planes, int sum, int vec,
                                     float* out, void* stream) {
  const Planes* p = static_cast<const Planes*>(planes);
  if (!valid(N, n_lods, sum ? n_lods : out_lods, F, vec, p)) return (int)cudaErrorInvalidValue;
  const long long threads = N * 3 * (F / vec);
  if (threads == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = wisp::ceil_div(threads, kThreads);
  if (vec == 4)
    triplane_fwd_kernel<4><<<blocks, kThreads, 0, st>>>(coords, N, n_lods, out_lods, F, *p,
                                                        sum, out);
  else
    triplane_fwd_kernel<1><<<blocks, kThreads, 0, st>>>(coords, N, n_lods, out_lods, F, *p,
                                                        sum, out);
  return (int)cudaGetLastError();
}

// grads: the host block of the zeroed plane gradients [W_l, W_l, F] float32 (same layout as
// the forward's planes), added into; grad_out [N, 3F] (sum = 1) or [N, 3F * out_lods] (the
// columns of LODs >= n_lods are not read).
WISP_EXPORT int wisp_triplane_v1_bwd(const float* coords, long long N, int n_lods,
                                     int out_lods, int F, const void* grads, int sum, int vec,
                                     const float* grad_out, void* stream) {
  const Planes* g = static_cast<const Planes*>(grads);
  if (!valid(N, n_lods, sum ? n_lods : out_lods, F, vec, g))
    return (int)cudaErrorInvalidValue;
  const long long threads = N * 3 * (F / vec);
  if (threads == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = wisp::ceil_div(threads, kThreads);
  if (vec == 4)
    triplane_bwd_kernel<4><<<blocks, kThreads, 0, st>>>(coords, N, n_lods, out_lods, F, *g,
                                                        sum, grad_out);
  else
    triplane_bwd_kernel<1><<<blocks, kThreads, 0, st>>>(coords, N, n_lods, out_lods, F, *g,
                                                        sum, grad_out);
  return (int)cudaGetLastError();
}
