// K18 — the triplane sample, forward and backward.
//
// Replaces wisp_tpu/models/grids/triplanar_grid.py `bilinear_sample` (:29, with `_reflect`
// :21; its four corner rows gathered through wisp_tpu/ops/grid.py:37 `gather_rows`, whose
// backward is `_gather_rows_bwd` :55), called three times a LOD by
// `TriplanarFeatureVolume.__call__` (:70) and summed or concatenated over the LODs by
// `TriplanarGrid.interpolate` (:125). JAX computes it as a chain of XLA ops a plane and a
// LOD; its backward is the transposed gathers, a scatter-add a corner.
//
// The arithmetic is JAX's, in JAX's order (the build has --fmad=false, so every product
// and sum rounds as the plain version's do):
//   u <- _reflect(u) = |mod(u + 1, 4) - 2| - 1, jnp.mod's floor semantics (fmodf truncates:
//        a non-zero remainder of the other sign than the divisor gets the divisor added,
//        as XLA and torch.remainder do);
//   x = (u + 1) * 0.5 * (W - 1); x0 = clip(floor(x), 0, W - 1); x1 = min(x0 + 1, W - 1);
//   fx = x - x0; the blend p00 (1-fx)(1-fy) + p01 fx(1-fy) + p10 (1-fx) fy + p11 fx fy,
//   each term ((p * a) * b), the terms added left to right; 'sum' adds the LODs in order.
// Plane fmx is sampled at (u, v) = (y, z), fmy at (x, z), fmz at (x, y); the row of (x, y)
// is y * W + x. The kernels compute x as (u + 1) * h with h = 0.5 * (W - 1): the scaling by
// 0.5 is exact, so this is the same single rounding of the same product.
//
// Bound on this card: bytes. Forward: a point's 12 bytes and its output row (60 bytes a
// sample at the yaml's F = 4, 'sum'); the 4.22 MB of planes of nerf_triplanar_lego_proxy.yaml
// stay in L2. Backward: the cotangent row read and the plane gradients written once; at the
// yaml's step (262,144 samples) it adds 12.6 M corner rows of 16 bytes, 3.1 M a LOD.
//
// Forward design: one thread a (point, plane, chunk of V features: V = 4, a float4, where
// F % 4 == 0 and every table is on 16 bytes; else 1), the chunk fastest, then the plane,
// so that neighbouring threads write neighbouring output words. A thread folds its two
// coordinates once (fmodf only outside the box) and keeps u + 1 and v + 1; the LOD loop is
// unrolled at compile time for the yaml's 4 LODs (the compiler then starts the LODs' loads
// ahead of their blends), and a point's index takes a division by the constant 3. A
// render chunk is bound by the rate at which the SMs start its ~300 instructions a (point,
// plane); the first design also spent them on 64-bit divisions, fmodf on every coordinate
// and a runtime LOD loop (chip_triplane_bench.py times the last two as variants).
//
// Backward design. A training batch (the tracer's compaction orders samples step-major:
// neighbouring slots are the same step of unrelated rays) adds 12.6 M corner rows at the
// yaml's step, and the L2's atomics (~63 G float4 adds a second on an H100) set its time;
// the coarse LODs' rows take ~1,000 adds each. The grid is 1-D with the plane interleaved
// (block b takes plane b % 3). The leading ``n_shared`` LODs of a block's plane (the
// host's rule, ops/triplane.py bwd_shared_lods: LODs 0 and 1 at the yaml, 85 KB) are
// summed in the block's shared memory (float pairs by a 64-bit compare-and-swap; about
// twice the rate of the L2's atomics) and each (persistent) block adds its copy's touched
// rows into the gradients once at its end. The other LODs add each corner with one float4
// (or float) atomic. A warp whose neighbouring lanes share a row (a render-ordered batch)
// first sums each row's values, so that one lane adds them.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxLods = 16;
constexpr int kFwdThreads = 256;           // forward: threads a block
constexpr int kFwdMinBlocks = 6;           // forward: __launch_bounds__'s blocks an SM
constexpr int kBwdThreads = 512;           // backward: samples a tile (one plane a block)

struct Planes {
  const float* p[3 * kMaxLods];  // fmx, fmy, fmz of LOD 0, then of LOD 1, ...: [W, W, F]
  int w[kMaxLods];               // W of each LOD
};

// JAX's _reflect(x, -1, 1): |mod(x + 1, 4) - 2| - 1. For x + 1 in [0, 4) (every point
// in the box) the remainder is x + 1 itself, so fmodf runs only outside.
__device__ __forceinline__ float reflect(float x) {
  const float lo = -1.0f, span = 2.0f, period = 4.0f;
  const float a = x - lo;
  float m = a;
  if (!(a >= 0.0f && a < period)) {
    m = fmodf(a, period);
    if (m != 0.0f && (m < 0.0f) != (period < 0.0f)) m += period;
  }
  return fabsf(m - span) + lo;
}

// A LOD's corner rows and fractions at folded coordinates (u, v) given as up1 = u + 1 and
// vp1 = v + 1, on a plane of width w
struct Corners {
  int r00, r01, r10, r11;
  float fx, fy;
};

__device__ __forceinline__ Corners corners(float up1, float vp1, int w) {
  const float h = 0.5f * (float)(w - 1);
  const float x = up1 * h;
  const float y = vp1 * h;
  int x0 = (int)floorf(x), y0 = (int)floorf(y);
  x0 = min(max(x0, 0), w - 1);
  y0 = min(max(y0, 0), w - 1);
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, w - 1);
  Corners c;
  c.fx = x - (float)x0;
  c.fy = y - (float)y0;
  c.r00 = y0 * w + x0;
  c.r01 = y0 * w + x1;
  c.r10 = y1 * w + x0;
  c.r11 = y1 * w + x1;
  return c;
}

// (u + 1, v + 1) of a plane at a point, folded: fmx at (y, z), fmy at (x, z), fmz at (x, y)
__device__ __forceinline__ void plane_uv(const float* __restrict__ c, int plane, float& up1,
                                         float& vp1) {
  const float cx = __ldg(c), cy = __ldg(c + 1), cz = __ldg(c + 2);
  up1 = reflect(plane == 0 ? cy : cx) + 1.0f;
  vp1 = reflect(plane == 2 ? cy : cz) + 1.0f;
}

template <int V>
struct Vec { float v[V]; };

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = __ldg(p + j);
  }
  return r;
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

// -- forward ------------------------------------------------------------------------------

// NL: the LOD count when known at compile time (the yaml's 4: the loop unrolled), else 0
template <int V, int NL>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks) triplane_fwd_kernel(
    const float* __restrict__ coords, long long N, int n_lods, int out_lods, int F,
    const __grid_constant__ Planes planes, int sum, float* __restrict__ out) {
  const int chunks = F / V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * 3 * chunks) return;
  long long n;
  int plane, chunk;
  if (chunks == 1) {  // a division by the constant 3
    n = t / 3;
    plane = (int)(t - 3 * n);
    chunk = 0;
  } else {
    chunk = (int)(t % chunks);
    plane = (int)((t / chunks) % 3);
    n = t / (3LL * chunks);
  }
  float up1, vp1;
  plane_uv(coords + 3 * n, plane, up1, vp1);
  const int f0 = chunk * V;
  float* o = out + n * (3LL * F * (sum ? 1 : out_lods)) + plane * F;
  const int nl = NL > 0 ? NL : n_lods;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int l = 0; l < nl; ++l) {
    const Corners c = corners(up1, vp1, planes.w[l]);
    const float* p = planes.p[3 * l + plane] + f0;
    const Vec<V> a = load<V>(p + c.r00 * F), b = load<V>(p + c.r01 * F);
    const Vec<V> d = load<V>(p + c.r10 * F), e = load<V>(p + c.r11 * F);
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    float s[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] = a.v[j] * gx * gy + b.v[j] * c.fx * gy;
      s[j] = s[j] + d.v[j] * gx * c.fy;
      s[j] = s[j] + e.v[j] * c.fx * c.fy;
    }
    if (sum) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = l == 0 ? s[j] : acc[j] + s[j];
    } else {
      store<V>(o + l * 3 * F + f0, s);
    }
  }
  if (sum) {
    store<V>(o + f0, acc);
  } else {
    float z[V];
#pragma unroll
    for (int j = 0; j < V; ++j) z[j] = 0.0f;
    for (int l = nl; l < out_lods; ++l) store<V>(o + l * 3 * F + f0, z);
  }
}

// -- backward -----------------------------------------------------------------------------

// p[0..1] += (a, b) in shared memory: one 64-bit compare-and-swap loop
__device__ __forceinline__ void shared_add2(float* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *q, assumed;
  do {
    assumed = old;
    const float x = __uint_as_float((unsigned)(assumed & 0xffffffffull)) + a;
    const float y = __uint_as_float((unsigned)(assumed >> 32)) + b;
    const unsigned long long next =
        (unsigned long long)__float_as_uint(x) | ((unsigned long long)__float_as_uint(y) << 32);
    old = atomicCAS(q, assumed, next);
  } while (old != assumed);
}

template <int V>
__device__ __forceinline__ void shared_add(float* p, const float (&v)[V]) {
  if (V == 4) {
    shared_add2(p, v[0], v[1]);
    shared_add2(p + 2, v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) atomicAdd(p + j, v[j]);
  }
}

template <int V>
__device__ __forceinline__ void global_add(float* p, const float (&v)[V]) {
  if (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) atomicAdd(p + j, v[j]);
  }
}

// A warp's adds of one corner, combined where lanes share a row (all lanes call it): a
// shuffle and a vote first ask whether any lane's row is its upper neighbour's (a
// render-ordered batch: neighbouring pixels; a training batch's lanes almost never); only
// then do the lanes of one row (__match_any_sync) sum their values (``v`` becomes the
// group's sum, by a butterfly where the whole warp is one row) so that the lowest of them
// adds. Returns whether this lane adds. ``active``: the lane holds an add.
template <int V>
__device__ __forceinline__ bool combine_row(int row, bool active, float (&v)[V], int lane) {
  const int key = active ? row : -1 - lane;  // inactive lanes match nobody
  const int up = __shfl_down_sync(wisp::kFullMask, key, 1);
  if (!__any_sync(wisp::kFullMask, lane < 31 && up == key)) return active;
  const unsigned peers = __match_any_sync(wisp::kFullMask, key);
  if (__all_sync(wisp::kFullMask, peers == wisp::kFullMask)) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += __shfl_xor_sync(wisp::kFullMask, v[j], o);
    }
    return lane == 0;
  }
  unsigned others = peers & ~(1u << lane);
  const int rounds = (int)__reduce_max_sync(wisp::kFullMask, (unsigned)__popc(others));
  float s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = v[j];
  for (int i = 0; i < rounds; ++i) {
    const int src = others ? __ffs(others) - 1 : lane;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = __shfl_sync(wisp::kFullMask, v[j], src);
      if (others) s[j] += t;
    }
    others &= others - 1;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = s[j];
  return active && lane == __ffs(peers) - 1;
}

// One corner's add (all lanes call it), after the warp's combining: into the block's shared
// copy (``priv``, non-null) or the gradient (``base``).
template <int V>
__device__ __forceinline__ void corner_add(float* priv, float* base, int F, int row,
                                           bool active, float (&v)[V], int lane) {
  if (!combine_row<V>(row, active, v, lane)) return;
  if (priv != nullptr)
    shared_add<V>(priv + row * F, v);
  else
    global_add<V>(base + (long long)row * F, v);
}

// The grid is 1-D and a multiple of 3: block b takes plane b % 3 and the tiles b / 3,
// b / 3 + gridDim.x / 3, ... (the planes interleaved, so that the rows being added to at
// any time are spread over all three planes' tables).
template <int V>
__global__ void __launch_bounds__(kBwdThreads) triplane_bwd_kernel(
    const float* __restrict__ coords, long long N, int n_lods, int out_lods, int F,
    const __grid_constant__ Planes grads, int sum, const float* __restrict__ grad_out,
    int n_shared) {
  extern __shared__ float4 smem4[];
  float* priv = reinterpret_cast<float*>(smem4);  // the plane's shared LODs, LOD 0 first
  const int plane = blockIdx.x % 3;
  const int lane = threadIdx.x & 31;
  int priv_floats = 0;
  for (int l = 0; l < n_shared; ++l) priv_floats += grads.w[l] * grads.w[l] * F;
  if (n_shared > 0) {
    for (int i = threadIdx.x; i < priv_floats; i += blockDim.x) priv[i] = 0.0f;
    __syncthreads();
  }
  const int chunks = F / V;
  const long long width = 3LL * F * (sum ? 1 : out_lods);
  const long long n_tiles = (N + kBwdThreads - 1) / kBwdThreads;
  for (long long tile = blockIdx.x / 3; tile < n_tiles; tile += gridDim.x / 3) {
    const long long n = tile * kBwdThreads + threadIdx.x;
    const bool active = n < N;  // inactive lanes take part in the warp's combining
    float up1 = 1.0f, vp1 = 1.0f;
    if (active) plane_uv(coords + 3 * n, plane, up1, vp1);
    const float* go = grad_out + (active ? n : 0) * width + plane * F;
    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int f0 = chunk * V;
      float g[V];
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = 0.0f;
      if (sum && active) {
        const Vec<V> q = load<V>(go + f0);
#pragma unroll
        for (int j = 0; j < V; ++j) g[j] = q.v[j];
      }
      int priv_off = 0;
      for (int l = 0; l < n_lods; ++l) {
        const int w = grads.w[l];
        const Corners c = corners(up1, vp1, w);
        if (!sum && active) {
          const Vec<V> q = load<V>(go + l * 3 * F + f0);
#pragma unroll
          for (int j = 0; j < V; ++j) g[j] = q.v[j];
        }
        const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
        // (g * w) * a for each feature: the order of autodiff's products
        float a00[V], a01[V], a10[V], a11[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a00[j] = g[j] * gy * gx;
          a01[j] = g[j] * gy * c.fx;
          a10[j] = g[j] * c.fy * gx;
          a11[j] = g[j] * c.fy * c.fx;
        }
        float* sh = l < n_shared ? priv + priv_off + f0 : nullptr;
        float* p = const_cast<float*>(grads.p[3 * l + plane]) + f0;
        corner_add<V>(sh, p, F, c.r00, active, a00, lane);
        corner_add<V>(sh, p, F, c.r01, active, a01, lane);
        corner_add<V>(sh, p, F, c.r10, active, a10, lane);
        corner_add<V>(sh, p, F, c.r11, active, a11, lane);
        if (l < n_shared) priv_off += w * w * F;
      }
    }
  }
  if (n_shared > 0) {
    // the block's sums into the gradients: one atomic a touched row
    __syncthreads();
    int priv_off = 0;
    for (int l = 0; l < n_shared; ++l) {
      const int rows = grads.w[l] * grads.w[l];
      float* dst = const_cast<float*>(grads.p[3 * l + plane]);
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const float* src = priv + priv_off + r * F;
        for (int f0 = 0; f0 < F; f0 += V) {
          float s[V];
          bool any = false;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s[j] = src[f0 + j];
            any = any || s[j] != 0.0f;
          }
          if (any) global_add<V>(dst + (long long)r * F + f0, s);
        }
      }
      priv_off += rows * F;
    }
  }
}

bool valid(long long N, int n_lods, int out_lods, int F, int vec, const Planes* planes) {
  if (N < 0 || n_lods < 1 || n_lods > out_lods || out_lods > kMaxLods || F < 1) return false;
  if (vec != 1 && !(vec == 4 && F % 4 == 0)) return false;
  for (int l = 0; l < n_lods; ++l)  // a plane's W^2 F floats are indexed with an int
    if (planes->w[l] < 1 || (long long)planes->w[l] * planes->w[l] * F >= (1LL << 31))
      return false;
  return true;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

template <int V, int NL>
int launch_fwd(const float* coords, long long N, int n_lods, int out_lods, int F,
               const Planes& p, int sum, float* out, cudaStream_t st) {
  const long long threads = N * 3 * (F / V);
  triplane_fwd_kernel<V, NL><<<wisp::ceil_div(threads, kFwdThreads), kFwdThreads, 0, st>>>(
      coords, N, n_lods, out_lods, F, p, sum, out);
  return (int)cudaGetLastError();
}

template <int V>
int launch_bwd(const float* coords, long long N, int n_lods, int out_lods, int F,
               const Planes& g, int sum, const float* grad_out, int n_shared,
               cudaStream_t st) {
  long long priv = 0;
  for (int l = 0; l < n_shared; ++l) priv += (long long)g.w[l] * g.w[l] * F;
  const size_t smem = priv * sizeof(float);
  auto kernel = triplane_bwd_kernel<V>;
  static size_t smem_allowed = 48 * 1024;  // this instance's dynamic shared memory limit
  if (smem > smem_allowed) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    smem_allowed = smem;
  }
  const long long tiles = (N + kBwdThreads - 1) / kBwdThreads;
  long long per_plane = tiles;
  if (n_shared > 0) {
    // persistent where a block sums into shared memory: each block's flush is paid once
    int resident = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kBwdThreads, smem);
    per_plane = std::min(tiles, ((long long)std::max(resident, 1) * sm_count() + 2) / 3);
  }
  kernel<<<(unsigned)(3 * per_plane), kBwdThreads, smem, st>>>(
      coords, N, n_lods, out_lods, F, g, sum, grad_out, n_shared);
  return (int)cudaGetLastError();
}

}  // namespace

// coords [N, 3] float32; planes: the host block of n_lods LODs' planes [W_l, W_l, F] float32;
// out [N, 3F] (sum = 1) or [N, 3F * out_lods] (sum = 0; columns of LODs >= n_lods are
// zeroed); vec: features a lane (4 needs F % 4 == 0 and 16-byte aligned planes and out).
WISP_EXPORT int wisp_triplane_fwd(const float* coords, long long N, int n_lods, int out_lods,
                                  int F, const void* planes, int sum, int vec, float* out,
                                  void* stream) {
  const Planes* p = static_cast<const Planes*>(planes);
  if (!valid(N, n_lods, sum ? n_lods : out_lods, F, vec, p)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // the yaml's 4 LODs unrolled at compile time; any other count in groups of kGroup
  if (vec == 4)
    return n_lods == 4 ? launch_fwd<4, 4>(coords, N, n_lods, out_lods, F, *p, sum, out, st)
                       : launch_fwd<4, 0>(coords, N, n_lods, out_lods, F, *p, sum, out, st);
  return n_lods == 4 ? launch_fwd<1, 4>(coords, N, n_lods, out_lods, F, *p, sum, out, st)
                     : launch_fwd<1, 0>(coords, N, n_lods, out_lods, F, *p, sum, out, st);
}

// grads: the host block of the zeroed plane gradients [W_l, W_l, F] float32 (same layout as
// the forward's planes), added into; grad_out [N, 3F] (sum = 1) or [N, 3F * out_lods] (the
// columns of LODs >= n_lods are not read); n_shared: the leading LODs summed in each
// block's shared memory (W_l^2 F floats each, of one plane; 0 adds every corner into the
// gradients directly).
WISP_EXPORT int wisp_triplane_bwd(const float* coords, long long N, int n_lods, int out_lods,
                                  int F, const void* grads, int sum, int vec,
                                  const float* grad_out, int n_shared, void* stream) {
  const Planes* g = static_cast<const Planes*>(grads);
  if (!valid(N, n_lods, sum ? n_lods : out_lods, F, vec, g) || n_shared < 0 ||
      n_shared > n_lods)
    return (int)cudaErrorInvalidValue;
  long long priv = 0;
  for (int l = 0; l < n_shared; ++l) priv += (long long)g->w[l] * g->w[l] * F;
  if (priv * (long long)sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4)
    return launch_bwd<4>(coords, N, n_lods, out_lods, F, *g, sum, grad_out, n_shared, st);
  return launch_bwd<1>(coords, N, n_lods, out_lods, F, *g, sum, grad_out, n_shared, st);
}
