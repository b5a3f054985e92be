// K19 — the codebook lookup of a VQAD grid, resolved once a dual vertex, and its backward.
//
// Replaces wisp_tpu/models/grids/codebook_grid.py `_index_features` (:71; training's
// straight-through `st_lookup` :84-91, eval :92-94, baked :78-80), which JAX computes on
// every (sample, corner) row of wisp_tpu/models/grids/octree_grid.py `_interpolate` (:96):
// a [samples, 8, 2^bw] softmax, argmax, one-hot and product with the LOD's dictionary, and
// its autodiff (rematerialized by jax.checkpoint). The row depends on the vertex alone, and
// the straight-through keys are exactly 0 off the argmax ((0 - s) + s = 0), so the row is
// c * D[a], c = (1 - s_a) + s_a. The resolve computes it once a vertex into a table E
// [V_l, F] that the octree grid's fused query (octree_grid.cu) interpolates as it
// interpolates features; its backward takes K15 backward's dE and gives
//   d logits_v = s * (g - <s, g>), g_k = sum_f D[k, f] dE_v[f]   (jax.nn.softmax's VJP),
//   d D[a_v] += c_v dE_v,
// which by linearity sums the same terms as JAX's per-corner backward.
//
// Arithmetic of s, as jax.nn.softmax computes it: m = max_k x_k, e_k = expf(x_k - m) (the
// same expf as PyTorch's exp on the card), s_k = e_k / sum_k e_k; the sum is taken lane by
// lane then across the warp, in another order than the plain version's, so s may differ
// from it by an ulp: a vertex whose two largest s lie within an ulp may pick another a.
// a is the FIRST argmax of s (ties to the lower index, as jnp.argmax), not of the logits.
// Eval: a = the first argmax of the logits, E = D[a]; baked: a = the stored float index
// truncated (JAX's astype) and clamped to the dictionary, E = D[a].
//
// Design: one launch for every LOD (a struct of the tables, LODs found by their vertex
// offsets), a warp a vertex (grid-stride), lanes across the 2^bw logits (max(1, 2^bw / 32)
// a lane, a compile-time count: the first build unrolled 8 a lane at every bitwidth and,
// issue-bound, took 0.165 ms at the codebook yaml's step),
// the max, the sum and the argmax by shuffles; lanes across F for E's row. The backward is
// one launch with the same walk: it recomputes s (JAX rematerializes too) and c at the
// forward's a, writes the vertex's d logits row and adds c dE into the LOD's dictionary
// gradient, summed first in a block-private shared copy of every LOD's [2^bw, F] (the rows
// of a 16-entry dictionary take ~all vertices' adds), then added to the tables once a
// block; where the copies pass 48 KB each vertex adds straight to the tables.
//
// Bound on this card: bytes (a vertex's logits read once, E written once; backward: the
// logits and dE read, d logits written). At nerf_codebook_lego_proxy.yaml's 2^4 logits of
// F = 5 a vertex moves 84 bytes forward and 148 backward.
#include "common.cuh"

namespace {

constexpr int kMaxLods = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerLane = 8;  // 2^8 logits over 32 lanes
constexpr int kTrain = 0, kEval = 1, kBaked = 2;

struct Lods {
  const float* logits[kMaxLods];  // [V_l, K] (baked: [V_l] float indices)
  const float* dict[kMaxLods];    // [K, F]
  const float* grad_e[kMaxLods];  // backward: dE [V_l, F]
  float* out[kMaxLods];           // forward: E [V_l, F]; backward: d logits [V_l, K]
  float* d_dict[kMaxLods];        // backward: [K, F], zeroed, added into
  int* arg[kMaxLods];             // forward: written; backward: read
  long long start[kMaxLods + 1];  // vertex offsets of the LODs
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(wisp::kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(wisp::kFullMask, v, o);
  return v;
}

// The first index of the largest value across the warp (each lane offers its own first)
__device__ __forceinline__ void warp_argmax(float& v, int& k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(wisp::kFullMask, v, o);
    const int ok = __shfl_xor_sync(wisp::kFullMask, k, o);
    if (ov > v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
}

__device__ __forceinline__ int lod_of(const Lods& lods, int n_lods, long long v) {
  int l = 0;
  while (l + 1 < n_lods && v >= lods.start[l + 1]) ++l;
  return l;
}

// The vertex's logits, one lane's share (k = lane + 32 j, J = max(1, K / 32) of them), -inf
// past K
template <int J>
__device__ __forceinline__ void load_logits(const float* x, int K, int lane, float (&v)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    v[j] = k < K ? x[k] : -INFINITY;
  }
}

// s = softmax(x) (0 past K) from a lane's share of the logits
template <int J>
__device__ __forceinline__ void softmax(const float (&x)[J], int K, int lane, float (&s)[J]) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < J; ++j) m = fmaxf(m, x[j]);
  m = warp_max(m);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    s[j] = lane + 32 * j < K ? expf(x[j] - m) : 0.0f;
    sum += s[j];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = s[j] / sum;
}

// The first argmax over the warp of a lane's share (-inf past K)
template <int J>
__device__ __forceinline__ int first_argmax(const float (&v)[J], int K, int lane, float& best) {
  best = -INFINITY;
  int k = K;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int kj = lane + 32 * j;
    if (kj < K && (k == K || v[j] > best)) {  // strictly larger: the first index stays
      best = v[j];
      k = kj;
    }
  }
  warp_argmax(best, k);
  return k;
}

// s_a of the lane share s (a is the same on every lane)
template <int J>
__device__ __forceinline__ float share_at(const float (&s)[J], int a) {
  float mine = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j == (a >> 5)) mine = s[j];
  return __shfl_sync(wisp::kFullMask, mine, a & 31);
}

template <int kMode, int J>
__global__ void __launch_bounds__(kThreads) codebook_resolve_kernel(int n_lods, int K, int F,
                                                                    const Lods lods) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long V = lods.start[n_lods];
  for (long long v = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); v < V;
       v += warps) {
    const int l = lod_of(lods, n_lods, v);
    const long long i = v - lods.start[l];
    int a;
    float c = 1.0f;
    if (kMode == kBaked) {
      a = (int)lods.logits[l][i];
      a = min(max(a, 0), K - 1);
    } else {
      float x[J], best;
      load_logits(lods.logits[l] + i * K, K, lane, x);
      if (kMode == kEval) {
        a = first_argmax(x, K, lane, best);
      } else {
        float s[J];
        softmax(x, K, lane, s);
        a = first_argmax(s, K, lane, best);
        c = (1.0f - best) + best;
      }
    }
    const float* d = lods.dict[l] + (long long)a * F;
    float* e = lods.out[l] + i * F;
    for (int f = lane; f < F; f += 32) e[f] = kMode == kTrain ? c * d[f] : d[f];
    if (lane == 0) lods.arg[l][i] = a;
  }
}

template <int kMode, bool kShared, int J>
__global__ void __launch_bounds__(kThreads) codebook_bwd_kernel(int n_lods, int K, int F,
                                                                const Lods lods) {
  extern __shared__ float sh[];  // kShared: n_lods x K x F dictionary gradients
  const int lane = threadIdx.x & 31;
  const int table = K * F;
  if (kShared) {
    for (int t = threadIdx.x; t < n_lods * table; t += kThreads) sh[t] = 0.0f;
    __syncthreads();
  }
  const long long warps = (long long)gridDim.x * kWarps;
  const long long V = lods.start[n_lods];
  for (long long v = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); v < V;
       v += warps) {
    const int l = lod_of(lods, n_lods, v);
    const long long i = v - lods.start[l];
    const int a = lods.arg[l][i];
    const float* ge = lods.grad_e[l] + i * F;
    const float* dict = lods.dict[l];
    float c = 1.0f;
    if (kMode == kTrain) {
      float x[J], s[J], g[J];
      load_logits(lods.logits[l] + i * K, K, lane, x);
      softmax(x, K, lane, s);
      const float sa = share_at(s, a);
      c = (1.0f - sa) + sa;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        g[j] = 0.0f;
        if (k < K) {
          const float* dk = dict + (long long)k * F;
          for (int f = 0; f < F; ++f) g[j] = g[j] + dk[f] * ge[f];
        }
        dot = dot + s[j] * g[j];
      }
      dot = warp_sum(dot);
      float* dl = lods.out[l] + i * K;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < K) dl[k] = s[j] * (g[j] - dot);
      }
    }
    for (int f = lane; f < F; f += 32) {
      const float add = c * ge[f];
      if (kShared)
        atomicAdd(sh + (long long)l * table + (long long)a * F + f, add);
      else
        atomicAdd(lods.d_dict[l] + (long long)a * F + f, add);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int t = threadIdx.x; t < n_lods * table; t += kThreads) {
      const float add = sh[t];
      if (add != 0.0f) atomicAdd(lods.d_dict[t / table] + t % table, add);
    }
  }
}

// the SMs of the current device, read once
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// J = the logits a lane holds, max(1, K / 32): a compile-time count, so a 2^4 codebook's
// lanes compute one exp and one quotient, not eight
template <int J>
void launch_resolve(int mode, int blocks, cudaStream_t st, int n_lods, int K, int F,
                    const Lods& p) {
  if (mode == kTrain)
    codebook_resolve_kernel<kTrain, J><<<blocks, kThreads, 0, st>>>(n_lods, K, F, p);
  else if (mode == kEval)
    codebook_resolve_kernel<kEval, J><<<blocks, kThreads, 0, st>>>(n_lods, K, F, p);
  else
    codebook_resolve_kernel<kBaked, J><<<blocks, kThreads, 0, st>>>(n_lods, K, F, p);
}

template <int J>
void launch_bwd(int mode, int shared, int blocks, size_t smem, cudaStream_t st, int n_lods,
                int K, int F, const Lods& p) {
  const bool train = mode == kTrain;
  if (shared && train)
    codebook_bwd_kernel<kTrain, true, J><<<blocks, kThreads, smem, st>>>(n_lods, K, F, p);
  else if (shared)
    codebook_bwd_kernel<kEval, true, J><<<blocks, kThreads, smem, st>>>(n_lods, K, F, p);
  else if (train)
    codebook_bwd_kernel<kTrain, false, J><<<blocks, kThreads, 0, st>>>(n_lods, K, F, p);
  else
    codebook_bwd_kernel<kEval, false, J><<<blocks, kThreads, 0, st>>>(n_lods, K, F, p);
}

bool valid(int n_lods, int K, int F, int mode) {
  return n_lods >= 1 && n_lods <= kMaxLods && K >= 2 && K <= 32 * kMaxPerLane &&
         (K & (K - 1)) == 0 && F >= 1 && mode >= kTrain && mode <= kBaked;
}

}  // namespace

// lods: the host block of n_lods LODs (logits, dict, out = E, arg, start); K = 2^bw logits
// a vertex (2..256), F features a row; mode 0 train, 1 eval, 2 baked.
WISP_EXPORT int wisp_codebook_resolve(int n_lods, int K, int F, int mode, const void* lods,
                                      void* stream) {
  if (!valid(n_lods, K, F, mode)) return (int)cudaErrorInvalidValue;
  const Lods* p = static_cast<const Lods*>(lods);
  const long long V = p->start[n_lods];
  if (V <= 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long want = (V + kWarps - 1) / kWarps;
  const int blocks = (int)(want < 32LL * sms ? want : 32LL * sms);
  cudaStream_t st = (cudaStream_t)stream;
  switch (K > 128 ? 8 : K > 64 ? 4 : K > 32 ? 2 : 1) {
    case 1: launch_resolve<1>(mode, blocks, st, n_lods, K, F, *p); break;
    case 2: launch_resolve<2>(mode, blocks, st, n_lods, K, F, *p); break;
    case 4: launch_resolve<4>(mode, blocks, st, n_lods, K, F, *p); break;
    default: launch_resolve<8>(mode, blocks, st, n_lods, K, F, *p);
  }
  return (int)cudaGetLastError();
}

// lods: logits, dict, grad_e, out = d logits (train), d_dict (zeroed [K, F] a LOD), arg (the
// forward's), start; shared: sum the dictionary gradients in shared memory first (n_lods x K
// x F floats, at most 48 KB).
WISP_EXPORT int wisp_codebook_bwd(int n_lods, int K, int F, int mode, int shared,
                                  const void* lods, void* stream) {
  if (!valid(n_lods, K, F, mode)) return (int)cudaErrorInvalidValue;
  const Lods* p = static_cast<const Lods*>(lods);
  const size_t smem = shared ? (size_t)n_lods * K * F * sizeof(float) : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long V = p->start[n_lods];
  if (V <= 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long want = (V + kWarps - 1) / kWarps;
  // fewer blocks where each adds its shared copies to the tables at its end (4 an SM took
  // ~50 vertices a warp, one after another, at the codebook yaml's step)
  const long long cap = (shared ? 16LL : 32LL) * sms;
  const int blocks = (int)(want < cap ? want : cap);
  cudaStream_t st = (cudaStream_t)stream;
  switch (K > 128 ? 8 : K > 64 ? 4 : K > 32 ? 2 : 1) {
    case 1: launch_bwd<1>(mode, shared, blocks, smem, st, n_lods, K, F, *p); break;
    case 2: launch_bwd<2>(mode, shared, blocks, smem, st, n_lods, K, F, *p); break;
    case 4: launch_bwd<4>(mode, shared, blocks, smem, st, n_lods, K, F, *p); break;
    default: launch_bwd<8>(mode, shared, blocks, smem, st, n_lods, K, F, *p);
  }
  return (int)cudaGetLastError();
}
