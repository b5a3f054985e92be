// K4 (forward) — volume integration (transmittance compositing).
//
// Replaces wisp_tpu/tracers/packed_rf_tracer.py PackedRFTracer.trace :258-274. Per ray:
// tau_i = sigma_i * delta * mask_i; the exclusive optical depth is taken as the
// inclusive sum minus tau_i, as JAX does; w_i = exp(-sum_prev_i) * (1 - exp(-tau_i));
// rgb = bg*(1-alpha) + sum w_i c_i, alpha = sum w_i, depth = sum w_i t_i, hit = alpha > 0,
// and each extra channel alpha * sum w_i f_i.
//
// Bound on this card: bytes. Per sample it reads density, depth, mask and 3 colour
// floats (21 bytes) and does ~20 flops, far below the card's flop-per-byte balance.
// Design: one warp per ray; the warp walks the ray's S steps 32 at a time, a
// shuffle-based inclusive scan gives each lane its prefix inside the chunk and the last
// lane's value carries into the next chunk. Loads of one chunk are contiguous across the
// warp. The per-lane partial sums are reduced with shuffles at the end; lane 0 writes the
// ray's outputs. The scan sums in another order than a sequential cumsum, so results
// agree with the plain version to float32 rounding, not bit for bit.
//
// K4 (backward) — the autodiff of the same compositing. With gw_i = g_rgb.c_i +
// (g_alpha - g_rgb.bg) + g_depth*t_i (the cotangent of w_i) and T_i = exp(-sum_prev_i):
// dL/dtau_i = T_i*exp(-tau_i)*gw_i - sum_{k>i} w_k*gw_k, dL/ddensity_i = dL/dtau_i*delta*m_i
// and dL/dcolor_i = w_i*g_rgb. JAX differentiates the inclusive-sum-minus-tau form, whose
// gradient equals this one in exact arithmetic but not in rounding. Bound on this card:
// bytes (it reads what the forward reads, plus 16 bytes a ray of cotangents, and writes
// 16 bytes a sample) at ~40 flops a sample. Design: one warp per ray, two passes over the
// ray's steps 32 at a time. Pass 1 scans tau forward and keeps the optical depth at the
// start of each chunk in shared memory. Pass 2 walks the chunks from the last to the
// first: it recomputes tau, the prefix and w, writes the colour gradient, and a reverse
// (suffix) shuffle scan of w*gw, carried from the later chunks, gives the sum over k > i
// without subtracting two large sums.
//
// K6b / K6c — one depth segment of the segmented trace (wisp_tpu/tracers/
// packed_rf_tracer.py _trace_segmented, the scan body :362-375 and :385). The same kernels,
// instantiated with a carried per-ray optical depth A = acc_tau[r] of the segments before:
// w_i = exp(-(A + sum_prev_i)) * (1 - exp(-tau_i)), with A added inside the exponent as JAX
// writes it. The forward writes the segment's partial rgb = sum w_i c_i (no background
// term), alpha, depth, the extra columns sum w_i f_i (the tracer scales their total by the
// ray's alpha) and acc_tau_out = A + sum tau_i. The backward adds the carry: with
// gw_i = g_rgb.c_i + g_alpha + g_depth*t_i (no background term) and g_acc the cotangent of
// acc_tau_out, dL/dtau_i = T_i*exp(-tau_i)*gw_i - sum_{k>i} w_k*gw_k + g_acc and
// dL/dA = g_acc - sum_i w_i*gw_i. Bound: bytes, K4's plus 8 bytes a ray (forward: A read,
// acc_tau_out written) or 12 (backward: A and g_acc read, dL/dA written).
#include "common.cuh"

namespace {

constexpr int kMaxExtra = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(wisp::kFullMask, v, o);
  return v;
}

// kSeg: the segment form (K6b): acc_tau is read and acc_out written, rgb carries no
// background and the extra columns are not scaled by alpha; bg and hit are unused.
template <bool kSeg>
__global__ void integrate_fwd_kernel(const float* __restrict__ density,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ depths,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ color,
                                     const float* __restrict__ extra,
                                     const float* __restrict__ acc_tau, int R, int S, int Ce,
                                     float bg0, float bg1, float bg2,
                                     float* __restrict__ rgb, float* __restrict__ alpha,
                                     float* __restrict__ depth, uint8_t* __restrict__ hit,
                                     float* __restrict__ extra_out,
                                     float* __restrict__ acc_out) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = gtid >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warps leave together: a warp never straddles two rays
  const float delta = deltas[r];
  const float A = kSeg ? acc_tau[r] : 0.0f;
  float carry = 0.0f;
  float a = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  float ex[kMaxExtra];
#pragma unroll
  for (int k = 0; k < kMaxExtra; ++k) ex[k] = 0.0f;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const long long o = r * S + s;
    float tau = 0.0f;
    if (s < S) tau = density[o] * delta * (float)mask[o];
    float incl = tau;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(wisp::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    incl += carry;
    carry = __shfl_sync(wisp::kFullMask, incl, 31);
    if (s < S) {
      const float sum_prev = incl - tau;
      const float w = expf(-(kSeg ? A + sum_prev : sum_prev)) * (1.0f - expf(-tau));
      a += w;
      c0 += w * color[3 * o];
      c1 += w * color[3 * o + 1];
      c2 += w * color[3 * o + 2];
      if (depth != nullptr) dep += w * depths[o];
      for (int k = 0; k < Ce; ++k) ex[k] += w * extra[o * Ce + k];
    }
  }
  a = warp_sum(a);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  dep = warp_sum(dep);
  for (int k = 0; k < Ce; ++k) ex[k] = warp_sum(ex[k]);
  if (lane == 0) {
    alpha[r] = a;
    if (kSeg) {
      rgb[3 * r] = c0;
      rgb[3 * r + 1] = c1;
      rgb[3 * r + 2] = c2;
      acc_out[r] = A + carry;
    } else {
      rgb[3 * r] = bg0 * (1.0f - a) + c0;
      rgb[3 * r + 1] = bg1 * (1.0f - a) + c1;
      rgb[3 * r + 2] = bg2 * (1.0f - a) + c2;
      hit[r] = (uint8_t)(a > 0.0f);
    }
    if (depth != nullptr) depth[r] = dep;
    for (int k = 0; k < Ce; ++k) extra_out[r * Ce + k] = kSeg ? ex[k] : a * ex[k];
  }
}

constexpr int kBwdWarps = 8;  // warps (rays) per block of the backward

// kSeg: the segment form (K6c): A = acc_tau[r] inside the exponent, g_acc (may be null:
// zero) added to every dL/dtau_i, dL/dA written to grad_acc; bg is unused (zero).
template <bool kSeg>
__global__ void integrate_bwd_kernel(const float* __restrict__ density,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ depths,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ color,
                                     const float* __restrict__ acc_tau, int R, int S,
                                     float bg0, float bg1, float bg2,
                                     const float* __restrict__ g_rgb,
                                     const float* __restrict__ g_alpha,
                                     const float* __restrict__ g_depth,
                                     const float* __restrict__ g_acc,
                                     float* __restrict__ grad_density,
                                     float* __restrict__ grad_color,
                                     float* __restrict__ grad_acc) {
  extern __shared__ float chunk_start[];  // [kBwdWarps][nchunks] optical depth
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kBwdWarps + wid;
  if (r >= R) return;  // whole warps leave together
  const int nchunks = (S + 31) / 32;
  float* starts = chunk_start + wid * nchunks;
  const float delta = deltas[r];
  const float gr0 = g_rgb != nullptr ? g_rgb[3 * r] : 0.0f;
  const float gr1 = g_rgb != nullptr ? g_rgb[3 * r + 1] : 0.0f;
  const float gr2 = g_rgb != nullptr ? g_rgb[3 * r + 2] : 0.0f;
  const float ga = g_alpha != nullptr ? g_alpha[r] : 0.0f;
  const float gd = g_depth != nullptr ? g_depth[r] : 0.0f;
  const float g_const = kSeg ? ga : ga - (gr0 * bg0 + gr1 * bg1 + gr2 * bg2);
  const float A = kSeg ? acc_tau[r] : 0.0f;
  const float gacc = (kSeg && g_acc != nullptr) ? g_acc[r] : 0.0f;

  // pass 1: the optical depth before each chunk
  float carry = 0.0f;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int s = ci * 32 + lane;
    const long long o = r * S + s;
    float tau = 0.0f;
    if (s < S) tau = density[o] * delta * (float)mask[o];
    float incl = tau;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(wisp::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 0) starts[ci] = carry;
    carry += __shfl_sync(wisp::kFullMask, incl, 31);
  }
  __syncwarp();

  // pass 2: chunks in reverse, suffix sums of w*gw carried from the later chunks
  float later = 0.0f;
  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int s = ci * 32 + lane;
    const long long o = r * S + s;
    float tau = 0.0f;
    if (s < S) tau = density[o] * delta * (float)mask[o];
    float incl = tau;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(wisp::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    incl += starts[ci];
    float b = 0.0f, gw = 0.0f, te = 0.0f, w = 0.0f;
    if (s < S) {
      const float trans = expf(-(kSeg ? A + (incl - tau) : incl - tau));
      const float e = expf(-tau);
      w = trans * (1.0f - e);
      te = trans * e;
      const float c0 = color[3 * o], c1 = color[3 * o + 1], c2 = color[3 * o + 2];
      gw = gr0 * c0 + gr1 * c1 + gr2 * c2 + g_const;
      if (g_depth != nullptr) gw += gd * depths[o];
      b = w * gw;
      grad_color[3 * o] = w * gr0;
      grad_color[3 * o + 1] = w * gr1;
      grad_color[3 * o + 2] = w * gr2;
    }
    float suf = b;  // inclusive suffix sum within the chunk
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(wisp::kFullMask, suf, off);
      if (lane + off < 32) suf += y;
    }
    float after = __shfl_down_sync(wisp::kFullMask, suf, 1);  // sum over k > i in chunk
    if (lane == 31) after = 0.0f;
    if (s < S) {
      float dtau = gw * te - (after + later);
      if (kSeg) dtau += gacc;
      grad_density[o] = dtau * delta * (float)mask[o];
    }
    later += __shfl_sync(wisp::kFullMask, suf, 0);
  }
  if (kSeg && lane == 0) grad_acc[r] = gacc - later;
}

}  // namespace

// g_rgb [R,3], g_alpha [R], g_depth [R] (each may be null: a zero cotangent; depths may
// be null when g_depth is); grad_density [R,S] and grad_color [R,S,3] are written whole.
WISP_EXPORT int wisp_integrate_bwd(const float* density, const float* deltas,
                                   const float* depths, const uint8_t* mask,
                                   const float* color, int R, int S, float bg0, float bg1,
                                   float bg2, const float* g_rgb, const float* g_alpha,
                                   const float* g_depth, float* grad_density,
                                   float* grad_color, void* stream) {
  if (g_depth != nullptr && depths == nullptr) return (int)cudaErrorInvalidValue;
  const int nchunks = (S + 31) / 32;
  const size_t smem = (size_t)kBwdWarps * nchunks * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if ((long long)R * S > 0) {
    integrate_bwd_kernel<false><<<wisp::ceil_div(R, kBwdWarps), kBwdWarps * 32, smem,
                                  (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, nullptr, R, S, bg0, bg1, bg2, g_rgb, g_alpha,
        g_depth, nullptr, grad_density, grad_color, nullptr);
  }
  return (int)cudaGetLastError();
}

// depths/depth may be null (no depth channel); extra/extra_out null when Ce == 0.
WISP_EXPORT int wisp_integrate_fwd(const float* density, const float* deltas,
                                   const float* depths, const uint8_t* mask,
                                   const float* color, const float* extra, int R, int S,
                                   int Ce, float bg0, float bg1, float bg2, float* rgb,
                                   float* alpha, float* depth, uint8_t* hit,
                                   float* extra_out, void* stream) {
  if (Ce < 0 || Ce > kMaxExtra) return (int)cudaErrorInvalidValue;
  const long long threads_total = (long long)R * 32;
  if (threads_total > 0) {
    const int threads = 256;
    integrate_fwd_kernel<false><<<wisp::ceil_div(threads_total, threads), threads, 0,
                                  (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, extra, nullptr, R, S, Ce, bg0, bg1, bg2, rgb,
        alpha, depth, hit, extra_out, nullptr);
  }
  return (int)cudaGetLastError();
}

// K6b. acc_tau [R] in; rgb [R,3], alpha [R], acc_out [R] and, where not null, depth [R]
// and extra_out [R,Ce] out (partial sums of the segment, no background).
WISP_EXPORT int wisp_integrate_seg_fwd(const float* density, const float* deltas,
                                       const float* depths, const uint8_t* mask,
                                       const float* color, const float* extra,
                                       const float* acc_tau, int R, int S, int Ce, float* rgb,
                                       float* alpha, float* depth, float* extra_out,
                                       float* acc_out, void* stream) {
  if (Ce < 0 || Ce > kMaxExtra) return (int)cudaErrorInvalidValue;
  const long long threads_total = (long long)R * 32;
  if (threads_total > 0) {
    const int threads = 256;
    integrate_fwd_kernel<true><<<wisp::ceil_div(threads_total, threads), threads, 0,
                                 (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, extra, acc_tau, R, S, Ce, 0.0f, 0.0f, 0.0f,
        rgb, alpha, depth, nullptr, extra_out, acc_out);
  }
  return (int)cudaGetLastError();
}

// K6c. g_rgb [R,3], g_alpha [R], g_depth [R], g_acc [R] (each may be null: zero);
// grad_density [R,S], grad_color [R,S,3] and grad_acc [R] are written whole.
WISP_EXPORT int wisp_integrate_seg_bwd(const float* density, const float* deltas,
                                       const float* depths, const uint8_t* mask,
                                       const float* color, const float* acc_tau, int R, int S,
                                       const float* g_rgb, const float* g_alpha,
                                       const float* g_depth, const float* g_acc,
                                       float* grad_density, float* grad_color,
                                       float* grad_acc, void* stream) {
  if (g_depth != nullptr && depths == nullptr) return (int)cudaErrorInvalidValue;
  const int nchunks = (S + 31) / 32;
  const size_t smem = (size_t)kBwdWarps * nchunks * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    integrate_bwd_kernel<true><<<wisp::ceil_div(R, kBwdWarps), kBwdWarps * 32, smem,
                                 (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, acc_tau, R, S, 0.0f, 0.0f, 0.0f, g_rgb,
        g_alpha, g_depth, g_acc, grad_density, grad_color, grad_acc);
  }
  return (int)cudaGetLastError();
}
