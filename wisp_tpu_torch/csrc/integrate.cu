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
// and dL/dcolor_i = w_i*g_rgb; with extra columns (extra_out = alpha * E, E = sum_i w_i
// f_i) gw_i also gains g_e.(E + alpha f_i) and dL/df_i = alpha*w_i*g_e, alpha and E summed
// in the first pass (a kernel instance of its own, so that the main path, which has no
// extras, runs none of that code). JAX differentiates the inclusive-sum-minus-tau form, whose
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
// packed_rf_tracer.py _trace_segmented, the scan body :362-375 and :385), with a carried
// per-ray optical depth A = acc_tau[r] of the segments before:
// w_i = exp(-(A + sum_prev_i)) * (1 - exp(-tau_i)), with A added inside the exponent as JAX
// writes it. The forward writes the segment's partial rgb = sum w_i c_i (no background
// term), alpha, depth, the extra columns sum w_i f_i (the tracer scales their total by the
// ray's alpha) and acc_tau_out = A + sum tau_i. The backward adds the carry: with
// gw_i = g_rgb.c_i + g_alpha + g_depth*t_i (no background term) and g_acc the cotangent of
// acc_tau_out, dL/dtau_i = T_i*exp(-tau_i)*gw_i - sum_{k>i} w_k*gw_k + g_acc and
// dL/dA = g_acc - sum_i w_i*gw_i. Bound: bytes, K4's plus 8 bytes a ray (forward: A read,
// acc_tau_out written) or 12 (backward: A and g_acc read, dL/dA written). The backward is
// K4's backward kernel instantiated with the carry.
// K6b's design (integrate_seg_fwd_kernel): a segment is short (128 steps on the main path)
// and its rays few (2,048: ~16 warps an SM), so K4's forward, 32 steps a round, left each
// warp four dependent rounds of load, scan and exponentials with little to hide their
// latency (the earlier design, csrc/baselines/integrate_seg_v1.cu). Here one warp takes a
// ray and each lane kSegVec = 4 consecutive steps, so a round covers 128 steps. A lane
// issues its round's loads together (where S % 4 == 0 and the rows are aligned: a float4
// of density, a float4 of depths, one 32-bit word of the mask, three float4s of colour;
// else scalar loads), takes the inclusive prefix of its 4 taus in step order, and one
// shuffle scan of the lanes' totals gives each lane the optical depth before its steps;
// the round's total carries to the next round (S > 128). The extra columns (Ce <= 16, in
// registers) sit behind one uniform branch, so that the main path (Ce = 0) runs none of
// their code. The sums are taken in another order than K4's, so results agree with the
// plain version to float32 rounding.
#include "common.cuh"

namespace {

constexpr int kMaxExtra = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(wisp::kFullMask, v, o);
  return v;
}

__global__ void integrate_fwd_kernel(const float* __restrict__ density,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ depths,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ color,
                                     const float* __restrict__ extra, int R, int S, int Ce,
                                     float bg0, float bg1, float bg2,
                                     float* __restrict__ rgb, float* __restrict__ alpha,
                                     float* __restrict__ depth, uint8_t* __restrict__ hit,
                                     float* __restrict__ extra_out) {
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = gtid >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warps leave together: a warp never straddles two rays
  const float delta = deltas[r];
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
      const float w = expf(-sum_prev) * (1.0f - expf(-tau));
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
    rgb[3 * r] = bg0 * (1.0f - a) + c0;
    rgb[3 * r + 1] = bg1 * (1.0f - a) + c1;
    rgb[3 * r + 2] = bg2 * (1.0f - a) + c2;
    hit[r] = (uint8_t)(a > 0.0f);
    if (depth != nullptr) depth[r] = dep;
    for (int k = 0; k < Ce; ++k) extra_out[r * Ce + k] = a * ex[k];
  }
}

constexpr int kSegVec = 4;                 // K6b: consecutive steps a lane
constexpr int kSegRound = 32 * kSegVec;    // K6b: steps a round of a warp

// K6b. kVector: S % 4 == 0 and density, depths (where read), colour on 16 bytes and the
// mask on 4, so that a lane's steps load as vectors.
template <bool kVector>
__global__ void __launch_bounds__(256)
integrate_seg_fwd_kernel(const float* __restrict__ density, const float* __restrict__ deltas,
                         const float* __restrict__ depths, const uint8_t* __restrict__ mask,
                         const float* __restrict__ color, const float* __restrict__ extra,
                         const float* __restrict__ acc_tau, int R, int S, int Ce,
                         float* __restrict__ rgb, float* __restrict__ alpha,
                         float* __restrict__ depth, float* __restrict__ extra_out,
                         float* __restrict__ acc_out) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warps leave together
  const float delta = deltas[r];
  const float A = acc_tau[r];
  float carry = 0.0f;
  float a = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dep = 0.0f;
  float ex[kMaxExtra];
#pragma unroll
  for (int k = 0; k < kMaxExtra; ++k) ex[k] = 0.0f;
  for (int s0 = 0; s0 < S; s0 += kSegRound) {
    const int sl = s0 + kSegVec * lane;          // the lane's first step
    const long long o = r * S + sl;
    // the round's loads, all issued before any arithmetic
    float dens[kSegVec], dp[kSegVec], col[3 * kSegVec];
    uint32_t m = 0u;                             // byte j: the mask of step sl + j
#pragma unroll
    for (int j = 0; j < kSegVec; ++j) dens[j] = dp[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 3 * kSegVec; ++j) col[j] = 0.0f;
    if (kVector) {
      if (sl < S) {                              // S % 4 == 0: all 4 steps are in the row
        const float4 dv = __ldg(reinterpret_cast<const float4*>(density + o));
        dens[0] = dv.x; dens[1] = dv.y; dens[2] = dv.z; dens[3] = dv.w;
        m = __ldg(reinterpret_cast<const unsigned int*>(mask + o));
        const float4* cv = reinterpret_cast<const float4*>(color + 3 * o);
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float4 c = __ldg(cv + v);
          col[4 * v] = c.x; col[4 * v + 1] = c.y; col[4 * v + 2] = c.z; col[4 * v + 3] = c.w;
        }
        if (depth != nullptr) {
          const float4 tv = __ldg(reinterpret_cast<const float4*>(depths + o));
          dp[0] = tv.x; dp[1] = tv.y; dp[2] = tv.z; dp[3] = tv.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSegVec; ++j) {
        if (sl + j < S) {
          dens[j] = density[o + j];
          m |= (uint32_t)mask[o + j] << (8 * j);
#pragma unroll
          for (int c = 0; c < 3; ++c) col[3 * j + c] = color[3 * (o + j) + c];
          if (depth != nullptr) dp[j] = depths[o + j];
        }
      }
    }
    // the lane's inclusive prefix in step order, then a scan of the lanes' totals
    float tau[kSegVec], incl[kSegVec];
    float run = 0.0f;
#pragma unroll
    for (int j = 0; j < kSegVec; ++j) {
      tau[j] = dens[j] * delta * (float)((m >> (8 * j)) & 0xffu);
      run += tau[j];
      incl[j] = run;
    }
    float x = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(wisp::kFullMask, x, off);
      if (lane >= off) x += y;
    }
    float before = __shfl_up_sync(wisp::kFullMask, x, 1);   // the lanes before this one
    if (lane == 0) before = 0.0f;
    const float base = carry + before;
    carry += __shfl_sync(wisp::kFullMask, x, 31);
    float w[kSegVec];
#pragma unroll
    for (int j = 0; j < kSegVec; ++j) {
      w[j] = 0.0f;
      if (sl + j < S) {
        const float sum_prev = (base + incl[j]) - tau[j];
        w[j] = expf(-(A + sum_prev)) * (1.0f - expf(-tau[j]));
        a += w[j];
        c0 += w[j] * col[3 * j];
        c1 += w[j] * col[3 * j + 1];
        c2 += w[j] * col[3 * j + 2];
        dep += w[j] * dp[j];
      }
    }
    // the extra columns behind one uniform branch: their predicated code run at every
    // round cost the main path (Ce = 0) ~0.8 us a segment (chip_scatter_seg_bench.py,
    // "per-step extras"; PERF.md)
    if (Ce > 0) {
#pragma unroll
      for (int j = 0; j < kSegVec; ++j) {
        if (sl + j < S) {
#pragma unroll
          for (int k = 0; k < kMaxExtra; ++k)
            if (k < Ce) ex[k] += w[j] * extra[(o + j) * Ce + k];
        }
      }
    }
  }
  a = warp_sum(a);
  c0 = warp_sum(c0);
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  dep = warp_sum(dep);
  if (Ce > 0) {
#pragma unroll
    for (int k = 0; k < kMaxExtra; ++k)
      if (k < Ce) ex[k] = warp_sum(ex[k]);
  }
  if (lane == 0) {
    alpha[r] = a;
    rgb[3 * r] = c0;
    rgb[3 * r + 1] = c1;
    rgb[3 * r + 2] = c2;
    acc_out[r] = A + carry;
    if (depth != nullptr) depth[r] = dep;
    if (Ce > 0) {
#pragma unroll
      for (int k = 0; k < kMaxExtra; ++k)
        if (k < Ce) extra_out[r * Ce + k] = ex[k];
    }
  }
}

constexpr int kBwdWarps = 8;  // warps (rays) per block of the backward

// kSeg: the segment form (K6c): A = acc_tau[r] inside the exponent, g_acc (may be null:
// zero) added to every dL/dtau_i, dL/dA written to grad_acc; bg is unused (zero).
// kExtra (K4 only): the Ce extra columns f_i [R,S,Ce] with their cotangent g_e [R,Ce] of
// extra_out = alpha * E, E = sum_i w_i f_i. Pass 1 then also sums alpha and E; the
// cotangent of w_i gains sum_k g_ek (E_k + alpha f_ik) (g_e.E joins the ray's constant
// term), and grad_extra_i = alpha * w_i * g_e.
template <bool kSeg, bool kExtra>
__global__ void integrate_bwd_kernel(const float* __restrict__ density,
                                     const float* __restrict__ deltas,
                                     const float* __restrict__ depths,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ color,
                                     const float* __restrict__ extra, int Ce,
                                     const float* __restrict__ acc_tau, int R, int S,
                                     float bg0, float bg1, float bg2,
                                     const float* __restrict__ g_rgb,
                                     const float* __restrict__ g_alpha,
                                     const float* __restrict__ g_depth,
                                     const float* __restrict__ g_acc,
                                     const float* __restrict__ g_extra,
                                     float* __restrict__ grad_density,
                                     float* __restrict__ grad_color,
                                     float* __restrict__ grad_acc,
                                     float* __restrict__ grad_extra) {
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
  float g_const = kSeg ? ga : ga - (gr0 * bg0 + gr1 * bg1 + gr2 * bg2);
  const float A = kSeg ? acc_tau[r] : 0.0f;
  const float gacc = (kSeg && g_acc != nullptr) ? g_acc[r] : 0.0f;
  float ge[kMaxExtra], ex[kMaxExtra];
  float alpha_x = 0.0f;
  if (kExtra) {
#pragma unroll
    for (int k = 0; k < kMaxExtra; ++k) {
      ge[k] = k < Ce ? g_extra[r * Ce + k] : 0.0f;
      ex[k] = 0.0f;
    }
  }

  // pass 1: the optical depth before each chunk (and, with extras, alpha and E)
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
    if (kExtra && s < S) {
      const float w = expf(-((incl + carry) - tau)) * (1.0f - expf(-tau));
      alpha_x += w;
#pragma unroll
      for (int k = 0; k < kMaxExtra; ++k)
        if (k < Ce) ex[k] += w * extra[o * Ce + k];
    }
    carry += __shfl_sync(wisp::kFullMask, incl, 31);
  }
  __syncwarp();
  if (kExtra) {
    alpha_x = warp_sum(alpha_x);
#pragma unroll
    for (int k = 0; k < kMaxExtra; ++k)
      if (k < Ce) g_const += ge[k] * warp_sum(ex[k]);
  }

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
      if (kExtra) {
        float xf = 0.0f;
#pragma unroll
        for (int k = 0; k < kMaxExtra; ++k) {
          if (k < Ce) {
            xf += ge[k] * extra[o * Ce + k];
            grad_extra[o * Ce + k] = alpha_x * w * ge[k];
          }
        }
        gw += alpha_x * xf;
      }
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
// extra [R,S,Ce] and g_extra [R,Ce], the extra columns and their cotangent, with
// grad_extra [R,S,Ce] written whole: all three null (Ce = 0) for none.
WISP_EXPORT int wisp_integrate_bwd(const float* density, const float* deltas,
                                   const float* depths, const uint8_t* mask,
                                   const float* color, const float* extra, int R, int S,
                                   int Ce, float bg0, float bg1, float bg2, const float* g_rgb,
                                   const float* g_alpha, const float* g_depth,
                                   const float* g_extra, float* grad_density,
                                   float* grad_color, float* grad_extra, void* stream) {
  if (g_depth != nullptr && depths == nullptr) return (int)cudaErrorInvalidValue;
  if (Ce < 0 || Ce > kMaxExtra) return (int)cudaErrorInvalidValue;
  const bool with_extra = Ce > 0;
  if ((long long)R * S > 0 &&
      (with_extra != (extra != nullptr) || with_extra != (g_extra != nullptr) ||
       with_extra != (grad_extra != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int nchunks = (S + 31) / 32;
  const size_t smem = (size_t)kBwdWarps * nchunks * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if ((long long)R * S > 0) {
    const unsigned blocks = wisp::ceil_div(R, kBwdWarps);
    if (with_extra)
      integrate_bwd_kernel<false, true><<<blocks, kBwdWarps * 32, smem,
                                          (cudaStream_t)stream>>>(
          density, deltas, depths, mask, color, extra, Ce, nullptr, R, S, bg0, bg1, bg2,
          g_rgb, g_alpha, g_depth, nullptr, g_extra, grad_density, grad_color, nullptr,
          grad_extra);
    else
      integrate_bwd_kernel<false, false><<<blocks, kBwdWarps * 32, smem,
                                           (cudaStream_t)stream>>>(
          density, deltas, depths, mask, color, nullptr, 0, nullptr, R, S, bg0, bg1, bg2,
          g_rgb, g_alpha, g_depth, nullptr, nullptr, grad_density, grad_color, nullptr,
          nullptr);
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
    integrate_fwd_kernel<<<wisp::ceil_div(threads_total, threads), threads, 0,
                           (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, extra, R, S, Ce, bg0, bg1, bg2, rgb, alpha,
        depth, hit, extra_out);
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
    const unsigned blocks = wisp::ceil_div(threads_total, threads);
    const bool vector = S % kSegVec == 0 && (uintptr_t)density % 16 == 0 &&
                        (uintptr_t)color % 16 == 0 && (uintptr_t)mask % 4 == 0 &&
                        (depth == nullptr || (uintptr_t)depths % 16 == 0);
    if (vector)
      integrate_seg_fwd_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          density, deltas, depths, mask, color, extra, acc_tau, R, S, Ce, rgb, alpha, depth,
          extra_out, acc_out);
    else
      integrate_seg_fwd_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          density, deltas, depths, mask, color, extra, acc_tau, R, S, Ce, rgb, alpha, depth,
          extra_out, acc_out);
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
    integrate_bwd_kernel<true, false><<<wisp::ceil_div(R, kBwdWarps), kBwdWarps * 32, smem,
                                        (cudaStream_t)stream>>>(
        density, deltas, depths, mask, color, nullptr, 0, acc_tau, R, S, 0.0f, 0.0f, 0.0f,
        g_rgb, g_alpha, g_depth, g_acc, nullptr, grad_density, grad_color, grad_acc, nullptr);
  }
  return (int)cudaGetLastError();
}
