// K3 — step-major sample compaction and scatter-back.
//
// Replaces wisp_tpu/ops/compaction.py masked_compact_indices (:23) together with the
// tracer's step-major remap, gathers and scatter-back (wisp_tpu/tracers/
// packed_rf_tracer.py:188-222). The valid samples of an [R, S] mask are packed in
// step-major order (position p = s*R + r) into a budget of B slots: slot k holds the flat
// row-major index r*S + s of the k-th valid sample, so when more than B samples are valid
// the latest steps across all rays are dropped. Only the first min(count, B) slots are
// written: the tracer reads no other (JAX fills the rest with R*S and the last sample, and
// so does the plain version, which the CPU parity tests hold against JAX). The point and
// the ray direction of every kept slot are gathered in the same pass; count is the
// uncapped number of valid samples. scatter_back writes per-slot rows [K, C] back into a
// zero-filled [R*S, C].
//
// K6a — the live cull of the segmented trace (wisp_tpu/tracers/packed_rf_tracer.py
// _trace_segmented :338-343): with a per-ray carried optical depth acc_tau [R] and a cap
// tau_cap = -log(eps), sample (r, s) is valid iff mask[r*S+s] && acc_tau[r] < tau_cap
// (float32), so the samples of rays whose transmittance fell to eps or below are neither
// counted nor kept. The order, the kept-slot contract and the count are those of K3.
//
// Design of K3 / K6a (wisp_compact), two launches. The mask is row-major [R, S] while the
// slots are step-major, so a block takes a tile of 256 rays x 32 steps: one ray a thread,
// whose 32 step bytes are contiguous in its row and are read as 16-byte vectors (4-byte
// words where the row or the pointer is not 16-byte aligned, bytes at an odd S), so every
// sector of the mask that is fetched is used whole. Each thread folds its 32 bytes into one
// 32-bit word (bit k: step s0 + k is valid; K6a reads acc_tau once a ray and clears the
// word of a culled ray). The tile is transposed to step-major order in registers rather
// than in shared memory: a warp's 32 ballots of those words are its 32 x 32 bit tile by
// steps (ballot k: the warp's rays valid at step s0 + k, in ray order), lane k keeps
// ballot k, and __popc of a ballot under a lane ranks that lane's sample in the step.
//   1. count: each block stores its warps' ballots (one bit a sample: R*S/8 bytes of
//      scratch on the main path's shapes), writes its per-step counts to counts[s * nR +
//      jr] (nR ray tiles) and adds them to group_totals[s * nG + jr / 32] (atomics; a
//      group is 32 ray tiles). The last block to finish (a counter taken with atomicAdd
//      after a fence) scans the S * nG group totals in step-major order into the groups'
//      first slots, writes the uncapped count, and sets the totals and the counter back to
//      0. That scan is a few thousand ints at most on the main path (512 x 2 at a render
//      chunk), so no launch of its own is needed.
//   2. write: each block reads its warps' ballots (not the mask again), gets each step's
//      first slot as its group's first slot plus the counts of the (at most 31) ray tiles
//      before it in the group, one a lane, plus the warps before it in the block. Then 8
//      steps at a time, each lane loads its ray's points of those steps together (they
//      are contiguous in samples) and writes each valid one to its slot with the ray's
//      direction and its index. No block-wide scan.
//   On the card, writing each warp's samples in slot order (32 consecutive slots a store)
//   or staging a block's runs of slots in shared memory made the write pass slower than
//   these per-step stores (PERF.md, section 6, the compaction redesign).
// Bound on this card: bytes. The mask once (1 byte a sample), acc_tau once (K6a), each
// kept sample's 12-byte point read and 8 + 12 + 12 bytes written. The design adds the
// ballots, written once and read once (1 bit a sample).
//
// K12 compaction — the SDF tracer's active-ray compaction (wisp_tpu/tracers/
// packed_sdf_tracer.py:168-220, over wisp_tpu/ops/compaction.py masked_compact_indices on
// an [R, 1] mask): the rays of an [R] mask in order into B slots. The payload of a kept
// slot is its ray's row: origin and direction (3 floats each), its walk depth t and its
// exit t_far. Unlike K3, every one of the B slots is defined, as JAX defines them: the
// slots past the count hold index R and the payload of ray R-1 (JAX's jnp.minimum(idx,
// R - 1) gather), so the sphere loop can run on all B slots with the empty ones masked
// dead. The mid-loop re-compaction is the same entry point on the first pass's B slots.
//
// Design of K12 (wisp_compact_rays): one launch, a single-pass scan with decoupled
// look-back. A block takes a ticket from an atomic counter, so the tiles before its own
// are already running; tickets below the tile count are tiles of 1,024 rays (8 warps of
// 4 ballots of 32 rays), the rest are fill blocks of 2,048 slots. A tile counts its rays
// with ballots, publishes its aggregate, looks back over its predecessors' status words
// (one warp, 32 at a time: aggregates are summed until an inclusive prefix is found),
// publishes its inclusive prefix and writes its kept rays, ranked by __popc of the ballot
// under each lane. The last tile writes the count. A fill block waits for the last tile's
// inclusive prefix (the total) and writes JAX's fill into its slots at or past it.
// Bound on this card: bytes: 1 byte of mask a ray, 32 bytes read and 8 + 32 written a kept
// slot, 8 + 32 written a filled slot.
//
// State across calls. Nothing is cleared by a memset or an extra launch. The wrapper keeps
// one set of words a stream, made zero once: K3's block counter and group totals are set
// back to 0 by the last block of the count pass; K12's ticket counter is set back to 0 by
// the block that takes the last ticket (every block has taken its ticket by then), and
// each K12 status word carries the call's epoch (a number the wrapper raises every call,
// never 0) in its upper 32 bits, so a word left by an earlier call never matches. Calls on
// one stream run in order, and calls on two streams use two sets of words, so a call
// reads no state of another. Positions, counts and prefixes are int32: R*S < 2^31.
//
// scatter_rows — the tracer's scatter-back of the compacted slots (`.at[idx].set(v,
// mode="drop")` onto a given base, packed_sdf_tracer.py:200-217): out_c[idx[k]] = v_c[k] for
// the first K slots whose index is below P, for every channel c of a chunk (t, xyz, hit,
// normal and the extras; the mid pass's t and hit), rows of any width in bytes. Bound: bytes,
// one 8-byte index a slot and each channel's row read and written a kept slot. The earlier
// design (csrc/baselines/scatter_rows_v1.cu) took a launch a channel, each re-reading the
// index to move a 1-12 byte row, so a chunk paid the launch floor (~1.5 us) four times.
// Design (wisp_scatter_rows_many): one launch for up to kScatterChannels channels, whose
// table (source, destination, row bytes and the width of a move) is a kernel parameter.
// One thread a slot: it loads the slot's index once and, with it, every channel's row of
// at most 16 bytes into registers, then stores the rows where the index is kept. So a slot
// waits for one memory round trip, not one a channel: copying the channels in turn, a
// row's load waits for the previous row's store (the compiler cannot tell the channels'
// rows apart). A longer row (an extra channel of more than 4 floats) is copied after them.
// A few lanes a slot, one a channel, lost the stores' coalescing over the sorted slots
// (chip_scatter_seg_bench.py; PERF.md). A row moves with the widest move
// that its width and both base addresses allow (16, 8, 4 or 1 bytes; a row of a multiple
// of w bytes at a base aligned to w keeps every row aligned to w). The kept slots'
// indices are distinct (one slot a ray), so no two threads write one row; the copy moves
// bits, equal to the plain version's.
//
// scatter_back backward (the autodiff of packed_rf_tracer.py:214, the `.at[idx].set`
// scatter of every differentiable channel of a trace or segment, colour and density):
// grad_v_c[k] = grad_out_c[idx[k]], a row of each channel's cotangent at the slot's sample
// index (0 for an empty slot, index P). Bound on this card: bytes, one 8-byte index a slot
// and each channel's row read and written (16 bytes for colour and density). The earlier
// design (baselines/scatter_back_bwd_v1.cu) took a launch a channel and a thread a (slot,
// column), each dividing its flat index by C in 64 bits, and density's cotangent reached it
// through the select view's backward (a zero fill and a copy over the n x s floats).
// Design (wisp_scatter_back_bwd_many): one launch for up to kGatherEntries entries of at
// most kGatherLanes columns in all, whose table (source, destination, columns, row stride,
// in floats, and each entry's first lane) is a kernel parameter. L lanes a slot, L the
// least power of two >= the columns (4 for colour and density): lane j of a slot moves
// column j of the slots' concatenated rows, so a warp's loads and stores each cover 32 / L
// consecutive slots' rows (colour's 12-byte rows of 8 slots are 96 contiguous bytes of
// output), and the L lanes' loads of the slot's index are one broadcast; a shift and a mask
// give the slot and lane, no division. On the card (chip_feedback_gather_bench.py, at the
// shape of flagship train step 25, 124,260 slots) this took 0.0039-0.0040 ms where one
// thread a slot (its index, then every row, then the stores) took 0.0041-0.0042 (0.0048
// in the redesign's first build, whose table loop predicated 32 loads a thread) and a
// block's rows staged through shared memory for coalesced stores 0.0041-0.0042. Density's
// cotangent is read as the flat [n*s] that K4's or K6c's backward wrote. A float is
// copied, so the result is exact.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRays = kThreads;            // K3: one ray a thread ...
constexpr int kTileSteps = 32;                 // ... and one bit a step of a 32-bit word
constexpr int kGroupTiles = 32;                // K3: ray tiles whose counts a step adds up
constexpr int kBatch = 8;                      // K3: steps whose points a lane loads at once
constexpr int kGroups = 4;                     // K12: ballots of 32 rays a warp
constexpr int kRayTile = kThreads * kGroups;   // K12: rays a tile
constexpr int kFillSlots = kThreads * 8;       // K12: slots a fill block
constexpr unsigned long long kInclusive = 1ull << 31;   // status flag; else an aggregate
constexpr unsigned long long kValueMask = kInclusive - 1;
constexpr int kScatterChannels = 8;            // scatter_rows: channels a launch
constexpr int kGatherEntries = 8;              // scatter_back backward: entries a launch
constexpr int kGatherLanes = 32;               // ... of at most 32 columns in all

// bit k set where byte k of w is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// Bit k: sample (r, s0 + k) is valid, for k < min(32, S - s0); 0 for a ray past R or one
// that acc_tau culls. W is the width of the row's loads in bytes (16, 4 or 1), which the
// launcher picks from S and the mask's alignment.
template <int W>
__device__ __forceinline__ uint32_t tile_bits(const uint8_t* __restrict__ mask,
                                              const float* __restrict__ acc_tau,
                                              float tau_cap, long long r, int R, int S,
                                              int s0) {
  if (r >= R || (acc_tau != nullptr && !(acc_tau[r] < tau_cap))) return 0u;
  const uint8_t* row = mask + r * S + s0;
  const int n = min(kTileSteps, S - s0);
  uint32_t bits = 0u;
  if (W == 16) {
#pragma unroll
    for (int c = 0; c < kTileSteps / 16; ++c) {
      if (16 * c < n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + c);
        bits |= (nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4) | (nonzero_bytes(v.z) << 8)
                 | (nonzero_bytes(v.w) << 12)) << (16 * c);
      }
    }
  } else if (W == 4) {
#pragma unroll
    for (int c = 0; c < kTileSteps / 4; ++c)
      if (4 * c < n)
        bits |= nonzero_bytes(__ldg(reinterpret_cast<const uint32_t*>(row) + c)) << (4 * c);
  } else {
    for (int k = 0; k < n; ++k) bits |= (uint32_t)(row[k] != 0) << k;
  }
  return bits;
}

// Lane k of the warp receives the ballot of bit k: the lanes whose bit k is set.
__device__ __forceinline__ uint32_t step_ballots(uint32_t bits, int lane) {
  uint32_t mine = 0u;
#pragma unroll
  for (int k = 0; k < kTileSteps; ++k) {
    const uint32_t b = __ballot_sync(wisp::kFullMask, (bits >> k) & 1u);
    mine = lane == k ? b : mine;
  }
  return mine;
}

// Pass 1 of K3 / K6a. Block b takes step tile b % nS of ray tile b / nS.
template <int W>
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, const float* __restrict__ acc_tau,
             float tau_cap, int R, int S, int nR, int nS, int nG,
             uint32_t* __restrict__ ballots, int* __restrict__ counts,
             int* __restrict__ group_prefix, int* __restrict__ group_totals,
             unsigned int* __restrict__ done, long long* __restrict__ count) {
  __shared__ int warp_counts[kWarps][kTileSteps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int js = blockIdx.x % nS, jr = blockIdx.x / nS;
  const int s0 = js * kTileSteps;
  const uint32_t bits = tile_bits<W>(mask, acc_tau, tau_cap,
                                     (long long)jr * kTileRays + threadIdx.x, R, S, s0);
  const uint32_t ballot = step_ballots(bits, lane);
  ballots[(long long)blockIdx.x * kThreads + threadIdx.x] = ballot;
  warp_counts[warp][lane] = __popc(ballot);
  __syncthreads();
  const int s = s0 + (int)threadIdx.x;
  if (threadIdx.x < kTileSteps && s < S) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += warp_counts[w][threadIdx.x];
    counts[(long long)s * nR + jr] = c;
    if (c) atomicAdd(group_totals + (long long)s * nG + jr / kGroupTiles, c);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every block's counts and group totals are in place. Scan the group
  // totals in step-major order, each thread a run of them, and leave them 0.
  __threadfence();
  const int m = S * nG;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(m, per * (int)threadIdx.x), hi = min(m, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += __ldcg(group_totals + i);
  int total;
  int run = wisp::block_exclusive_scan(sum, total);
  for (int i = lo; i < hi; ++i) {
    const int v = __ldcg(group_totals + i);
    group_prefix[i] = run;
    run += v;
    group_totals[i] = 0;
  }
  if (threadIdx.x == 0) {
    *count = total;
    *done = 0u;
  }
}

// Pass 2 of K3 / K6a: the kept slots of the block's tile, from its ballots.
__global__ void __launch_bounds__(kThreads)
write_kernel(const float* __restrict__ samples, const float* __restrict__ dirs, int R, int S,
             int nR, int nS, int nG, long long budget, const uint32_t* __restrict__ ballots,
             const int* __restrict__ counts, const int* __restrict__ group_prefix,
             long long* __restrict__ idx, float* __restrict__ cflat,
             float* __restrict__ cray_d) {
  __shared__ int warp_counts[kWarps][kTileSteps];
  __shared__ int step_base[kTileSteps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int js = blockIdx.x % nS, jr = blockIdx.x / nS;
  const int s0 = js * kTileSteps;
  const long long r = (long long)jr * kTileRays + threadIdx.x;
  // lane k: the ballot of step s0 + k, the warp's rays valid at that step
  const uint32_t ballot = ballots[(long long)blockIdx.x * kThreads + threadIdx.x];
  warp_counts[warp][lane] = __popc(ballot);
  // each warp: the first slot of kTileSteps / kWarps of the tile's steps, the prefix of
  // the step's group of ray tiles plus the counts of the tiles before this one in it
  const int g0 = jr - jr % kGroupTiles;
  for (int i = 0; i < kTileSteps / kWarps; ++i) {
    const int k = warp * (kTileSteps / kWarps) + i;
    const int s = s0 + k;
    int before = s < S && g0 + lane < jr ? counts[(long long)s * nR + g0 + lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(wisp::kFullMask, before, o);
    if (lane == 0)
      step_base[k] = s < S ? group_prefix[(long long)s * nG + jr / kGroupTiles] + before : 0;
  }
  __syncthreads();
  if (__any_sync(wisp::kFullMask, ballot != 0u) == 0) return;
  // lane k: the slot of this warp's first valid sample at step s0 + k
  int base = step_base[lane];
  for (int w = 0; w < warp; ++w) base += warp_counts[w][lane];
  const unsigned below = (1u << lane) - 1u;
  float d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) d[a] = r < R ? dirs[3 * r + a] : 0.0f;
  // kBatch steps at a time: the lane's points of those steps are loaded together (they are
  // contiguous in samples), then each step's ballot ranks them and they are written
  for (int k0 = 0; k0 < kTileSteps; k0 += kBatch) {
    uint32_t b[kBatch];
    uint32_t any = 0u;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      b[i] = __shfl_sync(wisp::kFullMask, ballot, k0 + i);
      any |= b[i];
    }
    if (any == 0u) continue;
    const long long q0 = r * S + s0 + k0;
    float p[kBatch][3];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        p[i][a] = (b[i] >> lane) & 1u ? samples[3 * (q0 + i) + a] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const long long slot =
          (long long)__shfl_sync(wisp::kFullMask, base, k0 + i) + __popc(b[i] & below);
      if (((b[i] >> lane) & 1u) && slot < budget) {
        idx[slot] = q0 + i;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          cflat[3 * slot + a] = p[i][a];
          cray_d[3 * slot + a] = d[a];
        }
      }
    }
  }
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// One warp: the exclusive prefix of tile `tile` > 0 from its predecessors' status words.
__device__ int look_back(const unsigned long long* status, int tile, unsigned int epoch,
                         int lane) {
  int prefix = 0;
  for (int end = tile;; end -= 32) {
    const int pred = end - 1 - lane;     // lane 0: the nearest predecessor
    unsigned long long w;
    bool ready;
    do {
      // a lane before tile 0 reads as an inclusive prefix of 0; tile 0 is inclusive, so
      // such a lane lies past the first inclusive one and adds nothing
      w = pred >= 0 ? load_status(status + pred)
                    : ((unsigned long long)epoch << 32 | kInclusive);
      ready = (unsigned int)(w >> 32) == epoch;
    } while (!__all_sync(wisp::kFullMask, ready));
    const unsigned inclusive = __ballot_sync(wisp::kFullMask, (w & kInclusive) != 0);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int v = lane <= stop ? (int)(w & kValueMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(wisp::kFullMask, v, o);
    prefix += v;
    if (inclusive) return prefix;
  }
}

__device__ __forceinline__ void copy_ray(long long slot, long long r,
                                         const float* __restrict__ origins,
                                         const float* __restrict__ dirs,
                                         const float* __restrict__ t,
                                         const float* __restrict__ t_far,
                                         float* __restrict__ o_c, float* __restrict__ d_c,
                                         float* __restrict__ t_c, float* __restrict__ tf_c) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o_c[3 * slot + a] = origins[3 * r + a];
    d_c[3 * slot + a] = dirs[3 * r + a];
  }
  t_c[slot] = t[r];
  tf_c[slot] = t_far[r];
}

// K12 compaction: n_tiles tiles of kRayTile rays, then fill blocks of kFillSlots slots.
__global__ void __launch_bounds__(kThreads)
compact_rays_kernel(const uint8_t* __restrict__ mask, int R, long long budget, int n_tiles,
                    const float* __restrict__ origins, const float* __restrict__ dirs,
                    const float* __restrict__ t, const float* __restrict__ t_far,
                    unsigned long long* __restrict__ status, unsigned int* __restrict__ ticket,
                    unsigned int epoch, long long* __restrict__ count,
                    long long* __restrict__ idx, float* __restrict__ o_c,
                    float* __restrict__ d_c, float* __restrict__ t_c,
                    float* __restrict__ tf_c) {
  __shared__ int s_ticket, s_prefix;
  __shared__ int warp_prefix[kWarps];
  const unsigned long long tag = (unsigned long long)epoch << 32;
  if (threadIdx.x == 0) {
    const unsigned int tk = atomicAdd(ticket, 1u);
    if (tk == gridDim.x - 1) atomicExch(ticket, 0u);   // every block has its ticket
    s_ticket = (int)tk;
  }
  __syncthreads();
  const int tile = s_ticket;
  if (tile >= n_tiles) {                 // a fill block: JAX's fill at or past the count
    if (threadIdx.x == 0) {
      unsigned long long w;
      while (true) {
        w = load_status(status + n_tiles - 1);
        if ((unsigned int)(w >> 32) == epoch && (w & kInclusive)) break;
        __nanosleep(100);
      }
      s_prefix = (int)(w & kValueMask);
    }
    __syncthreads();
    const long long lo = (long long)(tile - n_tiles) * kFillSlots;
    const long long hi = min(budget, lo + kFillSlots);
    for (long long slot = max(lo, (long long)s_prefix) + threadIdx.x; slot < hi;
         slot += kThreads) {
      idx[slot] = R;
      copy_ray(slot, R - 1, origins, dirs, t, t_far, o_c, d_c, t_c, tf_c);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)tile * kRayTile + warp * (32 * kGroups) + lane;
  unsigned ballots[kGroups];
  int mine = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long r = r0 + 32 * g;
    ballots[g] = __ballot_sync(wisp::kFullMask, r < R && mask[r] != 0);
    mine += __popc(ballots[g]);
  }
  if (lane == 0) warp_prefix[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_prefix[lane] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(wisp::kFullMask, x, o);
      if (lane >= o) x += y;
    }
    const int aggregate = __shfl_sync(wisp::kFullMask, x, kWarps - 1);
    if (lane < kWarps) warp_prefix[lane] = x - v;
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, tag | kInclusive | (unsigned long long)aggregate);
    } else {
      if (lane == 0) store_status(status + tile, tag | (unsigned long long)aggregate);
      prefix = look_back(status, tile, epoch, lane);
      if (lane == 0)
        store_status(status + tile, tag | kInclusive | (unsigned long long)(prefix + aggregate));
    }
    if (lane == 0) {
      s_prefix = prefix;
      if (tile == n_tiles - 1) *count = (long long)prefix + aggregate;
    }
  }
  __syncthreads();
  long long slot0 = (long long)s_prefix + warp_prefix[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const unsigned b = ballots[g];
    const long long slot = slot0 + __popc(b & below);
    if (((b >> lane) & 1u) && slot < budget) {
      const long long r = r0 + 32 * g;
      idx[slot] = r;
      copy_ray(slot, r, origins, dirs, t, t_far, o_c, d_c, t_c, tf_c);
    }
    slot0 += __popc(b);
  }
}

// K3's scatter-back: one thread a (slot, float) of the [K, C] rows
__global__ void scatter_floats_kernel(const uint32_t* __restrict__ v,
                                      const long long* __restrict__ idx, long long K, int C,
                                      long long P, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * C) return;
  const long long k = i / C;
  const int c = (int)(i % C);
  const long long q = idx[k];
  if (q < P) out[q * C + c] = v[i];
}

// scatter_rows: each channel's source and destination rows, row bytes and bytes a move
struct ScatterTable {
  const uint8_t* src[kScatterChannels];
  uint8_t* dst[kScatterChannels];
  int row_bytes[kScatterChannels];
  int move[kScatterChannels];
  int n;
};

constexpr int kRowMoves = 4;     // scatter_rows: moves of a long row loaded before stores

// A row of at most 16 bytes, in registers (indexed only by constants).
union SmallRow {
  uint4 v;
  uint2 d[2];
  uint32_t w[4];
  uint8_t b[16];
};

// Load (kStore false) or store a row of rb <= 16 bytes with moves of `move` bytes.
template <bool kStore>
__device__ __forceinline__ void small_row(const uint8_t* src, uint8_t* dst, int rb, int move,
                                          SmallRow& r) {
  switch (move) {
    case 16:
      if (kStore) *reinterpret_cast<uint4*>(dst) = r.v;
      else r.v = *reinterpret_cast<const uint4*>(src);
      break;
    case 8:
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (8 * i < rb) {
          if (kStore) reinterpret_cast<uint2*>(dst)[i] = r.d[i];
          else r.d[i] = reinterpret_cast<const uint2*>(src)[i];
        }
      break;
    case 4:
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * i < rb) {
          if (kStore) reinterpret_cast<uint32_t*>(dst)[i] = r.w[i];
          else r.w[i] = reinterpret_cast<const uint32_t*>(src)[i];
        }
      break;
    default:
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < rb) {
          if (kStore) dst[i] = r.b[i];
          else r.b[i] = src[i];
        }
  }
}

// A row of any length: each batch of kRowMoves loads issued before its stores.
template <typename W>
__device__ __forceinline__ void copy_row(const uint8_t* src, uint8_t* dst, int moves) {
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  for (int i = 0; i < moves; i += kRowMoves) {
    W r[kRowMoves];
#pragma unroll
    for (int j = 0; j < kRowMoves; ++j)
      if (i + j < moves) r[j] = s[i + j];
#pragma unroll
    for (int j = 0; j < kRowMoves; ++j)
      if (i + j < moves) d[i + j] = r[j];
  }
}

// One thread a slot: its index and every channel's row of at most 16 bytes are loaded
// together (the rows into registers), then stored where the index is kept; a longer row
// is copied after them.
__global__ void __launch_bounds__(kThreads)
scatter_rows_many_kernel(const ScatterTable tab, const long long* __restrict__ idx,
                         long long K, long long P) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long q = idx[k];
  SmallRow rows[kScatterChannels];
#pragma unroll
  for (int c = 0; c < kScatterChannels; ++c) {
    const int rb = tab.row_bytes[c];
    if (c < tab.n && rb <= 16)
      small_row<false>(tab.src[c] + k * rb, nullptr, rb, tab.move[c], rows[c]);
  }
  if (q < 0 || q >= P) return;           // an empty slot (index P): JAX's mode="drop"
#pragma unroll
  for (int c = 0; c < kScatterChannels; ++c) {
    if (c >= tab.n) break;
    const int rb = tab.row_bytes[c];
    uint8_t* dst = tab.dst[c] + q * rb;
    if (rb <= 16) {
      small_row<true>(nullptr, dst, rb, tab.move[c], rows[c]);
      continue;
    }
    const uint8_t* src = tab.src[c] + k * rb;
    switch (tab.move[c]) {
      case 16: copy_row<uint4>(src, dst, rb / 16); break;
      case 8: copy_row<uint2>(src, dst, rb / 8); break;
      case 4: copy_row<uint32_t>(src, dst, rb / 4); break;
      default: copy_row<uint8_t>(src, dst, rb); break;
    }
  }
}

__global__ void zero_kernel(float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = 0.0f;
}

// scatter_back backward: each entry's cotangent rows (src, [P, stride] floats from its
// column 0), its gradient rows (dst, [K, stride]), its columns and its first lane
struct GatherTable {
  const float* src[kGatherEntries];
  float* dst[kGatherEntries];
  int cols[kGatherEntries];
  int stride[kGatherEntries];
  int first[kGatherEntries];
  int n;
  int lanes;        // columns in all
  int shift;        // log2 of the lanes a slot
};

__global__ void gather_many_kernel(const GatherTable tab, const long long* __restrict__ idx,
                                   long long K, long long P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long k = t >> tab.shift;
  const int j = (int)(t & ((1 << tab.shift) - 1));
  if (k >= K || j >= tab.lanes) return;
  int e = 0;
#pragma unroll
  for (int i = 1; i < kGatherEntries; ++i)
    if (i < tab.n && j >= tab.first[i]) e = i;
  const int c = j - tab.first[e];
  const long long q = idx[k];
  const bool live = q >= 0 && q < P;     // an empty slot (index P) gathers zeros
  tab.dst[e][k * tab.stride[e] + c] = live ? tab.src[e][q * tab.stride[e] + c] : 0.0f;
}

template <int W>
cudaError_t launch_compact(const uint8_t* mask, const float* acc_tau, float tau_cap,
                           const float* samples, const float* dirs, int R, int S,
                           long long budget, int* scratch, int* group_totals,
                           unsigned int* done, long long* count, long long* idx, float* cflat,
                           float* cray_d, cudaStream_t st) {
  const int nR = wisp::ceil_div(R, kTileRays);
  const int nS = wisp::ceil_div(S, kTileSteps);
  const int nG = wisp::ceil_div(nR, kGroupTiles);
  const long long nb = (long long)nR * nS;
  uint32_t* ballots = reinterpret_cast<uint32_t*>(scratch);
  int* counts = scratch + nb * kThreads;
  int* group_prefix = counts + (long long)S * nR;
  count_kernel<W><<<(unsigned)nb, kThreads, 0, st>>>(mask, acc_tau, tau_cap, R, S, nR, nS, nG,
                                                     ballots, counts, group_prefix,
                                                     group_totals, done, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || budget == 0) return err;
  write_kernel<<<(unsigned)nb, kThreads, 0, st>>>(samples, dirs, R, S, nR, nS, nG, budget,
                                                  ballots, counts, group_prefix, idx, cflat,
                                                  cray_d);
  return cudaGetLastError();
}

}  // namespace

// K3 / K6a. With nR = ceil(R / 256), nS = ceil(S / 32) and nG = ceil(nR / 32): scratch:
// 32-bit words, 256 * nR * nS of ballots then S * (nR + nG) of counts and prefixes;
// group_totals: int32 [>= S * nG] and done: one uint32, both the stream's and 0 between
// calls (the kernel leaves them so); count: one int64, the number of valid samples (not
// capped by the budget). acc_tau [R] may be null (K3); else only the
// samples of rays with acc_tau < tau_cap are valid (K6a).
WISP_EXPORT int wisp_compact(const uint8_t* mask, const float* acc_tau, float tau_cap,
                             const float* samples, const float* dirs, int R, int S,
                             long long budget, int* scratch, int* group_totals,
                             unsigned int* done, long long* count, long long* idx,
                             float* cflat, float* cray_d, void* stream) {
  if (R < 1 || S < 1 || (long long)R * S >= (1LL << 31) || budget < 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = (uintptr_t)mask;
  cudaStream_t st = (cudaStream_t)stream;
  if (S % 16 == 0 && a % 16 == 0)
    return (int)launch_compact<16>(mask, acc_tau, tau_cap, samples, dirs, R, S, budget,
                                   scratch, group_totals, done, count, idx, cflat, cray_d, st);
  if (S % 4 == 0 && a % 4 == 0)
    return (int)launch_compact<4>(mask, acc_tau, tau_cap, samples, dirs, R, S, budget,
                                  scratch, group_totals, done, count, idx, cflat, cray_d, st);
  return (int)launch_compact<1>(mask, acc_tau, tau_cap, samples, dirs, R, S, budget, scratch,
                                group_totals, done, count, idx, cflat, cray_d, st);
}

WISP_EXPORT int wisp_scatter_back(const float* v, const long long* idx, long long K, int C,
                                  long long P, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = P * C;
  if (n > 0) {
    const int blocks = (int)(n < 132LL * 8 * 256 ? wisp::ceil_div(n, 256) : 132 * 8);
    zero_kernel<<<blocks, 256, 0, st>>>(out, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (K * C > 0) {   // the floats' bits, as scatter_rows moves them
    scatter_floats_kernel<<<wisp::ceil_div(K * C, 256), 256, 0, st>>>(
        (const uint32_t*)v, idx, K, C, P, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// For each of the n <= kGatherEntries entries e, dst_e[k * stride_e + j] = src_e[idx[k] *
// stride_e + j] for j < cols_e and k < K, 0 where idx[k] is not below P; the columns of all
// entries at most kGatherLanes. table: n rows of (src, dst, cols, stride), int64 each, on
// the host.
WISP_EXPORT int wisp_scatter_back_bwd_many(const long long* table, int n,
                                           const long long* idx, long long K, long long P,
                                           void* stream) {
  if (n < 1 || n > kGatherEntries || K < 0) return (int)cudaErrorInvalidValue;
  GatherTable tab;
  tab.n = n;
  int lanes = 0;
  for (int e = 0; e < kGatherEntries; ++e) {
    const bool used = e < n;
    const long long cols = used ? table[4 * e + 2] : 0, stride = used ? table[4 * e + 3] : 0;
    if (used && (cols < 1 || stride < cols || stride > (1 << 20)))
      return (int)cudaErrorInvalidValue;
    tab.src[e] = used ? reinterpret_cast<const float*>(table[4 * e]) : nullptr;
    tab.dst[e] = used ? reinterpret_cast<float*>(table[4 * e + 1]) : nullptr;
    tab.cols[e] = (int)cols;
    tab.stride[e] = (int)stride;
    tab.first[e] = lanes;
    lanes += (int)cols;
    if (lanes > kGatherLanes) return (int)cudaErrorInvalidValue;
  }
  tab.lanes = lanes;
  tab.shift = 0;
  while ((1 << tab.shift) < lanes) ++tab.shift;
  if (K > 0)
    gather_many_kernel<<<wisp::ceil_div(K << tab.shift, kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(tab, idx, K, P);
  return (int)cudaGetLastError();
}

// K12 compaction. mask [R] (bytes); origins, dirs [R, 3], t, t_far [R]; status: uint64
// [>= ceil(R / 1024)] and ticket: one uint32 (0 between calls), both the stream's; epoch:
// this call's, not 0 and not that of the stream's previous call; count: one int64, the
// number of set mask entries (not capped by the budget); idx [B] int64, o_c, d_c [B, 3],
// t_c, tf_c [B]: every slot written.
WISP_EXPORT int wisp_compact_rays(const uint8_t* mask, int R, long long budget,
                                  const float* origins, const float* dirs, const float* t,
                                  const float* t_far, unsigned long long* status,
                                  unsigned int* ticket, unsigned int epoch, long long* count,
                                  long long* idx, float* o_c, float* d_c, float* t_c,
                                  float* tf_c, void* stream) {
  if (R < 1 || budget < 1 || epoch == 0u) return (int)cudaErrorInvalidValue;
  const int n_tiles = wisp::ceil_div(R, kRayTile);
  const long long blocks = n_tiles + (long long)wisp::ceil_div(budget, kFillSlots);
  compact_rays_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      mask, R, budget, n_tiles, origins, dirs, t, t_far, status, ticket, epoch, count, idx,
      o_c, d_c, t_c, tf_c);
  return (int)cudaGetLastError();
}

// For each of the n <= kScatterChannels channels c, out_c[idx[k]] = v_c[k] for k < K where
// 0 <= idx[k] < P. table: n rows of (v_c, out_c, row bytes), int64 each, on the host; every
// out_c is given, of P rows.
WISP_EXPORT int wisp_scatter_rows_many(const long long* table, int n, const long long* idx,
                                       long long K, long long P, void* stream) {
  if (n < 1 || n > kScatterChannels || K < 0) return (int)cudaErrorInvalidValue;
  ScatterTable tab;
  tab.n = n;
  for (int c = 0; c < n; ++c) {
    const long long src = table[3 * c], dst = table[3 * c + 1], rb = table[3 * c + 2];
    if (rb < 1 || rb > (1 << 30)) return (int)cudaErrorInvalidValue;
    const long long a = src | dst | rb;
    tab.src[c] = reinterpret_cast<const uint8_t*>(src);
    tab.dst[c] = reinterpret_cast<uint8_t*>(dst);
    tab.row_bytes[c] = (int)rb;
    tab.move[c] = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
  }
  for (int c = n; c < kScatterChannels; ++c) tab.row_bytes[c] = 0;
  if (K > 0)
    scatter_rows_many_kernel<<<wisp::ceil_div(K, kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>(tab, idx, K, P);
  return (int)cudaGetLastError();
}
