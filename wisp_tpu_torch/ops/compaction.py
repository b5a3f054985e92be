"""Step-major sample compaction and scatter-back (K3; counterpart of
wisp_tpu/ops/compaction.py masked_compact_indices plus the tracer's remap, gathers and
scatter-back, wisp_tpu/tracers/packed_rf_tracer.py:188-222).

The valid samples of an [R, S] mask go, in step-major order, into a budget of B slots. When
more than B samples are valid, the latest march steps across all rays are dropped, not the
trailing rays. On a CUDA tensor these functions launch ``csrc/compaction.cu``; on a CPU
tensor they run their plain versions. Indices are integers and the scatter and gather move
floats unchanged, so the two agree exactly. ``scatter_back_many`` (``scatter_back``: one
channel) is differentiable: its backward is ``scatter_back_bwd_many``, the gather of every
channel's cotangent at the slots' indices in one launch (the autodiff of the JAX scatter).
``compact`` needs no gradient: sample points are not parameters.

Given a per-ray carried optical depth ``acc_tau`` and ``tau_cap``, ``compact`` also culls
(K6a, the segmented trace's live test, packed_rf_tracer.py:338-343): a sample is valid only
where its ray's ``acc_tau < tau_cap``, compared in float32 as JAX compares it.

``compact_rays`` and ``scatter_rows`` are K12's compaction, the SDF tracer's (packed_sdf_
tracer.py:168-220): the rays of an [R] mask in order, whose payload is each kept ray's
origin, direction, depth and exit; every slot is defined (JAX's fill: index R and ray
R-1's row), and ``scatter_rows_many`` writes the slots' rows of every channel of a chunk back
onto given tensors in one launch, as JAX's ``.at[idx].set(v, mode="drop")`` on each
(``scatter_rows``: one channel). Their launches count apart from K3's (``compact_rays``,
``scatter_rays``, and ``*_mid`` for the tracer's mid-loop pass).

``compact`` (two launches) and ``compact_rays`` (one) keep a few words on the device across
calls, one set a stream (``_StreamState``), so that no call clears state with a launch of
its own.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from wisp_tpu_torch import kernels

# the kernels' tiles (csrc/compaction.cu): K3 takes 256 rays x 32 steps a block and sums a
# step's counts by groups of 32 ray tiles; K12 takes 1,024 rays a tile
_RAY_TILE = 256
_STEP_TILE = 32
_GROUP_TILES = 32
_RAYS_TILE = 1024
# channels a launch of K12's scatter-back (csrc/compaction.cu kScatterChannels)
SCATTER_CHANNELS = 8
# entries, and columns in all, a launch of K3's scatter-back backward (csrc/compaction.cu
# kGatherEntries, kGatherLanes)
GATHER_ENTRIES = 8
GATHER_LANES = 32


class _StreamState:
    """The words the compaction kernels keep across calls on one stream, made zero once and
    grown (zero again) when a call needs more: ``words`` holds K3's block counter (word 0),
    K12's ticket counter (word 1) and K12's tile status words (from word 2); ``totals`` K3's
    group totals. The kernels leave the counters and totals at 0; K12 tags each status
    word with its call's ``epoch``, which every call raises (never 0 as a uint32)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.words = torch.zeros((2 + 64,), dtype=torch.int64, device=device)
        self.totals = torch.zeros((1024,), dtype=torch.int32, device=device)
        self.epoch = 0

    def need(self, tiles: int = 0, totals: int = 0) -> "_StreamState":
        if 2 + tiles > self.words.numel():
            self.words = torch.zeros((2 + 2 * tiles,), dtype=torch.int64, device=self.device)
        if totals > self.totals.numel():
            self.totals = torch.zeros((2 * totals,), dtype=torch.int32, device=self.device)
        return self

    def next_epoch(self) -> int:
        self.epoch = self.epoch % 0xFFFFFFFF + 1
        return self.epoch


_STATES = {}
# held from reading a stream's state to the launch that uses it, so that two threads never
# draw one epoch, nor grow the words while another thread's launch is about to use them
_STATE_LOCK = threading.Lock()


def _stream_state() -> _StreamState:
    """The current stream's state (the stream ``kernels.launch`` launches on); the caller
    holds ``_STATE_LOCK``."""
    index = torch._C._cuda_getDevice()
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    state = _STATES.get(key)
    if state is None:
        state = _STATES[key] = _StreamState(torch.device("cuda", index))
    return state


def compaction_budget(num_rays: int, num_steps: int, compaction: float) -> int:
    """Slots for ``compaction`` of the [R, S] samples, rounded up to a multiple of 128 and
    capped at R*S (packed_rf_tracer.py:193-194)."""
    budget = int(math.ceil(num_rays * num_steps * float(compaction) / 128.0)) * 128
    return min(budget, num_rays * num_steps)


def live_mask(mask: torch.Tensor, acc_tau: torch.Tensor, tau_cap: float) -> torch.Tensor:
    """``mask`` [R, S] where the ray's carried optical depth is below ``tau_cap``."""
    return mask & (acc_tau < float(tau_cap))[:, None]


def compact_plain(mask: torch.Tensor, samples: torch.Tensor, dirs: torch.Tensor,
                  budget: int, acc_tau: Optional[torch.Tensor] = None,
                  tau_cap: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``compact``."""
    if acc_tau is not None:
        mask = live_mask(mask, acc_tau, tau_cap)
    r, s = mask.shape
    rs = r * s
    mt = mask.T.reshape(-1)                                   # step-major: p = s*R + r
    slot = torch.cumsum(mt.to(torch.int64), 0) - 1
    keep = mt & (slot < budget)
    idx_t = torch.full((budget,), rs, dtype=torch.int64, device=mask.device)
    idx_t[slot[keep]] = torch.nonzero(keep).reshape(-1)
    idx = torch.where(idx_t < rs, (idx_t % r) * s + idx_t // r, rs)
    safe = idx.clamp(max=rs - 1)
    cflat = samples.reshape(rs, 3)[safe]
    cray_d = dirs[safe // s]
    return idx, cflat, cray_d, mt.sum()


def compact(mask: torch.Tensor, samples: torch.Tensor, dirs: torch.Tensor,
            budget: int, acc_tau: Optional[torch.Tensor] = None,
            tau_cap: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the valid samples of ``mask`` [R, S] into ``budget`` slots, step-major; with
    ``acc_tau`` [R] float32, only those of rays with ``acc_tau < tau_cap`` are valid.

    Returns ``idx`` [B] int64 (flat row-major sample index r*S+s per slot), the slots'
    points ``cflat`` [B, 3] and ray directions ``cray_d`` [B, 3], and ``count``, a 0-d int64
    tensor holding the number of valid samples, which may exceed the budget. Only the
    first min(count, B) slots are defined: the kernel leaves the others unwritten, while
    the plain version fills them as JAX does (index R*S, the last sample)."""
    if not mask.is_cuda:
        return compact_plain(mask, samples, dirs, budget, acc_tau, tau_cap)
    r, s = mask.shape
    kernels.check(mask, "mask", torch.bool, (r, s))
    if acc_tau is not None:
        kernels.check(acc_tau, "acc_tau", torch.float32, (r,))
    kernels.check(samples, "samples", torch.float32, (r, s, 3))
    kernels.check(dirs, "dirs", torch.float32, (r, 3))
    if r * s == 0 or budget < 0 or budget > r * s or r * s >= 2 ** 31:
        raise ValueError(f"compact: need 0 < R*S < 2^31 and 0 <= budget <= R*S, got "
                         f"R={r} S={s} budget={budget}")
    dev = mask.device
    n_tiles = -(-r // _RAY_TILE)
    n_groups = -(-n_tiles // _GROUP_TILES)
    # each tile's step ballots, then the counts of each (step, ray tile) and each step's
    # group prefixes
    n_ballots = _RAY_TILE * n_tiles * -(-s // _STEP_TILE)
    scratch = torch.empty((n_ballots + s * (n_tiles + n_groups),), dtype=torch.int32,
                          device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    idx = torch.empty((budget,), dtype=torch.int64, device=dev)
    cflat = torch.empty((budget, 3), dtype=torch.float32, device=dev)
    cray_d = torch.empty((budget, 3), dtype=torch.float32, device=dev)
    with _STATE_LOCK:
        state = _stream_state().need(totals=s * n_groups)
        kernels.launch("wisp_compact", "compact" if acc_tau is None else "compact_live",
                       mask.data_ptr(), kernels.ptr(acc_tau),
                       0.0 if tau_cap is None else float(tau_cap), samples.data_ptr(),
                       dirs.data_ptr(), r, s, budget, scratch.data_ptr(),
                       state.totals.data_ptr(), state.words.data_ptr(), count.data_ptr(),
                       idx.data_ptr(), cflat.data_ptr(), cray_d.data_ptr())
    return idx, cflat, cray_d, count


def scatter_back_plain(v: torch.Tensor, idx: torch.Tensor, total: int) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_back`` (differentiable by autograd)."""
    out = v.new_zeros((total + 1, v.shape[1]))
    out = out.index_copy(0, idx[:v.shape[0]], v)
    return out[:total]


def scatter_back_many_plain(idx: torch.Tensor, total: int, *vs: torch.Tensor) -> list:
    """Plain PyTorch version of ``scatter_back_many``: ``scatter_back_plain`` on each
    channel, differentiable by autograd."""
    return [scatter_back_plain(v.reshape(v.shape[0], math.prod(v.shape[1:])), idx, total)
            .reshape((total,) + tuple(v.shape[1:])) for v in vs]


def _scatter_back_fwd(v: torch.Tensor, idx: torch.Tensor, total: int) -> torch.Tensor:
    k, c = v.shape[0], math.prod(v.shape[1:])
    kernels.check(v, "v", torch.float32, None)
    kernels.check(idx, "idx", torch.int64, (None,))
    if k > idx.shape[0]:
        raise ValueError(f"scatter_back: {k} rows for {idx.shape[0]} slots")
    out = torch.empty((total,) + tuple(v.shape[1:]), dtype=torch.float32, device=v.device)
    kernels.launch("wisp_scatter_back", "scatter_back", v.data_ptr(), idx.data_ptr(), k, c,
                   total, out.data_ptr())
    return out


def scatter_back_bwd_plain(grad_out: torch.Tensor, idx: torch.Tensor, k: int
                           ) -> torch.Tensor:
    """Rows of one channel's cotangent ``grad_out`` [total, C] at the first ``k`` slots'
    indices, zero for an empty slot -> [k, C]: one channel of
    ``scatter_back_bwd_many_plain``."""
    padded = torch.cat([grad_out, grad_out.new_zeros((1, grad_out.shape[1]))])
    return padded[idx[:k]]


def scatter_back_bwd_many_plain(grads, idx: torch.Tensor, k: int) -> list:
    """Plain PyTorch version of ``scatter_back_bwd_many``: ``scatter_back_bwd_plain`` on
    each channel."""
    return [scatter_back_bwd_plain(g.reshape(g.shape[0], math.prod(g.shape[1:])), idx, k)
            .reshape((k,) + tuple(g.shape[1:])) for g in grads]


def scatter_back_bwd_many(grads, idx: torch.Tensor, k: int) -> list:
    """The gradients of ``scatter_back_many`` in its channels: for each cotangent ``grads``
    [total, ...] (float32, contiguous), its rows at the first ``k`` slots' indices, zero for
    an empty slot -> [k, ...]. One launch for up to ``GATHER_ENTRIES`` channels of
    ``GATHER_LANES`` columns in all (colour and density take one; a wider channel is split
    into entries of at most ``GATHER_LANES`` columns), counted under ``scatter_back_bwd``."""
    grads = list(grads)
    if not idx.is_cuda:
        return scatter_back_bwd_many_plain(grads, idx, k)
    kernels.check(idx, "idx", torch.int64, (None,))
    if k > idx.shape[0]:
        raise ValueError(f"scatter_back_bwd: {k} rows for {idx.shape[0]} slots")
    total = None
    entries, outs = [], []
    for i, g in enumerate(grads):
        kernels.check(g, f"grads[{i}]", torch.float32, None)
        if total is None:
            total = g.shape[0]
        if g.shape[0] != total:
            raise ValueError(f"scatter_back_bwd: channel {i} has {g.shape[0]} rows, channel "
                             f"0 {total}")
        c = math.prod(g.shape[1:])
        out = torch.empty((k,) + tuple(g.shape[1:]), dtype=torch.float32, device=g.device)
        outs.append(out)
        for col in range(0, c, GATHER_LANES):
            entries.append((g.data_ptr() + 4 * col, out.data_ptr() + 4 * col,
                            min(GATHER_LANES, c - col), c))
    if not k:
        return outs
    launches, cols = [[]], 0
    for entry in entries:       # entries a launch: at most GATHER_ENTRIES, GATHER_LANES columns
        if len(launches[-1]) == GATHER_ENTRIES or cols + entry[2] > GATHER_LANES:
            launches.append([])
            cols = 0
        launches[-1].append(entry)
        cols += entry[2]
    for part in launches:
        if part:
            flat = [x for entry in part for x in entry]
            rows = (ctypes.c_longlong * len(flat))(*flat)    # alive until the call returns
            kernels.launch("wisp_scatter_back_bwd_many", "scatter_back_bwd",
                           ctypes.addressof(rows), len(part), idx.data_ptr(), k, total)
    return outs


class _ScatterBackManyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, total, *vs):
        ctx.save_for_backward(idx)
        ctx.k = vs[0].shape[0]
        return tuple(_scatter_back_fwd(v, idx, total) for v in vs)

    @staticmethod
    def backward(ctx, *grads_out):
        (idx,) = ctx.saved_tensors
        want = [i for i, g in enumerate(grads_out)
                if g is not None and ctx.needs_input_grad[2 + i]]
        got = scatter_back_bwd_many([grads_out[i].contiguous() for i in want], idx, ctx.k)
        grads = [None] * len(grads_out)
        for i, g in zip(want, got):
            grads[i] = g
        return (None, None, *grads)


def scatter_back_many(idx: torch.Tensor, total: int, *vs: torch.Tensor) -> list:
    """The rows ``vs`` ([K] or [K, ...] float32, contiguous, one K) of the first K slots
    back to a zero-filled [total] or [total, ...] each, at the slots' sample indices; slots
    holding ``total`` (empty) are dropped. Only ``idx[:K]`` is read. Differentiable in every
    channel: the forward launches the scatter once a channel (``scatter_back``), the
    backward gathers every channel's cotangent in one launch (``scatter_back_bwd_many``), so
    a trace's colour [K, 3] and flat density [K] take one gather."""
    if not vs[0].is_cuda:
        return scatter_back_many_plain(idx, total, *vs)
    return list(_ScatterBackManyFn.apply(idx, total, *vs))


def scatter_back(v: torch.Tensor, idx: torch.Tensor, total: int) -> torch.Tensor:
    """Rows ``v`` [K, C] of the first K slots back to a zero-filled [total, C] at the
    slots' sample indices; slots holding ``total`` (empty) are dropped. Only ``idx[:K]``
    is read. Differentiable in ``v`` (``scatter_back_many`` with one channel)."""
    return scatter_back_many(idx, total, v)[0]


def ray_budget(num_rays: int, fraction: float) -> int:
    """Slots of the SDF tracer's ray compaction: ``max(round(R * fraction), 1)``, Python's
    half-even rounding, as JAX has it (packed_sdf_tracer.py:181, :195)."""
    return max(int(round(num_rays * float(fraction))), 1)


def compact_rays_plain(mask, budget, origins, dirs, t, t_far):
    """Plain PyTorch version of ``compact_rays``."""
    r = mask.shape[0]
    slot = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (slot < budget)
    idx = torch.full((budget,), r, dtype=torch.int64, device=mask.device)
    idx[slot[keep]] = torch.nonzero(keep).reshape(-1)
    safe = idx.clamp(max=r - 1)
    return idx, origins[safe], dirs[safe], t[safe], t_far[safe], mask.sum()


def compact_rays(mask: torch.Tensor, budget: int, origins: torch.Tensor, dirs: torch.Tensor,
                 t: torch.Tensor, t_far: torch.Tensor, mid: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
    """The rays of ``mask`` [R] bool, in order, into ``budget`` slots (K12's compaction;
    JAX's ``masked_compact_indices(mask[:, None], budget)`` and its clipped gathers).

    Returns ``idx`` [B] int64 (the ray of each slot, R for a slot past the count), the
    slots' ``origins``, ``dirs`` [B, 3], ``t`` and ``t_far`` [B] (ray R-1's for an empty
    slot) and ``count``, a 0-d int64 tensor: the rays of the mask, which may exceed the
    budget. ``mid`` counts the launch as the tracer's mid-loop pass."""
    if not mask.is_cuda:
        return compact_rays_plain(mask, budget, origins, dirs, t, t_far)
    r = mask.shape[0]
    kernels.check(mask, "mask", torch.bool, (r,))
    kernels.check(origins, "origins", torch.float32, (r, 3))
    kernels.check(dirs, "dirs", torch.float32, (r, 3))
    kernels.check(t, "t", torch.float32, (r,))
    kernels.check(t_far, "t_far", torch.float32, (r,))
    if r == 0 or r >= 2 ** 31 or budget < 1:
        raise ValueError(f"compact_rays: need 0 < R < 2^31 and budget >= 1, got R={r} "
                         f"budget={budget}")
    dev = mask.device
    count = torch.empty((), dtype=torch.int64, device=dev)
    idx = torch.empty((budget,), dtype=torch.int64, device=dev)
    o_c = torch.empty((budget, 3), dtype=torch.float32, device=dev)
    d_c = torch.empty((budget, 3), dtype=torch.float32, device=dev)
    t_c = torch.empty((budget,), dtype=torch.float32, device=dev)
    tf_c = torch.empty((budget,), dtype=torch.float32, device=dev)
    with _STATE_LOCK:
        state = _stream_state().need(tiles=-(-r // _RAYS_TILE))
        kernels.launch("wisp_compact_rays", "compact_rays_mid" if mid else "compact_rays",
                       mask.data_ptr(), r, budget, origins.data_ptr(), dirs.data_ptr(),
                       t.data_ptr(), t_far.data_ptr(), state.words.data_ptr() + 16,
                       state.words.data_ptr() + 8, state.next_epoch(), count.data_ptr(),
                       idx.data_ptr(), o_c.data_ptr(), d_c.data_ptr(), t_c.data_ptr(),
                       tf_c.data_ptr())
    return idx, o_c, d_c, t_c, tf_c, count


def scatter_rows_plain(v: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_rows``."""
    rows = idx[:v.shape[0]]
    keep = rows < out.shape[0]
    out[rows[keep]] = v[keep]
    return out


def scatter_rows_many_plain(idx: torch.Tensor, pairs) -> list:
    """Plain PyTorch version of ``scatter_rows_many``: ``scatter_rows_plain`` on each pair in
    turn."""
    return [scatter_rows_plain(v, idx, out) for v, out in pairs]


def scatter_rows_many(idx: torch.Tensor, pairs, mid: bool = False) -> list:
    """``out[idx[k]] = v[k]`` in place for every ``(v, out)`` of ``pairs``, for the K rows of
    each ``v`` [K, ...] whose slot index is below P = out.shape[0]; an index P (an empty
    slot) is dropped. Every ``v`` has the same K and every ``out`` [P, ...] the same P, with
    its ``v``'s dtype and row shape. One launch a table of ``SCATTER_CHANNELS`` channels
    (the tracer's chunk takes one), counted under ``scatter_rays``, or ``scatter_rays_mid``
    for the tracer's mid-loop pass. Returns the ``out`` tensors."""
    pairs = list(pairs)
    if not idx.is_cuda:
        return scatter_rows_many_plain(idx, pairs)
    kernels.check(idx, "idx", torch.int64, (None,))
    k = p = None
    table = []
    for i, (v, out) in enumerate(pairs):
        kernels.check(v, f"v[{i}]", v.dtype, None)
        kernels.check(out, f"out[{i}]", v.dtype, (None,) + tuple(v.shape[1:]))
        if k is None:
            k, p = v.shape[0], out.shape[0]
        if (v.shape[0], out.shape[0]) != (k, p):
            raise ValueError(f"scatter_rows_many: channel {i} has {v.shape[0]} rows onto "
                             f"{out.shape[0]}, channel 0 {k} onto {p}")
        row_bytes = math.prod(v.shape[1:]) * v.element_size()
        if row_bytes:
            table += [v.data_ptr(), out.data_ptr(), row_bytes]
    if k is not None and k > idx.shape[0]:
        raise ValueError(f"scatter_rows_many: {k} rows for {idx.shape[0]} slots")
    if k:
        for c in range(0, len(table), 3 * SCATTER_CHANNELS):
            part = table[c:c + 3 * SCATTER_CHANNELS]
            rows = (ctypes.c_longlong * len(part))(*part)    # alive until the call returns
            kernels.launch("wisp_scatter_rows_many",
                           "scatter_rays_mid" if mid else "scatter_rays",
                           ctypes.addressof(rows), len(part) // 3, idx.data_ptr(), k, p)
    return [out for _, out in pairs]


def scatter_rows(v: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
                 mid: bool = False) -> torch.Tensor:
    """``out[idx[k]] = v[k]`` in place for the K rows of ``v`` [K, ...] whose slot index is
    below P = out.shape[0]; an index P (an empty slot) is dropped. ``out`` [P, ...] has
    ``v``'s dtype and row shape; it is returned. ``scatter_rows_many`` with one channel."""
    return scatter_rows_many(idx, [(v, out)], mid)[0]
