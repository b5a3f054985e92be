"""The rules of K12's scatter-back in one launch (``csrc/compaction.cu``
``wisp_scatter_rows_many``) and of K6b's one-round segment (``csrc/integrate.cu``
``integrate_seg_fwd_kernel``), held on the CPU to the plain versions and to JAX.

(a) ``scatter_rows_many``'s plain version, the CPU route of the wrapper, equals
    ``scatter_rows_plain`` channel by channel and JAX's ``.at[idx].set(v, mode="drop")``
    (wisp_tpu/tracers/packed_sdf_tracer.py:206-217) on rows of 1, 4 and 12 bytes, with empty
    slots (index P) and with K = 0.
(b) ``k6b_order`` below repeats K6b's summation order in torch: a lane takes 4 consecutive
    steps and their inclusive prefix in step order, a shuffle scan of the 32 lanes' totals
    gives each lane the optical depth before its steps, the round's total carries to the
    next round of 128 steps, and each lane's sums are reduced by a butterfly. It is held to
    ``integrate_segment_plain`` and to JAX's scan body (packed_rf_tracer.py:362-385, its
    composite written out in jnp below) within K6b's tolerances, 1e-4 absolute on rgb,
    alpha, depth and the extras and 1e-5 relative on acc_tau out, with a carry that culls
    about half of the rays (their densities 0, as the scatter-back leaves a culled ray's
    samples; JAX masks them with its live test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu_torch.ops.compaction import (scatter_rows, scatter_rows_many,
                                           scatter_rows_many_plain, scatter_rows_plain)
from wisp_tpu_torch.ops.integration import integrate_segment, integrate_segment_plain

TOL, ACC_REL_TOL = 1e-4, 1e-5      # K6b's tolerances (chip_smoke.py SEG_FWD_TOL, ...)
VEC, LANES = 4, 32                 # K6b: steps a lane, lanes a warp
TAU_CAP = float(np.float32(-np.log(1e-3)))


@jax.jit
def _jax_set(bases, idx, rows):
    return [b.at[idx].set(v, mode="drop") for b, v in zip(bases, rows)]


def _slots(rng, p, k, empty):
    """k slots: distinct rows of [0, p), the last ``empty`` of them P (empty)."""
    idx = rng.permutation(p)[:k].astype(np.int64)
    if empty:
        idx[k - empty:] = p
    return idx


@pytest.mark.parametrize("k,empty", [(40, 0), (40, 15), (0, 0)])
def test_scatter_rows_many_plain_equals_each_channel_and_jax(k, empty):
    rng = np.random.default_rng(3 + k + empty)
    p = 64
    idx = _slots(rng, p, k, empty)
    channels = [                       # (rows [K, ...], base [P, ...]): 1, 4 and 12 bytes
        (rng.random(k) < 0.5, rng.random(p) < 0.5),
        (rng.standard_normal(k).astype(np.float32), rng.standard_normal(p).astype(np.float32)),
        (rng.standard_normal((k, 3)).astype(np.float32),
         rng.standard_normal((p, 3)).astype(np.float32))]
    pairs = [(torch.from_numpy(v), torch.from_numpy(b).clone()) for v, b in channels]
    t_idx = torch.from_numpy(idx)
    got = scatter_rows_many(t_idx, [(v, b.clone()) for v, b in pairs])
    plain = scatter_rows_many_plain(t_idx, [(v, b.clone()) for v, b in pairs])
    jax_out = _jax_set([b for _, b in channels], idx, [v for v, _ in channels])
    for (v, b), g, w, want in zip(pairs, got, plain, jax_out):
        each = scatter_rows_plain(v, t_idx, b.clone())
        one = scatter_rows(v, t_idx, b.clone())
        assert torch.equal(g, w) and torch.equal(g, each) and torch.equal(g, one)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
        if k - empty:
            assert not torch.equal(g, b)


def test_scatter_rows_many_plain_writes_in_place():
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(_slots(rng, 16, 10, 3))
    base = torch.zeros(16, 3)
    v = torch.ones(10, 3)
    (out,) = scatter_rows_many(idx, [(v, base)])
    assert out is base and int(base[:, 0].sum()) == 7


def _shift_up(x, off):
    """Lane i receives lane i - off's value (``__shfl_up_sync``); lanes below off their own."""
    y = torch.cat([x[..., :off], x[..., :-off]], dim=-1)
    return y


def _butterfly(v):
    """``warp_sum``: lane sums by xor shuffles, 16 down to 1 (every lane ends with the
    total; lane 0's is written)."""
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def k6b_order(density, deltas, depths, mask, color, acc_tau, extra=None):
    """K6b in torch, float32, in the kernel's order of operations (exp aside)."""
    r, s = density.shape
    rounds = -(-s // (VEC * LANES))
    pad = rounds * VEC * LANES - s

    def lanes(x):           # [R, S, ...] -> [R, rounds, lanes, VEC, ...], zeros past S
        x = torch.nn.functional.pad(x.movedim(1, -1), (0, pad)).movedim(-1, 1)
        return x.reshape((r, rounds, LANES, VEC) + tuple(x.shape[2:]))

    valid = lanes(torch.ones(r, s, dtype=torch.bool))
    tau = lanes(density) * deltas.reshape(-1, 1, 1, 1) * lanes(mask.to(torch.float32))
    col, dep = lanes(color), lanes(depths)
    ext = lanes(extra) if extra is not None else None
    lane = torch.arange(LANES)
    a_acc = torch.zeros(r, LANES)
    c_acc = torch.zeros(r, LANES, 3)
    d_acc = torch.zeros(r, LANES)
    e_acc = torch.zeros(r, LANES, extra.shape[-1]) if extra is not None else None
    carry = torch.zeros(r, 1)
    for q in range(rounds):
        t = tau[:, q]
        run = torch.zeros(r, LANES)
        incl = []
        for j in range(VEC):             # the lane's inclusive prefix in step order
            run = run + t[..., j]
            incl.append(run)
        x = run
        for off in (1, 2, 4, 8, 16):     # the shuffle scan of the lanes' totals
            x = torch.where(lane >= off, x + _shift_up(x, off), x)
        before = torch.where(lane == 0, torch.zeros(()), _shift_up(x, 1))
        base = carry + before
        carry = carry + x[:, 31:32]
        for j in range(VEC):
            sum_prev = (base + incl[j]) - t[..., j]
            w = torch.exp(-(acc_tau[:, None] + sum_prev)) * (1.0 - torch.exp(-t[..., j]))
            w = torch.where(valid[:, q, :, j], w, torch.zeros(()))
            a_acc = a_acc + w
            c_acc = c_acc + w[..., None] * col[:, q, :, j]
            d_acc = d_acc + w * dep[:, q, :, j]
            if ext is not None:
                e_acc = e_acc + w[..., None] * ext[:, q, :, j]
    out = {"rgb": torch.stack([_butterfly(c_acc[..., c]) for c in range(3)], -1),
           "alpha": _butterfly(a_acc)[:, None], "acc_tau": acc_tau + carry[:, 0],
           "depth": _butterfly(d_acc)[:, None]}
    if extra is not None:
        out["extra"] = torch.stack([_butterfly(e_acc[..., c])
                                    for c in range(extra.shape[-1])], -1)
    return out


@jax.jit
def _jax_segment(density, deltas, depths, mask, color, acc_tau, extra):
    """JAX's scan body's composite (packed_rf_tracer.py:362-385) with its live test."""
    live = acc_tau < TAU_CAP
    m = mask & live[:, None]
    tau = density * deltas * m.astype(density.dtype)
    sum_prev = jnp.cumsum(tau, axis=-1) - tau
    w = jnp.exp(-(acc_tau[:, None] + sum_prev)) * (1.0 - jnp.exp(-tau))
    return {"rgb": jnp.sum(w[..., None] * color, axis=1),
            "alpha": jnp.sum(w, axis=-1)[:, None],
            "depth": jnp.sum(w * depths, axis=-1)[:, None],
            "extra": jnp.sum(w[..., None] * extra, axis=1),
            "acc_tau": acc_tau + jnp.sum(tau, axis=-1)}


def _segment(s, seed):
    """A segment of 8 rays with 3 extra columns; the carry culls about half of the rays,
    whose densities are 0."""
    rng = np.random.default_rng(seed)
    r = 8
    acc = (rng.random(r) * 2.0 * TAU_CAP).astype(np.float32)
    density = (rng.random((r, s)) * 20.0).astype(np.float32)
    density[acc >= TAU_CAP] = 0.0
    arrays = {"density": density, "deltas": (rng.random(r) * 0.02).astype(np.float32),
              "depths": np.cumsum(rng.random((r, s)), -1).astype(np.float32),
              "mask": rng.random((r, s)) < 0.6,
              "color": rng.random((r, s, 3)).astype(np.float32), "acc_tau": acc,
              "extra": rng.random((r, s, 3)).astype(np.float32)}
    return arrays


def _close(got, want, key):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if key == "acc_tau":
        return np.all(np.abs(got - want) <= ACC_REL_TOL * np.maximum(np.abs(want), 1e-30))
    return np.all(np.abs(got - want) <= TOL)


@pytest.mark.parametrize("with_extra", [False, True])
@pytest.mark.parametrize("s", [1, 31, 128, 129, 300])
def test_k6b_order_matches_plain_and_jax(s, with_extra):
    arr = _segment(s, seed=11 + s + with_extra)
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    extra = t["extra"] if with_extra else None
    args = (t["density"], t["deltas"], t["depths"], t["mask"], t["color"], t["acc_tau"])
    got = k6b_order(*args, extra=extra)
    plain = integrate_segment_plain(*args, extra=extra)
    wrapper = integrate_segment(*args, extra=extra)
    jx = _jax_segment(arr["density"], np.broadcast_to(arr["deltas"][:, None], (8, s)),
                      arr["depths"], arr["mask"], arr["color"], arr["acc_tau"], arr["extra"])
    assert set(got) == set(plain) == set(wrapper) <= set(jx)
    culled = arr["acc_tau"] >= TAU_CAP
    assert 2 <= culled.sum() <= 6
    for key in got:
        assert torch.equal(wrapper[key], plain[key])
        assert _close(got[key], plain[key], key), key
        assert _close(got[key], np.asarray(jx[key]), key), key
    # a culled ray composites nothing and carries its depth unchanged
    assert float(got["alpha"][torch.from_numpy(culled)].abs().max()) == 0.0
    assert torch.equal(got["acc_tau"][torch.from_numpy(culled)],
                       t["acc_tau"][torch.from_numpy(culled)])


def test_k6b_order_takes_one_round_at_the_seg_segment():
    """At the seg step's S = 128 the lanes' 4 steps cover the segment in one round; the
    rendition's carry after it is the round's scan total."""
    arr = _segment(128, seed=2)
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    assert -(-128 // (VEC * LANES)) == 1
    got = k6b_order(t["density"], t["deltas"], t["depths"], t["mask"], t["color"],
                    t["acc_tau"])
    tau = t["density"] * t["deltas"][:, None] * t["mask"].float()
    assert torch.allclose(got["acc_tau"] - t["acc_tau"], tau.sum(-1), rtol=1e-5, atol=0.0)
