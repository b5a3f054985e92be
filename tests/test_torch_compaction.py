"""Port parity: K3 (step-major compaction and scatter-back) on the CPU against JAX's
``masked_compact_indices`` with the tracer's remap (packed_rf_tracer.py:188-222).

Everything here is integer indexing and copying, so the comparison is exact, with budgets
both above and below the valid count (where the latest steps must be the ones dropped).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import np_of
from wisp_tpu.ops.compaction import masked_compact_indices
from wisp_tpu_torch.ops.compaction import (compact, compaction_budget, scatter_back,
                                           scatter_back_plain)


@functools.partial(jax.jit, static_argnums=3)
def _jax_compact_jit(mask, samples, dirs, budget):
    n, s = mask.shape
    idx_t = masked_compact_indices(mask.T, budget)
    idx = jnp.where(idx_t < n * s, (idx_t % n) * s + (idx_t // n), n * s)
    flat = samples.reshape(n * s, 3)
    ray_d = jnp.broadcast_to(dirs[:, None, :], (n, s, 3)).reshape(n * s, 3)
    safe = jnp.minimum(idx, n * s - 1)
    return idx, flat[safe], ray_d[safe]


def _jax_compact(mask, samples, dirs, budget):
    """The JAX tracer's compaction, remap and gathers (packed_rf_tracer.py:193-206),
    jitted: integer indexing and copies only, so the compile changes no value."""
    out = _jax_compact_jit(jnp.asarray(mask), jnp.asarray(samples), jnp.asarray(dirs), budget)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("shape,frac,compaction",
                         [((40, 24), 0.1, 0.25),   # budget above the valid count
                          ((40, 24), 0.6, 0.25),   # overflow: latest steps dropped
                          ((33, 17), 1.0, 0.5),    # every sample valid
                          ((16, 64), 0.0, 0.25),   # nothing valid
                          ((1, 300), 0.6, 0.25),   # R = 1, overflow
                          ((300, 1), 0.6, 0.25)])  # S = 1, overflow
def test_compact_matches_jax(shape, frac, compaction):
    rng = np.random.default_rng(int(frac * 10) + shape[0])
    mask = rng.random(shape) < frac
    samples = rng.normal(size=(*shape, 3)).astype(np.float32)
    dirs = rng.normal(size=(shape[0], 3)).astype(np.float32)
    budget = compaction_budget(*shape, compaction)
    assert budget == min(int(np.ceil(shape[0] * shape[1] * compaction / 128.0)) * 128,
                         shape[0] * shape[1])
    w_idx, w_flat, w_dir = _jax_compact(mask, samples, dirs, budget)
    idx, cflat, cray_d, count = compact(torch.from_numpy(mask), torch.from_numpy(samples),
                                        torch.from_numpy(dirs), budget)
    np.testing.assert_array_equal(np_of(idx), w_idx)
    np.testing.assert_array_equal(np_of(cflat), w_flat)
    np.testing.assert_array_equal(np_of(cray_d), w_dir)
    assert int(count) == int(mask.sum())
    if mask.sum() > budget:
        # the kept samples are the earliest steps across all rays
        steps = np_of(idx) % shape[1]
        dropped = np.flatnonzero(mask.reshape(-1))
        dropped = np.setdiff1d(dropped, np_of(idx))
        assert steps.max() <= (dropped % shape[1]).min()


@pytest.mark.parametrize("budget", [1024, 256])
def test_compact_live_matches_jax(budget):
    """K6a: with a carry that kills some rays, ``compact(..., acc_tau, tau_cap)`` equals
    JAX's compaction of the live mask (mask & acc_tau < tau_cap, in float32), the budget
    above and below the live count."""
    rng = np.random.default_rng(6)
    shape = (40, 24)
    mask = rng.random(shape) < 0.6
    samples = rng.normal(size=(*shape, 3)).astype(np.float32)
    dirs = rng.normal(size=(shape[0], 3)).astype(np.float32)
    tau_cap = float(np.float32(-np.log(1e-3)))
    acc_tau = (rng.random(shape[0]) * 2.0 * tau_cap).astype(np.float32)
    acc_tau[:3] = np.float32(tau_cap)                  # at the cap: not live
    live = mask & (acc_tau < np.float32(tau_cap))[:, None]
    assert 0 < live.sum() < mask.sum()
    w_idx, w_flat, w_dir = _jax_compact(live, samples, dirs, budget)
    idx, cflat, cray_d, count = compact(torch.from_numpy(mask), torch.from_numpy(samples),
                                        torch.from_numpy(dirs), budget,
                                        torch.from_numpy(acc_tau), tau_cap)
    np.testing.assert_array_equal(np_of(idx), w_idx)
    np.testing.assert_array_equal(np_of(cflat), w_flat)
    np.testing.assert_array_equal(np_of(cray_d), w_dir)
    assert int(count) == int(live.sum())


@pytest.mark.parametrize("kept", [None, 5])
def test_scatter_back_matches_jax(kept):
    """Rows of the first K slots go back to their samples; empty slots are dropped."""
    rng = np.random.default_rng(4)
    mask = rng.random((20, 12)) < 0.3
    budget = 128
    idx, _, _, count = compact(torch.from_numpy(mask), torch.zeros(20, 12, 3),
                               torch.zeros(20, 3), budget)
    k = budget if kept is None else kept
    v = rng.normal(size=(k, 3)).astype(np.float32)
    # JAX: per-column .at[idx].set(mode='drop') over the padded budget
    v_pad = np.zeros((budget, 3), np.float32)
    v_pad[:k] = v
    idx_pad = np.asarray(np_of(idx))
    if kept is not None:
        idx_pad = idx_pad.copy()
        idx_pad[k:] = 240
    want = np.stack([np.asarray(jnp.zeros((240,)).at[jnp.asarray(idx_pad)]
                                .set(jnp.asarray(v_pad[:, c]), mode="drop"))
                     for c in range(3)], axis=-1)
    got = scatter_back(torch.from_numpy(v), idx, 240)
    np.testing.assert_array_equal(np_of(got), want)
    np.testing.assert_array_equal(np_of(scatter_back_plain(torch.from_numpy(v), idx, 240)),
                                  want)
