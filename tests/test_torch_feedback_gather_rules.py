"""The rules of K5 with the cell lookup inside (``csrc/scatter_max.cu``
``wisp_scatter_max_points``) and of K3's scatter-back backward as one gather for colour and
density (``csrc/compaction.cu`` ``wisp_scatter_back_bwd_many``), held on the CPU to JAX.

(a) ``scatter_max_points_plain``, the CPU route of ``scatter_max_points`` (``cell_ids`` and
    ``scatter_max_plain``), equals JAX's inline keep-score rule (wisp_tpu/tracers/
    packed_rf_tracer.py:237-256: ``quantize_points_jnp``, the flat ids, ``jnp.where`` on the
    mask and ``.at[ids].max(mode="drop")``) on points that include exact cell faces
    (x = -1 + 2k/res), points outside [-1, 1] and masked-off samples, with float32 and
    bfloat16 densities and a NaN density, into a fresh grid and into one grid carried over
    4 calls (the segments' ``fb``, :376-384).
(b) ``scatter_back_many_plain`` (colour [K, 3] and flat density [K] on one ``idx``) and its
    vjp by autograd equal JAX's per-column scatter and ``jax.vjp`` (packed_rf_tracer.py:
    210-222), with empty slots and K below the budget; ``scatter_back_bwd_many_plain``, the
    plain version of the one gather, equals the same vjp.
(c) The tracer makes one K5 call and one colour-and-density scatter-back a trace, and per
    segment of the segmented trace (``mock.patch`` on the tracer's names).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.ops.spc import quantize_points_jnp

from wisp_tpu_torch.ops.compaction import (scatter_back_bwd_many_plain, scatter_back_many,
                                           scatter_back_many_plain)
from wisp_tpu_torch.ops.density_grid import scatter_max_points, scatter_max_points_plain

LEVEL = 3
RES = 2 ** LEVEL
K = 600


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_feedback(grid, points, density, keep, level):
    """JAX's inline rule, into ``grid`` (zeros for a fresh one)."""
    resb = 2 ** level
    q = quantize_points_jnp(points, level)
    ids = (q[:, 0] * resb + q[:, 1]) * resb + q[:, 2]
    ids = jnp.where(keep, ids, resb ** 3)
    d = jnp.where(keep, density, 0.0)
    return grid.at[ids].max(jax.lax.stop_gradient(d.astype(jnp.float32)), mode="drop")


def _samples(seed, k=K):
    """Points in [-1.3, 1.3]^3 with a third on exact cell faces and a few far outside,
    relu'd densities (a fifth exactly 0) and a mask that drops about a quarter."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, size=(k, 3)).astype(np.float32)
    faces = (-1.0 + 2.0 * rng.integers(0, RES + 1, size=(k // 3, 3)) / RES).astype(np.float32)
    pts[:k // 3] = faces
    pts[k // 3:k // 3 + 6] = np.float32([[1.0, -1.0, 3.0], [-3.0, 0.0, 2.0], [1.5, 1.5, 1.5],
                                         [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                                         [-1.0000001, 0.9999999, 0.0]])
    dens = np.maximum(rng.normal(size=k), 0.0).astype(np.float32) * 4.0
    keep = rng.random(k) < 0.75
    return pts, dens, keep


def _port(pts, dens, keep, out=None, dtype=torch.float32):
    d = torch.from_numpy(dens).to(dtype)
    return scatter_max_points(torch.from_numpy(pts), d, LEVEL, out=out,
                              keep=None if keep is None else torch.from_numpy(keep))


@pytest.mark.parametrize("masked,dtype", [(False, "float32"), (True, "float32"),
                                          (True, "bfloat16")])
def test_k5_plain_equals_jax_inline_rule(masked, dtype):
    pts, dens, keep = _samples(1)
    jkeep = keep if masked else np.ones(K, bool)
    jdens = jnp.asarray(dens).astype(dtype)
    want = _jax_feedback(jnp.zeros((8 ** LEVEL,), jnp.float32), jnp.asarray(pts), jdens,
                         jnp.asarray(jkeep), LEVEL)
    got = _port(pts, dens, keep if masked else None, dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (8 ** LEVEL,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the CPU route is the plain version
    np.testing.assert_array_equal(
        got.numpy(), scatter_max_points_plain(torch.from_numpy(pts),
                                              torch.from_numpy(dens).to(getattr(torch, dtype)),
                                              LEVEL, keep=torch.from_numpy(keep)
                                              if masked else None).numpy())
    assert (got > 0).sum() > 20


def test_k5_nan_density_turns_its_cell_into_nan():
    pts, dens, keep = _samples(2)
    keep[:4] = True
    dens[3] = np.nan
    pts[3] = pts[0]                       # shares a cell with a finite density
    want = np.asarray(_jax_feedback(jnp.zeros((8 ** LEVEL,), jnp.float32), jnp.asarray(pts),
                                    jnp.asarray(dens), jnp.asarray(keep), LEVEL))
    got = _port(pts, dens, keep).numpy()
    cell = int(np.asarray(_cells(pts[3:4]))[0])
    assert np.isnan(got[cell]) and np.isnan(want[cell])
    np.testing.assert_array_equal(got, want)      # NaN where NaN, the rest equal


def _cells(pts):
    q = np.clip(np.floor((pts + np.float32(1.0)) * np.float32(RES / 2.0)), 0, RES - 1)
    return (q[:, 0] * RES + q[:, 1]) * RES + q[:, 2]


def test_k5_grid_carried_over_four_calls():
    grid = jnp.zeros((8 ** LEVEL,), jnp.float32)
    out = torch.zeros((8 ** LEVEL,), dtype=torch.float32)
    for g in range(4):
        pts, dens, keep = _samples(10 + g)
        grid = _jax_feedback(grid, jnp.asarray(pts), jnp.asarray(dens), jnp.asarray(keep),
                             LEVEL)
        # the segmented trace's calls carry compacted samples: no mask
        got = _port(pts[keep], dens[keep], None, out=out)
        assert got is out
        np.testing.assert_array_equal(out.numpy(), np.asarray(grid))


@jax.jit
def _jax_back(color, density, idx):
    """JAX's per-column scatter-back of colour and density (packed_rf_tracer.py:210-222),
    density through ``[..., 0]``."""
    total = _TOTAL

    def back(v):
        v2 = v.reshape(v.shape[0], -1)
        cols = [jnp.zeros((total,), v2.dtype).at[idx].set(v2[:, c], mode="drop")
                for c in range(v2.shape[-1])]
        return jnp.stack(cols, axis=-1)

    return back(color), back(density)[..., 0]


_TOTAL = 96


@pytest.mark.parametrize("kept,empty", [(40, 0), (40, 7)])
def test_scatter_back_many_and_its_vjp_equal_jax(kept, empty):
    rng = np.random.default_rng(kept + empty)
    budget = 64                                   # K = kept < budget: JAX's tail is empty
    idx = np.full(budget, _TOTAL, np.int64)
    idx[:kept] = rng.permutation(_TOTAL)[:kept]
    idx[kept - empty:kept] = _TOTAL               # empty slots among the first K too
    color = rng.standard_normal((budget, 3)).astype(np.float32)
    density = rng.standard_normal((budget, 1)).astype(np.float32)
    g_col = rng.standard_normal((_TOTAL, 3)).astype(np.float32)
    g_den = rng.standard_normal(_TOTAL).astype(np.float32)
    (jc, jd), vjp = jax.vjp(lambda c, d: _jax_back(c, d, jnp.asarray(idx)),
                            jnp.asarray(color), jnp.asarray(density))
    jg_col, jg_den = vjp((jnp.asarray(g_col), jnp.asarray(g_den)))

    c = torch.from_numpy(color[:kept]).requires_grad_(True)
    d = torch.from_numpy(density[:kept, 0]).requires_grad_(True)
    t_idx = torch.from_numpy(idx)
    pc, pd = scatter_back_many(t_idx, _TOTAL, c, d)
    assert pc.shape == (_TOTAL, 3) and pd.shape == (_TOTAL,)
    np.testing.assert_array_equal(pc.detach().numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pd.detach().numpy(), np.asarray(jd))
    gc, gd = torch.autograd.grad((pc, pd), (c, d),
                                 (torch.from_numpy(g_col), torch.from_numpy(g_den)))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jg_col)[:kept])
    np.testing.assert_array_equal(gd.numpy(), np.asarray(jg_den)[:kept, 0])
    assert not np.asarray(jg_col)[kept:].any()    # JAX's empty tail takes no gradient
    bc, bd = scatter_back_bwd_many_plain([torch.from_numpy(g_col), torch.from_numpy(g_den)],
                                         t_idx, kept)
    assert torch.equal(bc, gc) and torch.equal(bd, gd)
    pc2, pd2 = scatter_back_many_plain(t_idx, _TOTAL, c.detach(), d.detach())
    assert torch.equal(pc2, pc.detach()) and torch.equal(pd2, pd.detach())


def _port_tracer_setup():
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.models.grids.hash_grid import HashGrid
    from wisp_tpu_torch.models.nefs.nerf import NeuralRadianceField
    from wisp_tpu_torch.tracers.packed_rf_tracer import PackedRFTracer
    gen = torch.Generator().manual_seed(0)
    grid = HashGrid.from_geometric(blas=OctreeAS.make_dense(3, device="cpu"), feature_dim=2,
                                   num_lods=4, multiscale_type="cat", feature_std=0.5,
                                   feature_bias=0.0,
                                   codebook_bitwidth=10, min_grid_res=4, max_grid_res=32,
                                   generator=gen, device="cpu")
    nef = NeuralRadianceField(grid=grid, pos_embedder="none", view_embedder="positional",
                              view_multires=4, position_input=False, activation_type="relu",
                              layer_type="linear", hidden_dim=32, num_layers=1, bias=True,
                              generator=gen, device="cpu")
    rng = np.random.default_rng(5)
    o = np.float32([0.0, 0.0, -3.0]) + rng.normal(scale=0.2, size=(24, 3)).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)), 0.0, 8.0)
    return nef, rays, PackedRFTracer()


@pytest.mark.parametrize("mode", ["compacted", "uncompacted", "segmented"])
def test_tracer_calls_k5_and_the_scatter_back_once_a_trace_and_a_segment(mode):
    from wisp_tpu_torch.tracers import packed_rf_tracer as tr
    nef, rays, tracer = _port_tracer_setup()
    calls = {"k5": [], "back": 0}

    def k5(points, density, level, out=None, keep=None):
        calls["k5"].append((out is not None, keep is not None))
        return scatter_max_points(points, density, level, out=out, keep=keep)

    def back(idx, total, *vs):
        calls["back"] += 1
        assert [tuple(v.shape[1:]) for v in vs] == [(3,), ()]     # colour, flat density
        return scatter_back_many(idx, total, *vs)

    kw = {"compacted": dict(compaction=0.5), "uncompacted": {},
          "segmented": dict(compaction=1.0, seg_early_stop=1e-3, seg_count=4)}[mode]
    with mock.patch.object(tr, "scatter_max_points", k5), \
            mock.patch.object(tr, "scatter_back_many", back):
        rb = tracer.trace(nef, rays, channels={"rgb"}, extra_channels=set(), num_steps=16,
                          density_feedback=True, **kw)
        rb.rgb.sum().backward()
    n_calls = 4 if mode == "segmented" else 1
    assert calls["k5"] == [(mode == "segmented", mode == "uncompacted")] * n_calls
    # the uncompacted trace keeps its rows in place: no scatter-back
    assert calls["back"] == (0 if mode == "uncompacted" else n_calls)
    assert rb.density_max_grid.shape == (8 ** 3,) and (rb.density_max_grid > 0).any()
