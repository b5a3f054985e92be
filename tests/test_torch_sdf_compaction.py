"""K12's compaction in the port's sphere tracer against JAX's, at JAX's own test sizes
(tests/apps/test_nglod.py:39-133: the analytic sphere |x| - 0.5 on the level-4 octree of
its surface samples, 64 rays from z = -3, 64 steps).

Both tracers take the same steps in the same float order on the same analytic field, so
the traces agree to the bit: hits, overflow counts and the budgets exactly, depth, xyz and
normals within 1e-6. The budgets are read from JAX's ``masked_compact_indices`` (their
static argument) and from the port's ``compact_rays``, recorded as each is called."""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import both_rays, np_of
from test_torch_sdf_tracer import JSphereNef, SphereNef, _Grid

import wisp_tpu.ops.compaction as jcompaction
from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.tracers.packed_sdf_tracer import PackedSDFTracer as JPackedSDFTracer

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.ops import compaction
from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import sample_surface
from wisp_tpu_torch.ops.spc.core import quantize_points_np
from wisp_tpu_torch.tracers import packed_sdf_tracer
from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer

N = 64
BASE = dict(num_steps=64, step_size=0.8, min_dis=1e-3)
ATOL = 1e-6
# (compaction, mid_compaction, mid_at): JAX's ample, starved, mid-ample and mid-starved
# budgets, and R * c = 14.5 (half-even: 14 slots) with num_steps * mid_at = 2.5 (2 steps)
CASES = {
    "ample": (0.9, None, 0.5),
    "starved": (0.1, None, 0.5),
    "mid_ample": (0.9, 0.9, 0.25),
    "mid_starved": (0.9, 1.0 / N, 0.05),
    "half_even": (14.5 / N, 14.5 / N, 2.5 / 64),
}


@functools.lru_cache(maxsize=None)
def _scene():
    v, f = make_sphere_mesh(radius=0.5, subdivisions=3)
    q = quantize_points_np(sample_surface(v, f, 200000), 4)
    jnef = JSphereNef(_Grid(JOctreeAS.from_quantized_points(q, 4)))
    nef = SphereNef(_Grid(OctreeAS.from_quantized_points(q, 4, device="cpu")))
    ys = np.linspace(-0.9, 0.9, N, dtype=np.float32)
    o = np.stack([ys, np.zeros(N, np.float32), np.full(N, -3.0, np.float32)], -1)
    d = np.ascontiguousarray(np.broadcast_to(np.float32([0.0, 0.0, 1.0]), (N, 3)))
    jrays, rays = both_rays(o, d, 0.0, 10.0)
    return jnef, nef, jrays, rays


@functools.lru_cache(maxsize=None)
def _jax_trace(kw_items):
    """JAX's trace of the cached scene and the budgets it compacted to (one compile a
    setting)."""
    jnef, _, jrays, _ = _scene()
    budgets = []
    original = jcompaction.masked_compact_indices

    def recording(mask, budget, block=128):
        budgets.append(budget)
        return original(mask, budget, block)

    jcompaction.masked_compact_indices = recording
    try:
        rb = jax.jit(lambda r: JPackedSDFTracer(**BASE, **dict(kw_items))(jnef, r))(jrays)
        rb = jax.tree_util.tree_map(np.asarray, rb.channels)
    finally:
        jcompaction.masked_compact_indices = original
    return rb, tuple(budgets)


def _port_trace(monkeypatch, **kw):
    _, nef, _, rays = _scene()
    budgets = []
    original = compaction.compact_rays

    def recording(mask, budget, *args, **kwargs):
        budgets.append(budget)
        return original(mask, budget, *args, **kwargs)

    monkeypatch.setattr(packed_sdf_tracer, "compact_rays", recording)
    return PackedSDFTracer(**BASE, **kw)(nef, rays), tuple(budgets)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compacted_trace_matches_jax(monkeypatch, case):
    c, mid, mid_at = CASES[case]
    kw = dict(compaction=c, mid_compaction=mid, mid_at=mid_at)
    want, jbudgets = _jax_trace(tuple(sorted(kw.items())))
    got, budgets = _port_trace(monkeypatch, **kw)
    assert budgets == jbudgets and len(budgets) == (1 if mid is None else 2)
    assert float(got.num_overflow) == float(want["num_overflow"])
    np.testing.assert_array_equal(np_of(got.hit), want["hit"])
    for key in ("depth", "xyz", "normal", "rgb", "alpha"):
        np.testing.assert_allclose(np_of(got.channels[key]), want[key], atol=ATOL, rtol=0,
                                   err_msg=key)
    # the overflow rule of the starved budgets, and an untouched trace where none drops
    full, _ = _jax_trace(())
    if case in ("ample", "mid_ample"):
        assert float(got.num_overflow) == 0.0
        np.testing.assert_array_equal(np_of(got.hit), full["hit"])
    else:
        assert float(got.num_overflow) > 0.0
        assert not (np_of(got.hit) & ~full["hit"]).any(), "a compacted trace invented a hit"


def test_budgets_round_half_even():
    """R * c = 14.5 takes 14 slots and 64 * 2.5/64 = 2.5 sphere steps take 2, with Python's
    round as JAX has it; a budget is at least one slot."""
    assert compaction.ray_budget(N, 14.5 / N) == 14
    assert compaction.ray_budget(N, 15.5 / N) == 16
    assert compaction.ray_budget(N, 0.001) == 1
    _, jbudgets = _jax_trace(tuple(sorted(dict(compaction=14.5 / N, mid_compaction=14.5 / N,
                                               mid_at=2.5 / 64).items())))
    assert jbudgets == (14, 14)


def test_dropped_rays_keep_the_walk(monkeypatch):
    """A ray the budget drops keeps the walk's depth t0 (xyz = o + t0 d), misses and has a
    zero normal, as in JAX: the starved trace's dropped rays against the walk itself."""
    _, nef, _, rays = _scene()
    got, _ = _port_trace(monkeypatch, compaction=0.1)
    o, d = rays.origins, rays.dirs
    t_near, t_far = packed_sdf_tracer.aabb_intersect(o, d, rays.dist_min, rays.dist_max)
    t0 = t_near.clamp(min=0.0) + 1e-6
    alive = t_far > t0
    packed_sdf_tracer.sdf_walk(o, d, t0, alive, t_far.contiguous(),
                               nef.grid.blas.free_space_distance(), 4, BASE["num_steps"])
    budget = compaction.ray_budget(N, 0.1)
    dropped = torch.nonzero(alive).reshape(-1)[budget:]
    assert dropped.numel() == int(got.num_overflow)
    assert torch.equal(got.xyz[dropped], o[dropped] + t0[dropped, None] * d[dropped])
    assert not got.hit[dropped].any() and not got.normal[dropped].any()


@pytest.mark.parametrize("r,alive,budget", [(300, 0.0, 40),    # count 0: every slot filled
                                            (300, 0.6, 100),   # count above the budget
                                            (300, 1.0, 300),   # every ray alive
                                            (1, 1.0, 3)])      # R = 1
def test_compact_rays_matches_jax(r, alive, budget):
    """``compact_rays`` against JAX's ``masked_compact_indices(mask[:, None], budget)`` and
    its clipped gathers (packed_sdf_tracer.py:182-185), every slot."""
    import jax.numpy as jnp
    rng = np.random.default_rng(r + budget)
    mask = rng.random(r) < alive
    o, d = (rng.normal(size=(r, 3)).astype(np.float32) for _ in range(2))
    t, tf = (rng.random(r).astype(np.float32) for _ in range(2))
    indices = jax.jit(jcompaction.masked_compact_indices, static_argnums=1)
    idx = np.asarray(indices(jnp.asarray(mask[:, None]), budget))
    safe = np.minimum(idx, r - 1)
    got = compaction.compact_rays(torch.from_numpy(mask), budget, torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(t),
                                  torch.from_numpy(tf))
    for a, b in zip(got, (idx, o[safe], d[safe], t[safe], tf[safe], mask.sum())):
        np.testing.assert_array_equal(np_of(a), b)
