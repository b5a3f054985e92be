"""The octree query folded into the octree grid's interpolation (``octree_query_interp``) and
the sphere step folded in front of it (``sphere_iter``), by their plain versions here,
against the JAX package and against the port's unfused route.

Tolerances. (a) The fused query's features against JAX's ``OctreeGrid.interpolate``: 1e-6
(the blend's float sums in another order, features of std 0.5, as
tests/test_torch_octree_grid.py); its cells equal K9's with_parents columns exactly (integers).
(b) The restructured sphere loop against JAX's tracer: the existing SDF rule of
tests/test_torch_sdf_tracer.py (the same hits except where the field lies within 1e-5 of
min_dis, none here; depth and xyz within 1e-5, normals within 1e-4); against the port's
unfused loop: equal bit for bit in t, hit, xyz and normals (the same float operations in the
same order). The fused iteration writes zeros in the rows of rays that are not alive (its
kernel skips their gathers): the plain version does the same, and nothing reads those rows.
(c) The feature gradient through the cells the fused forward looked up against the unfused
one: equal bit for bit on the CPU, with PyTorch's deterministic algorithms (its CPU index
backward otherwise adds in an order that varies from run to run)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (jax_sdf_pipeline, np_of, sdf_params_from_jax,
                                sphere_octree_points)
from test_torch_sdf_tracer import _assert_trace_close

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.models.grids import OctreeGrid as JOctreeGrid
from wisp_tpu.models.nefs.neural_sdf import NeuralSDFTex as JNeuralSDFTex
from wisp_tpu.tracers.packed_sdf_tracer import PackedSDFTracer as JPackedSDFTracer

from wisp_tpu_torch import interop
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS, octree_query_plain
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.models.grids import octree_grid
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.tracers import packed_sdf_tracer
from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer

LEVEL = 5
INTERP_ATOL = 1e-6


def _points(n, seed):
    """Seeded points near the sphere (radius 0.9), anywhere in and around the box, on its
    faces (inside: K9's box test is inclusive) and just past them."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n // 2, 3))
    near = 0.9 * u / np.linalg.norm(u, axis=-1, keepdims=True) \
        + rng.normal(scale=0.02, size=(n // 2, 3))
    pts = np.concatenate([near, rng.uniform(-1.1, 1.1, (n - n // 2, 3))]).astype(np.float32)
    pts[:10, 0] = 1.0
    pts[10:20, 1] = -1.0
    pts[20:25] = np.float32([0.3, 1.0000001, -0.2])
    return pts


@functools.lru_cache(maxsize=None)
def _sphere_points():
    return sphere_octree_points(LEVEL, num_samples=50_000)


@functools.lru_cache(maxsize=None)
def _full_points(level):
    """Every cell of a level: a sparse octree of these is a dense one, whose cell indices
    are the morton codes."""
    g = np.arange(2 ** level, dtype=np.int32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def _jax_grid(kind):
    """JAX's OctreeGrid (3 LODs, features of std 0.5, 'sum') on the level-5 sphere octree
    ('sphere', F = 4) or on the octree of every cell of level 3 ('full', F = 5)."""
    q, level, f_dim = ((_sphere_points(), LEVEL, 4) if kind == "sphere"
                       else (_full_points(3), 3, 5))
    return JOctreeGrid(blas=JOctreeAS.from_quantized_points(q, level), feature_dim=f_dim,
                       num_lods=3, interpolation_type="linear", multiscale_type="sum",
                       feature_std=0.5, key=jax.random.PRNGKey(f_dim))


def _grids(kind, multiscale):
    """JAX's grid of ``_jax_grid`` merging its LODs by ``multiscale``, its interpolate at
    ``_points(1500, seed=F)``, and the port's OctreeGrid on the same octree (built as the
    port builds it now) holding JAX's features."""
    jgrid = _jax_grid(kind).replace(multiscale_type=multiscale)
    f_dim = jgrid.feature_dim
    want = np.asarray(jax.jit(lambda g, c: g.interpolate(c, 2))(
        jgrid, jnp.asarray(_points(1500, seed=f_dim))))
    q, level = (_sphere_points(), LEVEL) if kind == "sphere" else (_full_points(3), 3)
    grid = OctreeGrid(blas=OctreeAS.from_quantized_points(q, level, device="cpu"),
                      feature_dim=f_dim, num_lods=3, interpolation_type="linear",
                      multiscale_type=multiscale, device="cpu")
    with torch.no_grad():
        for f, jf in zip(grid.features, jgrid.features):
            f.copy_(torch.from_numpy(np.array(jf)))
    return jgrid, grid, want


def _jax_cells(jblas, pts, level, levels):
    """JAX's query columns of ``levels`` (with parents where there are several)."""
    if len(levels) == 1:
        pidx = jax.jit(lambda c: jblas.query(c, level).pidx)(jnp.asarray(pts))
        return np.asarray(pidx)[:, None]
    pidx = np.asarray(jax.jit(lambda c: jblas.query(c, level, with_parents=True).pidx)(
        jnp.asarray(pts)))
    return pidx[:, levels[0]:levels[-1] + 1]


# (route, multiscale): every route of the cell lookup and both LOD merges; F = 4 on the
# sphere octree (map, search), F = 5 on the octree of every cell (dense, bitfield)
ROUTE_CASES = [("map", "sum"), ("map", "cat"), ("search", "sum"), ("search", "cat"),
               ("dense", "sum"), ("dense", "cat"), ("bitfield", "sum")]


@pytest.mark.parametrize("route,multiscale", ROUTE_CASES)
def test_query_interp_matches_jax(monkeypatch, route, multiscale):
    """(a) The fused query's plain route against JAX's OctreeGrid.interpolate: map (the
    level-5 sphere octree), search (the same octree with its maps below level 3: the LODs'
    levels 3-5 binary-searched), dense (a make_dense octree: index = morton code, with the
    tables of the octree of every cell) and bitfield (a carved make_dense octree at its max
    level, one LOD: JAX's blend of JAX's query). The cells equal K9's columns exactly."""
    if route == "search":
        monkeypatch.setattr(OctreeAS, "PIDX_MAP_MAX_LEVEL", 2)
    jgrid, grid, want = _grids("sphere" if route in ("map", "search") else "full", multiscale)
    f_dim = grid.feature_dim
    pts = _points(1500, seed=f_dim)
    x = torch.from_numpy(pts)
    trinkets, feats = grid.trinkets, list(grid.features)
    if route in ("map", "search"):
        routes, levels = grid.blas.query_routes, list(grid.active_lods)
        assert [routes[l].kind for l in levels] == [route] * 3
        jcells = _jax_cells(jgrid.blas, pts, LEVEL, levels)
    elif route == "dense":
        routes, levels = OctreeAS.make_dense(3, device="cpu").query_routes, [1, 2, 3]
        jcells = _jax_cells(JOctreeAS.make_dense(3), pts, 3, levels)
        np.testing.assert_array_equal(jcells, _jax_cells(jgrid.blas, pts, 3, levels))
    else:
        occ = np.random.default_rng(9).random(8 ** 3) < 0.3
        jblas = JOctreeAS.make_dense(3).update_occupancy(jnp.asarray(occ))
        blas = OctreeAS.make_dense(3, device="cpu").update_occupancy(torch.from_numpy(occ))
        routes, levels = blas.query_routes, [3]
        assert routes[3].kind == "bitfield"
        trinkets, feats = trinkets[2:], feats[2:]
        jcells = _jax_cells(jblas, pts, 3, levels)
        want = np.asarray(jax.jit(lambda g, c, p: g._interpolate(c, g.features[2], p, 2))(
            jgrid, jnp.asarray(pts), jnp.asarray(jcells[:, 0])))
    with torch.no_grad():
        got, cells = octree_grid.octree_query_interp_plain(x, routes, trinkets, feats, levels,
                                                            multiscale)
    width = f_dim * (len(levels) if multiscale == "cat" else 1)
    assert got.shape == want.shape == (1500, width)
    np.testing.assert_allclose(np_of(got), want, atol=INTERP_ATOL, rtol=0)
    assert cells.dtype == torch.int32 and tuple(cells.shape) == (1500, len(levels))
    np.testing.assert_array_equal(np_of(cells), jcells)
    k9 = octree_query_plain(x, routes, levels[-1], with_parents=len(levels) > 1)
    k9 = k9[:, levels[0]:] if len(levels) > 1 else k9[:, None]
    assert torch.equal(cells, k9)
    outside = (np.abs(pts) > 1.0).any(-1)
    assert outside.any() and (jcells[outside] == -1).all()
    assert (jcells >= 0).any() and (jcells < 0).any()
    if route in ("map", "search"):
        # the grid's own route (interpolate) gives the same features
        with torch.no_grad():
            assert torch.equal(grid.interpolate(x, 2), got)


@functools.lru_cache(maxsize=None)
def _sdf_pipelines(tex: bool):
    """JAX's and the port's NGLOD pipeline (level 5, 3 LODs of 4 features, 'sum', hidden 32,
    the sphere decoder of radius 0.9); ``tex``: a NeuralSDFTex whose output 0 is that
    decoder's and 1-3 seeded."""
    dec = interop.sphere_sdf_decoder(4, 32, seed=0)
    jpipe = jax_sdf_pipeline(level=LEVEL, num_lods=3, hidden_dim=32, feature_dim=4,
                             decoder=dec)
    if tex:
        old = jpipe.nef
        nef = JNeuralSDFTex(grid=old.grid, position_input=True, hidden_dim=32,
                            key=jax.random.PRNGKey(5))
        rng = np.random.default_rng(6)
        w = rng.normal(0.0, 0.05, (4, 32)).astype(np.float32)
        w[0] = np.asarray(old.decoder.lout.weight)[0]
        b = np.float32([np.asarray(old.decoder.lout.bias)[0], 0.1, -0.2, 0.3])
        lout = nef.decoder.lout.replace(weight=jnp.asarray(w), bias=jnp.asarray(b))
        nef = nef.replace(decoder=nef.decoder.replace(layers=list(old.decoder.layers),
                                                      lout=lout))
        jpipe = jpipe.replace(nef=nef)
    params, config = sdf_params_from_jax(jpipe)
    return jpipe, interop.build_sdf_pipeline(params, config, device="cpu")


@functools.lru_cache(maxsize=None)
def _rays():
    """From (0, 0.6, -3): 320 rays towards seeded targets in [-0.8, 0.8]^3 and 64 that pass
    beside the box."""
    rng = np.random.default_rng(11)
    o = np.float32([0.0, 0.6, -3.0])
    targets = np.concatenate([rng.uniform(-0.8, 0.8, (320, 3)),
                              rng.uniform(-1.0, 1.0, (64, 3)) + np.float32([2.5, 0.0, 0.0])])
    d = (targets - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origins = np.ascontiguousarray(np.broadcast_to(o, d.shape)).astype(np.float32)
    return origins, d.astype(np.float32)


TRACE_KW = dict(num_steps=32, step_size=0.8, min_dis=3e-4)
# (compaction, mid_compaction, mid_at, NeuralSDFTex). The budgets drop no ray, so JAX's
# compacted traces equal its uncompacted one (a dead ray is frozen by the loop's masks;
# tests/test_torch_sdf_compaction.py holds the port's compaction to JAX's own): the
# compacted cases are held to JAX's uncompacted trace, one compile a field
TRACE_CASES = {"uncompacted": (None, None, 0.5, False), "compacted": (0.9, None, 0.5, False),
               "mid": (0.9, 0.6, 0.5, False), "tex": (None, None, 0.5, True)}


@functools.lru_cache(maxsize=None)
def _jax_trace(tex: bool):
    """JAX's uncompacted trace of the rays, and its field at the final points."""
    jpipe, pipe = _sdf_pipelines(tex)
    o, d = _rays()
    from wisp_tpu.core.rays import Rays as JRays
    # the free-space field of the port (equal to JAX's: tests/test_torch_octree.py), so that
    # JAX's dilations are not compiled here
    free_dist = jnp.asarray(np_of(pipe.nef.grid.blas.free_space_distance()))
    tracer = JPackedSDFTracer(free_dist=free_dist, **TRACE_KW)
    # the field and the tracer as arguments, not constants folded into the compile
    rb = jax.jit(lambda nef, tr, o_, d_: tr(nef, JRays(o_, d_, 0.0, 10.0)))(
        jpipe.nef, tracer, jnp.asarray(o), jnp.asarray(d))
    sdf = np.asarray(jax.jit(lambda nef, c_: nef(channels="sdf", coords=c_))(
        jpipe.nef, rb.xyz))[:, 0]
    return rb, sdf


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_fused_sphere_loop_matches_jax_and_the_unfused_loop(monkeypatch, case):
    """(b) The restructured loop (sphere_iter then the decoder, n times, and one closing
    sphere_step a loop) against JAX's trace and, bit for bit, against the port's unfused
    loop (the same tracer with the fused route turned off)."""
    c, mid, mid_at, tex = TRACE_CASES[case]
    _, pipe = _sdf_pipelines(tex)
    o, d = _rays()
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), 0.0, 10.0)
    tracer = PackedSDFTracer(compaction=c, mid_compaction=mid, mid_at=mid_at, **TRACE_KW)
    calls = {"sphere_iter": 0, "sphere_step": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(packed_sdf_tracer, name,
                            counting(name, getattr(packed_sdf_tracer, name)))
    assert packed_sdf_tracer.fused_field(pipe.nef, 2) is not None
    got = tracer(pipe.nef, rays)
    loops = 1 if mid is None else 2
    assert calls == {"sphere_iter": TRACE_KW["num_steps"], "sphere_step": loops}
    want, sdf = _jax_trace(tex)
    assert _assert_trace_close(got, want, sdf, TRACE_KW["min_dis"]) == 0
    assert float(got.num_overflow) == float(np.asarray(want.num_overflow)) == 0.0
    assert np_of(got.hit).mean() > 0.5 and not np_of(got.hit).all()

    monkeypatch.setattr(packed_sdf_tracer, "fused_field", lambda nef, lod_idx: None)
    calls.update(sphere_iter=0, sphere_step=0)
    unfused = tracer(pipe.nef, rays)
    assert calls == {"sphere_iter": 0, "sphere_step": TRACE_KW["num_steps"]}
    for key in ("depth", "hit", "xyz", "normal"):
        assert torch.equal(got.channels[key], unfused.channels[key]), key


def test_sphere_iter_plain_is_the_unfused_iteration():
    """sphere_iter's plain version on a state with dead, hit and live rays: t, alive and hit
    exactly as sphere_step_plain leaves them, then the rows of the live rays the unfused
    [interpolate | xyz] at o + t*d, and zeros elsewhere; without a field, no step."""
    _, pipe = _sdf_pipelines(False)
    nef, grid = pipe.nef, pipe.nef.grid
    o, d = (torch.from_numpy(a) for a in _rays())
    n = o.shape[0]
    free_dist = grid.blas.free_space_distance()
    rng = np.random.default_rng(12)
    t = torch.from_numpy(rng.uniform(2.0, 3.2, n).astype(np.float32))
    alive = torch.from_numpy(rng.random(n) < 0.8)
    hit = ~alive & torch.from_numpy(rng.random(n) < 0.5)
    t_far = torch.full((n,), 3.6)
    field = torch.from_numpy(rng.normal(0.0, 0.05, (n, 4)).astype(np.float32))
    field[:40, 0] = 1e-5                       # under min_dis: these hit where occupied
    args = (LEVEL, 0.8, 3e-4, *grid.query_interp_args(2), True)
    for with_field in (False, True):
        ts, alives, hits = t.clone(), alive.clone(), hit.clone()
        x = packed_sdf_tracer.sphere_iter_plain(o, d, ts, alives, hits, t_far,
                                                field if with_field else None, free_dist,
                                                *args)
        tw, aw, hw = t.clone(), alive.clone(), hit.clone()
        if with_field:
            packed_sdf_tracer.sphere_step_plain(o, d, tw, aw, hw, t_far,
                                                field[:, 0].contiguous(), free_dist, *args[:3])
            assert bool((hw & ~hit).any()) and bool((aw != alive).any())
        assert torch.equal(ts, tw) and torch.equal(alives, aw) and torch.equal(hits, hw)
        pos = o + tw[:, None] * d
        with torch.no_grad():
            want = torch.cat([grid.interpolate(pos, 2), pos], dim=-1)
        assert tuple(x.shape) == (n, 4 + 3)
        assert torch.equal(x[aw], want[aw]) and bool((x[~aw] == 0).all())
        with torch.no_grad():
            assert torch.equal(nef.decode_from(x)[aw], nef(channels="sdf", coords=pos)[aw])


@pytest.mark.parametrize("kind,multiscale", [("sphere", "sum"), ("full", "cat")])
def test_gradient_through_the_cells_equals_the_unfused(kind, multiscale):
    """(c) The autograd route of the card (the fused forward saves its cells, K15's backward
    takes them as its pidx), run here on the plain versions, against autograd of the
    unfused query and blend: features and feature gradients equal bit for bit."""
    _, grid, _ = _grids(kind, multiscale)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _gradients_equal(grid, multiscale, grid.feature_dim)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _gradients_equal(grid, multiscale, f_dim):
    x = torch.from_numpy(_points(1200, seed=3))
    routes, trinkets, feats, levels, ms = grid.query_interp_args(2)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1200, f_dim * (3 if multiscale == "cat" else 1))).astype(np.float32))
    out = octree_grid._OctreeQueryInterpFn.apply(x, routes, trinkets, levels, ms, *feats)
    got = torch.autograd.grad(out, feats, g)
    pidx = grid.blas.query(x, levels[-1], with_parents=True).pidx
    ref = octree_grid.octree_interp_plain(x, pidx, grid.base_lod, trinkets, feats, levels, ms)
    want = torch.autograd.grad(ref, feats, g)
    assert torch.equal(out, ref)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(bool((a != 0).any()) for a in got)
