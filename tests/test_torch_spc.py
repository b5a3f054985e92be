"""Port parity: the SPC browser's path on the CPU against the JAX package.

* ``pointcloud_to_octree`` (with attributes, with dilation): the level tables and the
  per-cell attribute means equal JAX's exactly.
* ``OctreeAS.raytrace`` (K10's plain version) on every route of JAX's ``occupied()``:
  dense, bitfield-only (a carved ``make_dense``), the pidx maps, and the binary search in
  the codes above the maps' levels (``PIDX_MAP_MAX_LEVEL`` lowered in both packages), at
  the default capacity and at one that overflows, and ``capacity='exact'`` with its byte
  guard: pidx, mask and overflow exactly, t_entry and t_exit exactly (the same float32
  operations in the same order).
* ``SPCField.rgba`` and ``PackedSPCTracer.trace`` (K13's plain version): hit, rgb, alpha
  and ``num_overflow`` exactly; depth to 1e-6 (XLA's compile contracts products and sums of
  JAX's walk into fused multiply-adds, which moves some depths by an ulp of t ~ 2).
* The first-hit walk against the DDA, JAX's own equivalence (tests/core/test_tracers_spc.py):
  the same hit set, depth within the boundary nudge, the same first cell but for a tie at
  a cell corner in under 1% of the rays.
* ``OfflineRenderer.render_lookat`` of an SPC pipeline and ``main_spc_browser.main`` at a
  tiny resolution against JAX's.

Sizes: a level-4 octree of a radius-0.6 sphere (JAX's test: level 6), a few hundred rays:
JAX's raytrace is a scan of 3*2^level + 2 steps under vmap, jitted once a call.
"""

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.spc_browser.main_spc_browser as jmain
from test_torch_helpers import carved_occupancy, np_of
from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.core import Rays as JRays
from wisp_tpu.models.nefs.spc_field import SPCField as JSPCField
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.ops.mesh import make_sphere_mesh, sample_surface
from wisp_tpu.ops.spc import pointcloud_to_octree as jpointcloud_to_octree
from wisp_tpu.tracers import PackedSPCTracer as JPackedSPCTracer
from wisp_tpu.trainers.tracker.offline_renderer import OfflineRenderer as JOfflineRenderer

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.examples.spc_browser import main_spc_browser
from wisp_tpu_torch.interop import build_spc_field
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.ops.spc.conversions import pointcloud_to_octree
from wisp_tpu_torch.tracers.packed_spc_tracer import PackedSPCTracer
from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer

LEVEL = 4
DEPTH_ATOL = 1e-6
RAYTRACE_KEYS = ("pidx", "t_entry", "t_exit", "mask", "overflow")


@pytest.fixture(scope="module")
def scene():
    """(samples, colours, JAX octree codes and cell colours) of the sphere."""
    v, f = make_sphere_mesh(radius=0.6, subdivisions=2)
    samples = sample_surface(v, f, 20_000)
    colors = (samples + 1.0) / 2.0
    codes, cell_colors = jpointcloud_to_octree(samples, LEVEL, attributes=colors)
    return samples, colors, codes, cell_colors


def _rays(n, seed=0):
    """JAX's test bundle: an axis-aligned frontal grid and random oblique rays."""
    ys = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    xx, yy = np.meshgrid(ys, ys, indexing="ij")
    o1 = np.stack([xx.ravel(), yy.ravel(), np.full(n * n, -3.0, np.float32)], -1)
    d1 = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), o1.shape).copy()
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(n * n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o2 = (-2.5 * d2 + rng.uniform(-0.05, 0.05, (n * n, 3))).astype(np.float32)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    return (JRays(jnp.asarray(o), jnp.asarray(d), 0.0, 10.0),
            Rays(torch.from_numpy(o), torch.from_numpy(d), 0.0, 10.0))


@pytest.mark.parametrize("dilate", [0, 1])
def test_pointcloud_to_octree_matches_jax(scene, dilate):
    samples, colors, _, _ = scene
    jcodes, jattr = jpointcloud_to_octree(samples, LEVEL, attributes=colors, dilate=dilate)
    codes, attr = pointcloud_to_octree(samples, LEVEL, attributes=colors, dilate=dilate)
    assert len(codes) == len(jcodes) == LEVEL + 1
    for a, b in zip(codes, jcodes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(attr, jattr)
    if dilate:
        assert (attr == 0).all(axis=1).any()      # the dilated cells carry zeros
    only = pointcloud_to_octree(samples, LEVEL, dilate=dilate)
    assert all(np.array_equal(a, b) for a, b in zip(only, codes))


def _octrees(kind, codes, monkeypatch):
    """(JAX octree, port octree) of one raytrace route."""
    if kind == "dense":
        return JOctreeAS.make_dense(3), OctreeAS.make_dense(3, device="cpu")
    if kind == "bitfield":
        occ, dens = carved_occupancy(3, seed=4, frac=0.1)
        jblas = JOctreeAS.make_dense(3).update_occupancy(jnp.asarray(occ),
                                                         cell_density=jnp.asarray(dens))
        blas = OctreeAS.make_dense(3, device="cpu").update_occupancy(
            torch.from_numpy(occ), torch.from_numpy(dens))
        return jblas, blas
    if kind == "search":
        monkeypatch.setattr(JOctreeAS, "PIDX_MAP_MAX_LEVEL", 2)
        monkeypatch.setattr(OctreeAS, "PIDX_MAP_MAX_LEVEL", 2)
    return JOctreeAS(codes), OctreeAS.from_codes(codes, device="cpu")


@pytest.mark.parametrize("kind,capacity", [("dense", None), ("bitfield", None),
                                           ("maps", None), ("maps", 3), ("search", None),
                                           ("search", "exact")])
def test_raytrace_matches_jax(scene, monkeypatch, kind, capacity):
    jblas, blas = _octrees(kind, scene[2], monkeypatch)
    assert blas.query_routes[blas.max_level].kind == {"maps": "map"}.get(kind, kind)
    jr, tr = _rays(8, seed=1)
    want = jax.jit(lambda r: jblas.raytrace(r, capacity=capacity))(jr)
    got = blas.raytrace(tr, capacity=capacity)
    for key in RAYTRACE_KEYS:
        np.testing.assert_array_equal(np_of(getattr(got, key)), np_of(getattr(want, key)),
                                      err_msg=key)
    assert np_of(got.mask).any()
    assert np_of(got.overflow).any() == (capacity == 3)


def test_raytrace_exact_guard(scene, monkeypatch):
    """capacity='exact' raises where the buffers would pass the byte guard, in both."""
    jr, tr = _rays(4)
    for cls in (JOctreeAS, OctreeAS):
        monkeypatch.setattr(cls, "RAYTRACE_EXACT_MAX_BYTES", 1000)
    with pytest.raises(ValueError, match="chunk"):
        JOctreeAS(scene[2]).raytrace(jr, capacity="exact")
    with pytest.raises(ValueError, match="chunk"):
        OctreeAS.from_codes(scene[2], device="cpu").raytrace(tr, capacity="exact")


def test_spc_field_rgba_matches_jax(scene):
    _, _, codes, cell_colors = scene
    pidx = np.asarray([0, 5, -1, len(cell_colors) - 1, -1], np.int32)
    jnef = JSPCField(blas=JOctreeAS(codes), colors=cell_colors)
    nef = build_spc_field(codes, cell_colors, device="cpu")
    for colors in (True, False):
        if not colors:
            jnef = JSPCField(blas=jnef.grid.blas)
            nef = build_spc_field(codes, device="cpu")
        want = jnef.rgba(pidx=jnp.asarray(pidx))
        got = nef(channels=["rgb", "alpha"], pidx=torch.from_numpy(pidx))
        for ch in ("rgb", "alpha"):
            np.testing.assert_array_equal(np_of(got[ch]), np_of(want[ch]), err_msg=ch)


@pytest.fixture(scope="module")
def traced(scene):
    """(JAX octree, port octree, rays, JAX's trace and the port's) at 64 walk steps and at
    4, where some walks run out of steps in free space."""
    _, _, codes, cell_colors = scene
    jnef = JSPCField(blas=JOctreeAS(codes), colors=cell_colors)
    nef = build_spc_field(codes, cell_colors, device="cpu")
    jr, tr = _rays(10)
    out = {}
    for steps in (64, 4):
        want = jax.jit(lambda r: JPackedSPCTracer(num_steps=steps)(jnef, r))(jr)
        out[steps] = (want, PackedSPCTracer(num_steps=steps)(nef, tr))
    return jnef.grid.blas, nef.grid.blas, jr, tr, out


@pytest.mark.parametrize("steps", [64, 4])
def test_spc_tracer_matches_jax(traced, steps):
    want, got = traced[4][steps]
    for ch in ("hit", "rgb", "alpha", "num_overflow"):
        np.testing.assert_array_equal(np_of(got.channels[ch]), np_of(getattr(want, ch)),
                                      err_msg=ch)
    np.testing.assert_allclose(np_of(got.depth), np_of(want.depth), atol=DEPTH_ATOL, rtol=0)
    assert np_of(got.hit).any()
    assert (float(got.num_overflow) > 0) == (steps == 4)


def test_spc_tracer_first_hit_matches_raytrace(traced):
    """JAX's own equivalence on the port: the walk's first hit is the DDA's first
    interval (tests/core/test_tracers_spc.py:47-75)."""
    _, blas, _, tr, out = traced
    rb = out[64][1]
    voxel = 2.0 / 2 ** blas.max_level
    rt = blas.raytrace(tr)
    assert not bool(rt.overflow.any()) and float(rb.num_overflow) == 0.0
    ref_hit = rt.mask.any(dim=-1)
    first = rt.mask.to(torch.int64).argmax(dim=-1, keepdim=True)
    ref_pidx = rt.pidx.gather(1, first)[:, 0]
    ref_t = rt.t_entry.gather(1, first)[:, 0]
    hit = rb.hit[:, 0]
    assert torch.equal(hit, ref_hit)
    np.testing.assert_allclose(np_of(rb.depth[:, 0][hit]), np_of(ref_t[hit]),
                               atol=2e-2 * voxel, rtol=0)
    pidx = blas.query(tr.origins + rb.depth * tr.dirs).pidx
    assert float((pidx[hit] == ref_pidx[hit]).float().mean()) >= 0.99


def test_render_lookat_matches_jax(scene):
    """An SPC pipeline through OfflineRenderer.render_lookat (JAX's
    tests/core/test_offline_renderer.py pipeline) at 16x16 in chunks of 128 rays."""
    _, _, codes, cell_colors = scene
    jpipe = JPipeline(nef=JSPCField(blas=JOctreeAS(codes), colors=cell_colors),
                      tracer=JPackedSPCTracer())
    pipe = Pipeline(nef=build_spc_field(codes, cell_colors, device="cpu"),
                    tracer=PackedSPCTracer())
    want = JOfflineRenderer(render_res=(16, 16), render_batch=128).render_lookat(
        jpipe, f=(0.0, 0.0, -3.0))
    got = OfflineRenderer(render_res=(16, 16), render_batch=128, device="cpu") \
        .render_lookat(pipe, f=(0.0, 0.0, -3.0))
    _assert_same_frame(got, want)
    assert float(got.num_overflow) == float(want.num_overflow)
    assert np_of(got.hit).any() and not np_of(got.hit).all()


def test_browser_main_matches_jax(monkeypatch, tmp_path):
    """main_spc_browser.main against JAX's at 12x12, both on a level-4 octree (the default
    level 6 costs JAX's CPU compile tens of seconds), and the PNG it writes."""
    for mod in (jmain, main_spc_browser):
        monkeypatch.setattr(mod, "mesh_to_colored_spc",
                            functools.partial(mod.mesh_to_colored_spc, level=LEVEL))
    want = jmain.main(out_path=str(tmp_path / "jax.png"), res=12)
    got = main_spc_browser.main(out_path=str(tmp_path / "png" / "port.png"), res=12,
                                device="cpu")
    _assert_same_frame(got, want)
    assert np_of(got.hit).any() and not np_of(got.hit).all()
    png = (tmp_path / "png" / "port.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and png[16:24] == struct.pack(">II", 12, 12)


def _assert_same_frame(got, want):
    for ch in ("hit", "rgb", "alpha"):
        np.testing.assert_array_equal(np_of(got.channels[ch]), np_of(getattr(want, ch)),
                                      err_msg=ch)
    np.testing.assert_allclose(np_of(got.depth), np_of(want.depth), atol=DEPTH_ATOL, rtol=0)
