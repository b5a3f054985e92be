"""The sparse octree of the port against the JAX package: mesh sampling, the host builders
(level tables, dual octree, trinkets), the pidx maps and occupancy, the point query (K9)
and the free-space distance field (K11). All of it is integer or host numpy, so every
comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import np_of, sphere_octree_points

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.ops import mesh as jmesh
from wisp_tpu.ops.spc import core as jcore

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
from wisp_tpu_torch.ops.spc import core


def test_mesh_sampling_matches_jax():
    v, f = make_sphere_mesh(radius=1.0, subdivisions=3)
    jv, jf = jmesh.make_sphere_mesh(radius=1.0, subdivisions=3)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    v, f = normalize(v, f, "sphere")
    jv, jf = jmesh.normalize(jv, jf, "sphere")
    np.testing.assert_array_equal(v, jv)
    for mode in ("aabb", "planar", "none"):
        np.testing.assert_array_equal(normalize(v * 1.3, f, mode)[0],
                                      jmesh.normalize(jv * 1.3, jf, mode)[0])
    np.testing.assert_array_equal(sample_surface(v, f, 5000, rng=np.random.default_rng(3)),
                                  jmesh.sample_surface(jv, jf, 5000,
                                                       rng=np.random.default_rng(3)))
    np.testing.assert_array_equal(sample_surface(v, f, 300), jmesh.sample_surface(jv, jf, 300))


def test_level_table_and_dual_match_jax():
    q = sphere_octree_points(5, num_samples=20_000)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(core.quantize_points_np(x, 5), jcore.quantize_points(x, 5))
    codes, points = core.build_level_table(q, 5)
    jcodes, jpoints = jcore.build_level_table(q, 5)
    assert len(codes) == len(jcodes) == 6
    for a, b in zip(codes, jcodes):
        np.testing.assert_array_equal(a.astype(np.uint64), np.asarray(b).astype(np.uint64))
    for a, b in zip(points, jpoints):
        np.testing.assert_array_equal(a, b)
    dual, trinkets = core.make_dual(points)
    jdual, jtrinkets = jcore.make_dual([np.asarray(p) for p in jpoints])
    for a, b, c, d in zip(dual, jdual, trinkets, jtrinkets):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
    np.testing.assert_array_equal(core.points_to_corners(points[3]),
                                  np.asarray(jcore.points_to_corners(jnp.asarray(points[3]))))
    np.testing.assert_array_equal(core.dilate_points(points[4], 4),
                                  jcore.dilate_points(points[4], 4))
    ints = rng.integers(0, 2 ** 10, (400, 3))
    np.testing.assert_array_equal(np_of(core.morton3d(torch.from_numpy(ints))),
                                  np.asarray(jcore.morton3d(jnp.asarray(ints))).astype(np.int64))
    np.testing.assert_array_equal(core.morton_to_points(core.points_to_morton(ints)), ints)


@pytest.fixture(scope="module")
def octrees():
    """The sphere octree at level 5, built by both packages from the same points."""
    q = sphere_octree_points(5, num_samples=50_000)
    return (JOctreeAS.from_quantized_points(q, 5),
            OctreeAS.from_quantized_points(q, 5, device="cpu"))


def test_sparse_octree_matches_jax(octrees):
    jblas, blas = octrees
    assert blas.level_counts == jblas.level_counts
    assert not blas.dense
    for a, b in zip(blas.codes, jblas.codes):
        np.testing.assert_array_equal(a, np.asarray(b).astype(np.uint64))
    for a, b in zip(blas.points, jblas.points):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(blas.pidx_maps) == len(jblas.pidx_maps) == 6
    for a, b in zip(blas.pidx_maps, jblas.pidx_maps):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    np.testing.assert_array_equal(np_of(blas.occ_grid), np.asarray(jblas.occ_grid))
    np.testing.assert_array_equal(np_of(blas.cell_density), np.asarray(jblas.cell_density))
    pts = np.random.default_rng(5).uniform(-1.1, 1.1, (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_of(blas.occupancy_at(torch.from_numpy(pts))),
                                  np.asarray(jblas.occupancy_at(jnp.asarray(pts))))
    cloud = np.random.default_rng(6).normal(scale=0.4, size=(300, 3)).astype(np.float32)
    a = OctreeAS.from_pointcloud(cloud, 4, dilate=1, device="cpu")
    b = JOctreeAS.from_pointcloud(cloud, 4, dilate=1)
    assert a.level_counts == b.level_counts
    np.testing.assert_array_equal(np_of(a.occ_grid), np.asarray(b.occ_grid))


def _query_points(n, seed):
    """Seeded points in and around the box, with points on every face (inside: the query's
    box test is inclusive) and just past them."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    pts[:40] = rng.uniform(-0.9, 0.9, (40, 3))
    pts[:20, 0] = 1.0
    pts[20:40, 1] = -1.0
    pts[40:50] = np.float32([0.3, 1.0000001, -0.2])
    return pts


@pytest.mark.parametrize("level,with_parents", [(5, False), (5, True), (3, True), (0, False)])
def test_query_matches_jax(octrees, level, with_parents):
    jblas, blas = octrees
    pts = _query_points(3000, seed=level)
    want = np.asarray(jax.jit(lambda c: jblas.query(c, level, with_parents=with_parents).pidx)(
        jnp.asarray(pts)))
    got = blas.query(torch.from_numpy(pts), level, with_parents=with_parents).pidx
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_of(got), want)
    assert (want >= 0).any() and (want < 0).any()


def test_query_outside_the_maps_raises(octrees):
    _, blas = octrees
    with pytest.raises(NotImplementedError):
        OctreeAS.make_dense(3, device="cpu").query(torch.zeros(4, 3))
    with pytest.raises(NotImplementedError):
        blas.query(torch.zeros(4, 3), level=8)


_JAX_FSD = {}


def _jax_free_space_distance(jblas, max_k=31):
    """JAX's field of ``jblas``'s occupancy, compiled once a (level, max_k): the compile
    of the dilations, not the octree, is what costs."""
    key = (jblas.max_level, max_k)
    if key not in _JAX_FSD:
        template = jblas
        _JAX_FSD[key] = jax.jit(
            lambda occ: template.replace(occ_grid=occ).free_space_distance(max_k))
    return np.asarray(_JAX_FSD[key](jblas.occ_grid))


@pytest.mark.parametrize("level,occupancy", [(4, "sphere"), (4, "random"), (5, "sphere"),
                                             (5, "random")])
def test_free_space_distance_matches_jax(octrees, level, occupancy):
    if occupancy == "sphere":
        q = sphere_octree_points(level, num_samples=20_000)
    else:
        rng = np.random.default_rng(level)
        q = rng.integers(0, 2 ** level, (max(2, 8 ** level // 300), 3)).astype(np.int32)
    jblas = JOctreeAS.from_quantized_points(q, level)
    blas = OctreeAS.from_quantized_points(q, level, device="cpu")
    want = _jax_free_space_distance(jblas)
    np.testing.assert_array_equal(want, np.asarray(jax.jit(jblas.free_space_distance)())
                                  if level == 4 else want)
    got = blas.free_space_distance()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_of(got), want)
    assert set(np.unique(want)) <= {0, 1, 2, 4, 8, 16, 32} and len(np.unique(want)) >= 4
    if level == 4:  # the cap follows JAX's dilation schedule for other max_k too
        np.testing.assert_array_equal(np_of(blas.free_space_distance(max_k=5)),
                                      _jax_free_space_distance(jblas, 5))
