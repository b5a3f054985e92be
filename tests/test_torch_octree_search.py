"""The point query's other routes (K9) against the JAX package: the binary search of a
level-8 octree above its pidx maps, with and without the ancestor chain (maps below, the
search at level 8), on points inside and outside the box; a dense octree (index = morton
code); a carved make_dense octree (the bitfield route). Integers: every comparison is
exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import np_of, sphere_octree_points

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS


def _points(n, seed):
    """Seeded points in and around the box, on its faces (inside: the box test is
    inclusive) and just past them, and near the icosphere (radius 0.9) where level 8 is occupied."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    pts[:20, 0] = 1.0
    pts[20:40, 1] = -1.0
    pts[40:50] = np.float32([0.3, 1.0000001, -0.2])
    shell = rng.normal(size=(n // 2, 3))
    pts[50:50 + n // 2] = (0.9 * shell / np.linalg.norm(shell, axis=-1, keepdims=True)
                           + rng.normal(scale=0.002, size=(n // 2, 3)))
    return pts


@functools.lru_cache(maxsize=None)
def _level8():
    q = sphere_octree_points(8, num_samples=20_000)
    return JOctreeAS.from_quantized_points(q, 8), OctreeAS.from_quantized_points(q, 8,
                                                                                 device="cpu")


def _jax_query(jblas, pts, level, with_parents):
    return np.asarray(jax.jit(lambda c: jblas.query(c, level, with_parents=with_parents).pidx)(
        jnp.asarray(pts)))


@pytest.mark.parametrize("with_parents", [False, True])
def test_level8_search_matches_jax(with_parents):
    jblas, blas = _level8()
    assert [r.kind for r in blas.query_routes] == ["map"] * 8 + ["search"]
    pts = _points(4000, seed=8)
    want = _jax_query(jblas, pts, 8, with_parents)
    got = blas.query(torch.from_numpy(pts), with_parents=with_parents).pidx
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_of(got), want)
    last = want[:, -1] if with_parents else want
    assert (last >= 0).sum() > 100 and (last < 0).any()
    inside = (np.abs(pts) <= 1.0).all(-1)
    assert (want[~inside] == -1).all() and (~inside).any()
    # a level below the search, on the same octree: the maps alone
    np.testing.assert_array_equal(np_of(blas.query(torch.from_numpy(pts), 6).pidx),
                                  _jax_query(jblas, pts, 6, False))


@pytest.mark.parametrize("level,with_parents", [(4, True), (4, False), (2, True)])
def test_dense_octree_matches_jax(level, with_parents):
    pts = _points(2000, seed=level)
    want = _jax_query(JOctreeAS.make_dense(4), pts, level, with_parents)
    got = OctreeAS.make_dense(4, device="cpu").query(torch.from_numpy(pts), level,
                                                     with_parents=with_parents).pidx
    np.testing.assert_array_equal(np_of(got), want)
    assert (want >= 0).reshape(len(pts), -1).all(-1).sum() > 1000


def test_bitfield_octree_matches_jax():
    rng = np.random.default_rng(9)
    occ = rng.random(8 ** 4) < 0.3
    jblas = JOctreeAS.make_dense(4).update_occupancy(jnp.asarray(occ))
    blas = OctreeAS.make_dense(4, device="cpu").update_occupancy(torch.from_numpy(occ))
    assert [r is None for r in blas.query_routes] == [True] * 4 + [False]
    pts = _points(2000, seed=10)
    want = _jax_query(jblas, pts, 4, False)
    np.testing.assert_array_equal(np_of(blas.query(torch.from_numpy(pts)).pidx), want)
    assert (want >= 0).any() and (want[(np.abs(pts) <= 1.0).all(-1)] < 0).any()
