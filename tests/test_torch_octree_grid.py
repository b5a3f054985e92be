"""The octree grid (K15 on the card, its plain version here) and the neural SDF of the port
against the JAX package, on the sphere octree at level 5 with 3 LODs.

Tolerances: the interpolation does the same float operations as JAX in the same order
except the sum over the 8 corners, which XLA may reassociate, so its features agree to
1e-6 (features of std 0.5; the differences are a few float32 ulps). The SDF adds one
32-wide hidden layer and the output layer on top (matmuls that the two libraries sum in
different orders), so it is held to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import (jax_sdf_pipeline, np_of, sdf_params_from_jax,
                                sphere_octree_points)

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.models.grids import OctreeGrid as JOctreeGrid

from wisp_tpu_torch import interop
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid

LEVEL = 5
INTERP_ATOL = 1e-6
SDF_ATOL = 1e-5


@pytest.fixture(scope="module")
def octrees():
    q = sphere_octree_points(LEVEL, num_samples=50_000)
    return (JOctreeAS.from_quantized_points(q, LEVEL),
            OctreeAS.from_quantized_points(q, LEVEL, device="cpu"))


def _points(n, seed):
    """Seeded points: half near the sphere's surface (occupied cells), half anywhere in and
    around the box (mostly empty cells, some outside)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n // 2, 3))
    near = 0.9 * u / np.linalg.norm(u, axis=-1, keepdims=True) \
        + rng.normal(scale=0.02, size=(n // 2, 3))
    anywhere = rng.uniform(-1.05, 1.05, (n - n // 2, 3))
    return np.concatenate([near, anywhere]).astype(np.float32)


@pytest.mark.parametrize("multiscale,interp,lod_idx", [
    ("sum", "linear", 0), ("sum", "linear", 1), ("sum", "linear", 2),
    ("cat", "linear", 0), ("cat", "linear", 1), ("cat", "linear", 2),
    ("sum", "closest", 2)])
def test_interpolate_matches_jax(octrees, multiscale, interp, lod_idx):
    jblas, blas = octrees
    jgrid = JOctreeGrid(blas=jblas, feature_dim=16, num_lods=3, interpolation_type=interp,
                        multiscale_type=multiscale, feature_std=0.5,
                        key=jax.random.PRNGKey(lod_idx))
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, interpolation_type=interp,
                      multiscale_type=multiscale, feature_std=0.5, device="cpu")
    assert [tuple(f.shape) for f in grid.features] == [f.shape for f in jgrid.features]
    if interp == "linear":
        for a, b in zip(grid.trinkets, jgrid.trinkets):
            np.testing.assert_array_equal(np_of(a), np.asarray(b))
    with torch.no_grad():
        for f, jf in zip(grid.features, jgrid.features):
            f.copy_(torch.from_numpy(np.array(jf)))
    pts = _points(3000, seed=lod_idx)
    want = np.asarray(jax.jit(lambda c: jgrid.interpolate(c, lod_idx))(jnp.asarray(pts)))
    with torch.no_grad():
        got = np_of(grid.interpolate(torch.from_numpy(pts), lod_idx))
    assert got.shape == want.shape == (3000, 16 * (lod_idx + 1 if multiscale == "cat" else 1))
    np.testing.assert_allclose(got, want, atol=INTERP_ATOL, rtol=0)
    empty = (want == 0).all(axis=-1)
    assert empty.any() and not empty.all()          # both empty and occupied cells seen
    assert (got[empty] == 0).all()


@pytest.fixture(scope="module")
def sdf_pair():
    jpipe = jax_sdf_pipeline(level=LEVEL, num_lods=3, hidden_dim=32)
    params, config = sdf_params_from_jax(jpipe)
    return jpipe, interop.build_sdf_pipeline(params, config, device="cpu")


def test_build_sdf_pipeline_carries_the_octree(sdf_pair):
    jpipe, pipe = sdf_pair
    jgrid, grid = jpipe.nef.grid, pipe.nef.grid
    assert grid.blas.level_counts == jgrid.blas.level_counts
    assert grid.active_lods == jgrid.active_lods and grid.base_lod == jgrid.base_lod
    for a, b in zip(grid.blas.pidx_maps, jgrid.blas.pidx_maps):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    for a, b in zip(grid.features, jgrid.features):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    assert pipe.tracer.num_steps == jpipe.tracer.num_steps
    assert pipe.tracer.min_dis == jpipe.tracer.min_dis


@pytest.mark.parametrize("lod_idx", [0, 2])
def test_neural_sdf_matches_jax(sdf_pair, lod_idx):
    jpipe, pipe = sdf_pair
    pts = _points(2000, seed=10 + lod_idx)
    want = np.asarray(jax.jit(lambda c: jpipe.nef.sdf(c, lod_idx))(jnp.asarray(pts)))
    with torch.no_grad():
        got = np_of(pipe.nef(channels="sdf", coords=torch.from_numpy(pts), lod_idx=lod_idx))
    assert got.shape == want.shape == (2000, 1)
    np.testing.assert_allclose(got, want, atol=SDF_ATOL, rtol=0)


def test_sphere_decoder_approximates_the_sphere():
    """Under ``sphere_sdf_decoder`` the field is close to |x| - 0.9, with the features
    still moving it."""
    dec = interop.sphere_sdf_decoder(16, 128, seed=0)
    jpipe = jax_sdf_pipeline(level=4, num_lods=2, hidden_dim=128, decoder=dec)
    params, config = sdf_params_from_jax(jpipe)
    pipe = interop.build_sdf_pipeline(params, config, device="cpu")
    pts = _points(2000, seed=20)
    x = torch.from_numpy(pts)
    with torch.no_grad():
        got = np_of(pipe.nef.sdf(x))[:, 0]
        for f in pipe.nef.grid.features:
            f.zero_()
        no_feats = np_of(pipe.nef.sdf(x))[:, 0]
    inside = (np.abs(pts) <= 1.0).all(-1)
    np.testing.assert_allclose(no_feats[inside], np.linalg.norm(pts, axis=-1)[inside] - 0.9,
                               atol=0.02)
    assert np.abs(got - no_feats).max() > 1e-4
