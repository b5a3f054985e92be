"""Port parity: K2 (the 'ray' occupancy march) on the CPU against the JAX package.

Samples, depths and deltas agree to 1e-6 (the same float32 operations in the same order);
the mask and the per-sample cell density agree exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import both_rays, carved_occupancy, jax_blas, np_of, ray_arrays
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS

ATOL = 1e-6


def _torch_blas(level, carve_seed):
    blas = OctreeAS.make_dense(level, device="cpu")
    if carve_seed is None:
        return blas
    occ, dens = carved_occupancy(level, carve_seed)
    return blas.update_occupancy(torch.from_numpy(occ), torch.from_numpy(dens))


@pytest.mark.parametrize("dist", [(0.0, 8.0), (2.5, 3.5)])
def test_aabb_intersect_matches_jax(dist):
    origins, dirs = ray_arrays(200, seed=1)
    dirs[:3] = [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]]  # axis-parallel
    jr, tr = both_rays(origins, dirs, *dist)
    from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
    jn, jf = JOctreeAS.aabb_intersect(jr)
    tn, tf = OctreeAS.aabb_intersect(tr)
    np.testing.assert_allclose(np_of(tn), np_of(jn), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(tf), np_of(jf), atol=ATOL, rtol=0)


@pytest.mark.parametrize("carve_seed,stride",
                         [(None, 1), (None, 2), (11, 1), (11, 2), (12, 3)])
def test_raymarch_ray_matches_jax(carve_seed, stride):
    """make_dense(3) tests the box alone; carved by update_occupancy it gathers the
    cell-density field, every sample at stride 1 and OR-broadcast at stride 2 and 3."""
    origins, dirs = ray_arrays(96, seed=2)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    num_samples = 37  # not a multiple of the stride: the tail group is short
    want = jax_blas(3, carve_seed)._raymarch_ray(jr, num_samples, None, stride=stride)
    got = _torch_blas(3, carve_seed)._raymarch_ray(tr, num_samples, None, stride=stride)
    np.testing.assert_allclose(np_of(got.samples), np_of(want.samples), atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(got.depth_samples), np_of(want.depth_samples),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(got.deltas), np_of(want.deltas), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np_of(got.mask), np_of(want.mask))
    assert np_of(want.mask).any() and not np_of(want.mask).all()
    if carve_seed is None:
        assert got.cell_density is None and want.cell_density is None
    else:
        np.testing.assert_array_equal(np_of(got.cell_density), np_of(want.cell_density))


def test_other_march_types_raise():
    """A march type JAX does not have raises, as in JAX; 'uniform' (K8) and 'voxel' (K7)
    are held to JAX in test_torch_raymarch_uniform.py and test_torch_raymarch_voxel.py."""
    _, tr = both_rays(*ray_arrays(4))
    blas = OctreeAS.make_dense(2, device="cpu")
    with pytest.raises(ValueError, match="Unknown raymarch_type"):
        blas.raymarch(tr, raymarch_type="cone", num_samples=8)
