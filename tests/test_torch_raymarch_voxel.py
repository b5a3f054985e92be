"""Port parity: K7 (the 'voxel' occupancy march) on the CPU against the JAX package.

Both packages build their octree from the same seeded numpy point cloud. The mask, the
per-sample cell density and ``num_overflow`` must be equal; depths, samples and deltas
agree to 1e-6 (the same float32 operations in the same order; equality is expected, and
equal depths mean the same segment order, since each slot's depth starts at t_near +
order * voxel). The jittered cases hand JAX's own draw (``jax.random.uniform`` of the
march's key and shape) to the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import both_rays, np_of, ray_arrays

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS

from wisp_tpu_torch.accelstructs.octree_as import (OctreeAS, num_coarse_segments,
                                                   raymarch_voxel_plain, voxel_slots)

ATOL = 1e-6
MAX_LEVEL = 5


def _pointcloud(seed: int = 0, n: int = 3000) -> np.ndarray:
    """Points on two seeded blobs in the box (a sparse level-5 octree after dilation)."""
    rng = np.random.default_rng(seed)
    centres = np.asarray([[0.3, -0.2, 0.1], [-0.4, 0.35, -0.3]], np.float32)
    pts = centres[rng.integers(0, 2, n)] + rng.normal(scale=0.15, size=(n, 3))
    return np.clip(pts, -1.0, 0.999).astype(np.float32)


def _densities(level: int, occ: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(occ, rng.random(8 ** level).astype(np.float32) * 6.0,
                    -1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blases(branch: str):
    """(JAX octree, port octree) of one march branch: 'density' (the fused field of a
    sparse octree), 'density_random' (that field with seeded densities), 'occ' (the
    boolean grid alone) or 'dense'."""
    if branch == "dense":
        return JOctreeAS.make_dense(MAX_LEVEL), OctreeAS.make_dense(MAX_LEVEL, device="cpu")
    pc = _pointcloud()
    jb = JOctreeAS.from_pointcloud(pc, MAX_LEVEL, dilate=1)
    tb = OctreeAS.from_pointcloud(pc, MAX_LEVEL, dilate=1, device="cpu")
    np.testing.assert_array_equal(np_of(tb.occ_grid), np.asarray(jb.occ_grid))
    if branch == "density_random":
        dens = _densities(MAX_LEVEL, np.asarray(jb.occ_grid), seed=5)
        jb = jb.update_occupancy(jb.occ_grid, cell_density=jnp.asarray(dens))
        tb = tb.update_occupancy(tb.occ_grid, torch.from_numpy(dens))
    elif branch == "occ":
        jb = jb.replace(cell_density=None)
        tb.cell_density = None
    return jb, tb


def _assert_same(got, want):
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    np.testing.assert_allclose(np_of(got.depth_samples), np.asarray(want.depth_samples),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(np_of(got.samples), np.asarray(want.samples), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(np.broadcast_to(np_of(got.deltas), want.deltas.shape),
                               np.asarray(want.deltas), atol=ATOL, rtol=0)
    assert float(got.num_overflow) == float(want.num_overflow)
    if want.cell_density is None:
        assert got.cell_density is None
    else:
        np.testing.assert_array_equal(np_of(got.cell_density), np.asarray(want.cell_density))


@pytest.mark.parametrize("branch,level,num_samples,budget,early_stop,jittered", [
    ("density", 3, 16, 1024, 0.0, False),         # the config's branch, K = every segment
    ("density", 3, 16, 1024, 0.0, True),
    ("density", MAX_LEVEL, 4, 1024, 0.0, False),  # level == max_level
    ("density", 3, 8, 24, 0.0, True),             # K = 3: rays overflow
    ("density_random", 3, 8, 1024, 0.0, False),
    ("density_random", 3, 8, 1024, 0.01, False),  # the coarse transmittance cull
    ("density_random", 4, 5, 20, 0.05, True),     # cull and overflow
    ("occ", 3, 16, 1024, 0.0, False),
    ("occ", 4, 6, 18, 0.0, True),
    ("dense", 3, 16, 1024, 0.0, False),
    ("dense", 3, 8, 40, 0.0, True),
])
def test_raymarch_voxel_matches_jax(branch, level, num_samples, budget, early_stop,
                                    jittered):
    origins, dirs = ray_arrays(160, seed=7)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    jb, tb = _blases(branch)
    key = jax.random.PRNGKey(11) if jittered else None
    want = jax.jit(lambda b, r: b._raymarch_voxel(r, num_samples, level, key, budget=budget,
                                                  early_stop=early_stop))(jb, jr)
    k = voxel_slots(num_samples, budget, level)
    jitter = None
    if jittered:
        jitter = torch.from_numpy(np.array(jax.jit(
            lambda kk: jax.random.uniform(kk, (origins.shape[0], k, num_samples)))(key)))
    got = tb.raymarch(tr, raymarch_type="voxel", num_samples=num_samples, level=level,
                      key=jitter, budget=budget, early_stop=early_stop)
    assert got.samples.shape == (origins.shape[0], k * num_samples, 3)
    _assert_same(got, want)
    mask = np_of(got.mask)
    assert mask.any() and not mask.all()
    assert not mask[: origins.shape[0] // 8].any()  # the rays that miss the box
    if budget < 1024:
        assert float(want.num_overflow) > 0


def test_config_slots_and_overflow():
    """At the octree config (level 4 segments, 16 samples, budget 1024) K covers every
    coarse segment, so no ray can overflow; a smaller budget makes rays overflow."""
    assert num_coarse_segments(4) == 29 and voxel_slots(16, 1024, 4) == 29
    assert voxel_slots(16, 64, 4) == 4 and voxel_slots(16, 8, 4) == 1
    origins, dirs = ray_arrays(64, seed=3)
    _, tr = both_rays(origins, dirs)
    _, tb = _blases("density")
    full = tb.raymarch(tr, "voxel", 16, level=4, budget=1024)
    assert float(full.num_overflow) == 0.0
    occupied = raymarch_voxel_plain(tr.origins, tr.dirs, 0.0, 8.0, 16, 4, 1024, tb.occ_grid,
                                    tb.cell_density, MAX_LEVEL).mask.reshape(64, 29, 16)
    per_ray = occupied.any(-1).sum(-1)
    small = tb.raymarch(tr, "voxel", 16, level=4, budget=32)
    assert float(small.num_overflow) == float((per_ray > 2).sum()) > 0


def test_uniform_march_raises():
    """The 'uniform' march (K8) no longer raises: on a dense octree it keeps the samples
    in the box and before each ray's exit, one global step apart."""
    _, tr = both_rays(*ray_arrays(4))
    got = OctreeAS.make_dense(2, device="cpu").raymarch(tr, raymarch_type="uniform",
                                                        num_samples=8)
    _, t_far = OctreeAS.aabb_intersect(tr)
    inside = ((got.samples >= -1.0) & (got.samples < 1.0)).all(dim=-1)
    assert torch.equal(got.mask, inside & (got.depth_samples < t_far[:, None]))
    steps = got.depth_samples[:, 1:] - got.depth_samples[:, :-1]
    assert torch.allclose(steps, got.deltas.expand_as(steps), atol=1e-6)
