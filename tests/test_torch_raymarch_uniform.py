"""Port parity: K8, the 'uniform' march, on the CPU against the JAX package.

* ``OctreeAS._raymarch_uniform`` (K8's plain version) against JAX's on carved and dense
  octrees, at strides 1 and 2, at midpoints and jittered with JAX's own draw: samples,
  depths, deltas, mask and cell density exactly (the same float32 operations in JAX's
  order: t_near + u * step). JAX runs eagerly here: XLA's compile contracts products and
  sums into fused multiply-adds, which moves points and depths by an ulp.
* One flagship-shaped trace with the 'uniform' march (the small pipeline of
  ``test_torch_render.py``, its weights carried across by ``interop.build_pipeline``, which
  serves this march unchanged): rgb, alpha and depth to 1e-4, hit and the valid-sample
  count exactly, as the 'ray' march's trace is held.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import (both_rays, carved_occupancy, jax_blas, jax_pipeline, np_of,
                                params_from_jax, ray_arrays)
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS, uniform_step
from wisp_tpu_torch.interop import build_pipeline

KEYS = ("samples", "depth_samples", "mask")


def _torch_blas(level, carve_seed):
    blas = OctreeAS.make_dense(level, device="cpu")
    if carve_seed is None:
        return blas
    occ, dens = carved_occupancy(level, carve_seed)
    return blas.update_occupancy(torch.from_numpy(occ), torch.from_numpy(dens))


@pytest.mark.parametrize("jittered", [False, True])
@pytest.mark.parametrize("carve_seed,stride", [(None, 1), (None, 2), (11, 1), (11, 2)])
def test_raymarch_uniform_matches_jax(carve_seed, stride, jittered):
    origins, dirs = ray_arrays(96, seed=2)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    num_samples = 37  # not a multiple of the stride: the tail group is short
    key = jax.random.PRNGKey(5) if jittered else None
    want = jax_blas(3, carve_seed)._raymarch_uniform(jr, num_samples, key, stride=stride)
    u = None
    if jittered:    # what JAX's march draws from its key
        u = torch.from_numpy(np.array(jax.random.uniform(key, (96, num_samples))))
    got = _torch_blas(3, carve_seed).raymarch(tr, raymarch_type="uniform",
                                              num_samples=num_samples, key=u, stride=stride)
    for k in KEYS:
        np.testing.assert_array_equal(np_of(getattr(got, k)), np_of(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(
        np.broadcast_to(np_of(got.deltas), (96, num_samples)), np_of(want.deltas))
    assert float(got.deltas[0, 0]) == uniform_step(num_samples)
    mask = np_of(want.mask)
    assert mask.any() and not mask.all()
    if carve_seed is None:
        assert got.cell_density is None and want.cell_density is None
    else:
        np.testing.assert_array_equal(np_of(got.cell_density), np_of(want.cell_density))


def test_uniform_trace_matches_jax():
    """The flagship-shaped small pipeline (4 LODs at bw 10, hidden 32, 32 steps, stride 2,
    compaction 0.25) on a carved octree with the 'uniform' march."""
    jpipe = jax_pipeline(carve_seed=21, compaction=0.25)
    jpipe = jpipe.replace(tracer=jpipe.tracer.replace(raymarch_type="uniform"))
    params, config = params_from_jax(jpipe)
    assert config["tracer"]["raymarch_type"] == "uniform"
    tpipe = build_pipeline(params, config, device="cpu")
    jr, tr = both_rays(*ray_arrays(64, seed=5), 0.0, 8.0)
    channels = ["rgb", "alpha", "depth", "hit"]
    want = jax.jit(lambda p, r: p(rays=r, channels=channels))(jpipe, jr)
    got = tpipe(rays=tr, channels=channels)
    for ch in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(np_of(got.channels[ch]), np_of(want.channels[ch]),
                                   atol=1e-4, rtol=0, err_msg=ch)
    np.testing.assert_array_equal(np_of(got.hit), np_of(want.hit))
    assert float(got.num_valid_samples) == float(want.num_valid_samples) > 0
    assert np_of(want.alpha).max() > 0.5
