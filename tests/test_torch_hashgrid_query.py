"""Port parity: K14, ``hashgrid_query``, on the CPU against the JAX package.

The raw corner rows [N, L, 2^d, F] of LODs 0..lod_idx, in 3D and 2D, on dense and hashed
LODs, at F = 2 and at widths no vector load covers (3, 5), for points inside and outside
[-1, 1]^d: equal to JAX's exactly, NaN where JAX's
``jnp.take`` fills one (a 2D dense LOD at res 300, whose clip to res-1-1e-5 rounds up to
res-1 in float32, so the upper corners index past the LOD's table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import np_of
from wisp_tpu.ops import grid as jgrid
from wisp_tpu_torch.ops import grid as tgrid

CASES = {3: ([4, 8, 16, 64], 10), 2: ([4, 16, 300, 512], 17)}


# (dim, lod_idx, F); the F = 2 cases keep their ids
PARAMS = [pytest.param(dim, lod_idx, f_dim, id=f"{dim}-{lod_idx}" + ("" if f_dim == 2 else
                                                                    f"-f{f_dim}"))
          for f_dim in (2, 3, 5) for lod_idx in (0, 3) for dim in (3, 2)]


@pytest.mark.parametrize("dim,lod_idx,f_dim", PARAMS)
def test_hashgrid_query_matches_jax(dim, lod_idx, f_dim):
    resolutions, bitwidth = CASES[dim]
    sizes = [min(r ** dim, 2 ** bitwidth) for r in resolutions]
    first = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    rng = np.random.default_rng(dim)
    table = rng.normal(size=(first[-1], f_dim)).astype(np.float32)
    coords = (rng.random((400, dim)) * 2.1 - 1.05).astype(np.float32)
    coords[:4] = 1.0                                     # the upper edge of every LOD
    args = (resolutions, bitwidth, lod_idx)
    want = np.asarray(jax.jit(lambda c, t: jgrid.hashgrid_query(c, *args, t, first, sizes))(
        jnp.asarray(coords), jnp.asarray(table)))
    got = np_of(tgrid.hashgrid_query(torch.from_numpy(coords), *args,
                                     torch.from_numpy(table), first, sizes))
    assert got.shape == want.shape == (400, lod_idx + 1, 2 ** dim, f_dim)
    np.testing.assert_array_equal(got, want)
    dense = [r ** dim <= 2 ** bitwidth for r in resolutions[:lod_idx + 1]]
    hashed = [not x for x in dense]
    assert any(dense) and (lod_idx == 0 or any(hashed))
    assert np.isnan(want).any() == (dim == 2 and lod_idx == 3)
