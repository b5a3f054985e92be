"""Port parity: K1 forward (hash-grid interpolation) on the CPU against the JAX package.

Tolerance: atol 1e-5. Corner indices agree exactly; the blend sums 2^d products in another
order than XLA, which moves float32 results by a few ulps of features of std 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)
from wisp_tpu.models.grids import HashGrid as JHashGrid
from wisp_tpu.ops import grid as jgrid
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.ops import grid as tgrid

ATOL = 1e-5


def _table(dim, bitwidth, resolutions, f_dim=2, seed=0):
    sizes = [min(r ** dim, 2 ** bitwidth) for r in resolutions]
    first = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    rng = np.random.default_rng(seed)
    table = (0.5 * rng.normal(size=(first[-1], f_dim))).astype(np.float32)
    return table, first, sizes


@pytest.mark.parametrize("res", [8, 16, 64])
@pytest.mark.parametrize("dim", [2, 3])
def test_hash_index_matches_jax(dim, res):
    """Dense indices (res^d fits 2^10) and hashed ones, with corners near 2^32/prime."""
    rng = np.random.default_rng(res + dim)
    corners = rng.integers(0, res + 1, size=(257, dim)).astype(np.int32)
    want = np.asarray(jgrid.hash_index(jnp.asarray(corners), res, 2 ** 10))
    got = tgrid.hash_index(torch.from_numpy(corners), res, 2 ** 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dim", [2, 3])
def test_hashgrid_matches_jax_and_naive(dim):
    resolutions = [4, 8, 16, 32]  # at bw 10: dense up to 8^3 / 32^2, hashed above
    table, first, sizes = _table(dim, 10, resolutions)
    coords = np.random.default_rng(1).uniform(-1.05, 1.05, size=(500, dim)).astype(np.float32)
    coords[:4] = [[-1.0] * dim, [1.0] * dim, [0.0] * dim, [0.5] * dim]  # cell boundaries
    lod_idx = 3
    jc, jt = jnp.asarray(coords), jnp.asarray(table)
    want = np.asarray(jax.jit(lambda c, t: jgrid.hashgrid(
        c, resolutions, 10, lod_idx, t, first, sizes, dense_matmul=None))(jc, jt))
    naive = np.asarray(jax.jit(lambda c, t: jgrid.hashgrid_naive(
        c, resolutions, 10, lod_idx, t, sizes, first))(jc, jt))
    got = tgrid.hashgrid(torch.from_numpy(coords), resolutions, 10, lod_idx,
                         torch.from_numpy(table), first, sizes).numpy()
    assert got.shape == (500, 4 * 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, naive, atol=ATOL, rtol=0)


def test_hashgrid_out_lods_pads_zero_columns():
    resolutions = [4, 8, 16, 32]
    table, first, sizes = _table(3, 10, resolutions)
    coords = torch.from_numpy(
        np.random.default_rng(2).uniform(-1, 1, size=(64, 3)).astype(np.float32))
    full = tgrid.hashgrid(coords, resolutions, 10, 3, torch.from_numpy(table), first, sizes)
    part = tgrid.hashgrid(coords, resolutions, 10, 1, torch.from_numpy(table), first, sizes,
                          out_lods=4)
    np.testing.assert_array_equal(part[:, :4].numpy(), full[:, :4].numpy())
    assert not part[:, 4:].any()


def _grids(multiscale_type):
    jg = JHashGrid.from_geometric(feature_dim=2, num_lods=4, codebook_bitwidth=10,
                                  min_grid_res=4, max_grid_res=32,
                                  multiscale_type=multiscale_type, feature_std=0.5,
                                  dense_lod_matmul=None, key=jax.random.PRNGKey(7))
    tg = HashGrid.from_geometric(feature_dim=2, num_lods=4, codebook_bitwidth=10,
                                 min_grid_res=4, max_grid_res=32,
                                 multiscale_type=multiscale_type, device="cpu")
    assert tg.resolutions == jg.resolutions
    with torch.no_grad():
        tg.codebook.feats.copy_(torch.from_numpy(np.array(jg.codebook.feats)))
    return jg, tg


@pytest.mark.parametrize("max_compute_lod", [None, 1])
@pytest.mark.parametrize("lod_idx", [3, 2])
@pytest.mark.parametrize("multiscale_type", ["cat", "sum"])
def test_interpolate_matches_jax(multiscale_type, lod_idx, max_compute_lod):
    """'cat' zeroes the columns from lod_idx*F on (the tracer's LOD quirk: lod_idx =
    num_lods-1 leaves the last LOD at zero); max_compute_lod truncates further."""
    jg, tg = _grids(multiscale_type)
    coords = np.random.default_rng(3).uniform(-1, 1, size=(300, 3)).astype(np.float32)
    want = np.asarray(jg.interpolate(jnp.asarray(coords), lod_idx,
                                     max_compute_lod=max_compute_lod))
    got = tg.interpolate(torch.from_numpy(coords), lod_idx,
                         max_compute_lod=max_compute_lod).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if multiscale_type == "cat":
        assert not got[:, lod_idx * 2:].any()
