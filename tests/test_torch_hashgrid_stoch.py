"""Port parity: K1's stochastic backward (JAX ``interp_rows_stoch`` / ``_irs_bwd``, the corner
draw of ``_lod_features`` and the per-LOD ``_fold_u``) on the CPU against the JAX package.

The sin hash of the per-sample uniforms amplifies the phase's last bits ~4e4-fold, so XLA and
torch draw different corners from the same coordinates: every parity case injects the same
uniforms into both packages. Tolerance: atol 1e-6 on the table gradient (the drawn rows
agree exactly; a row's sum of whole cotangents may round in another order). The hash
itself is held statistically: uniform draws, and a mean equal to the exact gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)
from wisp_tpu.ops import grid as jgrid
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.ops import grid as tgrid

ATOL = 1e-6


def _table(dim, bitwidth, resolutions, f_dim=2, seed=0):
    sizes = [min(r ** dim, 2 ** bitwidth) for r in resolutions]
    first = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(first[-1], f_dim)).astype(np.float32)
    return table, first, sizes


def _coords(n, dim, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, dim)).astype(np.float32)


def test_forward_matches_jax_stoch():
    resolutions = [4, 8, 16, 37]
    table, first, sizes = _table(3, 9, resolutions)
    coords = _coords(300, 3, 1)
    want = np.asarray(jax.jit(lambda c, t: jgrid.hashgrid(
        c, resolutions, 9, 3, t, first, sizes, stoch_grad=True))(jnp.asarray(coords),
                                                                 jnp.asarray(table)))
    got = tgrid.hashgrid(torch.from_numpy(coords), resolutions, 9, 3,
                         torch.from_numpy(table).requires_grad_(), first, sizes,
                         stoch_grad=True)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dim,res", [(3, 5), (3, 37), (2, 40)])
def test_lod_stoch_bwd_matches_jax(dim, res):
    """One LOD: JAX ``_lod_features(..., stoch_u=u)`` through ``jax.vjp`` against the port's
    plain draw with the same u (dense and hashed tables)."""
    cs = 2 ** 9
    size = min(res ** dim, cs)
    rng = np.random.default_rng(res + dim)
    table = rng.normal(size=(size, 2)).astype(np.float32)
    coords = _coords(400, dim, res)
    u = rng.random(400).astype(np.float32)
    g = rng.normal(size=(400, 2)).astype(np.float32)

    def table_grad(c, t, uu, gg):
        axes = [c[:, d] for d in range(dim)]
        _, vjp = jax.vjp(lambda tt: jgrid._lod_features(axes, res, cs, tt, stoch_u=uu), t)
        return vjp([gg[:, 0], gg[:, 1]])[0]

    want = jax.jit(table_grad)(jnp.asarray(coords), jnp.asarray(table), jnp.asarray(u),
                               jnp.asarray(g))
    got = tgrid.lod_stoch_bwd_plain(torch.from_numpy(coords), torch.from_numpy(g), res, cs,
                                    size, torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _jax_composed(coords, resolutions, bw, table, first, sizes, u0, dense_matmul):
    """[N, L*F] of JAX's per-LOD functions composed as ``_hashgrid_impl`` composes them,
    with ``_fold_u(u0, i)`` for LOD i (the un-checkpointed functions: the same values)."""
    dim = coords.shape[1]
    axes = [coords[:, d] for d in range(dim)]
    feats = []
    for i, res in enumerate(resolutions):
        level = table[first[i]:first[i] + sizes[i]]
        u = jgrid._fold_u(u0, i)
        if dense_matmul is not None and res ** dim <= 2 ** bw:
            feats.extend(jgrid._lod_features_dense_matmul(axes, res, level, dense_matmul, u))
        else:
            feats.extend(jgrid._lod_features(axes, res, 2 ** bw, level, u))
    return jnp.stack(feats, axis=0).T


@pytest.mark.parametrize("dense_matmul", [None, "f32_highest"])
def test_whole_grid_gradient_matches_jax(monkeypatch, dense_matmul):
    """A mix of dense (4, 8) and hashed (16, 37) LODs at bitwidth 9, with an injected u0:
    the port's ``hashgrid(stoch_grad=True)`` autograd gradient against JAX's composition.
    With ``dense_matmul`` the dense LODs take JAX's exact matrix-product gradient, and the
    port's rule keeps them exact too (rows * res^2 is far below the cap)."""
    resolutions = [4, 8, 16, 37]
    bw = 9
    table, first, sizes = _table(3, bw, resolutions, seed=3)
    coords = _coords(500, 3, 4)
    rng = np.random.default_rng(5)
    u0 = rng.random(500).astype(np.float32)
    g = rng.normal(size=(500, 8)).astype(np.float32)

    def table_grad(c, t, uu, gg):
        _, vjp = jax.vjp(lambda tt: _jax_composed(c, resolutions, bw, tt, first, sizes, uu,
                                                  dense_matmul), t)
        return vjp(gg)[0]

    want = jax.jit(table_grad)(jnp.asarray(coords), jnp.asarray(table), jnp.asarray(u0),
                               jnp.asarray(g))
    monkeypatch.setattr(tgrid, "stoch_u0", lambda c: torch.from_numpy(u0))
    t = torch.from_numpy(table).requires_grad_()
    out = tgrid.hashgrid(torch.from_numpy(coords), resolutions, bw, 3, t, first, sizes,
                         stoch_grad=True, dense_lod_matmul=dense_matmul)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _touched_rows(grad, first, sizes):
    return [int((np.abs(grad[f:f + s]).sum(-1) > 0).sum()) for f, s in zip(first, sizes)]


@pytest.mark.parametrize("rows,cap_over,dense_matmul", [
    (1, False, "bf16"), (1, True, "bf16"), (1, True, None), (1, False, None)])
def test_stoch_lods_matches_jax_branches(monkeypatch, rows, cap_over, dense_matmul):
    """JAX's branch condition observed, not restated: with ``_DENSE_MM_MAX_ELEMS`` set just
    below (or at) one sample times res^2, JAX's ``_hashgrid_impl`` gives a dense LOD the
    exact gradient (8 touched rows for one sample) or the drawn one (1 row); the port's
    ``stoch_lods`` under the same cap names the same LODs."""
    resolutions = [4, 8, 16, 37]   # dense, dense, hashed, hashed at bitwidth 9
    bw = 9
    table, first, sizes = _table(3, bw, resolutions, seed=6)
    coords = np.asarray([[0.113, -0.271, 0.389]], np.float32)
    for res in (4, 8):
        cap = rows * res * res - (1 if cap_over else 0)
        monkeypatch.setattr(jgrid, "_DENSE_MM_MAX_ELEMS", cap)
        monkeypatch.setattr(tgrid, "DENSE_MM_MAX_ELEMS", cap)
        monkeypatch.setattr(jgrid, "_lod_features_dense_matmul_ckpt",
                            jgrid._lod_features_dense_matmul)
        # a new function each time: jit traces it anew, under this cap
        want = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(jgrid._hashgrid_impl(
            jnp.asarray(coords), tuple(resolutions), bw, 3, t, tuple(first), tuple(sizes),
            dense_matmul, True))))(jnp.asarray(table)))
        touched = _touched_rows(want, first, sizes)
        jax_stoch = tuple(t == 1 for t in touched)
        assert all(t in (1, 8) for t in touched), touched
        assert tgrid.stoch_lods(resolutions, bw, 3, rows, dense_matmul) == jax_stoch


@pytest.mark.parametrize("res", [16, 20, 25, 32, 40, 50, 64, 80])
def test_stoch_lods_flagship_thresholds(res):
    """At the real cap (2^30) a dense LOD of the flagship (bitwidth 19) draws above
    2^30 / res^2 rows and keeps the exact gradient at or below it; hash LODs always draw,
    and without dense_lod_matmul every LOD draws."""
    assert tgrid.DENSE_MM_MAX_ELEMS == jgrid._DENSE_MM_MAX_ELEMS == 2 ** 30
    edge = 2 ** 30 // (res * res)
    assert tgrid.stoch_lods([res, 101, 512], 19, 3, edge, "bf16") == (False, True, True)
    assert tgrid.stoch_lods([res, 101, 512], 19, 3, edge + 1, "bf16") == (True, True, True)
    assert tgrid.stoch_lods([res, 101], 19, 3, 1, None) == (True, True)


class TestStochasticBackward:
    """Counterparts of JAX's ``TestStochasticBackward`` (tests/core/test_grid_ops.py:178),
    through the port's ``hashgrid`` on the CPU with its own sin hash."""

    @staticmethod
    def _setup(rng, n=200):
        resolutions, bw = (4, 8, 37), 9
        sizes = tuple(min(r ** 3, 2 ** bw) for r in resolutions)
        first = tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        codebook = torch.from_numpy(rng.standard_normal((sum(sizes), 2)).astype(np.float32))
        coords = torch.from_numpy((rng.random((n, 3)) * 2 - 1).astype(np.float32))
        return resolutions, bw, sizes, first, codebook, coords

    def test_forward_identical(self):
        resolutions, bw, sizes, first, codebook, coords = self._setup(
            np.random.default_rng(0))
        exact = tgrid.hashgrid(coords, resolutions, bw, 2, codebook, first, sizes)
        stoch = tgrid.hashgrid(coords, resolutions, bw, 2, codebook.requires_grad_(), first,
                               sizes, stoch_grad=True)
        np.testing.assert_allclose(exact.numpy(), stoch.detach().numpy(), atol=1e-6)

    def test_gradient_unbiased(self):
        rng = np.random.default_rng(1)
        resolutions, bw = (37,), 9
        sizes, first = (min(37 ** 3, 2 ** bw),), (0,)
        codebook = torch.from_numpy(rng.standard_normal((sizes[0], 2)).astype(np.float32))
        base = (rng.random((20, 3)) * 2 - 1).astype(np.float32)
        reps = 400
        jit = (rng.standard_normal((reps, 20, 3)) * 1e-4).astype(np.float32)
        coords = torch.from_numpy((base[None] + jit).reshape(-1, 3))

        def grad(c, stoch):
            t = codebook.clone().requires_grad_()
            tgrid.hashgrid(c, resolutions, bw, 0, t, first, sizes,
                           stoch_grad=stoch).sum().backward()
            return t.grad.numpy()

        g_exact = grad(torch.from_numpy(base), False)
        g_stoch = grad(coords, True) / reps
        touched = np.abs(g_exact).sum(-1) > 0
        np.testing.assert_allclose(g_stoch[touched], g_exact[touched], atol=0.15)
        assert np.abs(g_stoch[~touched]).max() < 0.15

    def test_gradient_flows_and_is_sparse(self):
        resolutions, bw, sizes, first, codebook, coords = self._setup(
            np.random.default_rng(2), n=50)
        t = codebook.clone().requires_grad_()
        tgrid.hashgrid(coords, resolutions, bw, 2, t, first, sizes,
                       stoch_grad=True).sum().backward()
        g = t.grad.numpy()
        assert np.abs(g).sum() > 0
        lod2 = g[first[2]:first[2] + sizes[2]]
        assert (np.abs(lod2).sum(-1) > 0).sum() <= 50


def test_sin_hash_is_uniform():
    """The port's sin hash on 10^5 points of [-1, 1]^3, and its golden-ratio folds: mean
    0.5 +- 0.01, Kolmogorov-Smirnov distance to U(0, 1) under 0.01."""
    coords = torch.from_numpy(_coords(100_000, 3, 11))
    u0 = tgrid.stoch_u0(coords)
    for u in (u0, tgrid.fold_u(u0, 0), tgrid.fold_u(u0, 15)):
        s = np.sort(u.numpy().astype(np.float64))
        n = s.size
        ks = max(np.max(np.arange(1, n + 1) / n - s), np.max(s - np.arange(n) / n))
        assert abs(s.mean() - 0.5) < 0.01 and ks < 0.01, (s.mean(), ks)
        assert s[0] >= 0.0 and s[-1] < 1.0


def test_hash_grid_rule_rows_reach_the_grid(monkeypatch):
    """``HashGrid`` passes ``stoch_grad``, ``dense_lod_matmul`` and the caller's
    ``stoch_rows`` to ``hashgrid``; without ``stoch_rows`` the rule reads the call's rows."""
    seen = []
    real = tgrid.hashgrid

    def spy(*args, **kwargs):
        seen.append((kwargs["stoch_grad"], kwargs["dense_lod_matmul"], kwargs["stoch_rows"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(tgrid, "hashgrid", spy)
    grid = HashGrid.from_geometric(feature_dim=2, num_lods=3, codebook_bitwidth=9,
                                   min_grid_res=4, max_grid_res=37, multiscale_type="sum",
                                   dense_lod_matmul="bf16", stoch_grad=True, device="cpu")
    coords = torch.from_numpy(_coords(64, 3, 12))
    grid.interpolate(coords, 2, stoch_rows=1 << 20).sum().backward()
    grid.interpolate(coords, 2).sum().backward()
    assert seen == [(True, "bf16", 1 << 20), (True, "bf16", None)]


def _wrong_shift(monkeypatch):
    real = tgrid.fold_u
    monkeypatch.setattr(tgrid, "fold_u", lambda u0, lod: real(u0, lod + 1))


def _wrong_corner_order(monkeypatch):
    real = tgrid._corners

    def reversed_corners(coords, res, codebook_size):
        idx, w = real(coords, res, codebook_size)
        return idx.flip(1), w.flip(1)
    monkeypatch.setattr(tgrid, "_corners", reversed_corners)


@pytest.mark.parametrize("mutate", [None, _wrong_shift, _wrong_corner_order],
                         ids=["plain", "wrong-shift", "wrong-corner-order"])
def test_chip_parity_check_fails_a_wrong_draw(monkeypatch, mutate):
    """``chip_smoke.stoch_parity``, the card's check of the kernel against its plain version,
    at a training step's cotangent scale (1e-6): the plain version passes it, and a 'kernel'
    that draws with the next LOD's golden shift or in reversed corner order fails it, each
    still unbiased. Here the kernel's route is the plain version, broken on purpose."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    resolutions = [16, 32, 64, 128, 256]
    _, first, sizes = _table(3, 12, resolutions)
    rng = np.random.default_rng(5)
    coords = torch.from_numpy(_coords(4000, 3, 4))
    g = torch.from_numpy((1e-6 * rng.normal(size=(4000, 10))).astype(np.float32))
    u0 = torch.from_numpy(rng.uniform(size=4000).astype(np.float32))
    mask = (False, False, True, True, True)
    args = (resolutions, 12, 4, first[-1], first[:-1], sizes)
    plain = tgrid.hashgrid_bwd_plain

    def kernel(*a, **k):
        with monkeypatch.context() as m:
            if mutate is not None:
                mutate(m)
            return plain(*a, **k)

    monkeypatch.setattr(tgrid, "hashgrid_bwd", kernel)
    p = chip_smoke.stoch_parity(coords, g, args, mask, u0, 5)
    assert p["held"] == (mutate is None), p
    if mutate is not None:
        assert p["flips"] > 0.1 * p["draws"] and p["err"] > 100 * p["tol"], p
