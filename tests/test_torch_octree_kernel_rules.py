"""The host-side rules of K15's forward and K11 (no JAX, no card).

K15: ``interp_vector_width`` picks the forward's route from F and the tables' alignment, and
``lod_tables`` keeps the argument block of the tables that the forward entry points read. K11:
``free_space_layout`` gives the kernel's bit grids; ``bit_free_space`` below repeats the
kernel's steps on those words with numpy (pack, z shifts within and across words, y and x
ORs by doubling, the count of missed thresholds) and is held to the plain version, which
keeps JAX's integers.
"""

import numpy as np
import pytest
import torch

from wisp_tpu_torch.accelstructs.octree_as import (QueryRoute, free_space_cap,
                                                   free_space_distance_plain,
                                                   free_space_layout)
from wisp_tpu_torch.models.grids import octree_grid


@pytest.mark.parametrize("f_dim", [1, 2, 3, 4, 5, 8, 12, 16, 32])
def test_interp_vector_width_follows_f(f_dim):
    aligned = [256, 4096, 16 * 7]
    assert octree_grid.interp_vector_width(f_dim, aligned) == (4 if f_dim % 4 == 0 else 1)
    # a table that does not start on 16 bytes takes the route of a lane a feature
    assert octree_grid.interp_vector_width(f_dim, aligned + [4100]) == 1


def test_lod_arrays_are_built_once_a_set_of_tables(monkeypatch):
    """``lod_tables`` builds the forward kernels' argument block once a set of tables, and
    builds it anew for anything its checks or the block read: another table, level, width,
    route, or a table of another length or dtype at the same address (a freed table's
    address may come back). The checks' CUDA rule is lifted: the tables are on the CPU."""
    monkeypatch.setattr(octree_grid, "_LOD_TABLES", {})
    monkeypatch.setattr(octree_grid.kernels, "check", lambda *args, **kwargs: None)
    trinkets = [torch.zeros((3, 8), dtype=torch.int32) for _ in range(2)]
    feats = [torch.zeros((5, 16)), torch.zeros((7, 16))]
    first = octree_grid.lod_tables(trinkets, feats, [4, 5])
    assert first.vec == octree_grid.interp_vector_width(16, [f.data_ptr() for f in feats])
    assert first.group == (4 if first.vec == 4 else 16)
    block = octree_grid._LodTables.from_address(first.address)
    assert list(block.trinkets[:2]) == [t.data_ptr() for t in trinkets]
    assert list(block.feats[:2]) == [f.data_ptr() for f in feats]
    assert list(block.level[:2]) == [4, 5]
    assert octree_grid.lod_tables(trinkets, feats, [4, 5]) is first
    assert len(octree_grid._LOD_TABLES) == 1
    # another table, level or width is another entry
    assert octree_grid.lod_tables(trinkets, feats[::-1], [4, 5]) is not first
    assert octree_grid.lod_tables(trinkets, feats, [4, 6]).address != first.address
    narrow = [f[:, :8].contiguous() for f in feats]
    assert octree_grid.lod_tables(trinkets, narrow, [4, 5]).vec in (1, 4)
    assert len(octree_grid._LOD_TABLES) == 4
    # the same addresses with another length or dtype: a new block, its length the new one
    codes = torch.arange(100, dtype=torch.int32)
    routes = [None] * 4 + [QueryRoute("search", codes[:60]),
                           QueryRoute("search", codes)]
    full = octree_grid.lod_tables(trinkets, feats, [4, 5], routes)
    routes[5] = QueryRoute("search", codes[:40])
    short = octree_grid.lod_tables(trinkets, feats, [4, 5], routes)
    assert short is not full and routes[5].table.data_ptr() == codes.data_ptr()
    assert list(octree_grid._LodTables.from_address(full.address).len[:2]) == [60, 100]
    assert list(octree_grid._LodTables.from_address(short.address).len[:2]) == [60, 40]
    assert list(octree_grid._LodTables.from_address(short.address).route[:2]) == [1, 1]
    as_float = [trinkets[0].view(torch.float32), trinkets[1]]
    assert octree_grid.lod_tables(as_float, feats, [4, 5]) is not first
    # the cache stays bounded
    for k in range(2 * octree_grid.LOD_TABLES_MAX):
        octree_grid.lod_tables(trinkets, feats, [k, 5])
    assert len(octree_grid._LOD_TABLES) <= octree_grid.LOD_TABLES_MAX


@pytest.mark.parametrize("level", range(9))
def test_free_space_layout(level):
    res = 2 ** level
    for max_k in (-1, 0, 1, 5, 6, 31, 63, 127):
        lay = free_space_layout(level, max_k)
        assert lay.line_words == max(1, res // 32)
        assert 2 ** lay.thresholds == free_space_cap(max_k)
        assert lay.scratch_words == (lay.thresholds + 1) * res * res * lay.line_words
        assert lay.line_words * 32 >= res


def _shift_words(a, r, up):
    """A z line's words ([..., W] uint32) shifted by +r (up: bit z takes bit z - r) or -r."""
    q, s = r >> 5, r & 31
    w = a.shape[-1]
    near, far = np.zeros_like(a), np.zeros_like(a)
    if q < w:
        if up:
            near[..., q:] = a[..., :w - q]
        else:
            near[..., :w - q] = a[..., q:]
    if s == 0:
        return near
    if q + 1 < w:
        if up:
            far[..., q + 1:] = a[..., :w - q - 1]
        else:
            far[..., :w - q - 1] = a[..., q + 1:]
    s = np.uint32(s)
    if up:
        return (near << s) | (far >> (np.uint32(32) - s))
    return (near >> s) | (far << (np.uint32(32) - s))


def _or_shifted(a, r, axis):
    """a | a shifted by +r and by -r along ``axis``, zero beyond the box."""
    out = a.copy()
    n = a.shape[axis]
    if r < n:
        lo = [slice(None)] * a.ndim
        hi = [slice(None)] * a.ndim
        lo[axis], hi[axis] = slice(r, None), slice(None, n - r)
        out[tuple(lo)] |= a[tuple(hi)]
        out[tuple(hi)] |= a[tuple(lo)]
    return out


def bit_free_space(occ: np.ndarray, level: int, max_k: int) -> np.ndarray:
    """The kernel's algorithm on its word layout, in numpy: [res^3] bool -> [res^3] int32."""
    res = 2 ** level
    lay = free_space_layout(level, max_k)
    occ = occ.reshape(res, res, res)
    z = np.arange(res)
    word, bit = z // 32, (z % 32).astype(np.uint32)
    grid = np.zeros((res, res, lay.line_words), np.uint32)
    for k in range(res):
        grid[:, :, word[k]] |= occ[:, :, k].astype(np.uint32) << bit[k]
    grids, cur = [grid], grid
    for j in range(lay.thresholds):                 # the z-y pass, threshold after threshold
        r = 1 << j
        cur = cur | _shift_words(cur, r, True) | _shift_words(cur, r, False)
        cur = _or_shifted(cur, r, axis=1)
        grids.append(cur)
    for g in range(1, lay.thresholds + 1):          # the x pass, grid by grid
        for step in range(g):
            grids[g] = _or_shifted(grids[g], 1 << step, axis=0)
    cells = [(g[:, :, word] >> bit) & 1 for g in grids]
    miss = sum((1 - c).astype(np.int32) for c in cells[1:]) if lay.thresholds else 0
    return np.where(cells[0] == 1, 0, np.left_shift(1, miss)).astype(np.int32).reshape(-1)


def _grids(level):
    """Occupancies that reach the kernel's edge cases at ``level``."""
    res = 2 ** level
    rng = np.random.default_rng(level)
    out = {"empty": np.zeros(res ** 3, bool), "full": np.ones(res ** 3, bool)}
    edges = sorted({0, res - 1, res // 2} | {z for z in (31, 32, 63) if z < res})
    one = np.zeros((res, res, res), bool)
    for x, y, z in ((0, 0, 0), (res - 1, res - 1, res - 1), (0, res - 1, 0),
                    (res // 2, res // 2, res // 2)):
        one[x, y, z] = True
    out["corners and centre"] = one.reshape(-1)
    for z in edges:
        cell = np.zeros((res, res, res), bool)
        cell[res // 3, (2 * res) // 3, z] = True
        out[f"one cell at z {z}"] = cell.reshape(-1)
    for frac in (0.01, 0.1, 0.5):
        out[f"random {frac}"] = rng.random(res ** 3) < frac
    return out


@pytest.mark.parametrize("level,name", [(level, name) for level in (0, 1, 3, 5, 6)
                                        for name in _grids(level)])
def test_bit_algorithm_matches_the_plain_version(level, name):
    occ = _grids(level)[name]
    for max_k in ((0, 1, 5, 31, 127) if level <= 5 else (31,)):
        want = free_space_distance_plain(torch.from_numpy(occ), level, max_k).numpy()
        got = bit_free_space(occ, level, max_k)
        assert np.array_equal(got, want), max_k
