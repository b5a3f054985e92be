"""The host-side rules of K2/K8 (the occupancy march) and K15's backward, redesigned (no
JAX, no card).

K2/K8: ``tile_march`` repeats the steps of ``raymarch_tile_kernel`` (``csrc/raymarch.cu``)
with numpy float32 on every tile of kMarchTile consecutive samples: the ray constants once a
ray (and its delta from the tile that holds its first sample), the strided tests of the
tile's samples and the next test of its last one, then four consecutive samples a thread
with the kernel's own stepping of ray, sample and strided test. It counts every store and
is held to ``raymarch_ray_plain`` and ``raymarch_uniform_plain`` bit for bit.

K15 backward: ``privatized_bwd`` repeats ``octree_interp_bwd_kernel``'s grouping (a block
a share of a LOD's (point, features) items; the LODs that ``bwd_shared_lods`` picks summed
by row in each block's own table, which is then added, the others added item by item) and
is held to ``octree_interp_bwd_plain`` within 1e-5 of the largest entry, the tolerance of
the card's atomics. ``bwd_shared_lods`` is the wrapper's rule, ``grad_tables`` its one zero
fill.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from wisp_tpu_torch.accelstructs.octree_as import (raymarch_ray_plain,
                                                   raymarch_uniform_plain, uniform_step)
from wisp_tpu_torch.models.grids.octree_grid import (BWD_SHARED_BYTES, BWD_SHARED_MIN_ADDS,
                                                     bwd_shared_lods, grad_tables,
                                                     interp_vector_width,
                                                     octree_interp_bwd_plain)

CSRC = Path(__file__).resolve().parents[1] / "wisp_tpu_torch" / "csrc"
F32 = np.float32


def constant(source: str, name: str) -> int:
    """An ``int`` constant that a kernel source declares, ``kMarchTile = 4 * kMarchThreads``
    style (one product of literals and earlier constants)."""
    text = (CSRC / source).read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    value = 1
    for factor in expr.split("*"):
        factor = factor.strip()
        value *= int(factor) if factor.isdigit() else constant(source, factor)
    return value


MARCH_THREADS = constant("raymarch.cu", "kMarchThreads")
MARCH_TILE = constant("raymarch.cu", "kMarchTile")
BWD_THREADS = constant("octree_grid.cu", "kBwdThreads")
BWD_BLOCKS = constant("octree_grid.cu", "kBwdBlocks")
BWD_SHARED_THREADS = constant("octree_grid.cu", "kBwdSharedThreads")
BWD_SHARED_BLOCKS = constant("octree_grid.cu", "kBwdSharedBlocks")


# -- K2/K8 -----------------------------------------------------------------------------------

def slab(o, d, dist_min, dist_max):
    """``load_ray``: t_near (clamped at 0), t_far, span, hit, in float32."""
    d = np.where(np.abs(d) > F32(1e-9), d, F32(1e-9)).astype(F32)
    inv = (F32(1.0) / d).astype(F32)
    t0 = ((F32(-1.0) - o) * inv).astype(F32)
    t1 = ((F32(1.0) - o) * inv).astype(F32)
    t_near = np.maximum(np.minimum(t0, t1).max(-1), F32(dist_min)).astype(F32)
    t_far = np.minimum(np.maximum(t0, t1).min(-1), F32(dist_max)).astype(F32)
    t_near = np.maximum(t_near, F32(0.0))
    span = np.maximum((t_far - t_near).astype(F32), F32(0.0))
    return t_near, t_far, span, t_far > t_near


def sample_at(o, d, t_near, span, j, u, S, ustep):
    """``sample_at`` for arrays of rays (their o, d, t_near, span) and sample indices j."""
    uj = (j.astype(F32) + u).astype(F32)
    if ustep > 0:
        t = (t_near + (uj * F32(ustep)).astype(F32)).astype(F32)
    else:
        t = (t_near + (span * (uj / F32(S)).astype(F32)).astype(F32)).astype(F32)
    return t, (o + (d * t[:, None]).astype(F32)).astype(F32)


def inside(p):
    return ((p >= -1.0) & (p < 1.0)).all(-1)


def field_at(p, field, level):
    res = 2 ** level
    q = np.clip(np.floor((p + F32(1.0)) * F32(res / 2.0)).astype(np.int64), 0, res - 1)
    flat = (q[:, 0] * res + q[:, 1]) * res + q[:, 2]
    return np.where(inside(p), field[flat], F32(-1.0)).astype(F32)


def tile_march(o, d, jitter, S, stride, ustep, dist_min, dist_max, field, level, tile):
    """The outputs of ``raymarch_tile_kernel`` and how often each element was stored."""
    R = o.shape[0]
    total = R * S
    nc = -(-S // stride)
    out = {"samples": np.zeros((total, 3), F32), "depths": np.zeros(total, F32),
           "mask": np.zeros(total, bool), "dens": np.zeros(total, F32),
           "deltas": np.zeros(R, F32)}
    writes = {k: np.zeros(v.shape[0], np.int64) for k, v in out.items()}
    stats = {"max_rays": 0, "max_tests": 0, "edge_pairs": 0}
    for o0 in range(0, total, tile):
        n = min(tile, total - o0)
        r0 = o0 // S
        j0 = o0 - r0 * S
        nr = (j0 + n - 1) // S + 1
        assert nr <= (tile - 1) // S + 2 and r0 + nr <= R     # the entry's shared memory
        rays = np.arange(r0, r0 + nr)
        t_near, t_far, span, hit = slab(o[rays], d[rays], dist_min, dist_max)
        first = rays[(rays > r0) | (j0 == 0)]                 # rays that start in this tile
        out["deltas"][first] = F32(ustep) if ustep > 0 else (span[first - r0] / F32(S))
        writes["deltas"][first] += 1
        stats["max_rays"] = max(stats["max_rays"], nr)
        qb = j0 // stride
        if field is not None:
            jl = j0 + n - 1 - (nr - 1) * S
            gl = jl // stride
            nq = (nr - 1) * nc + gl - qb + 1 + int(stride > 1 and gl + 1 < nc)
            assert nq <= tile + 1
            stats["max_tests"] = max(stats["max_tests"], nq)
            qi = qb + np.arange(nq)
            ri, g = qi // nc, qi % nc
            j = g * stride
            u = F32(0.5) if jitter is None else jitter[r0 + ri, j]
            _, p = sample_at(o[r0 + ri], d[r0 + ri], t_near[ri], span[ri], j, u, S, ustep)
            val_s = field_at(p, field, level)
        # four consecutive samples a thread, stepped as the kernel steps them
        l0 = 4 * np.arange(MARCH_THREADS)
        l0 = l0[l0 < n]
        ri = (j0 + l0) // S
        j = j0 + l0 - ri * S
        g = j // stride
        k = j - g * stride
        for e in range(4):
            ok = l0 + e < n
            loc, r_, j_, g_ = (l0 + e)[ok], ri[ok], j[ok], g[ok]
            u = F32(0.5) if jitter is None else jitter[r0 + r_, j_]
            t, p = sample_at(o[r0 + r_], d[r0 + r_], t_near[r_], span[r_], j_, u, S, ustep)
            occ = np.ones(loc.shape, bool)
            val = np.zeros(loc.shape, F32)
            if field is not None:
                qi = r_ * nc + g_ - qb
                val = val_s[qi]
                occ = val >= 0.0
                nxt = (stride > 1) & (g_ + 1 < nc)
                assert (qi[nxt] + 1 < nq).all()
                occ = occ | (nxt & (val_s[np.minimum(qi + 1, nq - 1)] >= 0.0))
                # a strided pair whose next test lies past the tile's last sample
                stats["edge_pairs"] += int((nxt & (o0 + loc + (stride - (j_ % stride))
                                                   >= o0 + n)).sum())
            far = (t < t_far[r_]) if ustep > 0 else hit[r_]
            flat = o0 + loc
            for key, v in (("samples", p), ("depths", t), ("dens", np.maximum(val, 0.0)),
                           ("mask", occ & inside(p) & far)):
                out[key][flat] = v
                writes[key][flat] += 1
            wrap = j + 1 == S
            step = ~wrap & (k + 1 == stride)
            ri, j = np.where(wrap, ri + 1, ri), np.where(wrap, 0, j + 1)
            g = np.where(wrap, 0, np.where(step, g + 1, g))
            k = np.where(wrap | step, 0, k + 1)
    return out, writes, stats


def march_inputs(R, S, seed, jittered):
    rng = np.random.default_rng(seed)
    d = rng.normal(scale=0.25, size=(R, 3)).astype(F32)
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (np.asarray([[0.1, -0.05, -3.0]], F32) + rng.normal(scale=0.3, size=(R, 3))).astype(F32)
    o[3::7] = [0.0, 0.0, -3.0]
    d[3::7] = [1.0, 0.0, 0.0]                                # rays that miss the box
    field = np.where(rng.random(8 ** 4) < 0.4, rng.random(8 ** 4) * 3.0, -1.0).astype(F32)
    jitter = rng.random((R, S)).astype(F32) if jittered else None
    return o, d, field, jitter


def test_the_tile_is_the_block_of_quads():
    assert MARCH_TILE == 4 * MARCH_THREADS and MARCH_TILE % 16 == 0


@pytest.mark.parametrize("mode", ["ray", "uniform"])
@pytest.mark.parametrize("S,R", [(67, 41), (512, 5), (3, 700), (1, 1500), (1025, 2)])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_tile_model_matches_the_plain_march(mode, S, R, stride):
    """Every output stored once, each tile's rays and tests within the entry point's shared
    memory, and all of it equal to the plain version, midpoints and jittered, with the
    field and without."""
    assert (R * S) % MARCH_TILE                               # the last tile is a tail
    plain = raymarch_ray_plain if mode == "ray" else raymarch_uniform_plain
    ustep = 0.0 if mode == "ray" else uniform_step(S)
    edge_pairs = 0
    for jittered in (False, True):
        o, d, field, jitter = march_inputs(R, S, 100 * S + R + stride, jittered)
        for fld in (field, None):
            got, writes, stats = tile_march(o, d, jitter, S, stride, ustep, 0.0, 8.0, fld, 4,
                                            MARCH_TILE)
            keys = ["samples", "depths", "mask", "deltas"] + ([] if fld is None else ["dens"])
            for k in keys:
                assert (writes[k] == 1).all(), k
            want = plain(torch.from_numpy(o), torch.from_numpy(d), 0.0, 8.0, S, stride,
                         None if fld is None else torch.from_numpy(fld), 4,
                         None if jitter is None else torch.from_numpy(jitter))
            assert np.array_equal(got["samples"], want.samples.reshape(-1, 3).numpy())
            assert np.array_equal(got["depths"], want.depth_samples.reshape(-1).numpy())
            assert np.array_equal(got["mask"], want.mask.reshape(-1).numpy())
            assert np.array_equal(got["deltas"], want.deltas.reshape(-1).numpy())
            if fld is not None:
                assert np.array_equal(got["dens"], want.cell_density.reshape(-1).numpy())
                assert stats["max_tests"] <= MARCH_TILE + 1
                edge_pairs += stats["edge_pairs"]
                assert want.mask.any() and not want.mask.all()
            assert stats["max_rays"] <= min(R, (MARCH_TILE - 1) // S + 2)
    # a strided pair straddles a tile edge where a tile (not the last) ends before its last
    # sample's strided group does: the next test is then made in both tiles
    nc = -(-S // stride)
    ends = [((t + 1) * MARCH_TILE - 1) % S // stride for t in range(R * S // MARCH_TILE)]
    assert (edge_pairs > 0) == (stride > 1 and any(g + 1 < nc for g in ends))


# -- K15 backward ----------------------------------------------------------------------------

def cell_frac(c, level):
    res = 2 ** level
    x = ((c + F32(1.0)) * F32(res / 2.0)).astype(F32)
    q = np.clip(np.floor(x), 0, res - 1).astype(F32)
    return np.clip((x - q).astype(F32), F32(0.0), F32(1.0))


def privatized_bwd(coords, pidx, col0, trinkets, rows, f_dim, levels, multiscale, grad_out,
                   shared, vec):
    """``octree_interp_bwd_kernel``'s sums: per LOD (a slot of blockIdx.y) its blocks take
    (point, V features) items in a grid-stride loop; a LOD with ``shared`` rows sums each
    block's adds by row in a block table, then adds the block tables into its table one
    after another; the others add each item's products straight in. Returns the tables and
    the global adds (entries) a LOD."""
    n, lods = coords.shape[0], len(levels)
    lanes = f_dim // vec
    items = n * lanes
    tables = [np.zeros((v, f_dim), F32) for v in rows]
    adds = [0] * lods
    # the launch: blocks of 1024 threads where any LOD is shared, else of 128; a LOD takes
    # its share of the launch's blocks
    threads, budget = ((BWD_SHARED_THREADS, BWD_SHARED_BLOCKS) if any(shared)
                       else (BWD_THREADS, BWD_BLOCKS))
    blocks = min(max(1, budget // lods), -(-items // threads))
    stride = blocks * threads
    for lod in range(lods):
        fr = np.stack([cell_frac(coords[:, a], levels[lod]) for a in range(3)], -1)
        w = np.ones((n, 8), F32)
        for c in range(8):
            for a, bit in enumerate((4, 2, 1)):
                w[:, c] = (w[:, c] * (fr[:, a] if c & bit else F32(1.0) - fr[:, a])).astype(F32)
        g = grad_out if multiscale == "sum" else grad_out[:, lod * f_dim:(lod + 1) * f_dim]
        for b in range(blocks):
            it = np.concatenate([np.arange(start, min(start + threads, items))
                                 for start in range(b * threads, items, stride)])
            pt, f = it // lanes, (it % lanes) * vec
            p = pidx[pt, col0 + lod]
            ok = p >= 0
            pt, f, p = pt[ok], f[ok], p[ok]
            block = np.zeros_like(tables[lod]) if shared[lod] else tables[lod]
            for c in range(8):
                r = trinkets[lod][p, c]
                for k in range(vec):
                    np.add.at(block, (r, f + k), (w[pt, c] * g[pt, f + k]).astype(F32))
            if shared[lod]:
                touched = block != 0
                tables[lod][touched] += block[touched]
                adds[lod] += int(touched.sum())
            else:
                adds[lod] += int(pt.size) * 8 * vec
    return tables, adds


def bwd_inputs(n, f_dim, lods, seed, layout):
    """Seeded K15 backward inputs: 'rays' gives runs of points on one cell (the octree
    NeRF's points come ray by ray), 'random' none to speak of, 'one cell' every point in one
    cell of every LOD; a tenth of the points of 'rays' and 'random' lie in empty cells."""
    rng = np.random.default_rng(seed)
    levels = [2 + i for i in range(lods)]
    cells = [int(v) for v in rng.integers(3, 200, lods)]
    rows = [int(v) for v in rng.integers(8, 300, lods)]
    trinkets = [rng.integers(0, rows[i], (cells[i], 8)).astype(np.int32) for i in range(lods)]
    col0 = 1
    pidx = rng.integers(-1, 5, (n, col0 + lods + 1)).astype(np.int32)
    for i in range(lods):
        if layout == "one cell":
            pidx[:, col0 + i] = cells[i] // 2
            continue
        if layout == "rays":
            runs = rng.integers(1, 40 // (i + 1) + 2, n)
            col = np.repeat(rng.integers(0, cells[i], n), runs)[:n]
        else:
            col = rng.integers(0, cells[i], n)
        col[rng.random(n) < 0.1] = -1
        pidx[:, col0 + i] = col
    coords = rng.uniform(-1.05, 1.05, (n, 3)).astype(F32)
    k = rng.integers(0, 2 ** 8 + 1, (n, 3))
    edge = rng.random(n) < 0.2                                # on cell boundaries
    coords[edge] = (k[edge] / 2.0 ** 7 - 1.0).astype(F32)
    return coords, pidx, col0, trinkets, rows, levels


@pytest.mark.parametrize("f_dim", [1, 5, 16])
@pytest.mark.parametrize("multiscale", ["sum", "cat"])
@pytest.mark.parametrize("layout", ["rays", "random", "one cell"])
def test_privatized_model_matches_the_plain_backward(f_dim, multiscale, layout):
    """The kernel's grouping (block tables for the LODs the rule picks, straight adds for
    the others, both vector widths) within the atomics' tolerance of the plain version;
    with every point in one cell a shared LOD takes one add a row entry a block."""
    n, lods = 300, 3
    coords, pidx, col0, trinkets, rows, levels = bwd_inputs(n, f_dim, lods,
                                                            f_dim + len(layout), layout)
    width = f_dim if multiscale == "sum" else f_dim * lods
    grad_out = np.random.default_rng(f_dim).normal(size=(n, width)).astype(F32)
    want = octree_interp_bwd_plain(torch.from_numpy(coords), torch.from_numpy(pidx), col0,
                                   [torch.from_numpy(t) for t in trinkets], rows, f_dim,
                                   levels, multiscale, torch.from_numpy(grad_out))
    scale = max(float(t.abs().max()) for t in want)
    assert scale > 0
    shared = bwd_shared_lods(rows, f_dim, n)
    for rule in (shared, [0] * lods, rows):
        for vec in {1, interp_vector_width(f_dim, [0])}:
            got, adds = privatized_bwd(coords, pidx, col0, trinkets, rows, f_dim, levels,
                                       multiscale, grad_out, rule, vec)
            for a, b in zip(got, want):
                assert np.abs(a - b.numpy()).max() <= 1e-5 * scale
            valid = [int((pidx[:, col0 + i] >= 0).sum()) for i in range(lods)]
            for i in range(lods):
                if not rule[i]:
                    assert adds[i] == valid[i] * 8 * f_dim
                elif layout == "one cell":
                    assert adds[i] <= 8 * f_dim * -(-n * f_dim // vec // BWD_SHARED_THREADS)


def test_bwd_shared_lods_rule():
    f_dim = 5
    fits = BWD_SHARED_BYTES // (4 * f_dim)
    assert BWD_SHARED_BYTES == constant("octree_grid.cu", "kBwdSharedBytes")
    # fits and hot: shared; too big, or too few adds a row: straight to the table
    n = -(-fits * BWD_SHARED_MIN_ADDS // 8)
    assert bwd_shared_lods([fits, fits + 1], f_dim, n) == [fits, 0]
    assert bwd_shared_lods([fits], f_dim, n - 1) == [0]
    # the octree NeRF's levels 4 and 5 (~1,300 and ~5,500 rows at F = 5, 187,360 points),
    # not its levels 6 and 7 (too big) nor the NGLOD batch's level 2 (~140 rows at F = 16,
    # 512 points: too few adds a row)
    assert bwd_shared_lods([1300, 5500, 30_000, 150_000], 5, 187_360) == [1300, 5500, 0, 0]
    assert bwd_shared_lods([140, 60_000], 16, 512) == [0, 0]


def test_grad_tables_are_views_of_one_zeroed_buffer():
    rows, f_dim = [7, 1, 30], 5
    tables = grad_tables(rows, f_dim, torch.device("cpu"))
    assert [tuple(t.shape) for t in tables] == [(v, f_dim) for v in rows]
    base = tables[0].untyped_storage().data_ptr()
    offset = 0
    for t, v in zip(tables, rows):
        assert t.is_contiguous() and not bool(t.any())
        assert t.untyped_storage().data_ptr() == base
        assert t.data_ptr() == base + offset * 4
        offset += v * f_dim
    assert grad_tables([0, 3], 16, torch.device("cpu"))[0].shape == (0, 16)
