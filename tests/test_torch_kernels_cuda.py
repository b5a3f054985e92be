"""Each hand-written CUDA kernel against its plain PyTorch version, on the card (the
backward kernels against autograd of the plain forward).

These tests need an NVIDIA GPU (marker ``cuda``); they skip where there is none. They
import neither jax nor the JAX package, so they also run on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q``.
chip_smoke.py repeats the comparisons at the flagship's shapes.
"""

import numpy as np
import pytest
import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.octree_as import raymarch_ray, raymarch_ray_plain
from wisp_tpu_torch.ops import grid as grid_ops
from wisp_tpu_torch.ops.compaction import (compact, compact_plain, scatter_back,
                                           scatter_back_bwd, scatter_back_bwd_plain,
                                           scatter_back_plain)
from wisp_tpu_torch.ops.density_grid import scatter_max, scatter_max_plain
from wisp_tpu_torch.ops.integration import (integrate, integrate_bwd, integrate_bwd_plain,
                                            integrate_plain)

pytestmark = pytest.mark.cuda


def ray_arrays(n, seed):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = (np.asarray([[0.1, -0.05, -3.0]], np.float32)
               + rng.normal(scale=0.3, size=(n, 3)).astype(np.float32))
    return origins, dirs


def carved_field(level, seed):
    rng = np.random.default_rng(seed)
    occ = rng.random(8 ** level) < 0.5
    return np.where(occ, rng.random(8 ** level) * 3.0, -1.0).astype(np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("carved,stride", [(False, 1), (True, 1), (True, 2)])
def test_raymarch_ray_kernel(dev, carved, stride):
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(300, seed=3))
    field = None
    if carved:
        field = torch.from_numpy(carved_field(4, 1)).to(dev)
    before = kernels.LAUNCHES["raymarch_ray"]
    got = raymarch_ray(o, d, 0.0, 8.0, 67, stride, field, 4)
    want = raymarch_ray_plain(o, d, 0.0, 8.0, 67, stride, field, 4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raymarch_ray"] == before + 1
    assert torch.equal(got.samples, want.samples)
    assert torch.equal(got.depth_samples, want.depth_samples)
    assert torch.equal(got.deltas, want.deltas)
    assert torch.equal(got.mask, want.mask)
    if carved:
        assert torch.equal(got.cell_density, want.cell_density)


@pytest.mark.parametrize("frac", [0.05, 0.5])
def test_compact_and_scatter_back_kernels(dev, frac):
    g = torch.Generator(device="cpu").manual_seed(0)
    mask = (torch.rand(300, 130, generator=g) < frac).to(dev)
    samples = torch.randn(300, 130, 3, generator=g).to(dev)
    dirs = torch.randn(300, 3, generator=g).to(dev)
    budget = 128 * 40
    got = compact(mask, samples, dirs, budget)
    want = compact_plain(mask, samples, dirs, budget)
    assert torch.equal(got[3], want[3])
    kept = min(int(got[3]), budget)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a[:kept], b[:kept])
    v = torch.randn(kept, 4, generator=g).to(dev)
    assert torch.equal(scatter_back(v, got[0], 300 * 130),
                       scatter_back_plain(v, want[0], 300 * 130))


@pytest.mark.parametrize("dim", [2, 3])
def test_hashgrid_kernel(dev, dim):
    resolutions = [4, 8, 16, 32, 64]
    sizes = [min(r ** dim, 2 ** 10) for r in resolutions]
    first = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    g = torch.Generator(device="cpu").manual_seed(1)
    table = (0.5 * torch.randn(first[-1], 2, generator=g)).to(dev)
    coords = (torch.rand(4000, dim, generator=g) * 2.1 - 1.05).to(dev)
    got = grid_ops.hashgrid(coords, resolutions, 10, 3, table, first, sizes, out_lods=5)
    want = grid_ops.hashgrid_plain(coords, resolutions, 10, 3, table, first, sizes,
                                   out_lods=5)
    assert (got - want).abs().max().item() <= 1e-5
    assert not got[:, 8:].any()


@pytest.mark.parametrize("with_extra", [False, True])
def test_integrate_kernel(dev, with_extra):
    g = torch.Generator(device="cpu").manual_seed(2)
    r, s = 200, 77
    density = (torch.rand(r, s, generator=g) * 20).to(dev)
    deltas = (torch.rand(r, 1, generator=g) * 0.02).to(dev)
    depths = torch.rand(r, s, generator=g).cumsum(-1).to(dev)
    mask = (torch.rand(r, s, generator=g) < 0.5).to(dev)
    color = torch.rand(r, s, 3, generator=g).to(dev)
    extra = torch.rand(r, s, 5, generator=g).to(dev) if with_extra else None
    got = integrate(density, deltas, depths, mask, color, (1.0, 1.0, 1.0), extra=extra)
    want = integrate_plain(density, deltas, depths, mask, color, (1.0, 1.0, 1.0),
                           extra=extra)
    assert set(got) == set(want)
    for k in got:
        if k == "hit":
            assert torch.equal(got[k], want[k])
        else:
            assert (got[k] - want[k]).abs().max().item() <= 1e-5, k


def test_wrappers_reject_bad_inputs(dev):
    with pytest.raises(TypeError):
        integrate(torch.zeros(4, 8, device=dev, dtype=torch.float64),
                  torch.zeros(4, device=dev), torch.zeros(4, 8, device=dev),
                  torch.zeros(4, 8, device=dev, dtype=torch.bool),
                  torch.zeros(4, 8, 3, device=dev), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        compact(torch.zeros(4, 8, device=dev, dtype=torch.bool).T,
                torch.zeros(8, 4, 3, device=dev), torch.zeros(8, 3, device=dev), 16)


@pytest.mark.parametrize("carved", [False, True])
def test_raymarch_ray_jitter_kernel(dev, carved):
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(300, seed=4))
    field = torch.from_numpy(carved_field(4, 2)).to(dev) if carved else None
    g = torch.Generator(device="cpu").manual_seed(5)
    jitter = torch.rand(300, 67, generator=g).to(dev)
    got = raymarch_ray(o, d, 0.0, 8.0, 67, 2, field, 4, jitter)
    want = raymarch_ray_plain(o, d, 0.0, 8.0, 67, 2, field, 4, jitter)
    assert torch.equal(got.samples, want.samples)
    assert torch.equal(got.depth_samples, want.depth_samples)
    assert torch.equal(got.mask, want.mask)
    midpoint = raymarch_ray(o, d, 0.0, 8.0, 67, 2, field, 4)
    assert not torch.equal(got.depth_samples, midpoint.depth_samples)


def _table(dim, resolutions, bitwidth, seed):
    sizes = [min(r ** dim, 2 ** bitwidth) for r in resolutions]
    first = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    g = torch.Generator(device="cpu").manual_seed(seed)
    return sizes, first, g


@pytest.mark.parametrize("n,dim,lod_idx", [(4000, 3, 3), (3000, 2, 4), (0, 3, 3)])
def test_hashgrid_bwd_kernel(dev, n, dim, lod_idx):
    resolutions = [4, 8, 16, 32, 64]
    sizes, first, g = _table(dim, resolutions, 10, 6)
    coords = (torch.rand(n, dim, generator=g) * 2.1 - 1.05).to(dev)
    grad_out = torch.randn(n, 5 * 2, generator=g).to(dev)
    before = kernels.LAUNCHES["hashgrid_bwd"]
    got = grid_ops.hashgrid_bwd(coords, grad_out, resolutions, 10, lod_idx, first[-1], first,
                                sizes, out_lods=5)
    want = grid_ops.hashgrid_bwd_plain(coords, grad_out, resolutions, 10, lod_idx, first[-1],
                                       first, sizes, out_lods=5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_bwd"] == before + (1 if n else 0)
    # atomics sum in another order: 1e-5 of the largest entry
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-5 * scale
    # autograd through the forward launches the backward kernel
    table = (0.5 * torch.randn(first[-1], 2, generator=g)).to(dev).requires_grad_(True)
    out = grid_ops.hashgrid(coords, resolutions, 10, lod_idx, table, first, sizes, out_lods=5)
    (out * grad_out).sum().backward()
    assert (table.grad - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("frac,budget", [(0.05, 128 * 40), (0.5, 128 * 40), (0.5, 128)])
def test_scatter_back_bwd_kernel(dev, frac, budget):
    g = torch.Generator(device="cpu").manual_seed(7)
    mask = (torch.rand(300, 130, generator=g) < frac).to(dev)
    samples = torch.randn(300, 130, 3, generator=g).to(dev)
    dirs = torch.randn(300, 3, generator=g).to(dev)
    idx, _, _, count = compact(mask, samples, dirs, budget)
    kept = min(int(count), budget)
    grad_out = torch.randn(300 * 130, 3, generator=g).to(dev)
    got = scatter_back_bwd(grad_out, idx, kept)
    want = scatter_back_bwd_plain(grad_out, idx, kept)
    assert torch.equal(got, want)
    v = torch.randn(kept, 3, generator=g).to(dev).requires_grad_(True)
    (scatter_back(v, idx, 300 * 130) * grad_out).sum().backward()
    assert torch.equal(v.grad, want)
    assert scatter_back_bwd(grad_out, idx, 0).shape == (0, 3)


@pytest.mark.parametrize("r,s,with_depth", [(200, 77, False), (64, 512, True), (0, 40, False)])
def test_integrate_bwd_kernel(dev, r, s, with_depth):
    g = torch.Generator(device="cpu").manual_seed(8)
    density = (torch.rand(r, s, generator=g) * 20).to(dev)
    deltas = (torch.rand(r, 1, generator=g) * 0.02).to(dev)
    depths = torch.rand(r, s, generator=g).cumsum(-1).to(dev)
    mask = (torch.rand(r, s, generator=g) < 0.5).to(dev)
    color = torch.rand(r, s, 3, generator=g).to(dev)
    g_rgb = torch.randn(r, 3, generator=g).to(dev)
    g_alpha = torch.randn(r, 1, generator=g).to(dev)
    g_depth = torch.randn(r, 1, generator=g).to(dev) if with_depth else None
    bg = (1.0, 0.5, 0.0)
    gd, gc = integrate_bwd(density, deltas, depths, mask, color, bg, g_rgb, g_alpha, g_depth)
    wd, wc = integrate_bwd_plain(density, deltas, depths, mask, color, bg, g_rgb, g_alpha,
                                 g_depth)
    assert gd.shape == (r, s) and gc.shape == (r, s, 3)
    if r:
        # float32 sums in another order (a suffix scan against autograd of cumsum)
        assert (gd - wd).abs().max().item() <= 1e-5 * max(1.0, wd.abs().max().item())
        assert (gc - wc).abs().max().item() <= 1e-6
    # autograd through the forward launches the backward kernel
    d = density.clone().requires_grad_(True)
    c = color.clone().requires_grad_(True)
    before = kernels.LAUNCHES["integrate_bwd"]
    out = integrate(d, deltas, depths, mask, c, bg, with_depth=with_depth)
    loss = (out["rgb"] * g_rgb).sum() + (out["alpha"] * g_alpha).sum()
    if with_depth:
        loss = loss + (out["depth"] * g_depth).sum()
    loss.backward()
    assert kernels.LAUNCHES["integrate_bwd"] == before + 1
    if r:
        assert (d.grad - wd).abs().max().item() <= 1e-5 * max(1.0, wd.abs().max().item())


@pytest.mark.parametrize("k", [0, 50, 200000])
def test_scatter_max_kernel(dev, k):
    g = torch.Generator(device="cpu").manual_seed(9)
    ids = torch.randint(-3, 4096 + 3, (k,), generator=g).to(dev)
    vals = torch.relu(torch.randn(k, generator=g)).to(dev)
    got = scatter_max(ids, vals, 4096)
    want = scatter_max_plain(ids, vals, 4096)
    assert torch.equal(got, want)


def test_scatter_max_kernel_propagates_nan(dev):
    ids = torch.tensor([3, 3, 5], device=dev)
    vals = torch.tensor([1.0, float("nan"), 2.0], device=dev)
    got = scatter_max(ids, vals, 8)
    want = scatter_max_plain(ids.cpu(), vals.cpu(), 8)
    assert torch.isnan(got[3]) and torch.isnan(want[3])
    assert got[5].item() == want[5].item() == 2.0


def _sphere_octree(level, device):
    """A sparse octree of the cells a shell of radius 0.6 crosses, and its free-space
    field."""
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    rng = np.random.default_rng(11)
    p = rng.normal(size=(20000, 3))
    p = 0.6 * p / np.linalg.norm(p, axis=-1, keepdims=True)
    return OctreeAS.from_pointcloud(p.astype(np.float32), level, device=device)


@pytest.mark.parametrize("with_parents", [False, True])
def test_octree_query_kernel(dev, with_parents):
    from wisp_tpu_torch.accelstructs.octree_as import octree_query, octree_query_plain
    blas = _sphere_octree(5, dev)
    g = torch.Generator(device="cpu").manual_seed(12)
    coords = (torch.rand(5000, 3, generator=g) * 2.2 - 1.1)
    coords[:50] = torch.tensor([1.0, -1.0, 0.3])              # on the faces: inside
    coords = coords.to(dev)
    before = kernels.LAUNCHES["octree_query"]
    got = octree_query(coords, blas.pidx_maps, 5, with_parents)
    want = octree_query_plain(coords, blas.pidx_maps, 5, with_parents)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_query"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want.to(torch.int32))


@pytest.mark.parametrize("level,max_k", [(4, 31), (5, 31), (5, 6)])
def test_free_space_distance_kernel(dev, level, max_k):
    from wisp_tpu_torch.accelstructs.octree_as import (free_space_distance,
                                                       free_space_distance_plain)
    occ = _sphere_octree(level, dev).occ_grid
    rand = (torch.rand(8 ** level, generator=torch.Generator().manual_seed(13)) < 0.01)
    for grid in (occ, rand.to(dev)):
        got = free_space_distance(grid, level, max_k)
        want = free_space_distance_plain(grid, level, max_k)
        assert torch.equal(got, want)


def _trace_inputs(level, dev, n=3000):
    from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect
    blas = _sphere_octree(level, dev)
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(n, seed=14))
    t_near, t_far = aabb_intersect(o, d, 0.0, 10.0)
    t = t_near.clamp(min=0.0) + 1e-6
    return blas, o, d, t, t_far > t, t_far


def test_sdf_walk_kernel(dev):
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sdf_walk, sdf_walk_plain
    blas, o, d, t, alive, t_far = _trace_inputs(6, dev)
    fd = blas.free_space_distance()
    tk, ak = t.clone(), alive.clone()
    tp, ap = t.clone(), alive.clone()
    sdf_walk(o, d, tk, ak, t_far, fd, 6, 32)
    sdf_walk_plain(o, d, tp, ap, t_far, fd, 6, 32)
    assert torch.equal(tk, tp) and torch.equal(ak, ap)
    assert bool((tk != t).any())


def test_sphere_step_kernel(dev):
    from wisp_tpu_torch.tracers.packed_sdf_tracer import (sdf_walk, sphere_step,
                                                          sphere_step_plain)
    blas, o, d, t, alive, t_far = _trace_inputs(6, dev)
    fd = blas.free_space_distance()
    sdf_walk(o, d, t, alive, t_far, fd, 6, 32)
    g = torch.Generator(device="cpu").manual_seed(15)
    state_k = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    state_p = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    for i in range(8):
        # the field at the ray's point: some |d| under min_dis, some negative
        dist = ((torch.rand(t.shape[0], generator=g) - 0.1) * 0.02).to(dev)
        sphere_step(o, d, *state_k, t_far, dist, fd, 6, 0.8, 3e-4)
        sphere_step_plain(o, d, *state_p, t_far, dist, fd, 6, 0.8, 3e-4)
        for a, b in zip(state_k, state_p):
            assert torch.equal(a, b), i
    assert bool(state_k[2].any())


@pytest.mark.parametrize("multiscale,lod_idx", [("sum", 2), ("cat", 2), ("sum", 0)])
def test_octree_interp_kernel(dev, multiscale, lod_idx):
    from wisp_tpu_torch.models.grids.octree_grid import (OctreeGrid, octree_interp,
                                                         octree_interp_plain)
    blas = _sphere_octree(5, dev)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, multiscale_type=multiscale,
                      feature_std=0.5, generator=torch.Generator().manual_seed(16),
                      device=dev)
    g = torch.Generator(device="cpu").manual_seed(17)
    coords = (torch.rand(4000, 3, generator=g) * 2.1 - 1.05).to(dev)
    level = grid.active_lods[lod_idx]
    pidx = blas.query(coords, level, with_parents=True).pidx
    col0 = grid.base_lod
    n = lod_idx + 1
    args = (coords, pidx, col0, grid.trinkets[:n], [f.detach() for f in grid.features[:n]],
            grid.active_lods[:n], multiscale)
    before = kernels.LAUNCHES["octree_interp"]
    got = octree_interp(*args)
    want = octree_interp_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_interp"] == before + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6
    assert bool((want == 0).all(dim=-1).any()) and bool((want != 0).any())
    with torch.no_grad():
        assert torch.equal(grid.interpolate(coords, lod_idx), got)
