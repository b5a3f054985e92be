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
                                           scatter_back_bwd_many,
                                           scatter_back_bwd_many_plain, scatter_back_bwd_plain,
                                           scatter_back_many, scatter_back_many_plain,
                                           scatter_back_plain)
from wisp_tpu_torch.ops.density_grid import (scatter_max, scatter_max_points,
                                             scatter_max_points_plain)
from wisp_tpu_torch.ops.integration import (integrate, integrate_bwd, integrate_bwd_plain,
                                            integrate_plain, integrate_segment,
                                            integrate_segment_bwd,
                                            integrate_segment_bwd_plain,
                                            integrate_segment_plain)

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


def _stoch_inputs(dev, n, dim, seed):
    resolutions = [4, 8, 16, 32, 64]
    sizes, first, g = _table(dim, resolutions, 10, seed)
    coords = (torch.rand(n, dim, generator=g) * 2.1 - 1.05).to(dev)
    grad_out = torch.randn(n, 5 * 2, generator=g).to(dev)
    u0 = torch.rand(n, generator=g).to(dev)
    return resolutions, sizes, first, coords, grad_out, u0


@pytest.mark.parametrize("n,dim,mask", [
    (4000, 3, (True,) * 5), (3000, 2, (True,) * 5),
    (4000, 3, (False, True, False, True, True)), (0, 3, (True,) * 5)])
def test_hashgrid_bwd_stoch_kernel(dev, n, dim, mask):
    """With injected uniforms the kernel draws the plain version's corners: equal to 1e-5 of
    the largest entry (atomics) outside the rows of draws that sit within 4 ulps of a
    cumulative boundary, where a flip is allowed and counted exactly (a unit cotangent makes
    each row the count of its draws); a mixed LOD set (exact and stochastic) in one launch."""
    resolutions, sizes, first, coords, grad_out, u0 = _stoch_inputs(dev, n, dim, 7)
    args = (resolutions, 10, 4, first[-1], first, sizes)
    before = dict(kernels.LAUNCHES)
    got = grid_ops.hashgrid_bwd(coords, grad_out, *args, out_lods=5, stoch_mask=mask, u0=u0)
    want = grid_ops.hashgrid_bwd_plain(coords, grad_out, *args, out_lods=5, stoch_mask=mask,
                                       u0=u0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_bwd_stoch"] == before["hashgrid_bwd_stoch"] + (n > 0)
    assert kernels.LAUNCHES["hashgrid_bwd"] == before["hashgrid_bwd"]
    tie_rows, ties = grid_ops.stoch_tie_rows(coords, resolutions, 10, 4, first, mask, u0)
    scale = max(1.0, want.abs().max().item())
    bad = ((got - want).abs() > 1e-5 * scale).any(dim=1)
    outside = bad.clone()
    outside[tie_rows.to(dev)] = False
    assert not outside.any()
    assert int(bad.sum()) <= 2 * ties
    ones = torch.cat([torch.full((n, 2), float(m), device=dev) for m in mask], dim=1)
    moved = (grid_ops.hashgrid_bwd(coords, ones, *args, out_lods=5, stoch_mask=mask, u0=u0)
             - grid_ops.hashgrid_bwd_plain(coords, ones, *args, out_lods=5, stoch_mask=mask,
                                           u0=u0))[:, 0]
    moved[tie_rows.to(dev)] = 0.0
    assert not moved.any()


def test_hashgrid_stoch_autograd_and_hash(dev):
    """Autograd through ``hashgrid(stoch_grad=True)`` launches the stochastic backward once
    (the exact one where the rule keeps every LOD exact); the kernel's own sin hash
    (``u0_out``) is uniform; the mean of 256 draws approaches the exact gradient."""
    resolutions, sizes, first, coords, grad_out, _ = _stoch_inputs(dev, 20000, 3, 8)
    table = torch.zeros(first[-1], 2, device=dev, requires_grad=True)
    before = dict(kernels.LAUNCHES)
    out = grid_ops.hashgrid(coords, resolutions, 10, 4, table, first, sizes, out_lods=5,
                            stoch_grad=True, dense_lod_matmul="bf16")
    (out * grad_out).sum().backward()
    assert kernels.LAUNCHES["hashgrid_bwd_stoch"] == before["hashgrid_bwd_stoch"] + 1
    out = grid_ops.hashgrid(coords, resolutions[:2], 10, 1, table, first, sizes[:2],
                            stoch_grad=True, dense_lod_matmul="bf16")
    out.sum().backward()   # res 4 and 8 are dense at bitwidth 10: the exact backward
    assert kernels.LAUNCHES["hashgrid_bwd"] == before["hashgrid_bwd"] + 1
    mask = (True,) * 5
    u0 = torch.empty(coords.shape[0], device=dev)
    grid_ops.hashgrid_bwd(coords, grad_out, resolutions, 10, 4, first[-1], first, sizes,
                          out_lods=5, stoch_mask=mask, u0_out=u0)
    s = torch.sort(u0.double()).values
    n = s.numel()
    ks = max((torch.arange(1, n + 1, device=dev) / n - s).max().item(),
             (s - torch.arange(n, device=dev) / n).max().item())
    assert abs(s.mean().item() - 0.5) < 0.01 and ks < 0.02
    exact = grid_ops.hashgrid_bwd(coords, grad_out, resolutions, 10, 4, first[-1], first,
                                  sizes, out_lods=5)
    spread = grid_ops.hashgrid_bwd(coords, grad_out ** 2, resolutions, 10, 4, first[-1], first,
                                   sizes, out_lods=5).sqrt()
    g = torch.Generator(device=dev).manual_seed(0)
    mean = torch.zeros_like(exact)
    for _ in range(256):
        u = torch.rand(coords.shape[0], generator=g, device=dev)
        mean += grid_ops.hashgrid_bwd(coords, grad_out, resolutions, 10, 4, first[-1], first,
                                      sizes, out_lods=5, stoch_mask=mask, u0=u)
    mean /= 256
    touched = spread > 0
    z = (mean - exact)[touched] / (spread[touched] / 16.0)
    assert (z ** 2).mean().item() <= 1.0 and (z.abs() > 4.0).float().mean().item() < 1e-3


@pytest.mark.parametrize("frac,budget", [(0.05, 128 * 40), (0.5, 128 * 40), (0.5, 128)])
def test_scatter_back_bwd_kernel(dev, frac, budget):
    g = torch.Generator(device="cpu").manual_seed(7)
    mask = (torch.rand(300, 130, generator=g) < frac).to(dev)
    samples = torch.randn(300, 130, 3, generator=g).to(dev)
    dirs = torch.randn(300, 3, generator=g).to(dev)
    idx, _, _, count = compact(mask, samples, dirs, budget)
    kept = min(int(count), budget)
    grad_out = torch.randn(300 * 130, 3, generator=g).to(dev)
    before = kernels.LAUNCHES["scatter_back_bwd"]
    got = scatter_back_bwd_many([grad_out], idx, kept)[0]
    assert kernels.LAUNCHES["scatter_back_bwd"] == before + (1 if kept else 0)
    want = scatter_back_bwd_plain(grad_out, idx, kept)
    assert torch.equal(got, want)
    v = torch.randn(kept, 3, generator=g).to(dev).requires_grad_(True)
    (scatter_back(v, idx, 300 * 130) * grad_out).sum().backward()
    assert torch.equal(v.grad, want)
    assert scatter_back_bwd_many([grad_out], idx, 0)[0].shape == (0, 3)


def _slots_with_empties(dev, g, total, budget, kept, empty):
    """``budget`` slots: ``kept`` distinct sample indices, ``empty`` of them set to total
    (an empty slot), the rest total too."""
    idx = torch.full((budget,), total, dtype=torch.int64)
    idx[:kept] = torch.randperm(total, generator=g)[:kept]
    idx[kept - empty:kept] = total
    return idx.to(dev)


@pytest.mark.parametrize("kept,empty", [(0, 0), (1, 0), (5000, 0), (5000, 700),
                                        (200000, 3)])
def test_scatter_back_many_kernel(dev, kept, empty):
    """Colour [K, 3] and flat density [K] on one idx: the forward per channel, the backward
    one launch, both equal to the plain version and to autograd of it, with empty slots."""
    g = torch.Generator(device="cpu").manual_seed(31 + kept + empty)
    total = max(2 * kept, 64)
    idx = _slots_with_empties(dev, g, total, kept + 128, kept, empty)
    color = torch.randn(kept, 3, generator=g).to(dev)
    dens = torch.randn(kept, generator=g).to(dev)
    g_col = torch.randn(total, 3, generator=g).to(dev)
    g_den = torch.randn(total, generator=g).to(dev)
    c, d = color.clone().requires_grad_(True), dens.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    oc, od = scatter_back_many(idx, total, c, d)
    assert kernels.LAUNCHES["scatter_back"] == before["scatter_back"] + 2
    assert od.shape == (total,)
    (oc * g_col).sum().add((od * g_den).sum()).backward()
    assert kernels.LAUNCHES["scatter_back_bwd"] == before["scatter_back_bwd"] + (kept > 0)
    pc, pd = color.clone().requires_grad_(True), dens.clone().requires_grad_(True)
    wc, wd = scatter_back_many_plain(idx, total, pc, pd)
    (wc * g_col).sum().add((wd * g_den).sum()).backward()
    assert torch.equal(oc, wc) and torch.equal(od, wd)
    assert torch.equal(c.grad, pc.grad) and torch.equal(d.grad, pd.grad)
    got = scatter_back_bwd_many([g_col, g_den], idx, kept)
    want = scatter_back_bwd_many_plain([g_col, g_den], idx, kept)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _gather_launches(widths):
    """Launches of scatter_back_bwd_many: channels split into entries of at most 32 columns,
    packed in order, at most 8 entries and 32 columns a launch."""
    launches, n, cols = 1, 0, 0
    for w in widths:
        for part in [min(32, w - c) for c in range(0, w, 32)]:
            if n == 8 or cols + part > 32:
                launches, n, cols = launches + 1, 0, 0
            n, cols = n + 1, cols + part
    return launches


@pytest.mark.parametrize("widths", [(1,), (4,), (7,), (40,), (3, 1, 12, 2, 5, 8, 1, 2, 3),
                                    (1,) * 9])
def test_scatter_back_bwd_many_kernel_widths(dev, widths):
    """Channels of 1-40 columns (wider than 32 take several entries; more than 8 entries or
    32 columns take another launch), each gathered exactly."""
    g = torch.Generator(device="cpu").manual_seed(sum(widths))
    total, kept = 3000, 1200
    idx = _slots_with_empties(dev, g, total, 1500, kept, 40)
    grads = [torch.randn(total, w, generator=g).to(dev) for w in widths]
    before = kernels.LAUNCHES["scatter_back_bwd"]
    got = scatter_back_bwd_many(grads, idx, kept)
    assert kernels.LAUNCHES["scatter_back_bwd"] == before + _gather_launches(widths)
    want = scatter_back_bwd_many_plain(grads, idx, kept)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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


@pytest.mark.parametrize("r,s,ce,with_depth", [(200, 77, 5, False), (64, 512, 16, True),
                                                (33, 40, 1, True), (0, 40, 3, False)])
def test_integrate_bwd_kernel_with_extra(dev, r, s, ce, with_depth):
    """K4's backward with extra columns (extra = alpha * sum w*f): the gradients of density,
    colour and the columns within 1e-5 of the largest entry of autograd through the plain
    version (float32 sums in another order); through ``integrate``'s autograd too, where a
    loss on the extra output reaches density, colour and the columns in one launch."""
    g = torch.Generator(device="cpu").manual_seed(9 + ce)
    density = (torch.rand(r, s, generator=g) * 20).to(dev)
    deltas = (torch.rand(r, 1, generator=g) * 0.02).to(dev)
    depths = torch.rand(r, s, generator=g).cumsum(-1).to(dev)
    mask = (torch.rand(r, s, generator=g) < 0.5).to(dev)
    color = torch.rand(r, s, 3, generator=g).to(dev)
    extra = torch.randn(r, s, ce, generator=g).to(dev)
    g_rgb = torch.randn(r, 3, generator=g).to(dev)
    g_alpha = torch.randn(r, 1, generator=g).to(dev)
    g_depth = torch.randn(r, 1, generator=g).to(dev) if with_depth else None
    g_extra = torch.randn(r, ce, generator=g).to(dev)
    bg = (1.0, 0.5, 0.0)
    got = integrate_bwd(density, deltas, depths, mask, color, bg, g_rgb, g_alpha, g_depth,
                        extra, g_extra)
    want = integrate_bwd_plain(density, deltas, depths, mask, color, bg, g_rgb, g_alpha,
                               g_depth, extra, g_extra)
    assert [t.shape for t in got] == [(r, s), (r, s, 3), (r, s, ce)]
    for a, b in zip(got, want):
        if r:
            assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
    d, c, e = (t.clone().requires_grad_(True) for t in (density, color, extra))
    before = kernels.LAUNCHES["integrate_bwd"]
    out = integrate(d, deltas, depths, mask, c, bg, extra=e, with_depth=with_depth)
    loss = (out["rgb"] * g_rgb).sum() + (out["alpha"] * g_alpha).sum() \
        + (out["extra"] * g_extra).sum()
    if with_depth:
        loss = loss + (out["depth"] * g_depth).sum()
    loss.backward()
    assert kernels.LAUNCHES["integrate_bwd"] == before + 1
    if r:
        for t, b in zip((d, c, e), want):
            assert (t.grad - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())


def _feedback_samples(dev, k, level, seed):
    """k points in [-1.2, 1.2]^3, a quarter on exact cell faces, relu'd densities (the
    field's density column: a [k, 16] buffer's column 0) and a mask."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    res = 2 ** level
    pts = torch.rand(k, 3, generator=g) * 2.4 - 1.2
    faces = -1.0 + 2.0 * torch.randint(0, res + 1, (k // 4, 3), generator=g).float() / res
    pts[:k // 4] = faces
    feats = torch.randn(k, 16, generator=g) * 3.0
    keep = torch.rand(k, generator=g) < 0.7
    return pts.to(dev), torch.relu(feats).to(dev), keep.to(dev)


def _grid_equal(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0),
                                                              b.nan_to_num(0.0))


@pytest.mark.parametrize("k,level", [(0, 7), (50, 3), (200000, 7), (125000, 7)])
@pytest.mark.parametrize("dtype,masked", [(torch.float32, False), (torch.float32, True),
                                          (torch.bfloat16, False)])
def test_scatter_max_kernel(dev, k, level, dtype, masked):
    """K5 with the cell lookup: points to cells, the mask and the max in one launch, equal
    to the plain version (cell_ids and scatter_max_plain); densities read at their stride
    (the field's column) in float32 or bfloat16."""
    pts, feats, keep = _feedback_samples(dev, k, level, 9 + k)
    dens = feats.to(dtype)[:, 0]                       # stride 16
    keep = keep if masked else None
    before = kernels.LAUNCHES["scatter_max"]
    got = scatter_max_points(pts, dens, level, keep=keep)
    assert kernels.LAUNCHES["scatter_max"] == before + (1 if k else 0)
    want = scatter_max_points_plain(pts, dens, level, keep=keep)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        scatter_max(torch.zeros(k, dtype=torch.int64, device=dev), dens.float(), 8 ** level)


def test_scatter_max_kernel_propagates_nan(dev):
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.12, 0.1, 0.1], [-0.5, 0.5, 0.9]], device=dev)
    vals = torch.tensor([1.0, float("nan"), 2.0], device=dev)
    got = scatter_max_points(pts, vals, 3)
    want = scatter_max_points_plain(pts.cpu(), vals.cpu(), 3)
    assert _grid_equal(got.cpu(), want)
    assert int(torch.isnan(got).sum()) == 1 and float(got.nan_to_num(0.0).max()) == 2.0


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
    got = octree_query(coords, blas.query_routes, 5, with_parents)
    want = octree_query_plain(coords, blas.query_routes, 5, with_parents)
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


@pytest.mark.parametrize("multiscale,lod_idx", [("sum", 2), ("cat", 2), ("sum", 0)])
def test_octree_interp_bwd_kernel(dev, multiscale, lod_idx):
    """K15 backward against autograd of the plain forward, to 1e-5 of the largest entry
    (the atomics add in no fixed order)."""
    from wisp_tpu_torch.models.grids.octree_grid import (OctreeGrid, octree_interp_bwd,
                                                         octree_interp_plain)
    blas = _sphere_octree(5, dev)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, multiscale_type=multiscale,
                      feature_std=0.5, generator=torch.Generator().manual_seed(18),
                      device=dev)
    g = torch.Generator(device="cpu").manual_seed(19)
    coords = (torch.rand(4000, 3, generator=g) * 2.1 - 1.05).to(dev)
    n = lod_idx + 1
    level = grid.active_lods[lod_idx]
    pidx = blas.query(coords, level, with_parents=True).pidx
    width = 16 * n if multiscale == "cat" else 16
    cot = torch.randn(4000, width, generator=g).to(dev)
    feats = [f.detach().clone().requires_grad_(True) for f in grid.features[:n]]
    out = octree_interp_plain(coords, pidx, grid.base_lod, grid.trinkets[:n], feats,
                              grid.active_lods[:n], multiscale)
    want = torch.autograd.grad(out, feats, cot)
    before = kernels.LAUNCHES["octree_interp_bwd"]
    got = octree_interp_bwd(coords, pidx, grid.base_lod, grid.trinkets[:n],
                            [f.shape[0] for f in feats], 16, grid.active_lods[:n], multiscale,
                            cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_interp_bwd"] == before + 1
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-5 * scale
    # and through OctreeGrid.interpolate's autograd route: one forward (the query folded
    # in: no K9 launch), one backward launch
    before = dict(kernels.LAUNCHES)
    grid.interpolate(coords, lod_idx).backward(cot)
    assert kernels.LAUNCHES["octree_query_interp"] == before["octree_query_interp"] + 1
    assert kernels.LAUNCHES["octree_query"] == before["octree_query"]
    assert kernels.LAUNCHES["octree_interp_bwd"] == before["octree_interp_bwd"] + 1
    for f, b in zip(grid.features, want):
        assert float((f.grad - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with pytest.raises(NotImplementedError, match="coordinates"):
        grid.interpolate(coords.clone().requires_grad_(True), lod_idx)


def winding_number(v, f, pts):
    """Generalized winding number (Van Oosterom-Strackee solid angles, float64): > 0.5
    inside a watertight mesh."""
    v = np.asarray(v, np.float64)
    pts = np.asarray(pts, np.float64)
    a = v[f[:, 0]][None] - pts[:, None]
    b = v[f[:, 1]][None] - pts[:, None]
    c = v[f[:, 2]][None] - pts[:, None]
    la, lb, lc = (np.linalg.norm(x, axis=-1) for x in (a, b, c))
    num = np.sum(a * np.cross(b, c), axis=-1)
    den = (la * lb * lc + np.sum(a * b, -1) * lc + np.sum(a * c, -1) * lb
           + np.sum(b * c, -1) * la)
    return np.sum(2.0 * np.arctan2(num, den), axis=-1) / (4.0 * np.pi)


def _l_prism():
    outline = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], np.float32)
    n = len(outline)
    bot = np.concatenate([outline, np.full((n, 1), -0.5, np.float32)], -1)
    top = np.concatenate([outline, np.full((n, 1), 0.5, np.float32)], -1)
    cap = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 5]], np.int32)
    sides = []
    for i in range(n):
        j = (i + 1) % n
        sides += [[i, j, j + n], [i, j + n, i + n]]
    return (np.concatenate([bot, top], 0),
            np.concatenate([cap[:, ::-1], cap + n, np.asarray(sides, np.int32)], 0))


def _bipyramid(sides=16, radius=0.6, height=0.5):
    """A closed bipyramid: a regular ``sides``-gon in z = 0 and two apexes at z = +-height
    of valence ``sides``, where K16's candidate list overflows; 2 * sides triangles."""
    ang = 2.0 * np.pi * np.arange(sides) / sides
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(sides)], -1)
    v = np.concatenate([ring, [[0.0, 0.0, height], [0.0, 0.0, -height]]]).astype(np.float32)
    f = []
    for k in range(sides):
        j = (k + 1) % sides
        f += [[k, j, sides], [j, k, sides + 1]]
    return v, np.asarray(f, np.int32)


def _mesh_cases():
    """(mesh, points): the icosphere of the SDF path with points near and far, and the
    hard meshes (a cube's corners and edges, a thin slab's midplane, an L-prism's concave
    edge, a bipyramid's apexes of valence 16 and its axis) with their queries and points
    around them."""
    from wisp_tpu_torch.ops.mesh.io import make_box_mesh, make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import normalize
    rng = np.random.default_rng(20)
    v, f = normalize(*make_sphere_mesh(1.0, subdivisions=3), "sphere")
    base = v[rng.integers(0, len(v), 3000)]
    sphere_pts = np.concatenate([base + rng.normal(scale=0.02, size=base.shape),
                                 rng.uniform(-1.0, 1.0, (3000, 3))])
    cases = [("icosphere", (v, f), sphere_pts)]
    for name, mesh, pts, lo, hi in (
            ("cube", make_box_mesh((0.5, 0.5, 0.5)),
             [[0.6, 0.6, 0.6], [0.55, 0.55, 0.0], [0.49, 0.49, 0.0], [0.0, 0.0, 0.0]],
             -0.8, 0.8),
            ("slab", make_box_mesh((1.0, 1.0, 0.02)),
             [[0.0, 0.0, 0.0], [0.5, -0.3, 0.0], [1.001, 0.0, 0.0], [0.999, 0.999, 0.0]],
             -1.2, 1.2),
            ("l_prism", _l_prism(),
             [[1.05, 1.05, 0.0], [0.95, 0.95, 0.0], [1.05, 1.05, 0.49]], -0.3, 2.3),
            ("bipyramid", _bipyramid(),
             np.concatenate([[[0.0, 0.0, 0.0], [0.0, 0.0, 0.55], [0.0, 0.0, -0.52]],
                             [0.0, 0.0, 0.5] + rng.normal(scale=0.02, size=(200, 3)),
                             [0.0, 0.0, -0.5] + rng.normal(scale=0.02, size=(200, 3))]),
             -0.8, 0.8)):
        cases.append((name, mesh, np.concatenate([pts, rng.uniform(lo, hi, (2000, 3))])))
    return [(name, mesh, p.astype(np.float32)) for name, mesh, p in cases]


def _assert_sdf_kernel(got, want):
    """K16's contract: the distance to 1e-5, a sign flip only where |d| < 1e-5."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    flip = (got < 0) != (want < 0)
    assert (np.abs(want[flip]) < 1e-5).all()
    assert np.abs(np.abs(got) - np.abs(want)).max() <= 1e-5
    assert np.abs(got[~flip] - want[~flip]).max() <= 1e-5


def _band_sizes(x, tris):
    """The triangles in each point's band, from the plain arithmetic."""
    from wisp_tpu_torch.ops.mesh.ops import closest_point_on_triangle, dot3
    e = x[:, None] - closest_point_on_triangle(x[:, None], tris[None, :, 0:3],
                                               tris[None, :, 3:6], tris[None, :, 6:9])
    d2 = dot3(e, e)
    d2min = d2.amin(dim=1)
    return (d2 <= (d2min + (1e-8 + 1e-4 * d2min))[:, None]).sum(dim=1)


@pytest.mark.parametrize("case", _mesh_cases(), ids=lambda c: c[0])
def test_mesh_sdf_kernel(dev, case):
    """K16 against its plain version: the distance to 1e-5, a sign flip only where
    |d| < 1e-5; and the signs against the winding-number oracle where |d| >= 1e-5. The
    bipyramid's bands overflow the kernel's candidate list."""
    from wisp_tpu_torch.ops.mesh.compute_sdf import (MESH_SDF_CANDIDATES, compute_sdf,
                                                     compute_sdf_plain, triangle_table)
    name, (v, f), pts = case
    x = torch.from_numpy(pts).to(dev)
    before = kernels.LAUNCHES["mesh_sdf"]
    got = compute_sdf(v, f, x)
    want = compute_sdf_plain(v, f, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mesh_sdf"] == before + 1
    _assert_sdf_kernel(got, want)
    got = got.cpu().numpy()
    far = np.abs(got) >= 1e-5
    inside = winding_number(v, f, pts[far]) > 0.5
    np.testing.assert_array_equal(got[far] < 0, inside)
    assert inside.any() and not inside.all()
    if name == "bipyramid":
        sizes = _band_sizes(x, triangle_table(v, f, dev))
        assert int((sizes > MESH_SDF_CANDIDATES).sum()) > 0


@pytest.mark.parametrize("rays", [300, 5000])
@pytest.mark.parametrize("branch,budget,early_stop", [
    ("density", 1024, 0.0), ("density", 48, 0.0), ("occ", 1024, 0.0), ("occ", 48, 0.0),
    ("dense", 1024, 0.0), ("dense", 48, 0.0), ("cull", 1024, 0.01), ("cull", 48, 0.01)])
def test_raymarch_voxel_kernel(dev, rays, branch, budget, early_stop):
    """K7 against its plain version, exactly, with and without a budget that overflows,
    at level 4 segments on a level-6 octree (29 coarse segments, 16 samples a voxel)."""
    from wisp_tpu_torch.accelstructs.octree_as import (raymarch_voxel, raymarch_voxel_plain,
                                                       voxel_slots)
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(rays, seed=21))
    blas = _sphere_octree(6, dev)
    occ = field = None
    if branch == "occ":
        occ = blas.occ_grid
    elif branch == "density":
        field = blas.cell_density
    elif branch == "cull":
        rng = np.random.default_rng(22)
        dens = np.where(blas.occ_grid.cpu().numpy(), rng.random(8 ** 6) * 20.0, -1.0)
        field = torch.from_numpy(dens.astype(np.float32)).to(dev)
    s, level = 16, 4
    k = voxel_slots(s, budget, level)
    jitter = torch.rand((rays, k, s), generator=torch.Generator().manual_seed(23)).to(dev)
    for u in (None, jitter):
        before = kernels.LAUNCHES["raymarch_voxel"]
        got = raymarch_voxel(o, d, 0.0, 8.0, s, level, budget, occ, field, 6, u, early_stop)
        want = raymarch_voxel_plain(o, d, 0.0, 8.0, s, level, budget, occ, field, 6, u,
                                    early_stop)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["raymarch_voxel"] == before + 1
        assert torch.equal(got.mask, want.mask)
        assert torch.equal(got.depth_samples, want.depth_samples)
        assert torch.equal(got.samples, want.samples)
        assert torch.equal(got.deltas, want.deltas)
        assert float(got.num_overflow) == float(want.num_overflow)
        assert (float(want.num_overflow) > 0) == (budget < 1024)
        if field is None:
            assert got.cell_density is None
        else:
            assert torch.equal(got.cell_density, want.cell_density)
        assert bool(want.mask.any()) and not bool(want.mask.all())


@pytest.mark.parametrize("backward", [False, True])
def test_octree_interp_kernel_f5(dev, backward):
    """K15 forward and backward at the octree NeRF's width: F = 5, four LODs, 'sum'."""
    from wisp_tpu_torch.models.grids.octree_grid import (OctreeGrid, octree_interp,
                                                         octree_interp_bwd,
                                                         octree_interp_plain)
    blas = _sphere_octree(6, dev)
    grid = OctreeGrid(blas=blas, feature_dim=5, num_lods=4, multiscale_type="sum",
                      feature_std=0.5, generator=torch.Generator().manual_seed(24),
                      device=dev)
    g = torch.Generator(device="cpu").manual_seed(25)
    coords = (torch.rand(6000, 3, generator=g) * 2.1 - 1.05).to(dev)
    pidx = blas.query(coords, grid.active_lods[-1], with_parents=True).pidx
    feats = [f.detach() for f in grid.features]
    if not backward:
        got = octree_interp(coords, pidx, grid.base_lod, grid.trinkets, feats,
                            grid.active_lods, "sum")
        want = octree_interp_plain(coords, pidx, grid.base_lod, grid.trinkets, feats,
                                   grid.active_lods, "sum")
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-6
        assert bool((want != 0).any())
        return
    cot = torch.randn(6000, 5, generator=g).to(dev)
    leaves = [f.clone().requires_grad_(True) for f in feats]
    out = octree_interp_plain(coords, pidx, grid.base_lod, grid.trinkets, leaves,
                              grid.active_lods, "sum")
    want = torch.autograd.grad(out, leaves, cot)
    got = octree_interp_bwd(coords, pidx, grid.base_lod, grid.trinkets,
                            [f.shape[0] for f in feats], 5, grid.active_lods, "sum", cot)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-5 * scale


# -- the segmented cull (K6a, K6b, K6c) and K5 accumulated ------------------------------------

@pytest.mark.parametrize("frac,budget", [(0.5, 128 * 40), (0.5, 128), (0.05, 128 * 40)])
def test_compact_live_kernel(dev, frac, budget):
    g = torch.Generator(device="cpu").manual_seed(12)
    r, s = 300, 130
    mask = (torch.rand(r, s, generator=g) < frac).to(dev)
    samples = torch.randn(r, s, 3, generator=g).to(dev)
    dirs = torch.randn(r, 3, generator=g).to(dev)
    acc_tau = (torch.rand(r, generator=g) * 12.0).to(dev)
    tau_cap = float(np.float32(-np.log(1e-3)))
    acc_tau[:5] = tau_cap                   # at the cap: culled (T = eps is not live)
    before = kernels.LAUNCHES["compact_live"]
    got = compact(mask, samples, dirs, budget, acc_tau, tau_cap)
    want = compact_plain(mask, samples, dirs, budget, acc_tau, tau_cap)
    assert kernels.LAUNCHES["compact_live"] == before + 1
    assert torch.equal(got[3], want[3])
    live = int((mask & (acc_tau < tau_cap)[:, None]).sum())
    assert int(got[3]) == live < int(mask.sum())
    kept = min(live, budget)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a[:kept], b[:kept])


def _segment_inputs(dev, r, s, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    density = (torch.rand(r, s, generator=g) * 20).to(dev)
    deltas = (torch.rand(r, 1, generator=g) * 0.02).to(dev)
    depths = torch.rand(r, s, generator=g).cumsum(-1).to(dev)
    mask = (torch.rand(r, s, generator=g) < 0.5).to(dev)
    color = torch.rand(r, s, 3, generator=g).to(dev)
    acc_tau = (torch.rand(r, generator=g) * 3.0).to(dev)
    return g, density, deltas, depths, mask, color, acc_tau


@pytest.mark.parametrize("r,s,with_extra", [(200, 77, False), (64, 128, True), (0, 40, False)])
def test_integrate_segment_kernel(dev, r, s, with_extra):
    g, density, deltas, depths, mask, color, acc_tau = _segment_inputs(dev, r, s, 13)
    extra = torch.rand(r, s, 5, generator=g).to(dev) if with_extra else None
    before = kernels.LAUNCHES["integrate_seg_fwd"]
    got = integrate_segment(density, deltas, depths, mask, color, acc_tau, extra=extra)
    want = integrate_segment_plain(density, deltas, depths, mask, color, acc_tau,
                                   extra=extra)
    assert kernels.LAUNCHES["integrate_seg_fwd"] == before + 1
    assert set(got) == set(want)
    for k in got:
        if r:
            tol = 1e-5 * max(1.0, want[k].abs().max().item()) if k == "acc_tau" else 1e-4
            assert (got[k] - want[k]).abs().max().item() <= tol, k


@pytest.mark.parametrize("r,s,with_depth,with_acc", [(200, 77, False, True),
                                                     (64, 128, True, False),
                                                     (0, 40, False, True)])
def test_integrate_segment_bwd_kernel(dev, r, s, with_depth, with_acc):
    g, density, deltas, depths, mask, color, acc_tau = _segment_inputs(dev, r, s, 14)
    g_rgb = torch.randn(r, 3, generator=g).to(dev)
    g_alpha = torch.randn(r, 1, generator=g).to(dev)
    g_depth = torch.randn(r, 1, generator=g).to(dev) if with_depth else None
    g_acc = torch.randn(r, generator=g).to(dev) if with_acc else None
    got = integrate_segment_bwd(density, deltas, depths, mask, color, acc_tau, g_rgb,
                                g_alpha, g_depth, g_acc)
    want = integrate_segment_bwd_plain(density, deltas, depths, mask, color, acc_tau, g_rgb,
                                       g_alpha, g_depth, g_acc)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if r:
            assert (a - b).abs().max().item() <= 1e-5 * max(1e-30, b.abs().max().item())
    # autograd through the forward launches the backward kernel, the carry's gradient too
    d = density.clone().requires_grad_(True)
    c = color.clone().requires_grad_(True)
    a = acc_tau.clone().requires_grad_(True)
    before = kernels.LAUNCHES["integrate_seg_bwd"]
    out = integrate_segment(d, deltas, depths, mask, c, a, with_depth=with_depth)
    loss = (out["rgb"] * g_rgb).sum() + (out["alpha"] * g_alpha).sum()
    if with_depth:
        loss = loss + (out["depth"] * g_depth).sum()
    if with_acc:
        loss = loss + (out["acc_tau"] * g_acc).sum()
    loss.backward()
    assert kernels.LAUNCHES["integrate_seg_bwd"] == before + 1
    if r:
        for got_, want_ in ((d.grad, want[0]), (a.grad, want[2])):
            assert (got_ - want_).abs().max().item() <= \
                1e-5 * max(1e-30, want_.abs().max().item())


@pytest.mark.parametrize("k", [0, 50, 27660, 200000])
def test_scatter_max_accumulated_kernel(dev, k):
    """K5 into a carried grid: 4 calls (the segments of one trace), each equal to the plain
    version, a NaN among the densities of the last."""
    g = torch.Generator(device="cpu").manual_seed(15)
    start = torch.relu(torch.randn(8 ** 7, generator=g)).to(dev)
    got, want = start.clone(), start.clone()
    before = kernels.LAUNCHES["scatter_max_acc"]
    for seg in range(4):
        pts, feats, _ = _feedback_samples(dev, k, 7, 40 + seg)
        dens = feats[:, 0]
        if seg == 3 and k:
            dens = dens.clone()
            dens[k // 2] = float("nan")
        out = scatter_max_points(pts, dens, 7, out=got)
        scatter_max_points_plain(pts, dens, 7, out=want)
        assert out is got and _grid_equal(got, want)
    assert kernels.LAUNCHES["scatter_max_acc"] == before + (4 if k else 0)


# -- K9's search, dense and bitfield routes, K12's compaction, K17 ---------------------------

def _query_coords(dev, n=6000, seed=13):
    g = torch.Generator(device="cpu").manual_seed(seed)
    coords = torch.rand(n, 3, generator=g) * 2.2 - 1.1
    coords[:50] = torch.tensor([1.0, -1.0, 0.3])              # on the faces: inside
    # points on the shell, where the level-8 cells are occupied
    shell = torch.randn(n // 2, 3, generator=g)
    coords[50:50 + n // 2] = 0.6 * shell / shell.norm(dim=-1, keepdim=True)
    return coords.to(dev)


@pytest.mark.parametrize("with_parents", [False, True])
def test_octree_query_search_kernel(dev, with_parents):
    """K9 at level 8: the maps below, the binary search at level 8 (counted apart)."""
    from wisp_tpu_torch.accelstructs.octree_as import octree_query, octree_query_plain
    blas = _sphere_octree(8, dev)
    assert blas.query_routes[8].kind == "search" and blas.query_routes[7].kind == "map"
    coords = _query_coords(dev)
    before = kernels.LAUNCHES["octree_query_search"]
    got = octree_query(coords, blas.query_routes, 8, with_parents)
    want = octree_query_plain(coords, blas.query_routes, 8, with_parents)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_query_search"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    last = got[:, -1] if with_parents else got
    assert (last >= 0).sum() > 500 and (last < 0).any()


@pytest.mark.parametrize("kind", ["dense", "bitfield"])
def test_octree_query_dense_bitfield_kernel(dev, kind):
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS, octree_query, octree_query_plain
    blas = OctreeAS.make_dense(5, device=dev)
    with_parents = kind == "dense"
    if kind == "bitfield":
        g = torch.Generator(device="cpu").manual_seed(14)
        blas = blas.update_occupancy((torch.rand(8 ** 5, generator=g) < 0.4).to(dev))
    coords = _query_coords(dev)
    before = kernels.LAUNCHES["octree_query"]
    got = octree_query(coords, blas.query_routes, 5, with_parents)
    want = octree_query_plain(coords, blas.query_routes, 5, with_parents)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_query"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("r,frac,budget", [(5000, 0.3, 3000), (5000, 0.3, 700),
                                            (70000, 0.5, 38500), (1, 1.0, 3)])
def test_compact_rays_kernel(dev, r, frac, budget):
    """K12's compaction: every slot (kept, then JAX's fill) equal to the plain version."""
    from wisp_tpu_torch.ops.compaction import compact_rays, compact_rays_plain
    g = torch.Generator(device="cpu").manual_seed(15)
    mask = (torch.rand(r, generator=g) < frac).to(dev)
    o, d = torch.randn(r, 3, generator=g).to(dev), torch.randn(r, 3, generator=g).to(dev)
    t, tf = torch.rand(r, generator=g).to(dev), torch.rand(r, generator=g).to(dev)
    for mid in (False, True):
        counter = "compact_rays_mid" if mid else "compact_rays"
        before = kernels.LAUNCHES[counter]
        got = compact_rays(mask, budget, o, d, t, tf, mid=mid)
        want = compact_rays_plain(mask, budget, o, d, t, tf)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[counter] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 3), (torch.float32, 1),
                                         (torch.bool, 1), (torch.bfloat16, 3)])
def test_scatter_rows_kernel(dev, dtype, width):
    from wisp_tpu_torch.ops.compaction import compact_rays_plain, scatter_rows, scatter_rows_plain
    g = torch.Generator(device="cpu").manual_seed(16)
    r, budget = 4000, 1500
    mask = (torch.rand(r, generator=g) < 0.3).to(dev)
    z = torch.zeros(r, 3, device=dev)
    idx = compact_rays_plain(mask, budget, z, z, z[:, 0], z[:, 0])[0]
    v = (torch.rand(budget, width, generator=g) < 0.5) if dtype == torch.bool \
        else torch.randn(budget, width, generator=g).to(dtype)
    base = (torch.rand(r, width, generator=g) < 0.5) if dtype == torch.bool \
        else torch.randn(r, width, generator=g).to(dtype)
    v, base = v.to(dev), base.to(dev)
    if width == 1:
        v, base = v[:, 0].contiguous(), base[:, 0].contiguous()
    before = kernels.LAUNCHES["scatter_rays"]
    got = scatter_rows(v, idx, base.clone())
    want = scatter_rows_plain(v, idx, base.clone())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_rays"] == before + 1
    assert torch.equal(got, want) and not torch.equal(got, base)


def _assert_closest_kernel(x, tris, got, want):
    """K17's contract: the triangle equal except where two triangles tie within 2 ulp of
    d2, distance and point within 1e-6."""
    from wisp_tpu_torch.ops.mesh.ops import closest_point_on_triangle, dot3
    (dk, nk, tk), (dp, np_, tp) = got, want
    assert tk.dtype == torch.int64 and nk.shape == (x.shape[0], 3)
    assert float((dk - dp).abs().max()) <= 1e-6
    assert float((nk - np_).abs().max()) <= 1e-6
    differ = tk != tp
    if differ.any():
        p = x[differ]

        def d2_to(t):
            cp = closest_point_on_triangle(p, tris[t, 0:3], tris[t, 3:6], tris[t, 6:9])
            return dot3(p - cp, p - cp)

        a, b = d2_to(tk[differ]), d2_to(tp[differ])
        assert bool(((a - b).abs() <= 2 * torch.finfo(torch.float32).eps * b).all())


@pytest.mark.parametrize("case", _mesh_cases(), ids=lambda c: c[0])
def test_closest_point_kernel(dev, case):
    """K17 against its plain version: the triangle equal except where two triangles tie
    within 2 ulp of d2, distance and point within 1e-6."""
    from wisp_tpu_torch.ops.mesh.compute_sdf import (closest_point, closest_point_plain,
                                                     triangle_table)
    _, (v, f), pts = case
    x = torch.from_numpy(pts).to(dev)
    tris = triangle_table(v, f, dev)
    before = kernels.LAUNCHES["closest_point"]
    got = closest_point(x, tris)
    want = closest_point_plain(x, tris)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["closest_point"] == before + 1
    _assert_closest_kernel(x, tris, got, want)


@pytest.mark.parametrize("carved,stride,jittered", [(False, 1, False), (True, 1, False),
                                                    (True, 2, False), (True, 2, True)])
def test_raymarch_uniform_kernel(dev, carved, stride, jittered):
    """K8, the 'uniform' mode of K2's kernel: every output exactly."""
    from wisp_tpu_torch.accelstructs.octree_as import raymarch_uniform, raymarch_uniform_plain
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(300, seed=3))
    field = torch.from_numpy(carved_field(4, 1)).to(dev) if carved else None
    jitter = None
    if jittered:
        g = torch.Generator(device="cpu").manual_seed(17)
        jitter = torch.rand(300, 67, generator=g).to(dev)
    before = kernels.LAUNCHES["raymarch_uniform"]
    got = raymarch_uniform(o, d, 0.0, 8.0, 67, stride, field, 4, jitter)
    want = raymarch_uniform_plain(o, d, 0.0, 8.0, 67, stride, field, 4, jitter)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raymarch_uniform"] == before + 1
    for k in ("samples", "depth_samples", "deltas", "mask"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.mask.any() and not got.mask.all()
    if carved:
        assert torch.equal(got.cell_density, want.cell_density)


def _traced_octree(kind, dev):
    """An octree whose max level takes route ``kind``: a sphere shell at level 5 (maps), at
    level 8 (the binary search), a dense level-5 octree, a carved one (bitfield)."""
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    if kind == "dense":
        return OctreeAS.make_dense(5, device=dev)
    if kind == "bitfield":
        g = torch.Generator(device="cpu").manual_seed(18)
        return OctreeAS.make_dense(5, device=dev).update_occupancy(
            (torch.rand(8 ** 5, generator=g) < 0.02).to(dev))
    return _sphere_octree(8 if kind == "search" else 5, dev)


def _spc_rays(n, dev, seed=19):
    """Rays from a sphere of radius 2.5 towards the centre, offset by up to 1.2 a
    coordinate: some miss the box, more miss the shell."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (-2.5 * d + rng.uniform(-1.2, 1.2, (n, 3))).astype(np.float32)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


@pytest.mark.parametrize("kind,capacity", [("map", None), ("map", 4), ("search", None),
                                           ("dense", None), ("bitfield", None)])
def test_raytrace_kernel(dev, kind, capacity):
    """K10 on every route, and at a capacity that overflows: every output exactly."""
    from wisp_tpu_torch.accelstructs.octree_as import raytrace, raytrace_plain
    blas = _traced_octree(kind, dev)
    level = blas.max_level
    assert blas.query_routes[level].kind == kind
    route = blas.query_routes[level]
    cap = capacity or min(3 * 2 ** level + 2, 512)
    o, d = _spc_rays(2000, dev)
    before = kernels.LAUNCHES["raytrace"]
    got = raytrace(o, d, 0.0, 10.0, route, level, cap, 3 * 2 ** level + 2)
    want = raytrace_plain(o, d, 0.0, 10.0, route, level, cap, 3 * 2 ** level + 2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raytrace"] == before + 1
    for k in ("pidx", "t_entry", "t_exit", "mask", "overflow"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.mask.any()
    assert bool(got.overflow.any()) == (capacity is not None)


@pytest.mark.parametrize("kind,steps", [("map", 256), ("map", 3), ("search", 256),
                                        ("dense", 256), ("bitfield", 256)])
def test_spc_trace_kernel(dev, kind, steps):
    """K13 on every route, and with a walk budget that runs out: t, hit, pidx and the
    overflow count exactly."""
    from wisp_tpu_torch.tracers.packed_spc_tracer import spc_trace, spc_trace_plain
    blas = _traced_octree(kind, dev)
    level = blas.max_level
    free_dist = blas.free_space_distance()
    occ = None if blas.dense else blas.occ_grid
    o, d = _spc_rays(5000, dev)
    args = (o, d, 0.0, 10.0, free_dist, occ, blas.query_routes[level], level, steps)
    before = kernels.LAUNCHES["spc_trace"]
    got = spc_trace(*args)
    want = spc_trace_plain(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spc_trace"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].any() and not got[1].all()
    assert float(got[3]) == 0.0 if kind == "dense" else (float(got[3]) > 0) == (steps == 3)


def _query_case(dim, f_dim, n, dev, seed=20):
    """K14's inputs: 4 LODs, dense and hashed (a 2D dense LOD at res 300 whose upper
    corners index past its table: NaN), points inside and outside [-1, 1]^d, the first
    four on the upper edge."""
    resolutions = [4, 16, 300, 512] if dim == 2 else [4, 8, 16, 64]
    bitwidth = 17 if dim == 2 else 10
    sizes = [min(r ** dim, 2 ** bitwidth) for r in resolutions]
    first = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.randn(first[-1], f_dim, generator=g).to(dev)
    coords = (torch.rand(n, dim, generator=g) * 2.1 - 1.05)
    coords[:4] = 1.0
    return coords.to(dev), (resolutions, bitwidth, 3, table, first, sizes)


def _query_equal(got, want):
    return (got.shape == want.shape and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)))


@pytest.mark.parametrize("f_dim", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dim", [2, 3])
def test_hashgrid_query_kernel(dev, dim, f_dim):
    """K14 in 3D and 2D on dense and hashed LODs, at the vector widths and at widths no
    vector load covers, NaN past a 2D dense LOD's table."""
    coords, args = _query_case(dim, f_dim, 4000, dev)
    before = kernels.LAUNCHES["hashgrid_query"]
    got = grid_ops.hashgrid_query(coords, *args)
    want = grid_ops.hashgrid_query_plain(coords, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_query"] == before + 1
    assert got.shape == (4000, 4, 2 ** dim, f_dim)
    assert _query_equal(got, want) and got.isnan().any() == (dim == 2)


@pytest.mark.parametrize("f_dim", [2, 5, 64])
@pytest.mark.parametrize("n", [0, 1, 33, 4001])
def test_hashgrid_query_kernel_ragged(dev, n, f_dim):
    """K14 where the points end inside a block's 32 (33, 4,001), at one point and at none
    (no launch); F = 64 is wider than the block's staging tile, so its lanes write their
    rows straight out."""
    coords, args = _query_case(3, f_dim, max(n, 4), dev, seed=n)
    coords = coords[:n].contiguous()
    before = kernels.LAUNCHES["hashgrid_query"]
    got = grid_ops.hashgrid_query(coords, *args)
    want = grid_ops.hashgrid_query_plain(coords, *args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_query"] == before + (n > 0)
    assert got.shape == (n, 4, 8, f_dim) and _query_equal(got, want)


@pytest.fixture(scope="module")
def query_v1():
    """The earlier design of K14, built beside the library (as chip_smoke.py does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return chip_smoke.HashGridQueryV1(chip_smoke.start_baseline_build(
        chip_smoke.HASHGRID_QUERY_V1_SRC, "libwisp_hashgrid_query_v1.so"))


def test_hashgrid_query_equals_the_earlier_design(dev, query_v1):
    """K14 and its earlier design bit for bit at a flagship-like shape: 16 LODs from res 16
    to 512, bitwidth 19, F = 2, 65,536 seeded points along neighbouring rays."""
    from wisp_tpu_torch.models.grids.hash_grid import HashGrid
    g = torch.Generator(device="cpu").manual_seed(19)
    grid = HashGrid.from_geometric(feature_dim=2, num_lods=16, codebook_bitwidth=19,
                                   min_grid_res=16, max_grid_res=512, feature_std=0.5,
                                   generator=g, device=dev)
    t = torch.linspace(0.0, 1.0, 256)[:, None, None]
    o = torch.rand(1, 256, 3, generator=g) * 0.1 - torch.tensor([0.9, 0.9, 0.9])
    d = torch.tensor([1.7, 1.6, 1.8]) + torch.rand(1, 256, 3, generator=g) * 0.05
    coords = (o + t * d).reshape(-1, 3).contiguous().to(dev)
    args = (grid.codebook.resolutions, 19, 15, grid.codebook.feats.detach(),
            grid.codebook.begin_idxes, grid.codebook.num_feats)
    got = grid_ops.hashgrid_query(coords, *args)
    was = query_v1.query(coords, *args)
    want = grid_ops.hashgrid_query_plain(coords, *args)
    torch.cuda.synchronize()
    assert got.shape == (65536, 16, 8, 2)
    assert torch.equal(got.view(torch.int32), was.view(torch.int32))
    assert _query_equal(got, want)


# -- the compaction kernels' cases: tiles, budgets, alignment, path shapes, back to back --------

def _compact_inputs(dev, r, s, frac, seed, cull=False, offset=0):
    """A mask with whole rays empty and the rest valid at about ``frac`` of their steps,
    its points and directions, and a carry that culls about a third of the rays (or None).
    ``offset`` > 0 puts the mask at that many bytes past an aligned allocation."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    mask = (torch.rand(r, s, generator=g) < frac) & (torch.rand(r, 1, generator=g) < 0.8)
    if frac >= 1.0:
        mask[:] = True
    buf = torch.zeros(offset + r * s, dtype=torch.bool)
    buf[offset:] = mask.reshape(-1)
    mask = buf.to(dev)[offset:].view(r, s)
    samples = torch.randn(r, s, 3, generator=g).to(dev)
    dirs = torch.randn(r, 3, generator=g).to(dev)
    tau_cap = float(np.float32(-np.log(1e-3)))
    acc = (torch.rand(r, generator=g) * 1.5 * tau_cap).to(dev) if cull else None
    return mask, samples, dirs, acc, tau_cap


def _assert_compact_equal(got, want, budget):
    assert torch.equal(got[3], want[3])
    kept = min(int(want[3]), budget)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a[:kept], b[:kept])


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("r,s,frac,budget,offset", [
    (1000, 77, 0.3, 20000, 0),      # many tiles, odd S: byte loads, partial tiles both ways
    (1000, 100, 0.3, 20000, 0),     # S a multiple of 4, not 16: 4-byte loads
    (700, 144, 0.3, 30000, 0),      # 16-byte loads, a half step tile at the end
    (700, 144, 0.3, 30000, 1),      # the same mask at an odd address: byte loads
    (9000, 96, 0.5, 50000, 0),      # 36 ray tiles (two groups): count above the budget
    (9000, 600, 0.05, 300000, 0),   # 1,200 group totals: the stream's words grow
    (1000, 96, 0.0, 128, 0),        # count 0
    (1000, 96, 1.0, 96000, 0),      # every sample valid, the budget all of them
    (1000, 96, 0.4, 0, 0),          # budget 0: the count alone
    (5000, 1, 0.5, 1000, 0),        # S = 1
    (1, 300, 0.5, 100, 0),          # R = 1
])
def test_compact_kernel_cases(dev, r, s, frac, budget, offset, cull):
    """wisp_compact (K3, and K6a with a culling carry) exactly equal to its plain version,
    one launch count a call."""
    mask, samples, dirs, acc, cap = _compact_inputs(dev, r, s, frac, seed=r + s, cull=cull,
                                                    offset=offset)
    counter = "compact_live" if cull else "compact"
    before = kernels.LAUNCHES[counter]
    got = compact(mask, samples, dirs, budget, acc, cap if cull else None)
    want = compact_plain(mask, samples, dirs, budget, acc, cap if cull else None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter] == before + 1
    _assert_compact_equal(got, want, budget)
    if frac == 1.0 and not cull:
        assert int(got[3]) == r * s


@pytest.mark.parametrize("r,s,frac,budget,cull", [
    (16384, 512, 0.1, 2097152, False),   # a flagship render chunk (budget 0.25)
    (4096, 512, 0.3, 524288, False),     # a training step's rays at the config's budget
    (4096, 464, 0.2, 1900544, False),    # the octree NeRF's 'voxel' march, budget 1.0
    (2048, 128, 0.3, 65536, True),       # a segment of the segmented cull
])
def test_compact_kernel_path_shapes(dev, r, s, frac, budget, cull):
    mask, samples, dirs, acc, cap = _compact_inputs(dev, r, s, frac, seed=s, cull=cull)
    counter = "compact_live" if cull else "compact"
    before = kernels.LAUNCHES[counter]
    got = compact(mask, samples, dirs, budget, acc, cap if cull else None)
    want = compact_plain(mask, samples, dirs, budget, acc, cap if cull else None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter] == before + 1
    _assert_compact_equal(got, want, budget)


def _ray_inputs(dev, r, frac, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mask = torch.rand(r, generator=g) < frac
    if frac >= 1.0:
        mask[:] = True
    o, d = torch.randn(r, 3, generator=g).to(dev), torch.randn(r, 3, generator=g).to(dev)
    t, tf = torch.rand(r, generator=g).to(dev), torch.rand(r, generator=g).to(dev)
    return mask.to(dev), o, d, t, tf


@pytest.mark.parametrize("r,frac,budget", [
    (5000, 0.3, 2000),       # five tiles, R not a multiple of the tile, fill past the count
    (70000, 0.6, 20000),     # count above the budget: nothing to fill
    (70000, 0.0, 5000),      # count 0: every slot filled
    (3000, 1.0, 3000),       # every ray alive
    (1, 1.0, 1), (1, 0.0, 4),   # R = 1
    (65536, 0.5876, 36045),  # an SDF chunk's first pass (compaction 0.55)
    (36045, 0.1519, 19661),  # its mid pass (mid_compaction 0.3)
])
def test_compact_rays_kernel_cases(dev, r, frac, budget):
    """wisp_compact_rays: every slot (kept, then JAX's fill) equal to the plain version, as
    the first pass and as the mid pass, one launch count a call."""
    from wisp_tpu_torch.ops.compaction import compact_rays, compact_rays_plain
    mask, o, d, t, tf = _ray_inputs(dev, r, frac, seed=r)
    for mid in (False, True):
        counter = "compact_rays_mid" if mid else "compact_rays"
        before = kernels.LAUNCHES[counter]
        got = compact_rays(mask, budget, o, d, t, tf, mid=mid)
        want = compact_rays_plain(mask, budget, o, d, t, tf)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[counter] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_compaction_kernels_back_to_back(dev):
    """200 calls of both kernels, of varying sizes, launched back to back on one stream
    with no synchronisation between them, then a few on a side stream: every result equals
    its plain version, so no counter or status word carries over from a call to the next."""
    from wisp_tpu_torch.ops.compaction import compact_rays, compact_rays_plain
    rng = np.random.default_rng(21)
    calls = []
    for i in range(200):
        if i % 2:
            r = int(rng.integers(1, 9000))
            inputs = _ray_inputs(dev, r, float(rng.random()), seed=i)
            calls.append(("rays", inputs, int(rng.integers(1, r + 64))))
        else:
            r, s = int(rng.integers(1, 2000)), int(rng.choice([1, 7, 32, 96, 130, 512]))
            inputs = _compact_inputs(dev, r, s, float(rng.random()), seed=i, cull=i % 4 == 0)
            calls.append(("samples", inputs, int(rng.integers(0, r * s + 1))))

    def run(kind, inputs, budget):
        if kind == "rays":
            return compact_rays(*inputs[:1], budget, *inputs[1:])
        mask, samples, dirs, acc, cap = inputs
        return compact(mask, samples, dirs, budget, acc, cap if acc is not None else None)

    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    got = [run(*c) for c in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_side = [run(*c) for c in calls[:6]]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    n_rays = sum(c[0] == "rays" for c in calls)
    n_live = sum(c[0] == "samples" and c[1][3] is not None for c in calls)
    assert kernels.LAUNCHES["compact_rays"] - before["compact_rays"] == n_rays + 3
    assert kernels.LAUNCHES["compact_live"] - before["compact_live"] == n_live + 2
    assert kernels.LAUNCHES["compact"] - before["compact"] == 200 - n_rays - n_live + 1
    for (kind, inputs, budget), a in zip(calls + calls[:6], got + got_side):
        if kind == "rays":
            want = compact_rays_plain(inputs[0], budget, *inputs[1:])
            assert all(torch.equal(x, y) for x, y in zip(a, want))
        else:
            mask, samples, dirs, acc, cap = inputs
            want = compact_plain(mask, samples, dirs, budget, acc,
                                 cap if acc is not None else None)
            _assert_compact_equal(a, want, budget)


# -- K1 as redesigned for Hopper: one thread a sample over its LODs; the backward's leading dense
# -- LODs in shared memory (grid.shared_lods), vector atomics for the others

def _flagship_geometry(num_lods=16, bitwidth=19, lo=16, hi=512, dim=3):
    b = np.exp((np.log(hi) - np.log(lo)) / (num_lods - 1))
    resolutions = [int(np.floor(lo * b ** lod)) for lod in range(num_lods)]
    sizes, first, _ = _table(dim, resolutions, bitwidth, 0)
    return resolutions, sizes, first


def _clustered_coords(n, dim, seed, spread=0.05, centres=6):
    """Samples around a few centres, so that the coarse LODs' rows take many of them."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.6, 0.6, size=(centres, dim))
    pick = rng.integers(0, centres, size=n)
    x = c[pick] + rng.normal(scale=spread, size=(n, dim))
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def _check_k1(dev, coords, resolutions, bitwidth, lod_idx, sizes, first, out_lods, f_dim,
              mask=None, seed=0):
    """K1 forward, exact backward and (with ``mask``) stochastic backward on ``coords``
    against the plain versions: forward within 1e-5, exact backward within 1e-5 of the
    largest entry, stochastic draws equal outside tie rows with counts exact; each wrapper
    launched once where there are samples."""
    n = coords.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = (0.5 * torch.randn(first[-1], f_dim, generator=g)).to(dev)
    grad_out = torch.randn(n, out_lods * f_dim, generator=g).to(dev)
    u0 = torch.rand(n, generator=g).to(dev)
    fargs = (resolutions, bitwidth, lod_idx, table, first, sizes)
    bargs = (resolutions, bitwidth, lod_idx, first[-1], first, sizes)
    before = dict(kernels.LAUNCHES)
    got = grid_ops.hashgrid(coords, *fargs, out_lods=out_lods)
    gb = grid_ops.hashgrid_bwd(coords, grad_out, *bargs, out_lods=out_lods)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hashgrid_fwd"] == before["hashgrid_fwd"] + (n > 0)
    assert kernels.LAUNCHES["hashgrid_bwd"] == before["hashgrid_bwd"] + (n > 0)
    want = grid_ops.hashgrid_plain(coords, *fargs, out_lods=out_lods)
    assert got.shape == (n, out_lods * f_dim)
    if n:
        assert (got - want).abs().max().item() <= 1e-5
        assert not got[:, (lod_idx + 1) * f_dim:].any()
    wb = grid_ops.hashgrid_bwd_plain(coords, grad_out, *bargs, out_lods=out_lods)
    assert gb.shape == wb.shape
    assert (gb - wb).abs().max().item() <= 1e-5 * max(wb.abs().max().item(), 1e-30)
    if mask is None:
        return
    gs = grid_ops.hashgrid_bwd(coords, grad_out, *bargs, out_lods=out_lods, stoch_mask=mask,
                               u0=u0)
    ws = grid_ops.hashgrid_bwd_plain(coords, grad_out, *bargs, out_lods=out_lods,
                                     stoch_mask=mask, u0=u0)
    tie_rows, ties = grid_ops.stoch_tie_rows(coords, resolutions, bitwidth, lod_idx, first,
                                             mask, u0)
    bad = ((gs - ws).abs() > 1e-5 * max(ws.abs().max().item(), 1e-30)).any(dim=1)
    bad[tie_rows.to(dev)] = False
    assert not bad.any()
    ones = torch.cat([torch.full((n, f_dim), float(m), device=dev) for m in mask]
                     + [torch.zeros((n, (out_lods - len(mask)) * f_dim), device=dev)], dim=1)
    moved = (grid_ops.hashgrid_bwd(coords, ones, *bargs, out_lods=out_lods, stoch_mask=mask,
                                   u0=u0)
             - grid_ops.hashgrid_bwd_plain(coords, ones, *bargs, out_lods=out_lods,
                                           stoch_mask=mask, u0=u0))[:, 0]
    moved[tie_rows.to(dev)] = 0.0
    assert not moved.any()
    assert kernels.LAUNCHES["hashgrid_bwd_stoch"] == before["hashgrid_bwd_stoch"] + 2 * (n > 0)


@pytest.mark.parametrize("spread", [0.02, 0.3])
def test_hashgrid_kernels_at_the_flagship_geometry(dev, spread):
    """16 LODs over 16..512 at bitwidth 19, F 2, LODs 0-12 computed (the tracer's cut), on
    120,000 samples around six centres (tight: the coarse rows take hundreds of corner
    updates each), with the flagship's LOD rule for the stochastic backward."""
    resolutions, sizes, first = _flagship_geometry()
    assert grid_ops.shared_lods(resolutions, 19, 3, 2, 13, grid_ops.SHARED_LOD_BYTES) >= 1
    coords = torch.from_numpy(_clustered_coords(120_000, 3, 1, spread)).to(dev)
    mask = grid_ops.stoch_lods(resolutions[:13], 19, 3, 2_097_152, "bf16")
    assert any(mask) and not all(mask)
    _check_k1(dev, coords, resolutions, 19, 12, sizes, first, 16, 2, mask)


@pytest.mark.parametrize("n", [0, 1, 31, 127, 129, 513, 4097, 32_767, 32_769, 65_535, 65_537,
                               100_003])
def test_hashgrid_kernels_ragged_sample_counts(dev, n):
    """N = 0 and N that is not a multiple of the forward's (128) or the backward's (512)
    block, on both sides of the forward's short-call size (32,768) and of the backward's
    (65,536: below it a sample's LODs spread over threads, above LOD 0 in shared memory)."""
    resolutions = [4, 8, 16, 32, 64]
    sizes, first, _ = _table(3, resolutions, 10, 0)
    coords = torch.from_numpy(_clustered_coords(n, 3, n, 0.3)).to(dev)
    _check_k1(dev, coords, resolutions, 10, 4, sizes, first, 5, 2, (True, False) * 2 + (True,))


def test_hashgrid_kernels_at_the_clip_edge(dev):
    """Coordinates at -1, at 1, beyond the box and a hair below 1 (x at res-1-1e-5 after the
    clip): every corner stays inside its LOD's rows, in shared memory too."""
    edge = np.asarray([-1.05, -1.0, -1.0 + 1e-7, 1.0 - 1e-7, 1.0, 1.05, 0.0], np.float32)
    grid = np.stack(np.meshgrid(edge, edge, edge, indexing="ij"), -1).reshape(-1, 3)
    # 68,600 samples: one thread a sample, LOD 0 in shared memory; the 343 distinct ones
    # alone: a sample's LODs spread over threads
    coords = torch.from_numpy(np.repeat(grid, 200, axis=0)).to(dev)
    resolutions, sizes, first = _flagship_geometry()
    _check_k1(dev, coords[::200].contiguous(), resolutions, 19, 12, sizes, first, 16, 2,
              (True,) * 13)
    _check_k1(dev, coords, resolutions, 19, 12, sizes, first, 16, 2, (True,) * 13)
    resolutions = [4, 8, 16, 32, 64]
    sizes, first, _ = _table(3, resolutions, 10, 0)
    _check_k1(dev, coords, resolutions, 10, 4, sizes, first, 5, 4, (True,) * 5)


@pytest.mark.parametrize("n", [6000, 70_000])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("f_dim", [1, 2, 4, 8])
def test_hashgrid_kernels_every_route(dev, dim, f_dim, n):
    """Every (dim, F) the wrapper takes, with a mixed stochastic LOD set and a LOD cut, in a
    short call (a thread a LOD) and a long one (a thread a sample; shared memory)."""
    resolutions = [4, 8, 16, 32, 64]
    sizes, first, _ = _table(dim, resolutions, 10, 0)
    coords = torch.from_numpy(_clustered_coords(n, dim, 7, 0.3)).to(dev)
    _check_k1(dev, coords, resolutions, 10, 3, sizes, first, 5, f_dim,
              (False, True, True, False))


@pytest.mark.parametrize("limit", ["none", "one", "full"])
def test_hashgrid_bwd_privatized_sets(dev, monkeypatch, limit):
    """The backward, exact and stochastic, with no LOD in shared memory, with one, and with
    every LOD (all dense and within a block): the same gradient."""
    resolutions = [4, 8, 16]
    sizes, first, _ = _table(3, resolutions, 12, 0)
    assert sizes == [64, 512, 4096]
    bytes_ = {"none": 0, "one": 64 * 2 * 4, "full": grid_ops.SHARED_MEMORY_BYTES}[limit]
    monkeypatch.setattr(grid_ops, "SHARED_LOD_BYTES", bytes_)
    assert grid_ops.shared_lods(resolutions, 12, 3, 2, 3, grid_ops.SHARED_LOD_BYTES) == \
        {"none": 0, "one": 1, "full": 3}[limit]
    coords = torch.from_numpy(_clustered_coords(70_000, 3, 3, 0.05)).to(dev)
    _check_k1(dev, coords, resolutions, 12, 2, sizes, first, 3, 2, (False, True, True))


def test_hashgrid_kernels_back_to_back(dev):
    """60 forward, exact and stochastic backward calls of several shapes on one stream with
    no synchronisation between them, each held to the plain version afterwards. Every
    fourth call takes 70,000 to 130,000 samples, so the long routes (the forward's tile,
    the persistent backward with LOD 0 in shared memory) alternate with the short ones."""
    rng = np.random.default_rng(5)
    resolutions, sizes, first = _flagship_geometry()
    g = torch.Generator(device="cpu").manual_seed(9)
    table = (0.5 * torch.randn(first[-1], 2, generator=g)).to(dev)
    calls = []
    for i in range(60):
        n = int(rng.integers(70_000, 130_000) if i % 4 == 3 else rng.integers(0, 20_000))
        lod_idx = int(rng.integers(0, 13))
        coords = torch.from_numpy(_clustered_coords(n, 3, i, float(rng.uniform(0.02, 0.5))))
        grad_out = torch.randn(n, 32, generator=g)
        u0 = torch.rand(n, generator=g)
        mask = tuple(bool(m) for m in rng.random(lod_idx + 1) < 0.5)
        calls.append((i % 3, coords.to(dev), grad_out.to(dev), u0.to(dev), lod_idx, mask))

    def run(kind, coords, grad_out, u0, lod_idx, mask, plain=False):
        fargs = (resolutions, 19, lod_idx, table, first, sizes)
        bargs = (resolutions, 19, lod_idx, first[-1], first, sizes)
        if kind == 0:
            fn = grid_ops.hashgrid_plain if plain else grid_ops.hashgrid
            return fn(coords, *fargs, out_lods=16)
        fn = grid_ops.hashgrid_bwd_plain if plain else grid_ops.hashgrid_bwd
        if kind == 1:
            return fn(coords, grad_out, *bargs, out_lods=16)
        return fn(coords, grad_out, *bargs, out_lods=16, stoch_mask=mask, u0=u0)

    torch.cuda.synchronize()
    got = [run(*c) for c in calls]
    torch.cuda.synchronize()
    for c, a in zip(calls, got):
        want = run(*c, plain=True)
        if c[0] == 2:
            tie_rows, _ = grid_ops.stoch_tie_rows(c[1], resolutions, 19, c[4], first, c[5],
                                                  c[3])
            keep = torch.ones(want.shape[0], dtype=torch.bool, device=dev)
            keep[tie_rows.to(dev)] = False
            a, want = a[keep], want[keep]
        scale = 1.0 if c[0] == 0 else max(want.abs().max().item(), 1e-30) if want.numel() \
            else 1.0
        assert a.numel() == 0 or (a - want).abs().max().item() <= 1e-5 * scale


# -- K11 and K15's forward, redesigned: every case the kernels take -------------------------

FSD_MAX_KS = (1, 5, 6, 31, 63, 127)


def _fsd_cases(level):
    """Occupancies at ``level``: empty, full, one cell at each corner, on a face and at the
    centre, cells at the bit words' edges, seeded random ones and the sphere octree's."""
    res = 2 ** level
    rng = np.random.default_rng(40 + level)
    out = {"empty": np.zeros(res ** 3, bool), "full": np.ones(res ** 3, bool)}
    m = res - 1
    spots = {"corners": [(x, y, z) for x in (0, m) for y in (0, m) for z in (0, m)],
             "face": [(res // 2, res // 2, 0)], "centre": [(res // 2, res // 2, res // 2)],
             "word edges": [(res // 3, (2 * res) // 3, z) for z in (31, 32, 63, 64, 95, 96)
                            if z < res]}
    for name, cells in spots.items():
        occ = np.zeros((res, res, res), bool)
        for c in cells:
            occ[c] = True
        out[name] = occ.reshape(-1)
    for frac in (0.001, 0.01, 0.1, 0.5):
        out[f"random {frac}"] = rng.random(res ** 3) < frac
    return out


@pytest.mark.parametrize("level", range(9))
def test_free_space_distance_kernel_cases(dev, level):
    """K11 equal to its plain version (JAX's integers) at every level the wrapper takes, on
    every case of ``_fsd_cases`` and the sphere octree, at each max_k; one launch a call."""
    from wisp_tpu_torch.accelstructs.octree_as import (free_space_distance,
                                                       free_space_distance_plain)
    cases = {k: torch.from_numpy(v).to(dev) for k, v in _fsd_cases(level).items()}
    if level >= 2:
        cases["sphere octree"] = _sphere_octree(level, dev).occ_grid
    for name, occ in cases.items():
        for max_k in FSD_MAX_KS:
            before = kernels.LAUNCHES["free_space_distance"]
            got = free_space_distance(occ, level, max_k)
            want = free_space_distance_plain(occ, level, max_k)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["free_space_distance"] == before + 1
            assert got.dtype == torch.int32 and torch.equal(got, want), (name, max_k)


def test_free_space_distance_kernel_rejects_a_cap_above_255(dev):
    from wisp_tpu_torch.accelstructs.octree_as import free_space_distance
    occ = torch.zeros(8 ** 3, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="out of range"):
        free_space_distance(occ, 3, 128)


def _interp_inputs(n, f_dim, n_lods, col0, seed, dev, misaligned=False):
    """Seeded K15 inputs that reach every branch: tables of random rows, a pidx with -1
    (empty) cells, coordinates on cell boundaries, on the box's faces and outside it.
    ``misaligned`` starts every table 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    levels = [int(v) for v in rng.integers(0, 13, n_lods)]
    cells = [int(v) for v in rng.integers(1, 300, n_lods)]
    rows = [int(v) for v in rng.integers(1, 500, n_lods)]

    def table(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if misaligned:
            flat = torch.zeros(t.numel() + 1, dtype=dtype)
            flat[1:] = t.reshape(-1)
            return flat.to(dev)[1:].view(t.shape)
        return t.to(dev)

    trinkets = [table(rng.integers(0, rows[i], (cells[i], 8)), torch.int32)
                for i in range(n_lods)]
    feats = [table(0.1 * rng.normal(size=(rows[i], f_dim)), torch.float32)
             for i in range(n_lods)]
    pidx = np.stack([rng.integers(-1, max(cells[i - col0], 1), n) if col0 <= i < col0 + n_lods
                     else rng.integers(-1, 5, n) for i in range(col0 + n_lods + 1)], axis=1)
    pidx[rng.random(pidx.shape) < 0.1] = -1
    coords = rng.uniform(-1.1, 1.1, (n, 3))
    k = rng.integers(0, 2 ** 12 + 1, (n, 3))
    edge = rng.random(n) < 0.3                       # on cell boundaries of every level
    coords[edge] = k[edge] / 2.0 ** 11 - 1.0
    coords[rng.random(n) < 0.05, 0] = 1.0            # on the box's faces
    coords[rng.random(n) < 0.05, 1] = -1.0
    return (torch.from_numpy(coords.astype(np.float32)).to(dev),
            torch.from_numpy(pidx.astype(np.int32)).to(dev), col0, trinkets, feats, levels)


@pytest.mark.parametrize("f_dim", [1, 2, 3, 4, 5, 8, 16, 32])
@pytest.mark.parametrize("n_lods", [1, 6, 16])
@pytest.mark.parametrize("multiscale", ["sum", "cat"])
def test_octree_interp_kernel_cases(dev, f_dim, n_lods, multiscale):
    """K15 forward within 1e-6 of its plain version at each F (both routes), LOD count and
    blend, col0 > 0, at N = 1, 7 and 16,385; one launch a call."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp, octree_interp_plain
    for n in (1, 7, 16_385):
        args = _interp_inputs(n, f_dim, n_lods, 2, f_dim * 100 + n_lods + n, dev)
        before = kernels.LAUNCHES["octree_interp"]
        got = octree_interp(*args, multiscale)
        want = octree_interp_plain(*args, multiscale)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["octree_interp"] == before + 1
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-6, n
        assert bool((want != 0).any()) or n == 1
        if multiscale == "cat":                      # an empty cell's slice is zeros
            empty = args[1][:, 2:2 + n_lods] < 0
            assert bool((got.view(n, n_lods, f_dim)[empty] == 0).all())


@pytest.mark.parametrize("f_dim,n_lods", [(5, 4), (16, 6)])
def test_octree_interp_kernel_large_and_misaligned(dev, f_dim, n_lods):
    """K15 forward at the octree NeRF's 187,360 points, and with every table 4 bytes off a
    16-byte boundary (the route of a lane a feature, scalar trinket loads)."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp, octree_interp_plain
    for misaligned in (False, True):
        args = _interp_inputs(187_360, f_dim, n_lods, 0, 77, dev, misaligned=misaligned)
        if misaligned:
            assert all(t.data_ptr() % 16 for t in args[3] + args[4])
        for multiscale in ("sum", "cat"):
            got = octree_interp(*args, multiscale)
            want = octree_interp_plain(*args, multiscale)
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= 1e-6, (misaligned, multiscale)


def test_octree_interp_kernel_back_to_back(dev):
    """K15 forward calls of both routes and both blends in turns on one stream with no
    synchronisation between them: each equal to its shape's first result, one launch a
    call."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp, octree_interp_plain
    shapes = [(16_384, 16, 6, "sum"), (187_360, 5, 4, "sum"), (7, 3, 16, "cat"),
              (4_000, 8, 2, "cat")]
    inputs = [_interp_inputs(n, f, l, 1, 90 + i, dev) + (m,)
              for i, (n, f, l, m) in enumerate(shapes)]
    first = [octree_interp(*a) for a in inputs]
    for a, f in zip(inputs, first):
        assert (f - octree_interp_plain(*a)).abs().max().item() <= 1e-6
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["octree_interp"]
    last = {}
    for i in range(200):
        last[i % len(inputs)] = octree_interp(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_interp"] == before + 200
    for i, f in enumerate(first):
        assert torch.equal(last[i], f), shapes[i]


# -- K2/K8 and K15's backward, redesigned: every case the kernels take ----------------------

# (rays, samples): R not a multiple of the tile, S from 1 to past the tile, the render chunk
MARCH_CASES = [(1, 1), (37, 67), (5, 512), (1500, 1), (700, 3), (2, 1025), (16_385, 512)]


def _march(mode):
    from wisp_tpu_torch.accelstructs.octree_as import raymarch_uniform, raymarch_uniform_plain
    if mode == "ray":
        return raymarch_ray, raymarch_ray_plain, "raymarch_ray"
    return raymarch_uniform, raymarch_uniform_plain, "raymarch_uniform"


def _march_equal(got, want):
    same = [torch.equal(got.samples, want.samples),
            torch.equal(got.depth_samples, want.depth_samples),
            torch.equal(got.deltas, want.deltas), torch.equal(got.mask, want.mask),
            (got.cell_density is None) == (want.cell_density is None)]
    if want.cell_density is not None:
        same.append(torch.equal(got.cell_density, want.cell_density))
    return all(same)


@pytest.mark.parametrize("mode", ["ray", "uniform"])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_raymarch_tile_kernel_cases(dev, mode, stride):
    """K2/K8 bit-equal to the plain version at every case of MARCH_CASES, midpoints and
    jittered, with the field and without; one launch a call."""
    fn, plain, counter = _march(mode)
    field = torch.from_numpy(carved_field(4, 31)).to(dev)
    for r, s in MARCH_CASES:
        o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(r, seed=r + s))
        g = torch.Generator(device="cpu").manual_seed(r * s)
        for jitter in (None, torch.rand(r, s, generator=g).to(dev)):
            for fld in (field, None):
                before = kernels.LAUNCHES[counter]
                got = fn(o, d, 0.0, 8.0, s, stride, fld, 4, jitter)
                want = plain(o, d, 0.0, 8.0, s, stride, fld, 4, jitter)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES[counter] == before + 1
                assert _march_equal(got, want), (r, s, jitter is None, fld is None)
                if fld is not None and r > 3:
                    assert bool(want.mask.any()) and not bool(want.mask.all())


@pytest.mark.parametrize("which", ["samples", "depths", "mask", "dens"])
def test_raymarch_tile_kernel_refuses_unaligned_outputs(dev, which):
    """The entry point refuses an output that does not start on 16 bytes (the tile's
    16-byte stores); the wrapper's own outputs always do."""
    r, s = 8, 40
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(r, seed=5))
    field = torch.from_numpy(carved_field(4, 32)).to(dev)
    sizes = {"samples": (r * s * 3, torch.float32), "depths": (r * s, torch.float32),
             "mask": (r * s, torch.bool), "dens": (r * s, torch.float32)}
    outs = {}
    for k, (n, dtype) in sizes.items():
        buf = torch.empty(n + 16, dtype=dtype, device=dev)
        outs[k] = buf[1:n + 1] if k == which else buf[:n]
    deltas = torch.empty(r, device=dev)
    before = kernels.LAUNCHES["raymarch_ray"]
    with pytest.raises(RuntimeError, match="wisp_raymarch_ray"):
        kernels.launch("wisp_raymarch_ray", "raymarch_ray", o.data_ptr(), d.data_ptr(), None,
                       r, s, 2, 0.0, 0.0, 8.0, field.data_ptr(), 4,
                       outs["samples"].data_ptr(), outs["depths"].data_ptr(),
                       outs["mask"].data_ptr(), outs["dens"].data_ptr(), deltas.data_ptr())
    assert kernels.LAUNCHES["raymarch_ray"] == before


def test_raymarch_tile_kernel_back_to_back(dev):
    """K2 and K8 calls at four shapes in turns on one stream with no synchronisation between
    them: each equal to its shape's first result and to the plain version."""
    field = torch.from_numpy(carved_field(4, 33)).to(dev)
    g = torch.Generator(device="cpu").manual_seed(34)
    calls = []
    for i, (mode, r, s, stride, jittered) in enumerate([
            ("ray", 16_384, 512, 2, False), ("ray", 4_096, 512, 2, True),
            ("uniform", 16_384, 512, 2, False), ("uniform", 37, 67, 3, True)]):
        o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(r, seed=40 + i))
        jitter = torch.rand(r, s, generator=g).to(dev) if jittered else None
        fn, plain, _ = _march(mode)
        args = (o, d, 0.0, 8.0, s, stride, field, 4, jitter)
        calls.append((fn, args, plain(*args)))
    first = [fn(*args) for fn, args, _ in calls]
    torch.cuda.synchronize()
    last = {}
    for i in range(200):
        fn, args, _ = calls[i % len(calls)]
        last[i % len(calls)] = fn(*args)
    torch.cuda.synchronize()
    for i, (_, _, want) in enumerate(calls):
        assert _march_equal(first[i], want) and _march_equal(last[i], first[i]), i


def _bwd_inputs(n, f_dim, n_lods, seed, dev, layout):
    """``_interp_inputs`` with the cells of each LOD laid out as 'random', in runs
    ('rays': consecutive points on one cell, as the octree NeRF's points come ray by ray)
    or all in one cell ('one cell'); a cotangent for 'sum' and one for 'cat'. The tables
    have at least n / 4 rows, so that a row sums about as many adds as at the paths' shapes
    (the plain version's own float32 sums part from exact by ~1e-5 of the largest entry
    past ~10^5 adds to one row)."""
    coords, pidx, col0, trinkets, feats, levels = _interp_inputs(n, f_dim, n_lods, 1, seed,
                                                                 dev)
    rng = np.random.default_rng(seed + 1)
    p = pidx.cpu().numpy()
    rows = []
    for i in range(n_lods):
        cells = trinkets[i].shape[0]
        rows.append(max(feats[i].shape[0], n // 4 + 1))
        trinkets[i] = torch.from_numpy(rng.integers(0, rows[i], (cells, 8)).astype(
            np.int32)).to(dev)
        if layout == "one cell":
            p[:, col0 + i] = cells // 2
        elif layout == "rays":
            col = np.repeat(rng.integers(0, cells, n), rng.integers(1, 48, n))[:n]
            col[rng.random(n) < 0.05] = -1
            p[:, col0 + i] = col
    pidx = torch.from_numpy(p).to(dev)
    cots = {m: torch.from_numpy(rng.normal(size=(n, f_dim * (n_lods if m == "cat" else 1)))
                                .astype(np.float32)).to(dev) for m in ("sum", "cat")}
    return coords, pidx, col0, trinkets, rows, levels, cots


def _bwd_check(args, multiscale, cot, got):
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp_bwd_plain
    coords, pidx, col0, trinkets, rows, levels = args
    want = octree_interp_bwd_plain(coords, pidx, col0, trinkets, rows, cot.shape[1] // (
        len(levels) if multiscale == "cat" else 1), levels, multiscale, cot)
    scale = max(float(w.abs().max()) for w in want)
    assert [tuple(a.shape) for a in got] == [tuple(w.shape) for w in want]
    return max(float((a - w).abs().max()) for a, w in zip(got, want)), scale


@pytest.mark.parametrize("f_dim", [1, 2, 3, 4, 5, 8, 16, 32])
@pytest.mark.parametrize("layout", ["random", "rays"])
def test_octree_interp_bwd_kernel_cases(dev, f_dim, layout):
    """K15 backward within 1e-5 of the plain version's largest entry at each F (chunks of
    four features, the last one short), 1, 6 and 16 LODs, both blends, N under a warp, at
    512 and past a block; one launch a call."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp_bwd
    for n_lods in (1, 6, 16):
        for n in (1, 7, 31, 512, 16_385):
            *args, cots = _bwd_inputs(n, f_dim, n_lods, f_dim * 7 + n_lods + n, dev, layout)
            for multiscale, cot in cots.items():
                before = kernels.LAUNCHES["octree_interp_bwd"]
                got = octree_interp_bwd(*args[:4], args[4], f_dim, args[5], multiscale, cot)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["octree_interp_bwd"] == before + 1
                err, scale = _bwd_check(args, multiscale, cot, got)
                assert err <= 1e-5 * scale, (n_lods, n, multiscale, err, scale)


@pytest.mark.parametrize("f_dim,n_lods", [(5, 4), (16, 6)])
@pytest.mark.parametrize("n", [31, 512, 16_385])
def test_octree_interp_bwd_kernel_one_cell(dev, f_dim, n_lods, n):
    """The worst case of the adds: every point in one cell of every LOD (a segment a warp,
    every warp on the same 8 rows; 16,385 points keep a row's float32 sum within the
    tolerance of the plain version's own order)."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp_bwd
    *args, cots = _bwd_inputs(n, f_dim, n_lods, 61, dev, "one cell")
    for multiscale, cot in cots.items():
        got = octree_interp_bwd(*args[:4], args[4], f_dim, args[5], multiscale, cot)
        torch.cuda.synchronize()
        err, scale = _bwd_check(args, multiscale, cot, got)
        assert scale > 0 and err <= 1e-5 * scale, (multiscale, err, scale)


@pytest.mark.parametrize("f_dim", [4, 5, 16])
def test_octree_interp_bwd_kernel_unaligned_tables(dev, f_dim):
    """Gradient tables that start 4 bytes past a 16-byte boundary: the entry point refuses
    float4 adds into them, and a lane a feature adds them within tolerance."""
    import ctypes
    import functools
    from wisp_tpu_torch.models.grids.octree_grid import bwd_shared_lods
    *args, cots = _bwd_inputs(5_000, f_dim, 6, 71, dev, "rays")
    coords, pidx, col0, trinkets, rows, levels = args
    cot = cots["sum"]
    grads = []
    for v in rows:
        buf = torch.zeros(v * f_dim + 4, device=dev)
        grads.append(buf[1:v * f_dim + 1].view(v, f_dim))
    assert all(g.data_ptr() % 16 for g in grads)
    trk, gps = kernels.pointers(trinkets), kernels.pointers(grads)
    lvl = np.asarray(levels, dtype=np.int32)
    shared = np.asarray(bwd_shared_lods(rows, f_dim, coords.shape[0]), dtype=np.int32)
    launch = functools.partial(
        kernels.launch, "wisp_octree_interp_bwd", "octree_interp_bwd", coords.data_ptr(),
        pidx.data_ptr(), coords.shape[0], pidx.shape[1], col0, len(levels), f_dim,
        ctypes.addressof(trk), ctypes.addressof(gps), lvl.ctypes.data, shared.ctypes.data, 1)
    if f_dim % 4 == 0:                  # float4 atomics need 16 bytes: refused
        with pytest.raises(RuntimeError, match="wisp_octree_interp_bwd"):
            launch(4, cot.data_ptr())
    launch(1, cot.data_ptr())
    torch.cuda.synchronize()
    err, scale = _bwd_check(args, "sum", cot, grads)
    assert err <= 1e-5 * scale


@pytest.mark.parametrize("min_adds", [0, 10 ** 9])
@pytest.mark.parametrize("f_dim,n", [(5, 2_000), (16, 512), (16, 16_385), (1, 16_385)])
def test_octree_interp_bwd_kernel_both_routes(dev, monkeypatch, min_adds, f_dim, n):
    """Every LOD whose table fits summed in shared memory first (min_adds 0), or none
    (min_adds 10^9): both within tolerance of the plain version."""
    from wisp_tpu_torch.models.grids import octree_grid
    monkeypatch.setattr(octree_grid, "BWD_SHARED_MIN_ADDS", min_adds)
    *args, cots = _bwd_inputs(n, f_dim, 6, 91, dev, "random")
    routes = octree_grid.bwd_shared_lods(args[4], f_dim, n)
    assert any(routes) == (min_adds == 0 and any(v * f_dim * 4 <= octree_grid.BWD_SHARED_BYTES
                                                 for v in args[4]))
    for multiscale, cot in cots.items():
        got = octree_grid.octree_interp_bwd(*args[:4], args[4], f_dim, args[5], multiscale,
                                            cot)
        torch.cuda.synchronize()
        err, scale = _bwd_check(args, multiscale, cot, got)
        assert err <= 1e-5 * scale, (multiscale, routes, err, scale)


def test_octree_interp_bwd_kernel_hot_rows(dev):
    """The octree NeRF's F = 5 call's shape: 187,360 points in random order over 4 LODs
    whose first two tables (1,300 and 5,500 rows, ~1,150 and ~270 adds a row) are summed in
    shared memory and whose others take their adds straight; within tolerance, one
    launch."""
    from wisp_tpu_torch.models.grids import octree_grid
    n, f_dim = 187_360, 5
    rng = np.random.default_rng(95)
    rows, cells = [1_300, 5_500, 30_000, 150_000], [150, 700, 4_000, 20_000]
    assert octree_grid.bwd_shared_lods(rows, f_dim, n) == [1_300, 5_500, 0, 0]
    trinkets = [torch.from_numpy(rng.integers(0, r, (c, 8)).astype(np.int32)).to(dev)
                for r, c in zip(rows, cells)]
    pidx = np.stack([rng.integers(0, c, n) for c in [1] + cells], axis=1).astype(np.int32)
    pidx[rng.random(pidx.shape) < 0.03] = -1
    coords = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).to(dev)
    pidx = torch.from_numpy(pidx).to(dev)
    cot = torch.from_numpy(rng.normal(size=(n, f_dim)).astype(np.float32)).to(dev)
    args = (coords, pidx, 1, trinkets, rows, [4, 5, 6, 7])
    before = kernels.LAUNCHES["octree_interp_bwd"]
    got = octree_grid.octree_interp_bwd(*args[:5], f_dim, args[5], "sum", cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_interp_bwd"] == before + 1
    err, scale = _bwd_check(args, "sum", cot, got)
    assert err <= 1e-5 * scale, (err, scale)


def test_octree_interp_bwd_kernel_back_to_back(dev):
    """K15 backward calls at four shapes in turns on one stream with no synchronisation
    between them: each within tolerance of its shape's first result."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp_bwd
    calls = []
    for i, (n, f_dim, n_lods, layout, multiscale) in enumerate([
            (187_360, 5, 4, "rays", "sum"), (512, 16, 6, "random", "sum"),
            (31, 3, 16, "rays", "cat"), (16_385, 16, 6, "one cell", "cat")]):
        *args, cots = _bwd_inputs(n, f_dim, n_lods, 80 + i, dev, layout)
        calls.append((args[:4] + [args[4], f_dim, args[5], multiscale, cots[multiscale]],
                      args))
    first = [octree_interp_bwd(*a) for a, _ in calls]
    for (a, args), f in zip(calls, first):
        err, scale = _bwd_check(args, a[7], a[8], f)
        assert err <= 1e-5 * scale
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["octree_interp_bwd"]
    last = {}
    for i in range(200):
        last[i % len(calls)] = octree_interp_bwd(*calls[i % len(calls)][0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_interp_bwd"] == before + 200
    for i, f in enumerate(first):
        scale = max(float(t.abs().max()) for t in f)
        err = max(float((a - b).abs().max()) for a, b in zip(last[i], f))
        assert err <= 1e-5 * scale, i


def _mesh_points(mesh, n, seed):
    """A mesh's triangle table inputs and ``n`` seeded points: the NGLOD app's icosphere
    (half the points within 0.02 of a vertex, half anywhere in the box) or the bipyramid
    (half near its apexes)."""
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
    from wisp_tpu_torch.ops.mesh.ops import normalize
    rng = np.random.default_rng(seed)
    if mesh == "icosphere":
        v, f = normalize(*make_sphere_mesh(1.0, subdivisions=3), "sphere")
        near = v[rng.integers(0, len(v), n // 2)]
    else:
        v, f = _bipyramid()
        near = np.asarray([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]])[rng.integers(0, 2, n // 2)]
    near = near + rng.normal(scale=0.02, size=near.shape)
    pts = np.concatenate([near, rng.uniform(-1.0, 1.0, (n - n // 2, 3))])
    return v, f, pts.astype(np.float32)


@pytest.mark.parametrize("mesh,n", [("icosphere", 1), ("icosphere", 1000),
                                    ("icosphere", 100_000), ("bipyramid", 70_000)])
def test_mesh_kernels_point_counts(dev, mesh, n):
    """K16 and K17 at 1 point, at a count that is no multiple of a block, at 100,000
    points and at 70,000 around the bipyramid (two points a thread, overflowing bands):
    each held to its plain version, one launch a call."""
    from wisp_tpu_torch.ops.mesh.compute_sdf import (closest_point, closest_point_plain,
                                                     mesh_sdf, mesh_sdf_plain, triangle_table)
    v, f, pts = _mesh_points(mesh, n, seed=n)
    x = torch.from_numpy(pts).to(dev)
    tris = triangle_table(v, f, dev)
    before = dict(kernels.LAUNCHES)
    got_sdf, got_cp = mesh_sdf(x, tris), closest_point(x, tris)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mesh_sdf"] == before["mesh_sdf"] + 1
    assert kernels.LAUNCHES["closest_point"] == before["closest_point"] + 1
    _assert_sdf_kernel(got_sdf, mesh_sdf_plain(x, tris))
    _assert_closest_kernel(x, tris, got_cp, closest_point_plain(x, tris))


def test_mesh_kernels_back_to_back(dev):
    """200 calls of K16 and K17 on one stream with no synchronisation between them, two
    shapes of each in turns: each shape's last result equals its first."""
    from wisp_tpu_torch.ops.mesh.compute_sdf import closest_point, mesh_sdf, triangle_table
    calls = []
    for mesh, n in (("icosphere", 5000), ("bipyramid", 70_000)):
        v, f, pts = _mesh_points(mesh, n, seed=7)
        x = torch.from_numpy(pts).to(dev)
        tris = triangle_table(v, f, dev)
        calls += [lambda x=x, t=tris: (mesh_sdf(x, t),),
                  lambda x=x, t=tris: closest_point(x, t)]
    first = [fn() for fn in calls]
    torch.cuda.synchronize()
    last = {}
    for i in range(200):
        last[i % len(calls)] = calls[i % len(calls)]()
    torch.cuda.synchronize()
    for i, ref in enumerate(first):
        assert all(torch.equal(a, b) for a, b in zip(last[i], ref))


# -- K9 folded into K15's forward (octree_query_interp), K12's step before it (sphere_iter) --

def _fused_grid(kind, f_dim, num_lods, dev, seed):
    """An OctreeGrid (features of std 0.5) and the query routes to read it by: the sphere
    shell's octree at level 5 ('map') or 8 ('search': level 8 above the pidx maps), or,
    with the tables of the octree of every level-4 cell, a make_dense level-4 octree
    ('dense') or a carved one ('bitfield': its max level alone, one LOD)."""
    from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    gen = torch.Generator().manual_seed(seed)
    if kind in ("map", "search"):
        blas = _sphere_octree(5 if kind == "map" else 8, dev)
        grid = OctreeGrid(blas=blas, feature_dim=f_dim, num_lods=num_lods, feature_std=0.5,
                          generator=gen, device=dev)
        return grid, blas.query_routes
    g = np.arange(16, dtype=np.int32)
    full = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    grid = OctreeGrid(blas=OctreeAS.from_quantized_points(full, 4, device=dev),
                      feature_dim=f_dim, num_lods=num_lods, feature_std=0.5, generator=gen,
                      device=dev)
    dense = OctreeAS.make_dense(4, device=dev)
    if kind == "dense":
        return grid, dense.query_routes
    occ = torch.rand(8 ** 4, generator=gen) < 0.3
    return grid, dense.update_occupancy(occ.to(dev)).query_routes


def _fused_coords(n, dev, seed):
    """Points on the shell of radius 0.6, anywhere in and around the box, and on its
    faces (inside: the box test is inclusive)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n // 2, 3))
    near = 0.6 * u / np.linalg.norm(u, axis=-1, keepdims=True)
    pts = np.concatenate([near, rng.uniform(-1.1, 1.1, (n - n // 2, 3))]).astype(np.float32)
    pts[:n // 20, 0] = 1.0
    return torch.from_numpy(pts).to(dev)


@pytest.mark.parametrize("kind,f_dim,num_lods,multiscale,n", [
    ("map", 16, 3, "sum", 16_384), ("map", 16, 3, "cat", 4000), ("map", 5, 3, "sum", 4000),
    ("map", 4, 1, "cat", 7), ("search", 16, 6, "sum", 512), ("search", 5, 4, "cat", 3000),
    ("dense", 16, 3, "sum", 3000), ("dense", 5, 2, "cat", 3000),
    ("bitfield", 16, 1, "sum", 3000), ("bitfield", 5, 1, "cat", 3000)])
def test_octree_query_interp_kernel(dev, kind, f_dim, num_lods, multiscale, n):
    """The fused query and K15 forward on every route (map, level-8 search, dense,
    bitfield), both vector widths and blends: features within K15's 1e-6 of the plain
    version (octree_query_plain, then octree_interp_plain), the cells equal to K9's
    columns, one launch, no K9 launch."""
    from wisp_tpu_torch.models.grids.octree_grid import (_query_interp_fwd,
                                                         octree_query_interp_plain)
    grid, routes = _fused_grid(kind, f_dim, num_lods, dev, seed=40 + f_dim)
    lods = num_lods if kind != "bitfield" else 1
    levels = list(grid.active_lods) if kind != "bitfield" else [4]
    trinkets = grid.trinkets[-lods:]
    feats = [f.detach() for f in grid.features][-lods:]
    coords = _fused_coords(n, dev, seed=n + f_dim)
    if kind == "search":
        assert routes[8].kind == "search"
    want, want_cells = octree_query_interp_plain(coords, routes, trinkets, feats, levels,
                                                 multiscale)
    for with_cells in (False, True):
        before = dict(kernels.LAUNCHES)
        got, cells = _query_interp_fwd(coords, routes, trinkets, feats, levels, multiscale,
                                       with_cells)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["octree_query_interp"] == before["octree_query_interp"] + 1
        assert kernels.LAUNCHES["octree_query"] == before["octree_query"]
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-6
        assert (cells is None) != with_cells
        if with_cells:
            assert cells.dtype == torch.int32 and torch.equal(cells, want_cells)
    assert bool((want_cells >= 0).any()) and bool((want_cells < 0).any())


def test_octree_query_interp_kernel_f5_call(dev):
    """The fused query at the octree NeRF's F = 5 call: 187,360 points, 4 LODs, 'sum'."""
    from wisp_tpu_torch.models.grids.octree_grid import (OctreeGrid, octree_query_interp,
                                                         octree_query_interp_plain)
    blas = _sphere_octree(7, dev)
    grid = OctreeGrid(blas=blas, feature_dim=5, num_lods=4, feature_std=0.5,
                      generator=torch.Generator().manual_seed(41), device=dev)
    coords = _fused_coords(187_360, dev, seed=42)
    args = (blas.query_routes, grid.trinkets, [f.detach() for f in grid.features],
            grid.active_lods, "sum")
    got = octree_query_interp(coords, *args)
    want, _ = octree_query_interp_plain(coords, *args)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6 and bool((want != 0).any())


@pytest.mark.parametrize("kind,multiscale", [("map", "sum"), ("search", "cat")])
def test_octree_query_interp_gradient_through_cells(dev, kind, multiscale):
    """A training batch (512 points, 6 LODs of 16) through OctreeGrid.interpolate's autograd
    route: the fused forward saves its cells, K15's backward takes them; the features'
    gradient within 1e-5 of the largest entry of the unfused one (the atomics add in no
    fixed order); one launch of each, no K9 launch."""
    from wisp_tpu_torch.models.grids.octree_grid import octree_interp_plain
    grid, routes = _fused_grid(kind, 16, 6 if kind == "search" else 3, dev, seed=43)
    coords = _fused_coords(512, dev, seed=44)
    lod_idx = grid.num_lods - 1
    width = 16 * grid.num_lods if multiscale == "cat" else 16
    grid.multiscale_type = multiscale
    cot = torch.randn(512, width, generator=torch.Generator().manual_seed(45)).to(dev)
    leaves = [f.detach().clone().requires_grad_(True) for f in grid.features]
    pidx = grid.blas.query(coords, grid.active_lods[-1], with_parents=True).pidx
    want = torch.autograd.grad(octree_interp_plain(coords, pidx, grid.base_lod, grid.trinkets,
                                                   leaves, grid.active_lods, multiscale),
                               leaves, cot)
    before = dict(kernels.LAUNCHES)
    grid.interpolate(coords, lod_idx).backward(cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["octree_query_interp"] == before["octree_query_interp"] + 1
    assert kernels.LAUNCHES["octree_interp_bwd"] == before["octree_interp_bwd"] + 1
    assert kernels.LAUNCHES["octree_query"] == before["octree_query"]
    for f, b in zip(grid.features, want):
        scale = float(b.abs().max())
        assert scale > 0 and float((f.grad - b).abs().max()) <= 1e-5 * scale


def test_octree_query_interp_new_table_at_a_known_address(dev):
    """A level-8 code table replaced by one of another length at the same address (as a
    freed octree's may come back), in turns: full, a prefix, full. Each fused query reads
    the table it is given: its cells equal K9's plain columns on those routes (past the
    prefix, -1), its features within 1e-6 of the plain version."""
    from wisp_tpu_torch.accelstructs.octree_as import QueryRoute, octree_query_plain
    from wisp_tpu_torch.models.grids.octree_grid import (_query_interp_fwd,
                                                         octree_query_interp_plain)
    grid, routes = _fused_grid("search", 16, 3, dev, seed=52)
    codes = routes[8].table
    trinkets = grid.trinkets
    feats = [f.detach() for f in grid.features]
    levels = list(grid.active_lods)
    coords = _fused_coords(4000, dev, seed=53)
    for length in (codes.shape[0], codes.shape[0] // 3, codes.shape[0]):
        now = list(routes)
        now[8] = QueryRoute("search", codes[:length])
        assert now[8].table.data_ptr() == codes.data_ptr()
        got, cells = _query_interp_fwd(coords, now, trinkets, feats, levels, "sum", True)
        want, want_cells = octree_query_interp_plain(coords, now, trinkets, feats, levels)
        torch.cuda.synchronize()
        k9 = octree_query_plain(coords, now, 8, with_parents=True)[:, levels[0]:]
        assert torch.equal(cells, want_cells) and torch.equal(cells, k9), length
        assert (got - want).abs().max().item() <= 1e-6, length
        assert bool((cells[:, -1] >= 0).any())


def _iter_state(dev, n, level, seed):
    """Rays after the walk on the level-`level` shell octree: (blas, o, d, t, alive, t_far,
    free-space field)."""
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sdf_walk
    blas, o, d, t, alive, t_far = _trace_inputs(level, dev, n)
    fd = blas.free_space_distance()
    sdf_walk(o, d, t, alive, t_far, fd, level, 32)
    return blas, o, d, t, alive, t_far, fd


@pytest.mark.parametrize("f_dim,num_lods,multiscale,with_xyz,n", [
    (16, 6, "sum", True, 16_384), (16, 3, "cat", True, 3000), (5, 3, "sum", True, 3000),
    (4, 2, "cat", False, 3000), (3, 2, "sum", True, 1)])
def test_sphere_iter_kernel(dev, f_dim, num_lods, multiscale, with_xyz, n):
    """sphere_iter against its plain version over 8 iterations (the first without the step)
    on the level-6 shell octree, the field read in column 0 of [N, 4] rows: t, alive and hit
    bit-equal to sphere_step_plain's, the decoder-input rows within K15's 1e-6 (the rows of
    rays that are not alive zeros in both), one launch an iteration."""
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sphere_iter, sphere_iter_plain
    blas, o, d, t, alive, t_far, fd = _iter_state(dev, n, 6, seed=46)
    grid = OctreeGrid(blas=blas, feature_dim=f_dim, num_lods=num_lods, feature_std=0.5,
                      multiscale_type=multiscale,
                      generator=torch.Generator().manual_seed(47), device=dev)
    fused = grid.query_interp_args(num_lods - 1) + (with_xyz,)
    g = torch.Generator(device="cpu").manual_seed(48)
    state_k = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    state_p = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    out = None
    with torch.no_grad():
        for i in range(8):
            field = None
            if i:
                field = ((torch.rand(n, 4, generator=g) - 0.1) * 0.02).to(dev)
            before = kernels.LAUNCHES["sphere_iter"]
            out = sphere_iter(o, d, *state_k, t_far, field, fd, 6, 0.8, 3e-4, *fused, out=out)
            want = sphere_iter_plain(o, d, *state_p, t_far, field, fd, 6, 0.8, 3e-4, *fused)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["sphere_iter"] == before + 1
            for a, b in zip(state_k, state_p):
                assert torch.equal(a, b), i
            assert out.shape == want.shape and out.stride(0) % 4 == 0
            assert (out - want).abs().max().item() <= 1e-6, i
            assert bool((out[~state_k[1]] == 0).all())
    if n > 1:
        assert bool(state_k[2].any()) and bool(state_k[1].any())


def test_sphere_iter_rejects_bad_inputs(dev):
    """A group of more than a warp's lanes, and rows of another shape, are refused."""
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sphere_iter
    blas, o, d, t, alive, t_far, fd = _iter_state(dev, 100, 5, seed=49)
    wide = OctreeGrid(blas=blas, feature_dim=33, num_lods=1, feature_std=0.5, device=dev)
    with pytest.raises(ValueError, match="lanes"):
        sphere_iter(o, d, t, alive, torch.zeros_like(alive), t_far, None, fd, 5, 0.8, 3e-4,
                    *wide.query_interp_args(0), True)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=1, feature_std=0.5, device=dev)
    with pytest.raises(ValueError, match="out"):
        sphere_iter(o, d, t, alive, torch.zeros_like(alive), t_far, None, fd, 5, 0.8, 3e-4,
                    *grid.query_interp_args(0), True,
                    out=torch.empty(100, 16, device=dev))


@pytest.mark.parametrize("compaction,mid_compaction", [(None, None), (0.9, 0.6)])
def test_fused_sphere_loop_on_the_card(dev, compaction, mid_compaction):
    """The tracer's fused loop on a NeuralSDF (the sphere decoder, level 5, 3 LODs of 16):
    sphere_iter once an iteration, sphere_step once a loop, no K9 and no K15 forward launch;
    the trace held to the unfused loop's by the SDF rule (the same hits except where the
    field lies within 1e-5 of min_dis; depth within 1e-4 and normals within 1e-4 on common
    hits: the decoder's GEMM may round its padded input rows otherwise)."""
    from wisp_tpu_torch import interop
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF
    from wisp_tpu_torch.tracers import packed_sdf_tracer
    from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
    blas = _sphere_octree(5, dev)
    gen = torch.Generator().manual_seed(50)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, feature_std=0.01, generator=gen,
                      device=dev, multiscale_type="sum")
    nef = NeuralSDF(grid=grid, position_input=True, hidden_dim=32, generator=gen, device=dev)
    with torch.no_grad():
        for name, value in interop.sphere_sdf_decoder(16, 32, seed=0, radius=0.6).items():
            nef.get_parameter(name).copy_(torch.from_numpy(value))
    rng = np.random.default_rng(51)
    o = np.float32([0.05, -0.03, -3.0]) + rng.normal(scale=0.05, size=(4096, 3))
    target = np.concatenate([rng.uniform(-0.7, 0.7, (4096, 2)), np.zeros((4096, 1))], -1)
    dirs = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    rays = Rays(torch.from_numpy(o.astype(np.float32)).to(dev),
                torch.from_numpy(dirs.astype(np.float32)).to(dev), 0.0, 10.0)
    tracer = PackedSDFTracer(num_steps=32, step_size=0.8, compaction=compaction,
                             mid_compaction=mid_compaction)
    with torch.no_grad():
        before = dict(kernels.LAUNCHES)
        got = tracer(nef, rays)
        torch.cuda.synchronize()
        loops = 1 if mid_compaction is None else 2
        assert kernels.LAUNCHES["sphere_iter"] == before["sphere_iter"] + 32
        assert kernels.LAUNCHES["sphere_step"] == before["sphere_step"] + loops
        assert kernels.LAUNCHES["octree_query"] == before["octree_query"]
        assert kernels.LAUNCHES["octree_interp"] == before["octree_interp"]
        unfused_field = packed_sdf_tracer.fused_field
        packed_sdf_tracer.fused_field = lambda nef_, lod_idx: None
        try:
            want = tracer(nef, rays)
        finally:
            packed_sdf_tracer.fused_field = unfused_field
        sdf_at = nef(channels="sdf", coords=got.xyz)[:, 0]
    ha, hb = got.hit[:, 0], want.hit[:, 0]
    differ = ha != hb
    assert not bool((differ & ((sdf_at.abs() - 3e-4).abs() > 1e-5)).any())
    both = ha & hb
    assert float(both.float().mean()) > 0.2
    assert float((got.depth - want.depth)[both].abs().max()) <= 1e-4
    assert float((got.normal - want.normal)[both].abs().max()) <= 1e-4


# -- K12's walk and K13 around the short step (csrc/sphere_walker.cuh), beside the earlier
# -- design (csrc/baselines/sphere_trace_v1.cu) ---------------------------------------------
@pytest.fixture(scope="module")
def walk_v1():
    """The earlier design of the walks, built beside the library (as chip_smoke.py does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    started = chip_smoke.start_baseline_build(chip_smoke.SPHERE_TRACE_V1_SRC,
                                              "libwisp_sphere_trace_v1.so")
    return chip_smoke.WalkDesign(
        chip_smoke.finish_baseline_build(started, chip_smoke.SPHERE_TRACE_V1_SRC), "_v1")


def _walk_fields(blas, level):
    """{name: (free-space field, occupancy)}: the octree's, all free (k = 32 everywhere),
    all occupied."""
    fd = blas.free_space_distance()
    occ = blas.occ_grid if blas.occ_grid is not None else torch.ones_like(fd, dtype=torch.bool)
    return {"octree": (fd, occ),
            "all free": (torch.full_like(fd, 32), torch.zeros_like(occ)),
            "all occupied": (torch.zeros_like(fd), torch.ones_like(occ))}


def _hard_walk_rays(dev, level):
    """The hard rays of chip_smoke.py's "walks" step and seeded rays, with the walk's start
    (t, alive, t_far)."""
    import chip_smoke
    from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect
    ho, hd = chip_smoke.walk_hard_rays(dev, level)
    so, sd = _spc_rays(2000, dev)
    o, d = torch.cat([ho, so]), torch.cat([hd, sd])
    t_near, t_far = aabb_intersect(o, d, 0.0, 10.0)
    t = t_near.clamp(min=0.0) + 1e-6
    return o, d, t, t_far > t, t_far


@pytest.mark.parametrize("level", [6, 8])
@pytest.mark.parametrize("steps", [0, 1, 32])
def test_sdf_walk_hard_rays(dev, walk_v1, level, steps):
    """K12's walk on the hard rays, on the shell octree's field, an all-free and an
    all-occupied one: the kernel and the earlier design bit-equal to the plain version."""
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sdf_walk, sdf_walk_plain
    blas = _sphere_octree(level, dev)
    o, d, t, alive, t_far = _hard_walk_rays(dev, level)
    for name, (fd, _) in _walk_fields(blas, level).items():
        states = {k: [t.clone(), alive.clone()] for k in ("new", "was", "plain")}
        before = kernels.LAUNCHES["sdf_walk"]
        sdf_walk(o, d, *states["new"], t_far, fd, level, steps)
        walk_v1.sdf_walk(o, d, *states["was"], t_far, fd, level, steps)
        sdf_walk_plain(o, d, *states["plain"], t_far, fd, level, steps)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["sdf_walk"] == before + 1
        for k in ("new", "was"):
            for a, b in zip(states[k], states["plain"]):
                assert torch.equal(a, b), (name, k)
        if steps and name == "octree":
            assert bool((states["new"][0] != t).any())


@pytest.mark.parametrize("kind", ["map", "search", "dense", "bitfield"])
@pytest.mark.parametrize("steps", [0, 1, 64])
def test_spc_trace_hard_rays(dev, walk_v1, kind, steps):
    """K13 on every route, on the hard rays and the three fields: t, hit, pidx and the
    overflow count of the kernel and of the earlier design bit-equal to the plain version."""
    from wisp_tpu_torch.tracers.packed_spc_tracer import spc_trace, spc_trace_plain
    blas = _traced_octree(kind, dev)
    level = blas.max_level
    route = blas.query_routes[level]
    o, d, _, _, _ = _hard_walk_rays(dev, level)
    for name, (fd, occ) in _walk_fields(blas, level).items():
        args = (o, d, 0.0, 10.0, fd, occ, route, level, steps)
        want = spc_trace_plain(*args)
        for got in (spc_trace(*args), walk_v1.spc_trace(*args)):
            for a, b in zip(got, want):
                assert torch.equal(a, b), name
        if name == "octree" and steps == 64:
            assert bool(want[1].any())
        if name == "all free" and steps == 1:       # one skip of 31 cells stays in the box
            assert float(want[3]) > 0


def test_sphere_step_and_iter_hard_rays(dev):
    """sphere_step and sphere_iter on the hard rays after the walk, 4 iterations with a
    field of both signs (some under min_dis): t, alive and hit bit-equal to the plain
    version's, the rows within 1e-6."""
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.tracers.packed_sdf_tracer import (sdf_walk, sphere_iter,
                                                          sphere_iter_plain, sphere_step,
                                                          sphere_step_plain)
    level = 6
    blas = _sphere_octree(level, dev)
    o, d, t, alive, t_far = _hard_walk_rays(dev, level)
    fd = blas.free_space_distance()
    sdf_walk(o, d, t, alive, t_far, fd, level, 8)
    n = o.shape[0]
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, feature_std=0.5,
                      generator=torch.Generator().manual_seed(52), device=dev)
    fused = grid.query_interp_args(2) + (True,)
    g = torch.Generator(device="cpu").manual_seed(53)
    step_k = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    step_p = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    iter_k = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    iter_p = [t.clone(), alive.clone(), torch.zeros_like(alive)]
    with torch.no_grad():
        for i in range(4):
            field = ((torch.rand(n, 4, generator=g) - 0.2) * 0.05).to(dev)
            dist = field[:, 0].contiguous()
            sphere_step(o, d, *step_k, t_far, dist, fd, level, 0.8, 3e-3)
            sphere_step_plain(o, d, *step_p, t_far, dist, fd, level, 0.8, 3e-3)
            rows = sphere_iter(o, d, *iter_k, t_far, field, fd, level, 0.8, 3e-3, *fused)
            want = sphere_iter_plain(o, d, *iter_p, t_far, field, fd, level, 0.8, 3e-3,
                                     *fused)
            torch.cuda.synchronize()
            for a, b, c in zip(step_k, step_p, iter_k):
                assert torch.equal(a, b) and torch.equal(c, b), i
            assert (rows - want).abs().max().item() <= 1e-6, i
    assert bool(step_k[2].any())


def test_walk_kernels_equal_the_earlier_design_on_a_level8_field(dev, walk_v1):
    """A level-8 shell octree's field: the walk and K13 (the binary-searched route) of the
    kernel equal the earlier design's bit for bit, at 64 steps, 1 and 0."""
    from wisp_tpu_torch.tracers.packed_sdf_tracer import sdf_walk
    from wisp_tpu_torch.tracers.packed_spc_tracer import spc_trace
    blas = _traced_octree("search", dev)
    level = blas.max_level
    fd = blas.free_space_distance()
    o, d, t, alive, t_far = _hard_walk_rays(dev, level)
    for steps in (64, 1, 0):
        new, was = [t.clone(), alive.clone()], [t.clone(), alive.clone()]
        sdf_walk(o, d, *new, t_far, fd, level, steps)
        walk_v1.sdf_walk(o, d, *was, t_far, fd, level, steps)
        args = (o, d, 0.0, 10.0, fd, blas.occ_grid, blas.query_routes[level], level, steps)
        for a, b in zip(new + list(spc_trace(*args)), was + list(walk_v1.spc_trace(*args))):
            assert torch.equal(a, b), steps


# -- K12's scatter-back in one launch a chunk and K6b in one round a segment, beside the
# -- earlier designs (csrc/baselines/scatter_rows_v1.cu, integrate_seg_v1.cu) ------------
@pytest.fixture(scope="module")
def scatter_seg_v1():
    """The earlier designs of K12's scatter-back and of K6b, built beside the library (as
    chip_smoke.py does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return chip_smoke.ScatterSegV1(
        chip_smoke.start_baseline_build(chip_smoke.SCATTER_ROWS_V1_SRC,
                                        "libwisp_scatter_rows_v1.so"),
        chip_smoke.start_baseline_build(chip_smoke.INTEGRATE_SEG_V1_SRC,
                                        "libwisp_integrate_seg_v1.so"))


def _rows(g, n, kind, dev, misaligned):
    """[n, ...] rows of a channel kind: (dtype, row shape); ``misaligned``: a view one
    element into its buffer, so that the rows start off 16 bytes."""
    dtype, shape = kind
    numel = n * int(np.prod(shape)) + 1
    if dtype == torch.bool:
        flat = torch.rand(numel, generator=g) < 0.5
    elif dtype == torch.uint8:
        flat = torch.randint(0, 256, (numel,), generator=g, dtype=torch.uint8)
    else:
        flat = torch.randn(numel, generator=g).to(dtype)
    flat = flat.to(dev)
    start = 1 if misaligned else 0
    return flat[start:start + numel - 1].view((n,) + tuple(shape))


# channels by row bytes: 1 (bool), 3 (uint8 x 3), 4 (float), 6 (bf16 x 3), 12 (float x 3),
# 16 (float x 4)
_SCATTER_KINDS = {1: (torch.bool, ()), 3: (torch.uint8, (3,)), 4: (torch.float32, ()),
                  6: (torch.bfloat16, (3,)), 12: (torch.float32, (3,)),
                  16: (torch.float32, (4,))}


@pytest.mark.parametrize("widths,misaligned,k,empty", [
    ((4, 12, 1, 12), False, 3000, 400),           # the tracer's chunk: t, xyz, hit, normal
    ((4, 1), False, 1500, 900),                   # its mid pass: t, hit
    ((1, 3, 4, 6, 12, 16), False, 3000, 0),
    ((1, 3, 4, 6, 12, 16), True, 3000, 700),
    ((16, 12, 4, 1, 16, 12, 4, 1, 3, 6, 16), False, 2000, 300),   # two tables
    ((16, 12, 4, 1, 16, 12, 4, 1, 3, 6, 16), True, 2000, 300),
    ((4, 12), False, 0, 0)])
def test_scatter_rows_many_kernel(dev, scatter_seg_v1, widths, misaligned, k, empty):
    from wisp_tpu_torch.ops.compaction import (SCATTER_CHANNELS, scatter_rows_many,
                                               scatter_rows_many_plain)
    g = torch.Generator(device="cpu").manual_seed(41 + k + len(widths))
    p = 5000
    idx = torch.randperm(p, generator=g)[:k]
    idx[k - empty:] = p
    idx = idx.to(dev)
    pairs = [(_rows(g, k, _SCATTER_KINDS[w], dev, misaligned),
              _rows(g, p, _SCATTER_KINDS[w], dev, misaligned)) for w in widths]
    bases = [b.clone() for _, b in pairs]
    before = kernels.LAUNCHES["scatter_rays"]
    got = scatter_rows_many(idx, [(v, b.clone()) for v, b in pairs])
    torch.cuda.synchronize()
    tables = -(-len(widths) // SCATTER_CHANNELS) if k else 0
    assert kernels.LAUNCHES["scatter_rays"] == before + tables
    want = scatter_rows_many_plain(idx, [(v, b.clone()) for v, b in pairs])
    was = scatter_seg_v1.scatter_rows_many(idx, [(v, b.clone()) for v, b in pairs])
    for gt, w, wa, base in zip(got, want, was, bases):
        assert torch.equal(gt, w) and torch.equal(wa, w)
        assert torch.equal(gt, base) == (k == empty)


def test_scatter_rows_many_rejects_bad_inputs(dev):
    from wisp_tpu_torch.ops.compaction import scatter_rows_many
    idx = torch.zeros(10, dtype=torch.int64, device=dev)
    v = torch.zeros(10, 3, device=dev)
    with pytest.raises(ValueError):        # channels of different K
        scatter_rows_many(idx, [(v, torch.zeros(20, 3, device=dev)),
                                (v[:5], torch.zeros(20, 3, device=dev))])
    with pytest.raises(ValueError):        # another P
        scatter_rows_many(idx, [(v, torch.zeros(20, 3, device=dev)),
                                (v, torch.zeros(21, 3, device=dev))])
    with pytest.raises(ValueError):        # more rows than slots
        scatter_rows_many(idx[:5], [(v, torch.zeros(20, 3, device=dev))])
    with pytest.raises(TypeError):         # dtypes differ
        scatter_rows_many(idx, [(v, torch.zeros(20, 3, device=dev, dtype=torch.float64))])
    with pytest.raises(ValueError):        # row shapes differ
        scatter_rows_many(idx, [(v, torch.zeros(20, 4, device=dev))])


@pytest.mark.parametrize("mid_compaction", [None, 0.6])
def test_sdf_tracer_scatters_a_chunk_in_one_launch(dev, mid_compaction):
    """The compacted SDF trace of one chunk makes one ``scatter_rays`` launch for t, xyz,
    hit, normal and an extra channel, and one ``scatter_rays_mid`` for the mid pass's t and
    hit; each call's results equal the per-channel plain sequence on its own inputs."""
    from wisp_tpu_torch import interop
    from wisp_tpu_torch.core.rays import Rays
    from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
    from wisp_tpu_torch.models.nefs.neural_sdf import NeuralSDF
    from wisp_tpu_torch.ops.compaction import scatter_rows_plain
    from wisp_tpu_torch.tracers import packed_sdf_tracer
    from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer
    blas = _sphere_octree(5, dev)
    gen = torch.Generator().manual_seed(52)
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, feature_std=0.01, generator=gen,
                      device=dev, multiscale_type="sum")
    nef = NeuralSDF(grid=grid, position_input=True, hidden_dim=32, generator=gen, device=dev)
    with torch.no_grad():
        for name, value in interop.sphere_sdf_decoder(16, 32, seed=0, radius=0.6).items():
            nef.get_parameter(name).copy_(torch.from_numpy(value))
    rng = np.random.default_rng(53)
    o = np.float32([0.05, -0.03, -3.0]) + rng.normal(scale=0.05, size=(4096, 3))
    target = np.concatenate([rng.uniform(-0.7, 0.7, (4096, 2)), np.zeros((4096, 1))], -1)
    dirs = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    rays = Rays(torch.from_numpy(o.astype(np.float32)).to(dev),
                torch.from_numpy(dirs.astype(np.float32)).to(dev), 0.0, 10.0)
    tracer = PackedSDFTracer(num_steps=32, step_size=0.8, compaction=0.9,
                             mid_compaction=mid_compaction)
    original = packed_sdf_tracer.scatter_rows_many
    calls = []

    def checked(idx, pairs, mid=False):
        pairs = list(pairs)
        want = [scatter_rows_plain(v, idx, out.clone()) for v, out in pairs]
        got = original(idx, pairs, mid=mid)
        calls.append((mid, len(pairs), all(torch.equal(a, b) for a, b in zip(got, want))))
        return got

    packed_sdf_tracer.scatter_rows_many = checked
    try:
        with torch.no_grad():
            before = dict(kernels.LAUNCHES)
            rb = tracer(nef, rays, channels=tracer.get_supported_channels() | {"sdf"})
            torch.cuda.synchronize()
    finally:
        packed_sdf_tracer.scatter_rows_many = original
    mids = int(mid_compaction is not None)
    assert kernels.LAUNCHES["scatter_rays"] == before["scatter_rays"] + 1
    assert kernels.LAUNCHES["scatter_rays_mid"] == before["scatter_rays_mid"] + mids
    assert sorted(calls) == sorted([(False, 5, True)] + [(True, 2, True)] * mids)
    assert float(rb.hit.float().mean()) > 0.2


def _segment_cases():
    """(S, Ce, with depth, aligned): every S with the main path's options, then the extras,
    no depth and rows off 16 bytes."""
    cases = [(s, 0, True, True) for s in (1, 31, 32, 127, 128, 129, 257, 8192)]
    cases += [(s, ce, d, True) for s, ce, d in ((128, 3, True), (129, 16, False),
                                                (8192, 3, False), (31, 16, True))]
    cases += [(s, 0, True, False) for s in (128, 256, 129)]
    return cases


@pytest.mark.parametrize("s,ce,with_depth,aligned", _segment_cases())
def test_integrate_segment_kernel_rounds(dev, scatter_seg_v1, s, ce, with_depth, aligned):
    r = 64
    g, density, deltas, depths, mask, color, acc_tau = _segment_inputs(dev, r, s, 60 + s)
    # a carry that culls about half of the rays
    acc_tau = acc_tau * 4.6
    extra = torch.rand(r, s, ce, generator=g).to(dev) if ce else None
    if not aligned:                          # the same values one element into a buffer
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view
        density, depths, mask, color = (shifted(x) for x in (density, depths, mask, color))
        assert density.data_ptr() % 16 and color.data_ptr() % 16
    args = (density, deltas, depths, mask, color, acc_tau)
    before = kernels.LAUNCHES["integrate_seg_fwd"]
    got = integrate_segment(*args, extra=extra, with_depth=with_depth)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["integrate_seg_fwd"] == before + 1
    want = integrate_segment_plain(*args, extra=extra, with_depth=with_depth)
    was = scatter_seg_v1.integrate_segment(*args, extra=extra, with_depth=with_depth)
    assert set(got) == set(want) == set(was)
    for out in (got, was):
        for k in want:
            if k == "acc_tau":
                tol = 1e-5 * want[k].abs().clamp(min=1e-30)
                assert bool(((out[k] - want[k]).abs() <= tol).all()), k
            else:
                assert (out[k] - want[k]).abs().max().item() <= 1e-4, k


# -- K18, the triplane sample, and K19, the codebook lookup ------------------------------------

def _triplanes(f_dim, n_lods, dev, seed, base=2):
    """n_lods LODs of three planes [2^l + 1, 2^l + 1, F] (std 0.5) from level ``base``."""
    g = torch.Generator().manual_seed(seed)
    return [tuple((torch.randn(2 ** (base + l) + 1, 2 ** (base + l) + 1, f_dim, generator=g)
                   * 0.5).to(dev) for _ in range(3)) for l in range(n_lods)]


def _triplane_coords(n, dev, seed):
    """Points in and up to 1.7 outside the box (the fold's both sides), some on its faces."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.7, 1.7, (n, 3)).astype(np.float32)
    pts[:n // 10, 1] = rng.choice([-1.0, 1.0], n // 10)
    return torch.from_numpy(pts).to(dev)


@pytest.mark.parametrize("f_dim,n_lods,out_lods,multiscale,n", [
    (1, 1, 1, "sum", 1000), (2, 2, 2, "cat", 1037), (3, 3, 4, "cat", 999),
    (4, 4, 4, "sum", 4096), (4, 2, 4, "cat", 1), (5, 4, 4, "sum", 777), (6, 1, 3, "cat", 500),
    (7, 3, 3, "sum", 333), (8, 4, 4, "cat", 2048), (8, 3, 3, "sum", 0),
    (1, 2, 5, "cat", 1), (2, 3, 6, "cat", 0), (3, 2, 3, "cat", 4099), (4, 4, 7, "cat", 3000),
    (5, 1, 2, "cat", 1), (6, 5, 6, "cat", 129), (7, 2, 4, "cat", 70_000),
    (8, 4, 6, "cat", 1), (4, 6, 6, "sum", 70_000), (4, 5, 5, "sum", 1)])
def test_triplane_kernels(dev, f_dim, n_lods, out_lods, multiscale, n):
    """K18 forward within 1e-6 of its plain version (F 1-8, 1-6 LODs, 'sum' and 'cat'
    padded past the given LODs, ragged and empty calls, N = 0 and 1), one launch; its
    backward within 1e-5 of the largest entry of the plain one's (the atomics add in no
    fixed order)."""
    from wisp_tpu_torch.ops.triplane import (triplane_sample, triplane_sample_bwd,
                                             triplane_sample_bwd_plain, triplane_sample_plain)
    planes = _triplanes(f_dim, n_lods, dev, seed=60 + f_dim)
    coords = _triplane_coords(n, dev, seed=61 + n)
    before = dict(kernels.LAUNCHES)
    got = triplane_sample(coords, planes, multiscale, out_lods)
    want = triplane_sample_plain(coords, planes, multiscale, out_lods)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["triplane_fwd"] == before["triplane_fwd"] + (1 if n else 0)
    assert got.shape == want.shape == (n, 3 * f_dim * (1 if multiscale == "sum" else out_lods))
    if n:
        assert (got - want).abs().max().item() <= 1e-6
    shapes = [tuple(p.shape) for lod in planes for p in lod]
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(62)).to(dev)
    g_k = triplane_sample_bwd(coords, shapes, multiscale, cot)
    g_p = triplane_sample_bwd_plain(coords, shapes, multiscale, cot)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["triplane_bwd"] == before["triplane_bwd"] + (1 if n else 0)
    scale = max(float(b.abs().max()) for b in g_p)
    for a, b in zip(g_k, g_p):
        assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30)


@pytest.fixture(scope="module")
def triplane_v1():
    """K18's first design (csrc/baselines/triplane_v1.cu), built beside the library."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    return chip_smoke.TriplaneV1(chip_smoke.start_baseline_build(
        chip_smoke.TRIPLANE_V1_SRC, "libwisp_triplane_v1.so"))


def _yaml_planes(dev, seed):
    """nerf_triplanar_lego_proxy.yaml's planes: 4 LODs from 2^5, F = 4 (std 0.1)."""
    g = torch.Generator().manual_seed(seed)
    return [tuple((torch.randn(2 ** l + 1, 2 ** l + 1, 4, generator=g) * 0.1).to(dev)
                  for _ in range(3)) for l in range(5, 9)]


def _triplane_bwd_shared(widths, f_dim):
    """K18 backward's shared-LOD counts to hold: none, and 1-2 leading LODs where they fit."""
    from wisp_tpu_torch.ops.triplane import BWD_SHARED_BYTES
    counts, total = [0], 0
    for k, w in enumerate(widths[:2]):
        total += w * w * f_dim * 4
        if total <= BWD_SHARED_BYTES:
            counts.append(k + 1)
    return counts


def _check_triplane(coords, planes, multiscale, out_lods, v1, cot_seed, long_sums=False):
    """K18 forward bit-equal to its plain version and to its first design; its backward at
    each option, and the first design's, within 1e-5 of the largest entry of
    chip_smoke.triplane_bwd_f64 (the plain version's float32 terms summed in float64: a
    render chunk's coarse rows take ~10^6 adds, whose float32 sums in two orders differ by
    more than that). With ``long_sums`` (such a chunk) the first design's backward is not
    held: its single float32 chains of ~10^6 adds a row miss the float64 sum by more than
    1e-5 of its largest entry, as the plain version's do; the new kernel's warp combine
    shortens them."""
    import chip_smoke
    from wisp_tpu_torch.ops.triplane import _sample_fwd, triplane_sample_bwd, triplane_sample_plain
    flat = [p for lod in planes for p in lod]
    got = _sample_fwd(coords, flat, multiscale, out_lods)
    want = triplane_sample_plain(coords, planes, multiscale, out_lods)
    assert torch.equal(got, want)
    assert torch.equal(v1.sample(coords, flat, multiscale, out_lods), want)
    shapes = [tuple(p.shape) for p in flat]
    cot = torch.randn(want.shape, generator=torch.Generator().manual_seed(cot_seed)).to(
        coords.device)
    del got, want
    g_p = chip_smoke.triplane_bwd_f64(coords, shapes, multiscale, cot)
    tol = 1e-5 * max(max(float(b.abs().max()) for b in g_p), 1e-30)
    widths = [sh[0] for sh in shapes[::3]]
    for n_shared in _triplane_bwd_shared(widths, shapes[0][2]):
        g_k = triplane_sample_bwd(coords, shapes, multiscale, cot, n_shared)
        for a, b in zip(g_k, g_p):
            assert float((a.double() - b).abs().max()) <= tol, n_shared
    if not long_sums:
        for a, b in zip(v1.sample_bwd(coords, shapes, multiscale, cot), g_p):
            assert float((a.double() - b).abs().max()) <= tol


@pytest.mark.parametrize("order,rays", [("train", 512), ("render", 512), ("render", 16_384)])
def test_triplane_kernels_at_the_yaml_geometry(dev, triplane_v1, order, rays):
    """K18 at nerf_triplanar_lego_proxy.yaml's planes on batches in both sample orders
    (chip_smoke.triplane_coords, 512 steps a ray, step-major): a training step's 262,144
    samples and a render chunk's 8,388,608 (and a render batch of the step's size). The
    forward bit-equal to the plain version and to the first design; the backward, with and
    without shared LODs, within 1e-5 of the largest entry of the float64 sum of its terms."""
    import chip_smoke
    coords = chip_smoke.triplane_coords(order, rays, 512, dev, seed=72)
    _check_triplane(coords, _yaml_planes(dev, seed=73), "sum", 4, triplane_v1, cot_seed=74,
                    long_sums=rays > 512)


def test_triplane_kernels_on_borders_and_outside(dev, triplane_v1):
    """K18 on coordinates exactly on every LOD's cell borders, on the box's faces, and far
    outside [-1, 1] (the fold's period 4 at +-3, +-5, +-1e3, and the values next to +-1),
    at the yaml's planes ('sum') and at 3 LODs of F = 6 ('cat' padded to 5): the forward
    bit-equal to the plain version and to the first design, the backward with and without
    shared LODs within 1e-5 of the largest entry of the float64 sum of its terms."""
    rng = np.random.default_rng(75)
    borders = np.concatenate([-1.0 + 2.0 * np.arange(2 ** l + 1) / 2 ** l for l in range(2, 9)])
    specials = np.asarray([-1.0, 1.0, np.nextafter(np.float32(1), np.float32(2)),
                           np.nextafter(np.float32(-1), np.float32(-2)),
                           np.nextafter(np.float32(1), np.float32(0)), 0.0, -0.0, 3.0, -3.0,
                           5.0, -5.0, 1e3, -1e3, 2.0, -2.0], np.float32)
    values = np.concatenate([borders, specials]).astype(np.float32)
    pts = rng.choice(values, size=(20_000, 3)).astype(np.float32)
    pts[:5000, 0] = rng.uniform(-1.5, 1.5, 5000)
    coords = torch.from_numpy(pts).to(dev)
    _check_triplane(coords, _yaml_planes(dev, seed=76), "sum", 4, triplane_v1, cot_seed=77)
    g = torch.Generator().manual_seed(78)
    planes = [tuple(torch.randn(2 ** l + 1, 2 ** l + 1, 6, generator=g).to(dev)
                    for _ in range(3)) for l in range(2, 5)]
    _check_triplane(coords, planes, "cat", 5, triplane_v1, cot_seed=79)


def test_triplanar_grid_on_the_card(dev):
    """TriplanarGrid.interpolate at the yaml's widths (4 LODs from 5, F = 4) on 65,536
    points, forward and the planes' gradient, against the same grid on the CPU; the
    coordinates' gradient raises."""
    from wisp_tpu_torch.models.grids.triplanar_grid import TriplanarGrid
    grids = [TriplanarGrid(feature_dim=4, log_base_resolution=5, num_lods=4, feature_std=0.5,
                           generator=torch.Generator().manual_seed(63), device=d)
             for d in (dev, "cpu")]
    coords = _triplane_coords(65_536, dev, seed=64)
    cot = torch.randn(65_536, 12, generator=torch.Generator().manual_seed(65))
    outs = []
    for grid, c, g in zip(grids, (coords, coords.cpu()), (cot.to(dev), cot)):
        out = grid.interpolate(c, 3)
        out.backward(g)
        outs.append(out.detach().cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
    for v_k, v_p in zip(grids[0].features, grids[1].features):
        for name in ("fmx", "fmy", "fmz"):
            a, b = getattr(v_k, name).grad.cpu(), getattr(v_p, name).grad
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with pytest.raises(NotImplementedError, match="coordinates"):
        grids[0].interpolate(coords.clone().requires_grad_(True), 3)


def test_aabb_march_kernel(dev):
    """K2 at level 0 (AxisAlignedBBoxAS, one cell) equals its plain version."""
    from wisp_tpu_torch.accelstructs.aabb_as import AxisAlignedBBoxAS
    from wisp_tpu_torch.core.rays import Rays
    o, d = (torch.from_numpy(a).to(dev) for a in ray_arrays(1000, seed=66))
    blas = AxisAlignedBBoxAS(device=dev)
    jitter = torch.rand(1000, 96, generator=torch.Generator().manual_seed(67)).to(dev)
    for key in (None, jitter):
        before = kernels.LAUNCHES["raymarch_ray"]
        got = blas.raymarch(Rays(o, d, 0.0, 8.0), raymarch_type="ray", num_samples=96, key=key)
        want = raymarch_ray_plain(o, d, 0.0, 8.0, 96, 1, None, 0, key)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["raymarch_ray"] == before + 1
        for name in ("samples", "depth_samples", "deltas", "mask"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert int(got.mask.sum()) > 0


def _codebook_tables(bits, f_dim, rows, mode, dev, seed, std=1.0):
    g = torch.Generator().manual_seed(seed)
    k = 2 ** bits
    dicts = [(torch.randn(k, f_dim, generator=g) * 0.5).to(dev) for _ in rows]
    if mode == "baked":
        logits = [torch.randint(0, k, (v,), generator=g).float().to(dev) for v in rows]
    else:
        logits = [(torch.randn(v, k, generator=g) * std).to(dev) for v in rows]
    return logits, dicts


def _near_ties(logits, mode):
    """Per LOD, the vertices whose two largest values (softmax in training, the logits in
    eval) lie within an ulp of each other: there two orders of summation may pick two
    indices."""
    from wisp_tpu_torch.ops.codebook import softmax_plain
    out = []
    for lg in logits:
        if mode == "baked" or lg.shape[1] < 2:
            out.append(torch.zeros(lg.shape[0], dtype=torch.bool, device=lg.device))
            continue
        v = softmax_plain(lg) if mode == "train" else lg
        top = torch.topk(v, 2, dim=-1).values
        ulp = torch.nextafter(top[:, 0], torch.full_like(top[:, 0], np.inf)) - top[:, 0]
        out.append(top[:, 0] - top[:, 1] <= ulp)
    return out


@pytest.mark.parametrize("bits,f_dim,rows,mode,std", [
    (1, 5, (300,), "train", 1.0), (2, 1, (100, 400), "train", 1.0),
    (3, 8, (1, 77, 500), "eval", 1.0), (4, 5, (2000, 7000, 20000, 60000), "train", 0.01),
    (4, 5, (2000, 7000, 20000, 60000), "eval", 0.01), (4, 5, (500, 0, 900), "baked", 1.0),
    (5, 3, (1000, 3000), "train", 1.0), (6, 7, (333, 4444), "train", 0.3),
    (7, 2, (2500,), "baked", 1.0), (8, 5, (4096, 10000), "train", 1.0),
    (8, 33, (700,), "eval", 1.0)])
def test_codebook_resolve_kernel(dev, bits, f_dim, rows, mode, std):
    """K19's resolve against its plain version (bitwidth 1-8, F up to 33, 1-4 LODs,
    ragged and empty LODs, every mode, the config's std 0.01 among them): E within 1e-6
    and a equal, except at the counted vertices whose two largest values lie within an ulp
    (where the plain version's sum may round them apart); one launch for every LOD."""
    from wisp_tpu_torch.ops.codebook import codebook_resolve, codebook_resolve_plain
    logits, dicts = _codebook_tables(bits, f_dim, rows, mode, dev, seed=70 + bits, std=std)
    before = kernels.LAUNCHES["codebook_resolve"]
    tables, arg = codebook_resolve(logits, dicts, mode)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["codebook_resolve"] == before + 1
    ties = _near_ties(logits, mode)
    start = 0
    for lg, d, e, tie in zip(logits, dicts, tables, ties):
        want, want_arg = codebook_resolve_plain(lg, d, mode)
        a = arg[start:start + lg.shape[0]]
        start += lg.shape[0]
        keep = ~tie
        assert e.shape == want.shape == (lg.shape[0], f_dim)
        if keep.any():
            assert torch.equal(a[keep], want_arg[keep])
            assert (e[keep] - want[keep]).abs().max().item() <= 1e-6
    assert sum(int(t.sum()) for t in ties) <= max(1, sum(rows) // 1000)


@pytest.mark.parametrize("bits,f_dim,rows,mode,shared", [
    (4, 5, (2000, 7000, 20000, 60000), "train", True), (1, 2, (500, 9), "train", True),
    (8, 5, (4096, 3000), "train", True), (8, 16, (1000, 2000, 3000, 4000), "train", False),
    (3, 6, (1000, 0, 500), "eval", True), (5, 4, (800,), "baked", True)])
def test_codebook_bwd_kernel(dev, bits, f_dim, rows, mode, shared):
    """K19's backward against its plain version at the forward's indices: d logits and d
    dictionary within 1e-5 of their largest entries (the dictionary's adds come in no fixed
    order), through the block-shared sums or straight to the tables."""
    from wisp_tpu_torch.ops import codebook
    logits, dicts = _codebook_tables(bits, f_dim, rows, mode, dev, seed=80 + bits)
    assert (len(rows) * 2 ** bits * f_dim * 4 <= codebook.BWD_SHARED_BYTES) == shared
    _, arg = codebook.codebook_resolve(logits, dicts, mode)
    g = torch.Generator().manual_seed(81)
    grad_e = [torch.randn(v, f_dim, generator=g).to(dev) for v in rows]
    before = kernels.LAUNCHES["codebook_bwd"]
    d_logits, d_dict = codebook.codebook_resolve_bwd(logits, dicts, arg, mode, grad_e)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["codebook_bwd"] == before + 1
    start = 0
    for i, (lg, d, ge) in enumerate(zip(logits, dicts, grad_e)):
        a = arg[start:start + lg.shape[0]]
        start += lg.shape[0]
        want_logits, want_dict = codebook.codebook_resolve_bwd_plain(lg, d, a, mode, ge)
        scale = float(want_dict.abs().max()) if lg.shape[0] else 1.0
        assert float((d_dict[i] - want_dict).abs().max()) <= 1e-5 * scale
        if mode == "train":
            if lg.shape[0]:
                assert float((d_logits[i] - want_logits).abs().max()) <= \
                    1e-5 * float(want_logits.abs().max())
        else:
            assert d_logits[i] is None


def test_codebook_rejects_a_bitwidth_above_8(dev):
    from wisp_tpu_torch.ops.codebook import codebook_resolve
    logits, dicts = _codebook_tables(9, 2, (10,), "train", dev, seed=90)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        codebook_resolve(logits, dicts, "train")


def test_codebook_grid_on_the_card(dev):
    """CodebookOctreeGrid at the yaml's widths (LODs 4-7 of a level-7 octree, F = 5, 2^4
    entries, 'sum') on 65,536 points: the forward and the logits' and dictionaries'
    gradients against the same grid on the CPU (within 1e-6, and 1e-5 of the largest
    entry); E stays in the grid's buffer, so the fused query's table cache holds one entry
    for it across calls; one resolve and one backward launch a step."""
    from wisp_tpu_torch.models.grids import octree_grid
    from wisp_tpu_torch.models.grids.codebook_grid import CodebookOctreeGrid
    grids = [CodebookOctreeGrid(blas=_sphere_octree(7, d), feature_dim=5, num_lods=4,
                                multiscale_type="sum", feature_std=1.0, codebook_bitwidth=4,
                                generator=torch.Generator().manual_seed(91), device=d)
             for d in (dev, "cpu")]
    coords = _fused_coords(65_536, dev, seed=92)
    cot = torch.randn(65_536, 5, generator=torch.Generator().manual_seed(93))
    assert not any(bool(t.any()) for t in _near_ties([f.detach() for f in grids[1].features],
                                                       "train"))
    outs = []
    before = dict(kernels.LAUNCHES)
    for grid, c, g in zip(grids, (coords, coords.cpu()), (cot.to(dev), cot)):
        out = grid.interpolate(c, 3)
        out.backward(g)
        outs.append(out.detach().cpu())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["codebook_resolve"] == before["codebook_resolve"] + 1
    assert kernels.LAUNCHES["codebook_bwd"] == before["codebook_bwd"] + 1
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
    for a, b in zip(list(grids[0].features) + list(grids[0].dictionary),
                    list(grids[1].features) + list(grids[1].dictionary)):
        assert float((a.grad.cpu() - b.grad).abs().max()) <= 1e-5 * float(b.grad.abs().max())
    cached = len(octree_grid._LOD_TABLES)
    with torch.no_grad():
        for _ in range(3):
            grids[0].interpolate(coords, 3)
    assert len(octree_grid._LOD_TABLES) == cached
