"""The rules of the walker's short step (``csrc/sphere_walker.cuh``), held on the CPU to the
plain version (no JAX, no card).

(a) One floor an axis: floor((p + 1) / voxel) and floor((p + 1) * half_res) are the same
    float at every level the kernels take. (b) ``short_step`` below repeats the kernel's step
    in torch (q once for the cell and the plane; the skip alone where (skip - eps) * m
    reaches voxel (1 + 2^-10), m the ray's largest moving |d|) and is held bit for bit to
    ``_fsd_at`` and ``_free_step``, the plain version's step, with both branches taken.
    (c) Its walk equals ``sdf_walk_plain``. (d) K13 counts its overflowing rays a warp at a
    time: the float total of the warps' integer counts, added in any order, equals the plain
    version's sum of 0/1 floats. (e) ``chip_smoke.timed`` and ``profile_call``, when no
    profiler session records a kernel, fall back and name the call, a ``functools.partial``
    such as the card's timed calls included.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from wisp_tpu_torch.accelstructs.octree_as import (QueryRoute, aabb_intersect,
                                                   free_space_distance_plain)
from wisp_tpu_torch.tracers.packed_sdf_tracer import (OUTSIDE, _free_step, _fsd_at,
                                                      sdf_walk_plain)
from wisp_tpu_torch.tracers.packed_spc_tracer import spc_trace_plain

FAR_SLACK = 1.0 + 2.0 ** -10     # the kernel's kFarSlack


def short_step(o, d, t, free_dist, level):
    """The kernel's step at depth t: (k, the step, whether the far path took it)."""
    res, voxel = 2 ** level, 2.0 / 2 ** level
    pos = o + t[:, None] * d
    q = torch.floor((pos + 1.0) * (res / 2.0))
    inside = ((pos >= -1.0) & (pos < 1.0)).all(dim=-1)
    c = q.to(torch.int64).clamp(0, res - 1)
    k = free_dist[(c[:, 0] * res + c[:, 1]) * res + c[:, 2]]
    k = torch.where(inside, k, torch.full_like(k, OUTSIDE))
    skip = (k.to(torch.float32) - 1.0) * voxel
    moving = d.abs() > 1e-12
    m = torch.where(moving, d.abs(), torch.zeros_like(d)).amax(dim=-1)
    far_path = (k != OUTSIDE) & ((skip - 1e-3 * voxel) * m >= voxel * FAR_SLACK)
    next_plane = -1.0 + (q + (d > 0.0).to(torch.float32)) * voxel
    dt = torch.where(moving, (next_plane - pos) / torch.where(moving, d, torch.ones_like(d)),
                     torch.full_like(pos, float("inf")))
    full = torch.maximum(skip, dt.clamp(min=0.0).amin(dim=-1) + 1e-3 * voxel)
    return k, torch.where(far_path, skip, full), far_path


def plain_step(o, d, t, free_dist, level):
    k, pos = _fsd_at(o, d, t, free_dist, level)
    return k, _free_step(k, pos, d, 2.0 / 2 ** level)


def seeded_rays(n, seed):
    """Unit rays from a sphere of radius 2.5 towards the box, offset by up to 1.2."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -2.5 * d + rng.uniform(-1.2, 1.2, (n, 3))
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("level", range(11))
def test_one_floor_gives_the_cell_and_the_plane(level):
    """(a) at every cell plane, 4 ulps either side, and on 10^6 seeded points."""
    res = 2 ** level
    voxel = torch.tensor(2.0 / res, dtype=torch.float32)
    planes = (-1.0 + torch.arange(res + 1, dtype=torch.float64) * (2.0 / res)).to(torch.float32)
    near = [planes]
    up, down = planes, planes
    for _ in range(4):
        up = torch.nextafter(up, torch.full_like(up, 10.0))
        down = torch.nextafter(down, torch.full_like(down, -10.0))
        near += [up, down]
    rng = np.random.default_rng(level)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, 10 ** 6).astype(np.float32))
    p = torch.cat(near + [pts])
    by_division = torch.floor((p + 1.0) / voxel)
    by_product = torch.floor((p + 1.0) * (res / 2.0))
    assert torch.equal(by_division, by_product)


def step_cases(level, seed):
    """Seeded and hard rays at depths in and out of the box, on a field of the values K11
    makes (0 and powers of two up to 32)."""
    res = 2 ** level
    o, d = seeded_rays(4000, seed)
    ho, hd = chip_smoke.walk_hard_rays(torch.device("cpu"), level, seed=seed)
    o, d = torch.cat([o, ho]), torch.cat([d, hd])
    g = torch.Generator().manual_seed(seed)
    t_near, t_far = aabb_intersect(o, d, 0.0, 10.0)
    t_near = t_near.clamp(min=0.0)
    u = torch.rand(o.shape[0], generator=g)
    t = torch.where(t_far > t_near, t_near + u * (t_far - t_near) * 1.2, u * 5.0)
    values = torch.tensor([0, 1, 2, 4, 8, 16, 32], dtype=torch.int32)
    field = values[torch.randint(0, len(values), (res ** 3,), generator=g)]
    return o, d, t.to(torch.float32), field


@pytest.mark.parametrize("level", [2, 4, 7])
def test_short_step_equals_the_plain_step(level):
    """(b) bit for bit, k in {0, 1, 2, 4, 8, 16, 32, OUTSIDE}, both branches taken."""
    o, d, t, field = step_cases(level, seed=40 + level)
    k, step, far_path = short_step(o, d, t, field, level)
    k_plain, step_plain = plain_step(o, d, t, field, level)
    assert torch.equal(k, k_plain)
    moves = k > 0
    assert torch.equal(step[moves], step_plain[moves])
    assert bool(far_path.any()) and bool((moves & ~far_path).any())
    for value in (1, 2, 4, 8, 16, 32, OUTSIDE):
        assert bool((k == value).any()), value
    # every step with k >= 4 of a unit ray in the box takes the far path
    unit = (d.norm(dim=-1) - 1.0).abs() < 1e-6
    assert bool(far_path[unit & (k >= 4) & (k != OUTSIDE)].all())


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32])
def test_short_step_on_uniform_fields(k):
    """(b) on the hard rays alone, each at its entry and deeper, the field k everywhere."""
    level = 6
    o, d = chip_smoke.walk_hard_rays(torch.device("cpu"), level, seed=k)
    field = torch.full((8 ** level,), k, dtype=torch.int32)
    t_near, t_far = aabb_intersect(o, d, 0.0, 10.0)
    for frac in (0.0, 0.3, 0.7):
        t = t_near.clamp(min=0.0) + 1e-6 + frac * (t_far - t_near).clamp(min=0.0)
        got = short_step(o, d, t, field, level)
        want = plain_step(o, d, t, field, level)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def walk(o, d, t, alive, t_far, free_dist, level, num_steps):
    """``sdf_walk_plain`` with ``short_step``: (t, alive, far steps taken)."""
    far_steps = 0
    for _ in range(num_steps):
        k, step, far_path = short_step(o, d, t, free_dist, level)
        advance = alive & (k > 0)
        far_steps += int((advance & far_path).sum())
        t = torch.where(advance, t + step, t)
        alive = alive & (t <= t_far)
    return t, alive, far_steps


def sparse_field(level, seed, cells):
    """A random occupancy of ``cells`` cells and its free-space field (K11's plain version)."""
    g = torch.Generator().manual_seed(seed)
    occ = torch.zeros(8 ** level, dtype=torch.bool)
    occ[torch.randint(0, 8 ** level, (cells,), generator=g)] = True
    return occ, free_space_distance_plain(occ, level)


@pytest.mark.parametrize("level,num_steps", [(5, 32), (6, 64)])
def test_short_step_walk_equals_sdf_walk_plain(level, num_steps):
    """(c) on an octree of large free regions, seeded and hard rays."""
    _, field = sparse_field(level, seed=level, cells=6)
    o, d = seeded_rays(3000, seed=50 + level)
    ho, hd = chip_smoke.walk_hard_rays(torch.device("cpu"), level)
    o, d = torch.cat([o, ho]), torch.cat([d, hd])
    t_near, t_far = aabb_intersect(o, d, 0.0, 10.0)
    t0 = t_near.clamp(min=0.0) + 1e-6
    a0 = t_far > t0
    t_got, a_got, far_steps = walk(o, d, t0, a0, t_far, field, level, num_steps)
    t_want, a_want = t0.clone(), a0.clone()
    sdf_walk_plain(o, d, t_want, a_want, t_far, field, level, num_steps)
    assert torch.equal(t_got, t_want) and torch.equal(a_got, a_want)
    assert far_steps > 0 and int(field.max()) >= 16


def warp_total(overflow: torch.Tensor, seed: int) -> np.float32:
    """K13's count: each warp's integer count (a ballot's population count) added to one
    float32, the warps in an arbitrary order (the atomics')."""
    pad = (-overflow.numel()) % 32
    bits = torch.cat([overflow, torch.zeros(pad, dtype=torch.bool)]).reshape(-1, 32)
    counts = bits.sum(dim=1).numpy()
    total = np.float32(0.0)
    for c in counts[np.random.default_rng(seed).permutation(len(counts))]:
        total = np.float32(total + np.float32(c))
    return total


@pytest.mark.parametrize("share", [0.0, 0.01, 0.5, 1.0])
def test_warp_counts_add_to_the_float_sum(share):
    """(d) on 300,007 rays (not a multiple of 32)."""
    g = torch.Generator().manual_seed(7)
    overflow = torch.rand(300_007, generator=g) < share
    assert warp_total(overflow, seed=1) == overflow.to(torch.float32).sum().item()


def test_warp_counts_of_an_spc_trace():
    """(d) on the overflowing rays of ``spc_trace_plain`` with a budget that runs out."""
    level, steps = 5, 4
    occ, field = sparse_field(level, seed=3, cells=300)
    o, d = seeded_rays(5000, seed=4)
    t, hit, _, num_overflow = spc_trace_plain(o, d, 0.0, 10.0, field, occ,
                                              QueryRoute("bitfield", occ), level, steps)
    # the rays the plain version counts: alive after the walk and not in an occupied cell
    t_near, t_far = aabb_intersect(o, d, 0.0, 10.0)
    t0 = t_near.clamp(min=0.0) + 1e-6
    t_walk, alive = t0.clone(), t_far > t0
    sdf_walk_plain(o, d, t_walk, alive, t_far, field, level, steps)
    assert torch.equal(t_walk, t)
    overflow = alive & ~hit
    assert 0 < int(overflow.sum()) < o.shape[0]
    assert warp_total(overflow, seed=5) == float(num_overflow)


@pytest.mark.parametrize("wrap", ["partial", "function"])
def test_profiler_fallback_names_the_call(wrap):
    """(e) with every profiler session empty."""
    def call(x=0):
        return x

    fn = functools.partial(call, 1) if wrap == "partial" else call
    with mock.patch.object(chip_smoke, "cuda_ms", lambda f, iters, warmup: 1.5), \
            mock.patch.object(chip_smoke, "device_kernels", lambda prof, top: (0.0, [])), \
            mock.patch.object(chip_smoke, "PROFILER_FALLBACKS", []) as fallbacks, \
            mock.patch("torch.profiler.profile"), mock.patch("torch.cuda.synchronize"):
        assert chip_smoke.timed(fn, iters=2) == (1.5, 1.5)
        assert chip_smoke.profile_call(fn)[1:] == (None, [], None)
    where = f"test_torch_walk_rules.py line {call.__code__.co_firstlineno}"
    assert fallbacks == [{"timed": where, "device_ms": "event time"},
                         {"profile": where, "device_busy_ms": "not measured"}]
