"""OctreeAS — the octree acceleration structure (counterpart of
wisp_tpu/accelstructs/octree_as.py).

Two kinds of octree, as in JAX:

* a ``make_dense`` octree, held as the dense max-level occupancy field the radiance-field
  march consults: ``occ_grid`` [res^3] bool and the fused ``cell_density`` [res^3] float32
  (-1 = empty, >= 0 = density estimate), flat index (x*res + y)*res + z. It marches
  against the box alone until ``update_occupancy`` carves it;
* a sparse octree (``from_quantized_points``, ``from_pointcloud``): per level the sorted
  morton codes and grid coords of the occupied cells (host numpy, the topology), the dense
  per-level cell-index maps ``pidx_maps`` through level ``PIDX_MAP_MAX_LEVEL`` (int32, -1 =
  not occupied, on the device), the sorted codes of the levels above them
  (``code_tables``, int32 on the device, for the query's binary search) and the max-level
  ``occ_grid`` and ``cell_density``.

``query_routes`` says how the point query (K9) looks up each level: by its map, by a
binary search in its codes, as a dense octree (index = morton code) or, for a carved
``make_dense`` octree, by the max-level occupancy.

Kernels: ``raymarch_ray`` is K2, ``raymarch_uniform`` K8 (a mode of K2's kernel) and
``raymarch_voxel`` K7 (``csrc/raymarch.cu``), ``octree_query`` K9, ``raytrace`` K10 and
``free_space_distance`` K11 (``csrc/octree.cu``; K9 and K10 share the route lookup of
``csrc/octree_lookup.cuh``). On a CUDA tensor each launches its kernel, on a CPU tensor it
runs its plain version. Rendering marches at midpoints; training passes a ``key``: a
``torch.Generator`` from which the march draws a uniform jitter ([R, S] for 'ray' and
'uniform', [R, K, S] for 'voxel') on the rays' device, or that jitter itself as a float32
tensor (what JAX's key would draw; the parity tests pass JAX's).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.base_as import (ASQueryResults, ASRaymarchResults,
                                                  ASRaytraceResults)
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.ops.spc.core import (MAX_OCTREE_LEVEL, build_level_table, dilate_points,
                                         morton3d, morton_to_points, quantize_points,
                                         quantize_points_np)


def aabb_intersect(origins: torch.Tensor, dirs: torch.Tensor, dist_min: float,
                   dist_max: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against [-1,1]^3 -> (t_near, t_far) per ray; t_near > t_far is a miss."""
    d = torch.where(dirs.abs() > 1e-9, dirs, torch.full_like(dirs, 1e-9))
    inv = 1.0 / d
    t0 = (-1.0 - origins) * inv
    t1 = (1.0 - origins) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    t_near = t_near.clamp(min=float(dist_min))
    t_far = t_far.clamp(max=float(dist_max))
    return t_near, t_far


def _inside(p: torch.Tensor) -> torch.Tensor:
    return ((p >= -1.0) & (p < 1.0)).all(dim=-1)


def _sample_grid_plain(origins, dirs, depths, stride: int,
                       cell_density: Optional[torch.Tensor], level: int):
    """(points, occupancy mask, density) of samples at ``depths`` [R, S] (JAX
    ``_sample_grid``, octree_as.py:443-490): in the box, and, with a field, its strided
    test or the next one hit; the density of the sample's strided test (None without a
    field)."""
    s = depths.shape[1]
    coords = origins[:, None, :] + dirs[:, None, :] * depths[..., None]
    inside = _inside(coords)
    if cell_density is None:
        return coords, inside, None
    res = 2 ** level
    c_str = coords[:, ::stride]
    q = quantize_points(c_str, level)
    flat = (q[..., 0] * res + q[..., 1]) * res + q[..., 2]
    vals = torch.where(_inside(c_str), cell_density[flat],
                       torch.full_like(flat, -1, dtype=torch.float32))
    occ = vals >= 0.0
    if stride > 1:
        occ = occ | torch.cat([occ[:, 1:], torch.zeros_like(occ[:, :1])], dim=1)
    mask = occ.repeat_interleave(stride, dim=1)[:, :s] & inside
    dens = vals.clamp(min=0.0).repeat_interleave(stride, dim=1)[:, :s]
    return coords, mask, dens


def raymarch_ray_plain(origins, dirs, dist_min, dist_max, num_samples: int, stride: int,
                       cell_density: Optional[torch.Tensor], level: int,
                       jitter: Optional[torch.Tensor] = None) -> ASRaymarchResults:
    """Plain PyTorch version of ``raymarch_ray`` (octree_as.py:443-510)."""
    s = num_samples
    t_near, t_far = aabb_intersect(origins, dirs, dist_min, dist_max)
    t_near = t_near.clamp(min=0.0)
    span = (t_far - t_near).clamp(min=0.0)
    u = torch.arange(s, dtype=torch.float32, device=origins.device)[None, :]
    u = u + (0.5 if jitter is None else jitter)
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from the true division of JAX and the kernel
    num = torch.full((1, 1), float(s), device=origins.device)
    u = u / num
    depths = t_near[:, None] + span[:, None] * u
    coords, mask, dens = _sample_grid_plain(origins, dirs, depths, stride, cell_density,
                                            level)
    hit = (t_far > t_near)[:, None]
    return ASRaymarchResults(samples=coords, depth_samples=depths,
                             deltas=span[:, None] / num, mask=mask & hit, cell_density=dens)


def _march(counter: str, origins, dirs, dist_min, dist_max, num_samples: int, stride: int,
           cell_density, level: int, jitter, ustep: float) -> ASRaymarchResults:
    """Launch ``wisp_raymarch_ray``: K2 with ``ustep`` 0, K8 with the uniform step."""
    n = origins.shape[0]
    s = int(num_samples)
    kernels.check(origins, "origins", torch.float32, (n, 3))
    kernels.check(dirs, "dirs", torch.float32, (n, 3))
    if cell_density is not None:
        kernels.check(cell_density, "cell_density", torch.float32, (8 ** level,))
    if jitter is not None:
        kernels.check(jitter, "jitter", torch.float32, (n, s))
    if s < 1 or stride < 1 or not 0 <= level <= 10:
        raise ValueError(f"{counter}: bad num_samples {s}, stride {stride} or level {level}")
    dev = origins.device
    samples = torch.empty((n, s, 3), dtype=torch.float32, device=dev)
    depths = torch.empty((n, s), dtype=torch.float32, device=dev)
    mask = torch.empty((n, s), dtype=torch.bool, device=dev)
    dens = (torch.empty((n, s), dtype=torch.float32, device=dev)
            if cell_density is not None else None)
    deltas = torch.empty((n, 1), dtype=torch.float32, device=dev)
    kernels.launch("wisp_raymarch_ray", counter, origins.data_ptr(), dirs.data_ptr(),
                   kernels.ptr(jitter), n, s, int(stride), float(ustep), float(dist_min),
                   float(dist_max), kernels.ptr(cell_density), int(level), samples.data_ptr(),
                   depths.data_ptr(), mask.data_ptr(), kernels.ptr(dens), deltas.data_ptr())
    return ASRaymarchResults(samples=samples, depth_samples=depths, deltas=deltas,
                             mask=mask, cell_density=dens)


def raymarch_ray(origins: torch.Tensor, dirs: torch.Tensor, dist_min: float, dist_max: float,
                 num_samples: int, stride: int, cell_density: Optional[torch.Tensor],
                 level: int, jitter: Optional[torch.Tensor] = None) -> ASRaymarchResults:
    """Samples over each ray's box span, masked by occupancy (K2): sample i of a ray sits
    at (i + u_i)/S of the span, u_i = 0.5 (midpoints) or ``jitter`` [R, S] in [0, 1).

    ``cell_density`` None marches against the box alone (a dense octree, stride unused);
    otherwise every ``stride``-th sample is tested against the field and each sample is
    occupied when its own strided test or the next one hit."""
    if not origins.is_cuda:
        return raymarch_ray_plain(origins, dirs, dist_min, dist_max, num_samples, stride,
                                  cell_density, level, jitter)
    return _march("raymarch_ray", origins, dirs, dist_min, dist_max, num_samples, stride,
                  cell_density, level, jitter, 0.0)


def uniform_step(num_samples: int) -> float:
    """The 'uniform' march's step, float32(2*sqrt(3) / S): the box's diagonal in S steps."""
    return float(np.float32(2.0 * float(np.sqrt(3)) / num_samples))


def raymarch_uniform_plain(origins, dirs, dist_min, dist_max, num_samples: int, stride: int,
                           cell_density: Optional[torch.Tensor], level: int,
                           jitter: Optional[torch.Tensor] = None) -> ASRaymarchResults:
    """Plain PyTorch version of ``raymarch_uniform`` (octree_as.py:612-633), in JAX's order
    of operations: t_near + u * step."""
    t_near, t_far = aabb_intersect(origins, dirs, dist_min, dist_max)
    t_near = t_near.clamp(min=0.0)
    u = torch.arange(num_samples, dtype=torch.float32, device=origins.device)[None, :]
    u = u + (0.5 if jitter is None else jitter)
    step = torch.tensor(uniform_step(num_samples), device=origins.device)
    depths = t_near[:, None] + u * step
    coords, mask, dens = _sample_grid_plain(origins, dirs, depths, stride, cell_density,
                                            level)
    return ASRaymarchResults(samples=coords, depth_samples=depths,
                             deltas=step.expand(origins.shape[0], 1).contiguous(),
                             mask=mask & (depths < t_far[:, None]), cell_density=dens)


def raymarch_uniform(origins: torch.Tensor, dirs: torch.Tensor, dist_min: float,
                     dist_max: float, num_samples: int, stride: int,
                     cell_density: Optional[torch.Tensor], level: int,
                     jitter: Optional[torch.Tensor] = None) -> ASRaymarchResults:
    """Samples at one global step over the box's diagonal, masked by occupancy (K8): sample
    i of a ray sits at t_near + (i + u_i) * ``uniform_step(S)``, u_i as in ``raymarch_ray``,
    and is valid where the occupancy test of ``raymarch_ray`` holds (the same ``stride``
    rule) and its depth lies before the ray's exit. ``deltas`` [R, 1] holds the step (JAX
    fills [R, S] with it)."""
    if not origins.is_cuda:
        return raymarch_uniform_plain(origins, dirs, dist_min, dist_max, num_samples, stride,
                                      cell_density, level, jitter)
    return _march("raymarch_uniform", origins, dirs, dist_min, dist_max, num_samples, stride,
                  cell_density, level, jitter, uniform_step(num_samples))


def num_coarse_segments(level: int) -> int:
    """Coarse segments of the 'voxel' march at ``level``: one voxel each over the box's
    diagonal, plus one."""
    return int(np.ceil(2 * np.sqrt(3) / (2.0 / 2 ** level))) + 1


def voxel_slots(num_samples: int, budget: int, level: int) -> int:
    """K, the segments a ray keeps in the 'voxel' march: budget // num_samples, at least 1,
    at most every coarse segment."""
    return max(1, min(budget // max(num_samples, 1), num_coarse_segments(level)))


def raymarch_voxel_plain(origins, dirs, dist_min, dist_max, num_samples: int, level: int,
                         budget: int, occ_grid: Optional[torch.Tensor],
                         cell_density: Optional[torch.Tensor], max_level: int,
                         jitter: Optional[torch.Tensor] = None,
                         early_stop: float = 0.0) -> ASRaymarchResults:
    """Plain PyTorch version of ``raymarch_voxel`` (octree_as.py:512-610, line by line)."""
    res = 2 ** level
    voxel = 2.0 / res
    t_near, t_far = aabb_intersect(origins, dirs, dist_min, dist_max)
    t_near = t_near.clamp(min=0.0)
    n, dev = origins.shape[0], origins.device
    num_coarse = num_coarse_segments(level)
    tc = t_near[:, None] + (torch.arange(num_coarse, dtype=torch.float32, device=dev)[None, :]
                            + 0.5) * voxel
    coarse = origins[:, None, :] + dirs[:, None, :] * tc[..., None]
    inside = _inside(coarse)
    span_valid = (tc - 0.5 * voxel) < t_far[:, None]
    cdens = None
    if occ_grid is None and cell_density is None:
        cmask = inside & span_valid
    else:
        q = quantize_points(coarse, max_level)
        rmax = 2 ** max_level
        flat = (q[..., 0] * rmax + q[..., 1]) * rmax + q[..., 2]
        if cell_density is not None:
            vals = torch.where(inside, cell_density[flat], torch.full_like(tc, -1.0))
            cmask = (vals >= 0.0) & span_valid
            cdens = vals.clamp(min=0.0)
        else:
            cmask = inside & occ_grid[flat] & span_valid
    cmask_sel = cmask
    if cdens is not None and early_stop and early_stop > 0.0:
        tau_seg = cdens * voxel * cmask.to(torch.float32)
        t_seg = torch.exp(-(torch.cumsum(tau_seg, dim=1) - tau_seg))
        cmask_sel = cmask & (t_seg > early_stop)
    k = voxel_slots(num_samples, budget, level)
    num_overflow = (cmask_sel.sum(dim=1) > k).sum().to(torch.float32)
    order = torch.argsort((~cmask_sel).to(torch.uint8), dim=1, stable=True)[:, :k]
    sel_valid = torch.gather(cmask_sel, 1, order)
    u = torch.arange(num_samples, dtype=torch.float32, device=dev)[None, None, :]
    u = u + (0.5 if jitter is None else jitter.reshape(n, k, num_samples))
    step = torch.tensor(np.float32(voxel / num_samples), device=dev)
    seg_t0 = t_near[:, None] + order.to(torch.float32) * voxel
    depths = (seg_t0[..., None] + u * step).reshape(n, k * num_samples)
    samples = origins[:, None, :] + dirs[:, None, :] * depths[..., None]
    mask = sel_valid[..., None].expand(n, k, num_samples).reshape(n, k * num_samples)
    mask = mask & (depths < t_far[:, None])
    dens = None
    if cdens is not None:
        dens = torch.gather(cdens, 1, order)[..., None].expand(n, k, num_samples) \
            .reshape(n, k * num_samples)
    return ASRaymarchResults(samples=samples, depth_samples=depths,
                             deltas=step.expand(n, 1).contiguous(), mask=mask,
                             cell_density=dens, num_overflow=num_overflow)


def raymarch_voxel(origins: torch.Tensor, dirs: torch.Tensor, dist_min: float,
                   dist_max: float, num_samples: int, level: int, budget: int,
                   occ_grid: Optional[torch.Tensor], cell_density: Optional[torch.Tensor],
                   max_level: int, jitter: Optional[torch.Tensor] = None,
                   early_stop: float = 0.0) -> ASRaymarchResults:
    """``num_samples`` samples in each of the first K occupied voxels of a ray (K7).

    The ray's box span is cut into ``num_coarse_segments(level)`` segments of one voxel at
    ``level``; a segment is occupied when its midpoint is in the box, its start before the
    ray's exit, and the octree's occupancy at ``max_level`` holds there: ``cell_density``
    (the fused field, -1 = empty; it also gives each segment a density estimate),
    ``occ_grid`` (bool), or neither (a dense octree: the box alone). With a density field
    and ``early_stop`` > 0 the segments whose transmittance estimate has fallen to
    ``early_stop`` are dropped first. The first K = ``voxel_slots(num_samples, budget,
    level)`` occupied segments in ray order fill the slots, then the others in index order;
    slot k's depths are t_near + order_k * voxel + (j + u_j) * voxel / num_samples, u = 0.5
    or ``jitter`` [R, K, S]. ``num_overflow`` counts the rays with more than K occupied
    segments (a float32 scalar)."""
    if not origins.is_cuda:
        return raymarch_voxel_plain(origins, dirs, dist_min, dist_max, num_samples, level,
                                    budget, occ_grid, cell_density, max_level, jitter,
                                    early_stop)
    n = origins.shape[0]
    s = int(num_samples)
    if s < 1 or budget < 1 or not 0 <= level <= 10 or not 0 <= max_level <= 10:
        raise ValueError(f"raymarch_voxel: bad num_samples {s}, budget {budget}, level "
                         f"{level} or max_level {max_level}")
    nc = num_coarse_segments(level)
    k = voxel_slots(s, budget, level)
    kernels.check(origins, "origins", torch.float32, (n, 3))
    kernels.check(dirs, "dirs", torch.float32, (n, 3))
    if cell_density is not None:
        kernels.check(cell_density, "cell_density", torch.float32, (8 ** max_level,))
        occ_grid = None  # the field carries the occupancy
    elif occ_grid is not None:
        kernels.check(occ_grid, "occ_grid", torch.bool, (8 ** max_level,))
    if jitter is not None:
        kernels.check(jitter, "jitter", torch.float32, (n, k, s))
    dev = origins.device
    samples = torch.empty((n, k * s, 3), dtype=torch.float32, device=dev)
    depths = torch.empty((n, k * s), dtype=torch.float32, device=dev)
    mask = torch.empty((n, k * s), dtype=torch.bool, device=dev)
    dens = (torch.empty((n, k * s), dtype=torch.float32, device=dev)
            if cell_density is not None else None)
    num_overflow = torch.zeros((), dtype=torch.float32, device=dev)
    voxel = 2.0 / 2 ** level
    step = float(np.float32(voxel / s))
    kernels.launch("wisp_raymarch_voxel", "raymarch_voxel", origins.data_ptr(),
                   dirs.data_ptr(), kernels.ptr(jitter), n, s, k, nc, voxel, step,
                   float(dist_min), float(dist_max), kernels.ptr(occ_grid),
                   kernels.ptr(cell_density), int(max_level), float(early_stop or 0.0),
                   samples.data_ptr(), depths.data_ptr(), mask.data_ptr(), kernels.ptr(dens),
                   num_overflow.data_ptr())
    return ASRaymarchResults(samples=samples, depth_samples=depths,
                             deltas=torch.full((n, 1), step, dtype=torch.float32, device=dev),
                             mask=mask, cell_density=dens, num_overflow=num_overflow)


class QueryRoute(NamedTuple):
    """How ``octree_query`` finds the cells of one level: ``kind`` 'map' (``table`` the
    level's dense pidx map, int32 [8^l]), 'search' (``table`` its sorted morton codes,
    int32), 'dense' (every cell exists, index = morton code; no table) or 'bitfield'
    (``table`` the max-level occupancy, bool [8^l]: index = morton code where occupied)."""
    kind: str
    table: Optional[torch.Tensor] = None


_ROUTE_CODES = {"map": 0, "search": 1, "dense": 2, "bitfield": 3}


def cell_index_plain(route: QueryRoute, q: torch.Tensor, l: int) -> torch.Tensor:
    """[N] int32 index of the cells ``q`` [N, 3] (integer coords in [0, 2^l)) at level l by
    ``route`` (see ``QueryRoute``); -1 = not occupied."""
    res_l = 2 ** l
    flat = (q[:, 0] * res_l + q[:, 1]) * res_l + q[:, 2]
    code = morton3d(q).to(torch.int32)
    if route.kind == "map":
        pidx = route.table[flat]
    elif route.kind == "search":
        table = route.table
        i = torch.searchsorted(table, code).clamp(0, table.shape[0] - 1)
        pidx = torch.where(table[i] == code, i.to(torch.int32), torch.full_like(code, -1))
    elif route.kind == "dense":
        pidx = code
    else:
        pidx = torch.where(route.table[flat], code, torch.full_like(code, -1))
    return pidx.to(torch.int32)


def octree_query_plain(coords: torch.Tensor, routes: Sequence, level: int,
                       with_parents: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``octree_query`` (octree_as.py:199-242, every route)."""
    q = quantize_points(coords, level)
    cols = [cell_index_plain(routes[l], q >> (level - l), l)
            for l in (range(level + 1) if with_parents else [level])]
    pidx = torch.stack(cols, dim=-1) if with_parents else cols[0]
    inside = ((coords >= -1.0) & (coords <= 1.0)).all(dim=-1)
    return torch.where(inside[:, None] if with_parents else inside, pidx,
                       torch.full_like(pidx, -1))


def octree_query(coords: torch.Tensor, routes: Sequence, level: int,
                 with_parents: bool = False) -> torch.Tensor:
    """Point -> level-local cell index at ``level`` (K9): [N,3] float32 -> [N] int32, or
    [N, level+1] int32 for the whole ancestor chain. -1 = unoccupied; outside [-1,1]^3
    (inclusive) always -1. ``routes[l]``, a ``QueryRoute``, says how level l is looked up
    (``OctreeAS.query_routes``; a map's flat index is (x*res_l + y)*res_l + z). A launch
    that takes the search route at some level counts under ``octree_query_search``, any
    other under ``octree_query``."""
    if not coords.is_cuda:
        return octree_query_plain(coords, routes, level, with_parents)
    n = coords.shape[0]
    kernels.check(coords, "coords", torch.float32, (n, 3))
    if not 0 <= level < len(routes) or level > 10:
        raise ValueError(f"octree_query: level {level} needs its route ({len(routes)} "
                         f"given)")
    first = 0 if with_parents else level
    codes, tables, lens = [], [], []
    for l in range(level + 1):
        route = routes[l] if l >= first else QueryRoute("dense")     # not read
        code, table, length = route_args(route, l, f"routes[{l}]")
        codes.append(code)
        tables.append(table)
        lens.append(length)
    ncols = level + 1 if with_parents else 1
    out = torch.empty((n, ncols) if with_parents else (n,), dtype=torch.int32,
                      device=coords.device)
    if n:
        c_routes = (ctypes.c_int * len(codes))(*codes)
        c_tables = (ctypes.c_void_p * len(tables))(*tables)
        c_lens = (ctypes.c_longlong * len(lens))(*lens)
        searched = any(c == _ROUTE_CODES["search"] for c in codes[first:])
        kernels.launch("wisp_octree_query",
                       "octree_query_search" if searched else "octree_query",
                       coords.data_ptr(), n, level, ctypes.addressof(c_routes),
                       ctypes.addressof(c_tables), ctypes.addressof(c_lens),
                       int(bool(with_parents)), out.data_ptr())
    return out


def route_args(route: QueryRoute, level: int, name: str):
    """(route code, table pointer, table length) of one level's route, checked."""
    if route.kind == "map":
        kernels.check(route.table, name, torch.int32, (8 ** level,))
    elif route.kind == "search":
        kernels.check(route.table, name, torch.int32, (None,))
        if route.table.shape[0] < 1:
            raise ValueError(f"{name}: level {level}'s code table is empty")
    elif route.kind == "bitfield":
        kernels.check(route.table, name, torch.bool, (8 ** level,))
    elif route.kind != "dense":
        raise ValueError(f"{name}: unknown route {route.kind!r}")
    table = route.table
    return (_ROUTE_CODES[route.kind], 0 if table is None else table.data_ptr(),
            0 if table is None else table.shape[0])


def raytrace_plain(origins, dirs, dist_min, dist_max, route: QueryRoute, level: int,
                   capacity: int, max_steps: int) -> ASRaytraceResults:
    """Plain PyTorch version of ``raytrace``: JAX's ``trace_one`` (octree_as.py:371-409)
    over all rays at once, step by step, in its float order."""
    res = 2 ** level
    voxel = 2.0 / res
    n, dev = origins.shape[0], origins.device
    t_near, tf = aabb_intersect(origins, dirs, dist_min, dist_max)
    tn = t_near.clamp(min=0.0)
    d_safe = torch.where(dirs.abs() > 1e-9, dirs, torch.full_like(dirs, 1e-9))
    start = origins + (tn + torch.tensor(1e-6, device=dev))[:, None] * dirs
    # floor, then the int32 cast (saturating, as XLA's) and the clip
    iv = torch.floor((start + 1.0) / voxel).clamp(-1, res).to(torch.int64).clamp(0, res - 1)
    step = torch.where(d_safe > 0, 1, -1).to(torch.int64)
    next_bound = (iv + (step > 0).to(torch.int64)).to(torch.float32) * voxel - 1.0
    t_max = (next_bound - origins) / d_safe
    t_delta = (torch.full_like(d_safe, voxel) / d_safe).abs()
    pidx_buf = torch.full((n, capacity), -1, dtype=torch.int32, device=dev)
    t_in = torch.zeros((n, capacity), dtype=torch.float32, device=dev)
    t_out = torch.zeros((n, capacity), dtype=torch.float32, device=dev)
    ptr = torch.zeros((n,), dtype=torch.int64, device=dev)
    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    t_cur = tn
    alive = tf > tn
    for _ in range(max_steps):
        if not bool(alive.any()):      # a dead ray is frozen: nothing is written any more
            break
        axis = torch.where(t_max[:, 1] < t_max[:, 0], 1, 0)      # jnp.argmin: first on a tie
        axis = torch.where(t_max[:, 2] < t_max[rows, axis], 2, axis)
        t_next = torch.minimum(t_max[rows, axis], tf)
        inb = ((iv >= 0) & (iv < res)).all(dim=1)
        pidx = torch.where(inb, cell_index_plain(route, iv.clamp(0, res - 1), level),
                           torch.full_like(ptr, -1, dtype=torch.int32))
        hit = alive & (pidx >= 0)
        write = hit & (ptr < capacity)
        overflow |= hit & (ptr >= capacity)
        w_rows, w_slots = rows[write], ptr[write]
        pidx_buf[w_rows, w_slots] = pidx[write]
        t_in[w_rows, w_slots] = t_cur[write]
        t_out[w_rows, w_slots] = t_next[write]
        ptr = ptr + write.to(torch.int64)
        iv[rows, axis] += step[rows, axis]
        t_max[rows, axis] += t_delta[rows, axis]
        alive = alive & (t_next < tf) & ((iv >= 0) & (iv < res)).all(dim=1)
        t_cur = t_next
    return ASRaytraceResults(pidx=pidx_buf, t_entry=t_in, t_exit=t_out, mask=pidx_buf >= 0,
                             overflow=overflow)


def raytrace(origins: torch.Tensor, dirs: torch.Tensor, dist_min: float, dist_max: float,
             route: QueryRoute, level: int, capacity: int, max_steps: int
             ) -> ASRaytraceResults:
    """The occupied cells of ``level`` that each ray crosses, in ray order (K10): a 3-D DDA
    of ``max_steps`` steps from the cell at t_near + 1e-6 (t_near clamped at 0), each cell
    looked up by ``route`` (the level's ``QueryRoute``), each occupied one's (pidx, entry
    depth, exit depth) in the ray's next slot of ``capacity``; a ray with more occupied
    cells than slots has ``overflow`` set. Empty slots hold -1, 0 and 0."""
    if not origins.is_cuda:
        return raytrace_plain(origins, dirs, dist_min, dist_max, route, level, capacity,
                              max_steps)
    n = origins.shape[0]
    kernels.check(origins, "origins", torch.float32, (n, 3))
    kernels.check(dirs, "dirs", torch.float32, (n, 3))
    if not 0 <= level <= 10 or capacity < 1 or max_steps < 0:
        raise ValueError(f"raytrace: bad level {level}, capacity {capacity} or max_steps "
                         f"{max_steps}")
    code, table, length = route_args(route, level, "route")
    dev = origins.device
    pidx = torch.empty((n, capacity), dtype=torch.int32, device=dev)
    t_in = torch.empty((n, capacity), dtype=torch.float32, device=dev)
    t_out = torch.empty((n, capacity), dtype=torch.float32, device=dev)
    mask = torch.empty((n, capacity), dtype=torch.bool, device=dev)
    overflow = torch.empty((n,), dtype=torch.bool, device=dev)
    kernels.launch("wisp_raytrace", "raytrace", origins.data_ptr(), dirs.data_ptr(), n,
                   float(dist_min), float(dist_max), int(level), code, table, length,
                   int(capacity), int(max_steps), pidx.data_ptr(), t_in.data_ptr(),
                   t_out.data_ptr(), mask.data_ptr(), overflow.data_ptr())
    return ASRaytraceResults(pidx=pidx, t_entry=t_in, t_exit=t_out, mask=mask,
                             overflow=overflow)


def free_space_distance_plain(occ_grid: torch.Tensor, level: int,
                              max_k: int = 31) -> torch.Tensor:
    """Plain PyTorch version of ``free_space_distance``: JAX's log-doubling separable
    max-dilations (octree_as.py:270-287), each a max-pool, whose implicit -inf padding
    acts as JAX's zero padding on the 0/1 grid."""
    res = 2 ** level
    occ = occ_grid.reshape(res, res, res)
    cur = occ.to(torch.float32)[None, None]
    dist = torch.where(occ, 0, -1).to(torch.int32)
    s_prev, s, radius = 0, 0, 1
    while s < max_k:
        for axis in range(3):
            win = tuple(2 * radius + 1 if a == axis else 1 for a in range(3))
            pad = tuple(radius if a == axis else 0 for a in range(3))
            cur = F.max_pool3d(cur, kernel_size=win, stride=1, padding=pad)
        s += radius
        dist = torch.where((cur[0, 0] > 0) & (dist < 0), s_prev + 1, dist).to(torch.int32)
        s_prev = s
        radius *= 2
    return torch.where(dist < 0, s_prev + 1, dist).to(torch.int32).reshape(-1)


def free_space_cap(max_k: int) -> int:
    """The value of the cells JAX's dilations never reach: one more than the last
    cumulative radius 1, 3, 7, 15, ... that is at least ``max_k``."""
    s, radius = 0, 1
    while s < max_k:
        s += radius
        radius *= 2
    return s + 1


class FreeSpaceLayout(NamedTuple):
    """K11's bit grids: a z line of ``2^level`` cells in ``line_words`` 32-bit words (bit b
    of word w is cell z = 32w + b; a line shorter than a word uses its low bits), and
    ``thresholds + 1`` such grids in ``scratch_words`` words of scratch (the occupancy, then
    its dilations at the cumulative radii 1, 3, 7, ...)."""
    line_words: int
    thresholds: int
    scratch_words: int


def free_space_layout(level: int, max_k: int) -> FreeSpaceLayout:
    """The bit layout of ``free_space_distance``'s kernel at ``level`` and ``max_k``: J
    thresholds where ``free_space_cap(max_k)`` = 2^J."""
    res = 2 ** level
    line_words = max(1, res // 32)
    thresholds = free_space_cap(max_k).bit_length() - 1
    return FreeSpaceLayout(line_words, thresholds, (thresholds + 1) * res * res * line_words)


def free_space_distance(occ_grid: torch.Tensor, level: int, max_k: int = 31) -> torch.Tensor:
    """Chebyshev distance from each max-level cell to occupied space, quantized as JAX
    quantizes it (K11): [res^3] bool -> [res^3] int32, 0 = occupied, else the largest power
    of two not above the distance, and ``free_space_cap(max_k)`` (32 for max_k 31) beyond
    the last dilation. A point in a cell of value k is at least (k-1)·voxel from occupied
    space."""
    if not occ_grid.is_cuda:
        return free_space_distance_plain(occ_grid, level, max_k)
    res = 2 ** level
    kernels.check(occ_grid, "occ_grid", torch.bool, (res ** 3,))
    cap = free_space_cap(max_k)
    if not 0 <= level <= 8 or cap > 255:
        raise ValueError(f"free_space_distance: level {level} or max_k {max_k} out of range")
    scratch = torch.empty((free_space_layout(level, max_k).scratch_words,), dtype=torch.int32,
                          device=occ_grid.device)
    out = torch.empty((res ** 3,), dtype=torch.int32, device=occ_grid.device)
    kernels.launch("wisp_free_space_distance", "free_space_distance", occ_grid.data_ptr(),
                   level, cap, scratch.data_ptr(), out.data_ptr())
    return out


class MeshExtent:
    """Host-side mesh kept beside an octree built from it (never on the device)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = vertices
        self.faces = faces


class OctreeAS:
    """A dense occupancy field (``make_dense``) or a sparse octree (level tables); see the
    module docstring."""

    # levels with a dense pidx map (8^7 int32 = 8 MB); JAX binary-searches above
    PIDX_MAP_MAX_LEVEL = 7
    # levels with the dense occupancy field and density estimate
    OCC_GRID_MAX_LEVEL = 8

    def __init__(self, max_level: int, occ_grid: Optional[torch.Tensor],
                 cell_density: Optional[torch.Tensor], dense: bool,
                 codes: Optional[List[np.ndarray]] = None,
                 points: Optional[List[np.ndarray]] = None,
                 pidx_maps: Optional[List[torch.Tensor]] = None,
                 code_tables: Optional[List[torch.Tensor]] = None):
        self.max_level = int(max_level)
        self.occ_grid = occ_grid
        self.cell_density = cell_density
        self.dense = bool(dense)
        self.codes = codes
        self.points = points
        self.pidx_maps = pidx_maps
        # the sorted codes (int32, on the device) of the levels above the pidx maps
        self.code_tables = code_tables
        # the mesh the octree was built from, where an SDF dataset needs it
        self.extent: Optional[MeshExtent] = None
        self.level_counts = (tuple(int(len(c)) for c in codes) if codes is not None
                             else tuple(8 ** l for l in range(self.max_level + 1)))
        self.query_routes = self._query_routes()

    def _query_routes(self) -> List[Optional[QueryRoute]]:
        """How ``query`` looks up each level (JAX's route order, octree_as.py:209-233):
        dense, bitfield-only (the max level alone; None elsewhere), the pidx maps, the
        binary search above them."""
        levels = range(self.max_level + 1)
        if self.dense:
            return [QueryRoute("dense") for _ in levels]
        if self.codes is None:
            return [QueryRoute("bitfield", self.occ_grid) if l == self.max_level else None
                    for l in levels]
        maps = self.pidx_maps
        return [QueryRoute("map", maps[l]) if l < len(maps)
                else QueryRoute("search", self.code_tables[l - len(maps)]) for l in levels]

    @classmethod
    def make_dense(cls, level: int, device: DeviceLike = None) -> "OctreeAS":
        """Fully occupied octree: the march tests the box alone until it is carved."""
        device = resolve_device(device)
        n = 8 ** level
        return cls(level, torch.ones((n,), dtype=torch.bool, device=device),
                   torch.zeros((n,), dtype=torch.float32, device=device), dense=True)

    @classmethod
    def from_codes(cls, codes_per_level: Sequence[np.ndarray],
                   device: DeviceLike = None) -> "OctreeAS":
        """A sparse octree from the sorted morton codes of each level 0..max_level."""
        device = resolve_device(device)
        codes = [np.asarray(c, dtype=np.uint64) for c in codes_per_level]
        max_level = len(codes) - 1
        if max_level > MAX_OCTREE_LEVEL:
            raise ValueError(f"octree level {max_level} above {MAX_OCTREE_LEVEL}")
        points = [morton_to_points(c) for c in codes]
        maps = []
        for l, pts in enumerate(points[:cls.PIDX_MAP_MAX_LEVEL + 1]):
            res_l = 2 ** l
            p = pts.astype(np.int64)
            m = np.full(res_l ** 3, -1, np.int32)
            m[(p[:, 0] * res_l + p[:, 1]) * res_l + p[:, 2]] = np.arange(len(p),
                                                                         dtype=np.int32)
            maps.append(torch.from_numpy(m).to(device))
        # the levels above the maps are binary-searched in their sorted codes (< 2^30)
        tables = [torch.from_numpy(c.astype(np.int32)).to(device)
                  for c in codes[cls.PIDX_MAP_MAX_LEVEL + 1:]]
        occ = dens = None
        if max_level <= cls.OCC_GRID_MAX_LEVEL:
            res = 2 ** max_level
            p = points[-1].astype(np.int64)
            o = np.zeros(res ** 3, dtype=bool)
            o[(p[:, 0] * res + p[:, 1]) * res + p[:, 2]] = True
            occ = torch.from_numpy(o).to(device)
            dens = torch.where(occ, 0.0, -1.0).to(torch.float32)
        return cls(max_level, occ, dens, dense=False, codes=codes, points=points,
                   pidx_maps=maps, code_tables=tables)

    @classmethod
    def from_quantized_points(cls, quantized_points: np.ndarray, level: int,
                              device: DeviceLike = None) -> "OctreeAS":
        codes, _ = build_level_table(np.asarray(quantized_points), level)
        return cls.from_codes(codes, device=device)

    @classmethod
    def from_mesh(cls, mesh_path: str, level: int, sample_tex: bool = False,
                  num_samples: int = 100_000_000, device: DeviceLike = None) -> "OctreeAS":
        """The cells of ``num_samples`` area-weighted surface samples of the .obj at
        ``mesh_path`` (normalized to 'sphere') and of the same samples jittered by up to a
        voxel, ``default_rng(0)``, as JAX draws them (octree_as.py:147-163). The octree
        carries the normalized mesh as ``extent``."""
        from wisp_tpu_torch.ops.mesh.io import load_obj
        from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
        out = load_obj(mesh_path, load_materials=sample_tex)
        vertices, faces = normalize(out[0], out[1], "sphere")
        samples = sample_surface(vertices, faces, num_samples)
        rng = np.random.default_rng(0)
        jitter = (rng.random(samples.shape).astype(np.float32) * 2 - 1) * (1.0 / (2 ** level))
        pts = np.clip(np.concatenate([samples, samples + jitter]), -1.0, 1.0 - 1e-6)
        blas = cls.from_quantized_points(quantize_points_np(pts, level), level, device=device)
        blas.extent = MeshExtent(vertices, faces)
        return blas

    @classmethod
    def from_pointcloud(cls, pointcloud: np.ndarray, level: int, dilate: int = 0,
                        device: DeviceLike = None) -> "OctreeAS":
        """Occupied cells = the cells holding the points, dilated (26-neighbourhood)
        ``dilate`` times."""
        q = quantize_points_np(np.asarray(pointcloud), level)
        for _ in range(dilate):
            q = dilate_points(q, level)
        return cls.from_quantized_points(q, level, device=device)

    def update_occupancy(self, occ_grid: torch.Tensor,
                         cell_density: Optional[torch.Tensor] = None) -> "OctreeAS":
        """A new octree with the occupancy replaced (the pruning fast path; the level
        tables stay). Without ``cell_density`` the old estimates stay where cells stay
        occupied."""
        occ_grid = occ_grid.reshape(self.occ_grid.shape).to(torch.bool)
        if cell_density is None:
            cell_density = torch.where(occ_grid, self.cell_density.clamp(min=0.0),
                                       torch.full_like(self.cell_density, -1.0))
        return OctreeAS(self.max_level, occ_grid,
                        cell_density.reshape(occ_grid.shape).to(torch.float32)
                        .contiguous(), dense=False, codes=self.codes, points=self.points,
                        pidx_maps=self.pidx_maps, code_tables=self.code_tables)

    def query(self, coords: torch.Tensor, level: Optional[int] = None,
              with_parents: bool = False) -> ASQueryResults:
        """Point -> cell index at ``level`` (K9; see ``octree_query``), by the level's
        route (``query_routes``). A bitfield-only octree answers at its max level alone,
        as JAX's does."""
        if level is None:
            level = self.max_level
        if not 0 <= level <= self.max_level:
            raise ValueError(f"query at level {level} of an octree of levels "
                             f"0..{self.max_level}")
        needed = range(level + 1) if with_parents else [level]
        if any(self.query_routes[l] is None for l in needed):
            raise ValueError("a bitfield-only octree (a carved make_dense) answers queries "
                             "at its max level only, without parents")
        return ASQueryResults(pidx=octree_query(coords.contiguous(), self.query_routes, level,
                                                with_parents))

    def occupancy_at(self, coords: torch.Tensor) -> torch.Tensor:
        """Boolean occupancy at max_level (one gather); outside [-1,1)^3 is empty."""
        inside = _inside(coords)
        if self.dense or self.occ_grid is None:
            return inside
        res = 2 ** self.max_level
        q = quantize_points(coords, self.max_level)
        occ = self.occ_grid[(q[..., 0] * res + q[..., 1]) * res + q[..., 2]]
        return inside & occ

    def free_space_distance(self, max_k: int = 31) -> torch.Tensor:
        """K11 on the max-level occupancy (see ``free_space_distance``); all zeros for a
        dense octree."""
        if self.dense or self.occ_grid is None:
            device = (self.occ_grid if self.occ_grid is not None else self.pidx_maps[0]).device
            return torch.zeros((8 ** self.max_level,), dtype=torch.int32, device=device)
        return free_space_distance(self.occ_grid, self.max_level, max_k)

    @staticmethod
    def aabb_intersect(rays: Rays) -> Tuple[torch.Tensor, torch.Tensor]:
        return aabb_intersect(rays.origins, rays.dirs, rays.dist_min, rays.dist_max)

    # the byte guard of capacity='exact' (13 bytes a slot: pidx, both depths, the mask)
    RAYTRACE_EXACT_MAX_BYTES = 2 * 1024 ** 3

    def raytrace(self, rays: Rays, level: Optional[int] = None, with_exit: bool = False,
                 capacity=None, max_steps: Optional[int] = None) -> ASRaytraceResults:
        """The occupied cells of ``level`` (default the max level) that each ray crosses
        (K10; see ``raytrace``), looked up by the level's route. ``capacity`` defaults to
        min(3·2^level + 2, 512), the cells a ray can cross at most, capped; 'exact' takes
        that bound at any level and raises if the buffers would pass
        ``RAYTRACE_EXACT_MAX_BYTES`` (chunk the rays then). ``max_steps`` defaults to
        3·2^level + 2. ``with_exit`` is JAX's vestigial flag: both depths are always
        returned."""
        if level is None:
            level = self.max_level
        if not 0 <= level <= self.max_level:
            raise ValueError(f"raytrace at level {level} of an octree of levels "
                             f"0..{self.max_level}")
        route = self.query_routes[level]
        if route is None:
            raise ValueError("a bitfield-only octree (a carved make_dense) is traced at its "
                             "max level only")
        res = 2 ** level
        n = rays.origins.shape[0]
        if capacity == "exact":
            capacity = 3 * res + 2
            need = n * capacity * 13
            if need > self.RAYTRACE_EXACT_MAX_BYTES:
                raise ValueError(
                    f"raytrace(capacity='exact') at level {level} needs ~{need / 2**30:.1f}"
                    f" GB of interval buffers for {n} rays; chunk the rays (limit "
                    f"{self.RAYTRACE_EXACT_MAX_BYTES / 2**30:.1f} GB)")
        if capacity is None:
            capacity = min(3 * res + 2, 512)
        if max_steps is None:
            max_steps = 3 * res + 2
        return raytrace(rays.origins.contiguous(), rays.dirs.contiguous(), rays.dist_min,
                        rays.dist_max, route, level, int(capacity), int(max_steps))

    def raymarch(self, rays: Rays, raymarch_type: str = "voxel", num_samples: int = 64,
                 level: Optional[int] = None, key=None, budget: Optional[int] = None,
                 stride: int = 1, early_stop: float = 0.0) -> ASRaymarchResults:
        """``budget`` ('voxel' only): the fine samples a ray keeps, ``budget //
        num_samples`` voxels (default 1024). ``stride`` ('ray' and 'uniform'): see
        ``raymarch_ray``.
        ``early_stop`` ('voxel' only): the coarse transmittance cull of ``raymarch_voxel``;
        0 = off."""
        if level is None:
            level = self.max_level
        if raymarch_type == "ray":
            return self._raymarch_ray(rays, num_samples, key, stride=stride)
        if raymarch_type == "voxel":
            return self._raymarch_voxel(rays, num_samples, level, key, budget=budget or 1024,
                                        early_stop=early_stop)
        if raymarch_type == "uniform":
            return self._raymarch_uniform(rays, num_samples, key, stride=stride)
        raise ValueError(f"Unknown raymarch_type {raymarch_type!r}")

    def _raymarch_ray(self, rays: Rays, num_samples: int, key=None,
                      stride: int = 1) -> ASRaymarchResults:
        return raymarch_ray(rays.origins, rays.dirs, rays.dist_min, rays.dist_max,
                            num_samples, stride, self._march_field(),
                            self.max_level, self._jitter(rays, num_samples, key))

    def _raymarch_uniform(self, rays: Rays, num_samples: int, key=None,
                          stride: int = 1) -> ASRaymarchResults:
        """K8: the box's diagonal in ``num_samples`` steps from each ray's entry."""
        return raymarch_uniform(rays.origins, rays.dirs, rays.dist_min, rays.dist_max,
                                num_samples, stride, self._march_field(),
                                self.max_level, self._jitter(rays, num_samples, key))

    def _march_field(self) -> Optional[torch.Tensor]:
        """The field the 'ray' and 'uniform' marches test: none for a dense octree."""
        return None if self.dense else self.cell_density

    @staticmethod
    def _jitter(rays: Rays, num_samples: int, key) -> Optional[torch.Tensor]:
        """The [R, S] march jitter of ``key``: drawn from a ``torch.Generator``, or given."""
        if isinstance(key, torch.Generator):
            return torch.rand((rays.origins.shape[0], num_samples), generator=key,
                              dtype=torch.float32, device=rays.origins.device)
        return None if key is None else key.to(torch.float32).contiguous()

    def _raymarch_voxel(self, rays: Rays, num_samples: int, level: int, key=None,
                        budget: int = 1024, early_stop: float = 0.0) -> ASRaymarchResults:
        """K7 over segments at ``level`` against the occupancy at ``max_level``: the fused
        density field of a sparse or carved octree, the box alone for a dense one."""
        n = rays.origins.shape[0]
        jitter = None
        if isinstance(key, torch.Generator):
            k = voxel_slots(num_samples, budget, level)
            jitter = torch.rand((n, k, num_samples), generator=key, dtype=torch.float32,
                                device=rays.origins.device)
        elif key is not None:
            jitter = key.to(torch.float32).contiguous()
        occ = field = None
        if not (self.dense or self.occ_grid is None):
            occ, field = self.occ_grid, self.cell_density
        return raymarch_voxel(rays.origins, rays.dirs, rays.dist_min, rays.dist_max,
                              num_samples, level, budget, occ, field, self.max_level, jitter,
                              early_stop)
