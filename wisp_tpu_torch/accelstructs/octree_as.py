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
  not occupied, on the device) and the max-level ``occ_grid`` and ``cell_density``.

Kernels: ``raymarch_ray`` is K2 (``csrc/raymarch.cu``), ``octree_query`` K9 and
``free_space_distance`` K11 (``csrc/octree.cu``). On a CUDA tensor each launches its kernel,
on a CPU tensor it runs its plain version. Rendering marches at midpoints; training passes
a ``key``: a ``torch.Generator`` from which the march draws a uniform jitter [R, S] on the
rays' device, or that jitter itself as a float32 tensor (what JAX's key would draw; the
parity tests pass JAX's).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.base_as import ASQueryResults, ASRaymarchResults
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.ops.spc.core import (MAX_OCTREE_LEVEL, build_level_table, dilate_points,
                                         morton_to_points, quantize_points,
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


def raymarch_ray_plain(origins, dirs, dist_min, dist_max, num_samples: int, stride: int,
                       cell_density: Optional[torch.Tensor], level: int,
                       jitter: Optional[torch.Tensor] = None) -> ASRaymarchResults:
    """Plain PyTorch version of ``raymarch_ray`` (octree_as.py:443-510)."""
    n, s = origins.shape[0], num_samples
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
    coords = origins[:, None, :] + dirs[:, None, :] * depths[..., None]
    inside = _inside(coords)
    hit = (t_far > t_near)[:, None]
    dens = None
    if cell_density is None:
        mask = inside
    else:
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
    return ASRaymarchResults(samples=coords, depth_samples=depths,
                             deltas=span[:, None] / num, mask=mask & hit, cell_density=dens)


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
    n = origins.shape[0]
    s = int(num_samples)
    kernels.check(origins, "origins", torch.float32, (n, 3))
    kernels.check(dirs, "dirs", torch.float32, (n, 3))
    if cell_density is not None:
        kernels.check(cell_density, "cell_density", torch.float32, (8 ** level,))
    if jitter is not None:
        kernels.check(jitter, "jitter", torch.float32, (n, s))
    if s < 1 or stride < 1 or not 0 <= level <= 10:
        raise ValueError(f"raymarch_ray: bad num_samples {s}, stride {stride} or "
                         f"level {level}")
    dev = origins.device
    samples = torch.empty((n, s, 3), dtype=torch.float32, device=dev)
    depths = torch.empty((n, s), dtype=torch.float32, device=dev)
    mask = torch.empty((n, s), dtype=torch.bool, device=dev)
    dens = (torch.empty((n, s), dtype=torch.float32, device=dev)
            if cell_density is not None else None)
    deltas = torch.empty((n, 1), dtype=torch.float32, device=dev)
    kernels.launch("wisp_raymarch_ray", "raymarch_ray", origins.data_ptr(), dirs.data_ptr(),
                   kernels.ptr(jitter), n, s, int(stride), float(dist_min), float(dist_max),
                   kernels.ptr(cell_density), int(level), samples.data_ptr(),
                   depths.data_ptr(), mask.data_ptr(), kernels.ptr(dens), deltas.data_ptr())
    return ASRaymarchResults(samples=samples, depth_samples=depths, deltas=deltas,
                             mask=mask, cell_density=dens)


def octree_query_plain(coords: torch.Tensor, pidx_maps: Sequence[torch.Tensor], level: int,
                       with_parents: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``octree_query`` (octree_as.py:199-242, the pidx-map
    route)."""
    q = quantize_points(coords, level)
    cols = []
    for l in (range(level + 1) if with_parents else [level]):
        res_l = 2 ** l
        qq = q >> (level - l)
        cols.append(pidx_maps[l][(qq[:, 0] * res_l + qq[:, 1]) * res_l + qq[:, 2]])
    pidx = torch.stack(cols, dim=-1) if with_parents else cols[0]
    inside = ((coords >= -1.0) & (coords <= 1.0)).all(dim=-1)
    return torch.where(inside[:, None] if with_parents else inside, pidx,
                       torch.full_like(pidx, -1))


def octree_query(coords: torch.Tensor, pidx_maps: Sequence[torch.Tensor], level: int,
                 with_parents: bool = False) -> torch.Tensor:
    """Point -> level-local cell index at ``level`` (K9): [N,3] float32 -> [N] int32, or
    [N, level+1] int32 for the whole ancestor chain. -1 = unoccupied; outside [-1,1]^3
    (inclusive) always -1. ``pidx_maps[l]`` is level l's dense map, flat index
    (x*res_l + y)*res_l + z."""
    if not coords.is_cuda:
        return octree_query_plain(coords, pidx_maps, level, with_parents)
    n = coords.shape[0]
    kernels.check(coords, "coords", torch.float32, (n, 3))
    if not 0 <= level < len(pidx_maps) or level > 10:
        raise ValueError(f"octree_query: level {level} needs its map ({len(pidx_maps)} "
                         f"given)")
    maps = list(pidx_maps[:level + 1])
    for l, m in enumerate(maps):
        kernels.check(m, f"pidx_maps[{l}]", torch.int32, (8 ** l,))
    ncols = level + 1 if with_parents else 1
    out = torch.empty((n, ncols) if with_parents else (n,), dtype=torch.int32,
                      device=coords.device)
    if n:
        ptrs = kernels.pointers(maps)
        kernels.launch("wisp_octree_query", "octree_query", coords.data_ptr(), n, level,
                       ctypes.addressof(ptrs), int(bool(with_parents)), out.data_ptr())
    return out


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
    scratch = torch.empty((2, res ** 3), dtype=torch.uint8, device=occ_grid.device)
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
                 pidx_maps: Optional[List[torch.Tensor]] = None):
        self.max_level = int(max_level)
        self.occ_grid = occ_grid
        self.cell_density = cell_density
        self.dense = bool(dense)
        self.codes = codes
        self.points = points
        self.pidx_maps = pidx_maps
        self.level_counts = (tuple(int(len(c)) for c in codes) if codes is not None
                             else tuple(8 ** l for l in range(self.max_level + 1)))

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
        occ = dens = None
        if max_level <= cls.OCC_GRID_MAX_LEVEL:
            res = 2 ** max_level
            p = points[-1].astype(np.int64)
            o = np.zeros(res ** 3, dtype=bool)
            o[(p[:, 0] * res + p[:, 1]) * res + p[:, 2]] = True
            occ = torch.from_numpy(o).to(device)
            dens = torch.where(occ, 0.0, -1.0).to(torch.float32)
        return cls(max_level, occ, dens, dense=False, codes=codes, points=points,
                   pidx_maps=maps)

    @classmethod
    def from_quantized_points(cls, quantized_points: np.ndarray, level: int,
                              device: DeviceLike = None) -> "OctreeAS":
        codes, _ = build_level_table(np.asarray(quantized_points), level)
        return cls.from_codes(codes, device=device)

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
                        pidx_maps=self.pidx_maps)

    def query(self, coords: torch.Tensor, level: Optional[int] = None,
              with_parents: bool = False) -> ASQueryResults:
        """Point -> cell index at ``level`` (K9; see ``octree_query``)."""
        if level is None:
            level = self.max_level
        if self.pidx_maps is None:
            raise NotImplementedError("query on a dense octree is not ported yet "
                                      "(ROADMAP Queue 1)")
        if level >= len(self.pidx_maps):
            raise NotImplementedError(f"query at level {level} > {self.PIDX_MAP_MAX_LEVEL} "
                                      f"(a binary search in JAX) is not ported yet")
        return ASQueryResults(pidx=octree_query(coords.contiguous(), self.pidx_maps, level,
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

    def raymarch(self, rays: Rays, raymarch_type: str = "ray", num_samples: int = 64,
                 level: Optional[int] = None, key=None, stride: int = 1
                 ) -> ASRaymarchResults:
        if raymarch_type == "ray":
            return self._raymarch_ray(rays, num_samples, key, stride=stride)
        if raymarch_type == "voxel":
            raise NotImplementedError("'voxel' march is not ported yet (ROADMAP Queue 2, K7)")
        if raymarch_type == "uniform":
            raise NotImplementedError("'uniform' march is not ported yet "
                                      "(ROADMAP Queue 2, K8)")
        raise ValueError(f"Unknown raymarch_type {raymarch_type!r}")

    def _raymarch_ray(self, rays: Rays, num_samples: int, key=None,
                      stride: int = 1) -> ASRaymarchResults:
        jitter = None
        if isinstance(key, torch.Generator):
            jitter = torch.rand((rays.origins.shape[0], num_samples), generator=key,
                                dtype=torch.float32, device=rays.origins.device)
        elif key is not None:
            jitter = key.to(torch.float32).contiguous()
        field = None if self.dense else self.cell_density
        return raymarch_ray(rays.origins, rays.dirs, rays.dist_min, rays.dist_max,
                            num_samples, stride, field, self.max_level, jitter)
