"""PackedSPCTracer — the first-hit tracer of raw SPC rendering (counterpart of
wisp_tpu/tracers/packed_spc_tracer.py).

Each ray walks from its entry into the box to its first occupied max-level cell with the
free-space distance field (K11, once a trace unless the tracer holds it:
``with_free_dist``), as the SDF tracer's walk does; the cell there gives the field its
colour. ``spc_trace`` (K13) does the whole per-ray part in one launch: the walk, the
occupancy test at the final point, the cell index of a hit by the octree's route (K9's
lookup) and the count of the walks that ended in free space with their budget spent
(``num_overflow``). On a CUDA tensor it launches ``csrc/sphere_trace.cu``, on a CPU tensor
it runs its plain version. The colour gather stays in ``SPCField.rgba``, as in JAX.
"""

from __future__ import annotations

import copy
from typing import Optional, Set, Tuple

import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.octree_as import (QueryRoute, aabb_intersect,
                                                   cell_index_plain, route_args)
from wisp_tpu_torch.core.render_buffer import RenderBuffer
from wisp_tpu_torch.ops.spc.core import quantize_points
from wisp_tpu_torch.tracers.base_tracer import BaseTracer
from wisp_tpu_torch.tracers.packed_sdf_tracer import sdf_walk_plain


def spc_trace_plain(origins, dirs, dist_min, dist_max, free_dist,
                    occ_grid: Optional[torch.Tensor], route: QueryRoute, level: int,
                    num_steps: int):
    """Plain PyTorch version of ``spc_trace`` (packed_spc_tracer.py:50-81)."""
    t_near, t_far = aabb_intersect(origins, dirs, dist_min, dist_max)
    t = t_near.clamp(min=0.0) + 1e-6
    alive = t_far > t
    sdf_walk_plain(origins, dirs, t, alive, t_far, free_dist, level, num_steps)
    pos = origins + t[:, None] * dirs
    q = quantize_points(pos, level)
    in_occ = ((pos >= -1.0) & (pos < 1.0)).all(dim=-1)
    if occ_grid is not None:
        res = 2 ** level
        in_occ = in_occ & occ_grid[(q[:, 0] * res + q[:, 1]) * res + q[:, 2]]
    hit = alive & in_occ
    num_overflow = (alive & ~in_occ).to(torch.float32).sum()
    pidx = torch.where(hit, cell_index_plain(route, q, level),
                       torch.full_like(q[:, 0], -1, dtype=torch.int32))
    return t, hit, pidx, num_overflow


def spc_trace(origins: torch.Tensor, dirs: torch.Tensor, dist_min: float, dist_max: float,
              free_dist: torch.Tensor, occ_grid: Optional[torch.Tensor], route: QueryRoute,
              level: int, num_steps: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each ray's first occupied cell of the max level ``level`` (K13): (t [R] float32, the
    depth where the walk stopped; hit [R] bool; pidx [R] int32, the hit cell's index by
    ``route`` or -1; num_overflow, a float32 scalar: the rays still alive in free space
    after ``num_steps`` walk steps). ``free_dist`` [8^level] int32 is the octree's K11 field;
    ``occ_grid`` [8^level] bool its occupancy, or None where the box alone counts (a dense
    octree)."""
    if not origins.is_cuda:
        return spc_trace_plain(origins, dirs, dist_min, dist_max, free_dist, occ_grid, route,
                               level, num_steps)
    n = origins.shape[0]
    kernels.check(origins, "origins", torch.float32, (n, 3))
    kernels.check(dirs, "dirs", torch.float32, (n, 3))
    if not 0 <= level <= 10 or num_steps < 0:
        raise ValueError(f"spc_trace: bad level {level} or num_steps {num_steps}")
    kernels.check(free_dist, "free_dist", torch.int32, (8 ** level,))
    if occ_grid is not None:
        kernels.check(occ_grid, "occ_grid", torch.bool, (8 ** level,))
    code, table, length = route_args(route, level, "route")
    dev = origins.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    pidx = torch.empty((n,), dtype=torch.int32, device=dev)
    num_overflow = torch.zeros((), dtype=torch.float32, device=dev)
    kernels.launch("wisp_spc_trace", "spc_trace", origins.data_ptr(), dirs.data_ptr(), n,
                   float(dist_min), float(dist_max), free_dist.data_ptr(),
                   kernels.ptr(occ_grid), int(level), int(num_steps), code, table, length,
                   t.data_ptr(), hit.data_ptr(), pidx.data_ptr(), num_overflow.data_ptr())
    return t, hit, pidx, num_overflow


class PackedSPCTracer(BaseTracer):
    def __init__(self, num_steps: int = 256, free_dist: Optional[torch.Tensor] = None):
        super().__init__()
        self.num_steps = num_steps
        self.free_dist = free_dist

    def with_free_dist(self, blas) -> "PackedSPCTracer":
        """A tracer holding ``blas.free_space_distance()``, so that its traces skip K11 (an
        SPC's topology does not change)."""
        tracer = copy.copy(self)
        tracer.free_dist = blas.free_space_distance()
        return tracer

    def get_supported_channels(self) -> Set[str]:
        return {"depth", "hit", "rgb", "alpha"}

    def get_required_nef_channels(self) -> Set[str]:
        return {"rgb"}

    def trace(self, nef, rays, channels, extra_channels, lod_idx=None, num_steps=256,
              free_dist=None):
        blas = nef.grid.blas
        level = blas.max_level
        if free_dist is None:
            free_dist = blas.free_space_distance()
        occ = None if blas.dense or blas.occ_grid is None else blas.occ_grid
        o, d = rays.origins.contiguous(), rays.dirs.contiguous()
        t, hit, pidx, num_overflow = spc_trace(o, d, rays.dist_min, rays.dist_max, free_dist,
                                               occ, blas.query_routes[level], level,
                                               int(num_steps))
        out = nef(channels=["rgb", "alpha"], pidx=pidx, coords=o + t[:, None] * d)
        hit_c = hit[:, None]
        return RenderBuffer(rgb=out["rgb"], alpha=out["alpha"] * hit_c.to(out["alpha"].dtype),
                            depth=torch.where(hit, t, torch.zeros_like(t))[:, None], hit=hit_c,
                            num_overflow=num_overflow)
