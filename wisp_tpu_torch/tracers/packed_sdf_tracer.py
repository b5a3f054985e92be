"""PackedSDFTracer — the NGLOD sphere tracer (counterpart of
wisp_tpu/tracers/packed_sdf_tracer.py).

A trace call computes the free-space distance field of the octree (K11) unless the tracer
holds one (``with_free_dist``), then:

1. the walk (``sdf_walk``, K12): ``num_steps`` occupancy-only steps that carry each ray to
   its first occupied cell, skipping (k-1)·voxel through a cell k voxels (L-inf) from
   occupied space, or exactly to the next cell boundary when that is further;
2. ``num_steps`` sphere iterations: the field at every ray's point (the octree query K9,
   the interpolation K15, the decoder), then ``sphere_step`` (K12): a ray in an occupied
   cell hits when |sdf| < min_dis, else advances by max(sdf·step_size, 0); a ray in free
   space advances as the walk does; a ray past its exit dies;
3. normals from 6 finite-difference taps of the field at the final points.

With ``compaction`` (K12's compaction, ``ops/compaction.py compact_rays``) only the rays
that are still alive after the walk go through steps 2 and 3, packed into
``max(round(R * compaction), 1)`` slots; with ``mid_compaction`` too, after
``round(num_steps * mid_at)`` iterations the rays still alive are packed again into
``max(round(R * mid_compaction), 1)`` slots for the rest. The results go back onto the
walk's values (``scatter_rows``): a ray that was dropped keeps the walk's depth and point,
misses, and has a zero normal. ``num_overflow`` counts the rays dropped by either budget
(it is 0 without compaction), as JAX does.

As in JAX every ray (or slot) is queried at every iteration, and nothing in the loop reads
the device. ``sdf_walk`` and ``sphere_step`` update t, alive and hit in place: on a CUDA
tensor they launch ``csrc/sphere_trace.cu``, on a CPU tensor they run their plain
versions, which divide by tensors so that kernel and plain version agree bit for bit on t.
"""

from __future__ import annotations

import copy
from typing import Optional, Set

import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.octree_as import aabb_intersect
from wisp_tpu_torch.core.render_buffer import RenderBuffer
from wisp_tpu_torch.ops.compaction import compact_rays, ray_budget, scatter_rows
from wisp_tpu_torch.ops.differential import finitediff_gradient
from wisp_tpu_torch.ops.geometric import voxel_boundary_step
from wisp_tpu_torch.ops.spc.core import quantize_points
from wisp_tpu_torch.tracers.base_tracer import BaseTracer

OUTSIDE = 2 ** 30   # free-space distance reported for points outside [-1,1)^3


def _fsd_at(origins, dirs, t, free_dist, level):
    """(free-space distance of each ray's cell at depth t, the point)."""
    res = 2 ** level
    pos = origins + t[:, None] * dirs
    inside = ((pos >= -1.0) & (pos < 1.0)).all(dim=-1)
    q = quantize_points(pos, level)
    k = free_dist[(q[:, 0] * res + q[:, 1]) * res + q[:, 2]]
    return torch.where(inside, k, torch.full_like(k, OUTSIDE)), pos


def _free_step(k, pos, dirs, voxel):
    skip = (k.to(torch.float32) - 1.0) * voxel
    return torch.maximum(skip, voxel_boundary_step(pos, dirs, voxel))


def sdf_walk_plain(origins, dirs, t, alive, t_far, free_dist, level: int,
                   num_steps: int) -> None:
    """Plain PyTorch version of ``sdf_walk`` (packed_sdf_tracer.py:121-129)."""
    voxel = 2.0 / 2 ** level
    t_cur, alive_cur = t.clone(), alive.clone()
    for _ in range(num_steps):
        k, pos = _fsd_at(origins, dirs, t_cur, free_dist, level)
        advance = alive_cur & (k > 0)
        t_cur = torch.where(advance, t_cur + _free_step(k, pos, dirs, voxel), t_cur)
        alive_cur = alive_cur & (t_cur <= t_far)
    t.copy_(t_cur)
    alive.copy_(alive_cur)


def sdf_walk(origins: torch.Tensor, dirs: torch.Tensor, t: torch.Tensor, alive: torch.Tensor,
             t_far: torch.Tensor, free_dist: torch.Tensor, level: int, num_steps: int) -> None:
    """The occupancy-only walk (K12), in place: ``t`` [N] float32 and ``alive`` [N] bool
    come in at the rays' entry and leave at their first occupied cell (or where they
    died). ``free_dist`` [8^level] int32 is the octree's free-space distance field."""
    if not origins.is_cuda:
        return sdf_walk_plain(origins, dirs, t, alive, t_far, free_dist, level, num_steps)
    n = origins.shape[0]
    _check_rays(origins, dirs, t, alive, t_far, free_dist, level)
    if n:
        kernels.launch("wisp_sdf_walk", "sdf_walk", origins.data_ptr(), dirs.data_ptr(),
                       t.data_ptr(), alive.data_ptr(), t_far.data_ptr(),
                       free_dist.data_ptr(), n, level, int(num_steps))


def sphere_step_plain(origins, dirs, t, alive, hit, t_far, d, free_dist, level: int,
                      step_size: float, min_dis: float) -> None:
    """Plain PyTorch version of ``sphere_step`` (the body of packed_sdf_tracer.py:136-150)."""
    k, pos = _fsd_at(origins, dirs, t, free_dist, level)
    in_occ = k == 0
    hit_now = alive & in_occ & (d.abs() < min_dis)
    step = torch.where(in_occ, (d * step_size).clamp(min=0.0),
                       _free_step(k, pos, dirs, 2.0 / 2 ** level))
    still = alive & ~hit_now
    t_new = torch.where(still, t + step, t)
    hit.logical_or_(hit_now)
    alive.copy_(still & (t_new <= t_far))
    t.copy_(t_new)


def sphere_step(origins: torch.Tensor, dirs: torch.Tensor, t: torch.Tensor,
                alive: torch.Tensor, hit: torch.Tensor, t_far: torch.Tensor, d: torch.Tensor,
                free_dist: torch.Tensor, level: int, step_size: float,
                min_dis: float) -> None:
    """One sphere-trace iteration given the field ``d`` [N] at each ray's point (K12), in
    place on ``t``, ``alive`` and ``hit``."""
    if not origins.is_cuda:
        return sphere_step_plain(origins, dirs, t, alive, hit, t_far, d, free_dist, level,
                                 step_size, min_dis)
    n = origins.shape[0]
    _check_rays(origins, dirs, t, alive, t_far, free_dist, level)
    kernels.check(hit, "hit", torch.bool, (n,))
    kernels.check(d, "d", torch.float32, (n,))
    if n:
        kernels.launch("wisp_sphere_step", "sphere_step", origins.data_ptr(),
                       dirs.data_ptr(), t.data_ptr(), alive.data_ptr(), hit.data_ptr(),
                       t_far.data_ptr(), d.data_ptr(), free_dist.data_ptr(), n, level,
                       float(step_size), float(min_dis))


def _check_rays(origins, dirs, t, alive, t_far, free_dist, level):
    n = origins.shape[0]
    kernels.check(origins, "origins", torch.float32, (n, 3))
    kernels.check(dirs, "dirs", torch.float32, (n, 3))
    kernels.check(t, "t", torch.float32, (n,))
    kernels.check(alive, "alive", torch.bool, (n,))
    kernels.check(t_far, "t_far", torch.float32, (n,))
    if not 0 <= level <= 10:
        raise ValueError(f"sphere trace: bad level {level}")
    kernels.check(free_dist, "free_dist", torch.int32, (8 ** level,))


class PackedSDFTracer(BaseTracer):
    def __init__(self, num_steps: int = 1024, step_size: float = 0.8, min_dis: float = 0.0003,
                 free_dist=None, compaction: Optional[float] = None,
                 mid_compaction: Optional[float] = None, mid_at: float = 0.5):
        super().__init__()
        self.num_steps = num_steps
        self.step_size = step_size
        self.min_dis = min_dis
        self.compaction = compaction
        self.mid_compaction = mid_compaction
        self.mid_at = mid_at
        self.free_dist = free_dist

    def with_free_dist(self, blas) -> "PackedSDFTracer":
        """A tracer holding ``blas.free_space_distance()``, so that its traces skip K11.
        Recompute after an occupancy change."""
        tracer = copy.copy(self)
        tracer.free_dist = blas.free_space_distance()
        return tracer

    def get_supported_channels(self) -> Set[str]:
        return {"depth", "normal", "xyz", "hit", "rgb", "alpha"}

    def get_required_nef_channels(self) -> Set[str]:
        return {"sdf"}

    def trace(self, nef, rays, channels, extra_channels, lod_idx=None, num_steps=64,
              step_size=1.0, min_dis=1e-4, free_dist=None, compaction=None,
              mid_compaction=None, mid_at=0.5):
        if lod_idx is None:
            lod_idx = nef.grid.num_lods - 1
        blas = nef.grid.blas
        level = blas.max_level
        if free_dist is None:
            free_dist = blas.free_space_distance()
        o, d = rays.origins.contiguous(), rays.dirs.contiguous()
        num_rays = o.shape[0]
        t_near, t_far = aabb_intersect(o, d, rays.dist_min, rays.dist_max)
        t = t_near.clamp(min=0.0) + 1e-6
        alive = t_far > t
        t_far = t_far.contiguous()
        sdf_walk(o, d, t, alive, t_far, free_dist, level, num_steps)

        def sphere_loop(o, d, t, alive, hit, t_far, n):
            for _ in range(n):
                pos = o + t[:, None] * d
                dist = nef(channels="sdf", coords=pos, lod_idx=lod_idx)[:, 0].contiguous()
                sphere_step(o, d, t, alive, hit, t_far, dist, free_dist, level, step_size,
                            min_dis)

        def finalize(o, d, t, hit):
            xyz = o + t[:, None] * d
            grad = finitediff_gradient(
                xyz, lambda pts: nef(channels="sdf", coords=pts, lod_idx=lod_idx))
            normal = grad / grad.norm(dim=-1, keepdim=True).clamp(min=1e-12)
            hit_c = hit[:, None]
            normal = torch.where(hit_c, normal, torch.zeros_like(normal))
            extras = {}
            for channel in extra_channels:
                feats = nef(channels=channel, coords=xyz, lod_idx=lod_idx)
                extras[channel] = torch.where(hit_c, feats, torch.zeros_like(feats))
            return xyz, normal, extras

        if compaction is None:
            hit = torch.zeros_like(alive)
            sphere_loop(o, d, t, alive, hit, t_far, num_steps)
            xyz, normal, extras = finalize(o, d, t, hit)
            num_overflow = torch.zeros((), dtype=torch.float32, device=o.device)
        else:
            budget = ray_budget(num_rays, compaction)
            idx, o_c, d_c, t_c, tf_c, count = compact_rays(alive, budget, o, d, t, t_far)
            live = idx < num_rays
            hit_c = torch.zeros_like(live)
            dropped_mid = 0
            if mid_compaction is None:
                sphere_loop(o_c, d_c, t_c, live, hit_c, tf_c, num_steps)
            else:
                n1 = min(max(int(round(num_steps * float(mid_at))), 0), num_steps)
                sphere_loop(o_c, d_c, t_c, live, hit_c, tf_c, n1)
                budget2 = ray_budget(num_rays, mid_compaction)
                idx2, o_m, d_m, t_m, tf_m, count2 = compact_rays(live, budget2, o_c, d_c, t_c,
                                                                 tf_c, mid=True)
                live2 = idx2 < budget
                hit_m = torch.zeros_like(live2)
                sphere_loop(o_m, d_m, t_m, live2, hit_m, tf_m, num_steps - n1)
                scatter_rows(t_m, idx2, t_c, mid=True)
                scatter_rows(hit_m, idx2, hit_c, mid=True)
                dropped_mid = (count2 - budget2).clamp(min=0)
            xyz_c, normal_c, extras_c = finalize(o_c, d_c, t_c, hit_c)
            # onto the walk's values: a dropped ray keeps its depth and point and misses
            xyz = scatter_rows(xyz_c, idx, o + t[:, None] * d)
            scatter_rows(t_c, idx, t)
            hit = scatter_rows(hit_c, idx, torch.zeros_like(alive))
            normal = scatter_rows(normal_c, idx, torch.zeros_like(o))
            extras = {ch: scatter_rows(v.contiguous(), idx,
                                       v.new_zeros((num_rays,) + tuple(v.shape[1:])))
                      for ch, v in extras_c.items()}
            num_overflow = ((count - budget).clamp(min=0) + dropped_mid).to(torch.float32)

        hit_c = hit[:, None]
        return RenderBuffer(
            xyz=xyz, depth=torch.where(hit, t, torch.zeros_like(t))[:, None], hit=hit_c,
            rgb=torch.where(hit_c, (normal + 1.0) / 2.0, torch.ones_like(normal)),
            alpha=hit_c.to(torch.float32), normal=normal, num_overflow=num_overflow,
            **extras)
