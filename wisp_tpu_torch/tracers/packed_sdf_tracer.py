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

Where the field is a NeuralSDF on a 'linear' OctreeGrid whose decoder reads the features
(and the raw xyz) alone, step 2 runs as ``sphere_iter`` then the decoder, ``num_steps``
times: ``sphere_iter`` (one kernel, ``csrc/octree_grid.cu``) takes the step on the previous
iteration's field (not on the first iteration), then writes the decoder's input row at
the new point (the fused query and interpolation); one closing ``sphere_step`` takes the
last step. The steps, points and fields are the same as the loop above, which every other
field takes.

With ``compaction`` (K12's compaction, ``ops/compaction.py compact_rays``) only the rays
that are still alive after the walk go through steps 2 and 3, packed into
``max(round(R * compaction), 1)`` slots; with ``mid_compaction`` too, after
``round(num_steps * mid_at)`` iterations the rays still alive are packed again into
``max(round(R * mid_compaction), 1)`` slots for the rest. The results go back onto the
walk's values (``scatter_rows_many``, one launch for every channel of a chunk or of the mid
pass): a ray that was dropped keeps the walk's depth and point, misses, and has a zero
normal. ``num_overflow`` counts the rays dropped by either budget (it is 0 without
compaction), as JAX does.

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
from wisp_tpu_torch.models.grids.octree_grid import (OctreeGrid, lod_tables,
                                                     octree_query_interp_plain, ray_lanes)
from wisp_tpu_torch.ops.compaction import compact_rays, ray_budget, scatter_rows_many
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


def sphere_iter_plain(origins, dirs, t, alive, hit, t_far, field, free_dist, level: int,
                      step_size: float, min_dis: float, routes, trinkets, features, levels,
                      multiscale_type: str, with_xyz: bool, out=None) -> torch.Tensor:
    """Plain PyTorch version of ``sphere_iter``: ``sphere_step_plain`` on column 0 of
    ``field`` (where given), the point o + t*d, ``octree_query_interp_plain`` there and the
    decoder's input row [features | xyz] (xyz where ``with_xyz``); a ray that is not alive
    gets zeros."""
    if field is not None:
        sphere_step_plain(origins, dirs, t, alive, hit, t_far, field[:, 0], free_dist, level,
                          step_size, min_dis)
    pos = origins + t[:, None] * dirs
    feats, _ = octree_query_interp_plain(pos, routes, trinkets, features, levels,
                                         multiscale_type)
    x = torch.cat([feats, pos], dim=-1) if with_xyz else feats
    x = torch.where(alive[:, None], x, torch.zeros_like(x))
    return x if out is None else out.copy_(x)


def sphere_iter(origins: torch.Tensor, dirs: torch.Tensor, t: torch.Tensor,
                alive: torch.Tensor, hit: torch.Tensor, t_far: torch.Tensor,
                field: Optional[torch.Tensor], free_dist: torch.Tensor, level: int,
                step_size: float, min_dis: float, routes, trinkets, features, levels,
                multiscale_type: str, with_xyz: bool,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sphere iteration up to the decoder, in one kernel: where ``field`` (the last
    decoder outputs [N, K], the distance in column 0) is given, ``sphere_step`` on ``t``,
    ``alive`` and ``hit`` in place; then the decoder's input rows [N, width (+ 3)] at each
    ray's point: ``octree_query_interp``'s features (``routes`` .. ``multiscale_type``, as
    ``OctreeGrid.query_interp_args`` gives them) and, where ``with_xyz``, the point. A ray
    that is not alive gets a row of zeros. ``out``: rows to write (on the card, where the
    tables take 4 features a lane, each row starting on 16 bytes: a view of rows padded to 16
    bytes, as this call makes them), else new ones. A ray's lanes are the tables' (``lod_tables``). No gradient: the tracer calls
    it under ``torch.no_grad``."""
    if not origins.is_cuda:
        return sphere_iter_plain(origins, dirs, t, alive, hit, t_far, field, free_dist, level,
                                 step_size, min_dis, routes, trinkets, features, levels,
                                 multiscale_type, with_xyz, out)
    n, n_lods, f_dim = origins.shape[0], len(levels), features[0].shape[1]
    _check_rays(origins, dirs, t, alive, t_far, free_dist, level)
    kernels.check(hit, "hit", torch.bool, (n,))
    if multiscale_type not in ("sum", "cat"):
        raise ValueError(f"sphere_iter: {multiscale_type!r}")
    tabs = lod_tables(trinkets, features, levels, routes)
    if tabs.group > 32:
        raise ValueError(f"sphere_iter: {f_dim} features take more than a warp's lanes")
    width = f_dim if multiscale_type == "sum" else f_dim * n_lods
    cols = width + 3 * bool(with_xyz)
    if out is None:
        out = torch.empty((n, -(-cols // 4) * 4), dtype=torch.float32,
                          device=origins.device)[:, :cols]
    elif (not out.is_cuda or out.dtype != torch.float32 or tuple(out.shape) != (n, cols)
          or out.stride(1) != 1
          or (tabs.vec == 4 and (out.data_ptr() % 16 or out.stride(0) % 4))):
        raise ValueError(f"sphere_iter: out must be float32 CUDA rows [{n}, {cols}] (where "
                         "the tables take 4 features a lane, each starting on 16 bytes)")
    d_ptr, d_stride = None, 1
    if field is not None:
        if (not field.is_cuda or field.dtype != torch.float32 or field.ndim != 2
                or field.shape[0] != n):
            raise ValueError("sphere_iter: field must be the decoder's float32 CUDA outputs "
                             f"[{n}, K]")
        d_ptr, d_stride = field.data_ptr(), field.stride(0)
    if n:
        kernels.launch("wisp_sphere_iter", "sphere_iter", origins.data_ptr(), dirs.data_ptr(),
                       t.data_ptr(), alive.data_ptr(), hit.data_ptr(), t_far.data_ptr(),
                       d_ptr, d_stride, free_dist.data_ptr(), n, level, float(step_size),
                       float(min_dis), int(field is not None), levels[-1], n_lods, f_dim,
                       tabs.address, int(multiscale_type == "sum"), tabs.vec, tabs.group,
                       out.data_ptr(), out.stride(0), width if with_xyz else -1)
    return out


def fused_field(nef, lod_idx: int):
    """``sphere_iter``'s field arguments (routes .. multiscale_type, with_xyz) where the nef
    is a NeuralSDF on a 'linear' OctreeGrid whose decoder input is [features] or [features |
    xyz] and a ray's lanes fit a warp (``ray_lanes``, the rule by which ``lod_tables`` gives
    ``sphere_iter`` its lanes); else None (the loop decodes through the nef)."""
    grid = getattr(nef, "grid", None)
    input_xyz = getattr(nef, "decoder_input_xyz", None)
    if (input_xyz is None or not isinstance(grid, OctreeGrid)
            or grid.interpolation_type != "linear"):
        return None
    args = grid.query_interp_args(lod_idx)
    if ray_lanes(args[2])[1] > 32:
        return None
    with_xyz = input_xyz()
    return None if with_xyz is None else args + (with_xyz,)


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

        fused = fused_field(nef, lod_idx)

        def sphere_loop(o, d, t, alive, hit, t_far, n):
            if fused is None:
                for _ in range(n):
                    pos = o + t[:, None] * d
                    dist = nef(channels="sdf", coords=pos, lod_idx=lod_idx)[:, 0].contiguous()
                    sphere_step(o, d, t, alive, hit, t_far, dist, free_dist, level, step_size,
                                min_dis)
                return
            if n == 0:
                return
            # n fields and n steps, as above: the first sphere_iter takes no step, the
            # others take the step on the last field, and one sphere_step closes the loop
            with torch.no_grad():
                x = sphere_iter(o, d, t, alive, hit, t_far, None, free_dist, level, step_size,
                                min_dis, *fused)
                for _ in range(n - 1):
                    x = sphere_iter(o, d, t, alive, hit, t_far, nef.decode_from(x), free_dist,
                                    level, step_size, min_dis, *fused, out=x)
                dist = nef.decode_from(x)[:, 0].contiguous()
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
                scatter_rows_many(idx2, [(t_m, t_c), (hit_m, hit_c)], mid=True)
                dropped_mid = (count2 - budget2).clamp(min=0)
            xyz_c, normal_c, extras_c = finalize(o_c, d_c, t_c, hit_c)
            # onto the walk's values: a dropped ray keeps its depth and point and misses;
            # the point is taken from the walk's t before the slots' depths overwrite it
            xyz = o + t[:, None] * d
            hit = torch.zeros_like(alive)
            normal = torch.zeros_like(o)
            extras = {ch: v.new_zeros((num_rays,) + tuple(v.shape[1:]))
                      for ch, v in extras_c.items()}
            scatter_rows_many(idx, [(t_c, t), (xyz_c, xyz), (hit_c, hit), (normal_c, normal)]
                              + [(v.contiguous(), extras[ch]) for ch, v in extras_c.items()])
            num_overflow = ((count - budget).clamp(min=0) + dropped_mid).to(torch.float32)

        hit_c = hit[:, None]
        return RenderBuffer(
            xyz=xyz, depth=torch.where(hit, t, torch.zeros_like(t))[:, None], hit=hit_c,
            rgb=torch.where(hit_c, (normal + 1.0) / 2.0, torch.ones_like(normal)),
            alpha=hit_c.to(torch.float32), normal=normal, num_overflow=num_overflow,
            **extras)
