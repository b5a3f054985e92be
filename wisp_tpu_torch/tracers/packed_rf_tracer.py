"""PackedRFTracer — differentiable volumetric radiance-field renderer (counterpart of
wisp_tpu/tracers/packed_rf_tracer.py, the unsegmented ``trace``).

march (K2 'ray', K7 'voxel') -> step-major compaction into the budget (K3) -> one field call
on the kept samples (grid: K1 or K15) -> scatter-back (K3) -> integration (K4). The voxel
march keeps ``march_budget // num_steps`` voxels a ray and counts the rays with more in the
buffer's ``num_overflow``. The JAX tracer evaluates the field on all B budget slots; the
port evaluates only the min(valid, B) filled ones, which leaves every output and gradient
unchanged (empty slots are dropped by the scatter-back) at the cost of one read of the
valid count per trace.

``trace`` builds an autograd graph when gradients are enabled: the backward runs K4
backward, the scatter-back's one gather of colour and density and K1 backward. Extra
channels are differentiable as in JAX (K4's backward with their columns); the segmented
trace refuses to differentiate them (ROADMAP Queue 3). Rendering
wraps its calls in ``torch.no_grad``. ``key`` (a ``torch.Generator``, or the jitter [R, S]
itself) jitters the march depths; ``density_feedback`` adds ``density_max_grid``, the
per-cell max of the kept samples' densities (K5, the cell lookup inside its launch).

``seg_early_stop > 0`` runs ``_trace_segmented`` (K6, JAX's ``_trace_segmented``): the march's
samples in ``seg_count`` depth segments, each culled where the ray's carried optical depth
has reached -log(seg_early_stop) (K6a), compacted into a per-segment budget, decoded once
and composited with that optical depth carried into the exponent (K6b, K6c).
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np
import torch

from wisp_tpu_torch.core.render_buffer import RenderBuffer
from wisp_tpu_torch.ops.compaction import (compact, compaction_budget, scatter_back,
                                           scatter_back_many)
from wisp_tpu_torch.ops.density_grid import scatter_max_points
from wisp_tpu_torch.ops.integration import integrate, integrate_segment
from wisp_tpu_torch.tracers.base_tracer import BaseTracer


def _back(v: torch.Tensor, idx: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """The kept slots' rows ``v`` [K, ...] scattered back to [n, s, C] (K3)."""
    v2 = v.reshape(v.shape[0], int(np.prod(v.shape[1:]))).contiguous()
    return scatter_back(v2, idx, n * s).reshape(n, s, v2.shape[-1])


def _back_field(out, idx: torch.Tensor, n: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept slots' colour [K, 3] and density [K, 1] scattered back to [n, s, 3] and
    [n, s] in one differentiable call (K3), whose backward gathers both cotangents in one
    launch; density comes back flat, with no select view for autograd to undo."""
    k = out["density"].shape[0]
    color, density = scatter_back_many(idx, n * s, out["rgb"].contiguous(),
                                       out["density"].reshape(k))
    return color.reshape(n, s, 3), density.reshape(n, s)


class PackedRFTracer(BaseTracer):
    def __init__(self, raymarch_type: str = "ray", num_steps: int = 1024,
                 step_size: float = 1.0,
                 bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 compaction: float = 0.0, early_stop: float = 0.0,
                 lod_spacing_scale: float = 0.0, march_budget: int = 1024,
                 march_stride: int = 1, seg_early_stop: float = 0.0, seg_count: int = 4):
        super().__init__(bg_color=bg_color)
        self.raymarch_type = raymarch_type
        self.num_steps = num_steps
        self.step_size = step_size
        self.compaction = compaction
        self.early_stop = early_stop
        self.lod_spacing_scale = lod_spacing_scale
        # 'voxel' march: the fine samples a ray keeps, march_budget // num_steps voxels
        self.march_budget = march_budget
        self.march_stride = march_stride
        self.seg_early_stop = seg_early_stop
        self.seg_count = seg_count
        self.prev_num_samples: Optional[int] = None

    def get_supported_channels(self) -> Set[str]:
        return {"depth", "hit", "rgb", "alpha"}

    def get_required_nef_channels(self) -> Set[str]:
        return {"rgb", "density"}

    @staticmethod
    def max_compute_lod(grid, raymarch_type: str, num_steps: int,
                        lod_spacing_scale) -> Optional[int]:
        """Keep the LODs whose cell 2/res is at least lod_spacing_scale times the coarsest
        step (packed_rf_tracer.py:106-125); None keeps all."""
        if not (lod_spacing_scale and lod_spacing_scale > 0.0
                and hasattr(grid, "resolutions")):
            return None
        if raymarch_type == "voxel":
            blas_level = getattr(getattr(grid, "blas", None), "max_level", None)
            if blas_level is None:
                return None
            delta_est = (2.0 / (2 ** blas_level)) / num_steps
        else:
            delta_est = 2.0 * float(np.sqrt(3)) / num_steps
        res_cap = 2.0 / (float(lod_spacing_scale) * delta_est)
        keep = [i for i, r in enumerate(grid.resolutions) if r <= res_cap]
        return max(keep) if keep else 0

    def trace(self, nef, rays, channels, extra_channels, lod_idx=None,
              raymarch_type="ray", num_steps=64, step_size=1.0, bg_color=(1.0, 1.0, 1.0),
              key=None, compaction=None, early_stop=None, lod_spacing_scale=None,
              march_budget=None, march_stride=None, seg_early_stop=None, seg_count=None,
              density_feedback=False):
        if nef.grid is None:
            raise ValueError("PackedRFTracer requires a grid")
        seg_on = bool(seg_early_stop and seg_early_stop > 0.0)
        if seg_on:
            # JAX's dispatch (packed_rf_tracer.py:169-184), which also runs unsegmented,
            # without the cull, when seg_count <= 1: the port refuses that instead
            if early_stop and early_stop > 0.0:
                raise ValueError("seg_early_stop (the segmented cull) and early_stop (the "
                                 "cell-peak transmittance estimate) are mutually exclusive")
            if not (compaction and compaction > 0.0):
                raise ValueError("seg_early_stop requires compaction > 0 (the cull saves "
                                 "work through the compaction budget)")
            if not (seg_count and int(seg_count) > 1):
                raise ValueError(f"seg_early_stop requires seg_count > 1, got {seg_count} "
                                 f"(one segment would not cull)")
        if early_stop and early_stop > 0.0:
            raise NotImplementedError("early_stop > 0, the transmittance cull, is not ported "
                                      "yet (ROADMAP Queue 1, item 5)")
        n = rays.origins.shape[0]
        if lod_idx is None:
            lod_idx = nef.grid.num_lods - 1
        max_compute_lod = self.max_compute_lod(nef.grid, raymarch_type, num_steps,
                                               lod_spacing_scale)
        march_kw = {}
        if march_budget and raymarch_type == "voxel":
            march_kw["budget"] = int(march_budget)
        if march_stride and march_stride > 1 and raymarch_type in ("ray", "uniform"):
            march_kw["stride"] = int(march_stride)
        with torch.no_grad():
            mr = nef.grid.raymarch(rays, raymarch_type=raymarch_type, num_samples=num_steps,
                                   key=key, **march_kw)
        req_channels = ["rgb", "density", *sorted(extra_channels)]
        if seg_on:
            return self._trace_segmented(nef, rays, channels, extra_channels, req_channels,
                                         lod_idx, max_compute_lod, mr, float(compaction),
                                         float(seg_early_stop), int(seg_count), bg_color,
                                         density_feedback)
        samples, depths, mask = mr.samples, mr.depth_samples, mr.mask
        s = samples.shape[1]
        rs = n * s

        if compaction and compaction > 0.0:
            budget = compaction_budget(n, s, compaction)
            with torch.no_grad():
                idx, cflat, cray_d, count = compact(mask, samples, rays.dirs, budget)
            num_valid = int(count)
            kept = min(num_valid, budget)
            coords = cflat[:kept]
            # JAX evaluates the field on all budget slots: the stochastic backward's rule
            # reads that row count
            out = nef(channels=req_channels, coords=coords, ray_d=cray_d[:kept],
                      lod_idx=lod_idx, max_compute_lod=max_compute_lod, stoch_rows=budget)
            fb_points, fb_keep = coords, None
            color, density = _back_field(out, idx, n, s)

            def back(v):
                return _back(v, idx, n, s)
        else:
            flat = samples.reshape(rs, 3)
            ray_d = rays.dirs[:, None, :].expand(n, s, 3).reshape(rs, 3)
            out = nef(channels=req_channels, coords=flat, ray_d=ray_d, lod_idx=lod_idx,
                      max_compute_lod=max_compute_lod, stoch_rows=rs)
            num_valid = int(mask.sum())
            fb_points, fb_keep = flat, mask.reshape(-1)
            color = out["rgb"].reshape(n, s, 3).contiguous()
            density = out["density"].reshape(n, s).contiguous()

            def back(v):
                return v.reshape(n, s, -1)

        density_max_grid = None
        if density_feedback:
            # K5 with the cell lookup inside: the samples off the mask (uncompacted) dropped
            density_max_grid = scatter_max_points(fb_points, out["density"][:, 0].detach(),
                                                  self._fb_level(nef), keep=fb_keep)

        extra = None
        if extra_channels:
            # differentiable, as JAX's: a loss on an extra channel reaches the field through
            # the channel and through the weights (K4's backward with extra columns)
            extra = torch.cat([back(out[ch]) for ch in sorted(extra_channels)], dim=-1)
        res = integrate(density, mr.deltas, depths, mask, color, bg_color,
                        extra=None if extra is None else extra.contiguous(),
                        with_depth="depth" in channels)
        extra_outputs = {}
        col = 0
        for ch in sorted(extra_channels):
            width = int(np.prod(out[ch].shape[1:]))
            extra_outputs[ch] = res["extra"][:, col:col + width]
            col += width
        self.prev_num_samples = num_valid
        return RenderBuffer(depth=res.get("depth"), hit=res["hit"], rgb=res["rgb"],
                            alpha=res["alpha"],
                            num_valid_samples=torch.tensor(float(num_valid),
                                                           device=density.device),
                            num_overflow=mr.num_overflow,
                            density_max_grid=density_max_grid, **extra_outputs)

    def _trace_segmented(self, nef, rays, channels, extra_channels, req_channels, lod_idx,
                         max_compute_lod, mr, compaction: float, eps: float, g_cnt: int,
                         bg_color, density_feedback):
        """The march's S samples in G = ``g_cnt`` segments of ceil(S/G) steps (the last one
        padded with masked-off steps), in order: cull the rays whose carried optical depth
        reached tau_cap = -log(eps), i.e. whose transmittance is at most eps (K6a); compact
        the survivors step-major into the per-segment budget; one field call on the kept
        slots; scatter back; composite with the carried optical depth (K6b; K6c is its
        backward, so gradients flow through the carry); max the kept densities into one
        grid (K5 accumulated). Each segment reads its valid count once (JAX evaluates all
        budget slots instead); the overflow and the peak per-segment valid fraction
        ``seg_frac_max``, which the trainer's adaptive budget keys on, follow from those
        counts on the host."""
        n = rays.origins.shape[0]
        samples, depths, mask = mr.samples, mr.depth_samples, mr.mask
        s_total = samples.shape[1]
        s_g = -(-s_total // g_cnt)
        pad = g_cnt * s_g - s_total
        if pad:
            samples = torch.nn.functional.pad(samples, (0, 0, 0, pad))
            depths = torch.nn.functional.pad(depths, (0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        budget = compaction_budget(n, s_g, compaction)
        # JAX compares the float32 optical depth with the weak-typed -log(eps): in float32
        tau_cap = float(np.float32(-np.log(eps)))
        dev = samples.device
        level = self._fb_level(nef) if density_feedback else None
        fb_grid = torch.zeros((8 ** level,), dtype=torch.float32, device=dev) \
            if density_feedback else None
        acc_tau = torch.zeros((n,), dtype=torch.float32, device=dev)
        extra_names = sorted(extra_channels)
        sums = {}
        valids = []
        for g in range(g_cnt):
            cols = slice(g * s_g, (g + 1) * s_g)
            seg_mask = mask[:, cols].contiguous()
            seg_depths = depths[:, cols].contiguous()
            with torch.no_grad():
                idx, cflat, cray_d, count = compact(seg_mask, samples[:, cols].contiguous(),
                                                    rays.dirs, budget, acc_tau.detach(),
                                                    tau_cap)
            valid = int(count)
            valids.append(valid)
            kept = min(valid, budget)
            coords = cflat[:kept]
            out = nef(channels=req_channels, coords=coords, ray_d=cray_d[:kept],
                      lod_idx=lod_idx, max_compute_lod=max_compute_lod, stoch_rows=budget)
            if fb_grid is not None:
                scatter_max_points(coords, out["density"][:, 0].detach(), level, out=fb_grid)

            def back(v):
                return _back(v, idx, n, s_g)

            extra = None
            if extra_names:
                if torch.is_grad_enabled() and any(out[k].requires_grad
                                                   for k in ["density", *extra_names]):
                    raise NotImplementedError(
                        "the segmented trace (seg_early_stop > 0) does not differentiate "
                        "extra channels (ROADMAP Queue 3): render them under torch.no_grad(), "
                        "or trace without the segmented cull")
                extra = torch.cat([back(out[ch]) for ch in extra_names], dim=-1).contiguous()
            # culled samples have no slot: their density is 0 after the scatter-back, so
            # the march's mask composites as JAX's mask & live does
            color, density = _back_field(out, idx, n, s_g)
            res = integrate_segment(density, mr.deltas, seg_depths, seg_mask, color, acc_tau,
                                    extra=extra, with_depth="depth" in channels)
            acc_tau = res["acc_tau"]
            for k in ("rgb", "alpha", "depth", "extra"):
                if k in res:
                    sums[k] = res[k] if k not in sums else sums[k] + res[k]
        alpha = sums["alpha"]
        bg = torch.as_tensor(bg_color, dtype=sums["rgb"].dtype, device=dev)
        rgb = bg[None, :] * (1.0 - alpha) + sums["rgb"]
        extra_outputs = {}
        col = 0
        for ch in extra_names:
            width = int(np.prod(out[ch].shape[1:]))
            extra_outputs[ch] = alpha * sums["extra"][:, col:col + width]
            col += width
        num_valid = sum(valids)
        overflow = float(sum(max(v - budget, 0) for v in valids))
        num_overflow = torch.tensor(overflow, device=dev)
        if mr.num_overflow is not None:
            num_overflow = num_overflow + mr.num_overflow
        self.prev_num_samples = num_valid
        return RenderBuffer(depth=sums.get("depth"), hit=alpha > 0.0, rgb=rgb, alpha=alpha,
                            num_valid_samples=torch.tensor(float(num_valid), device=dev),
                            num_overflow=num_overflow,
                            seg_frac_max=torch.tensor(max(valids) / float(n * s_g),
                                                      device=dev),
                            density_max_grid=fb_grid, **extra_outputs)

    @staticmethod
    def _fb_level(nef) -> int:
        blas = getattr(nef.grid, "blas", None)
        if getattr(blas, "max_level", None) is None:
            raise ValueError("density_feedback needs a grid with an octree blas")
        return int(blas.max_level)
