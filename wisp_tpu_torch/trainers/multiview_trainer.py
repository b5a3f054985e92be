"""MultiviewTrainer — NeRF optimization from posed images (counterpart of
wisp_tpu/trainers/multiview_trainer.py).

* step: trace with gradients (the march jittered from the trainer's generator) -> loss (l2,
  l1 or huber over rays or samples, optional opacity loss for the first 1,000 iterations)
  -> backward -> the optimizer of the config's preset. The step's stats (loss, valid
  samples, ``num_overflow`` of the voxel march or the segmented cull, and the segmented
  cull's ``seg_frac_max``) are read at once, in one device read (JAX defers the fetch by one
  step to hide a device round trip).
* adaptive ray batching holds the valid samples per step near ``target_sample_size``, in
  power-of-two batches capped by ``max_compacted_samples``; adaptive compaction grows the
  tracer's budget at once and shrinks it on a window of steps, in half-octave buckets.
  Both count ``num_steps`` slots a ray, as JAX does, also on a 'voxel' march, whose rays
  have K x num_steps slots (464 at the octree config): there the valid fraction reads
  up to K times too high and the budget goes to 1.0. The port keeps the reference's
  rule (ROADMAP Queue 3).
* pruning on its cadence (``pre_step``), fed with the running per-cell max of the training
  samples' densities (K5), which each prune consumes and resets.
* validation renders whole views in chunks without autograd and reports PSNR.
* ``extra_state`` carries, beside JAX's tuner fields (less its retuner's, ROADMAP "Not to
  port"), the ray sampler's random stream and batch size, the tracer's budget and the
  carried density maxima, so that a resumed run draws and decides as the original would.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict

import numpy as np
import torch

from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
from wisp_tpu_torch.ops.image.metrics import psnr as psnr_fn
from wisp_tpu_torch.trainers.base_trainer import BaseTrainer, ConfigBaseTrainer

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ConfigMultiviewTrainer(ConfigBaseTrainer):
    start_prune: int = 1000
    prune_every: int = 100
    rgb_lambda: float = 1.0
    opacity_loss: float = 0.0
    rgb_loss_type: str = "l2"      # 'l2' | 'l1' | 'huber'
    rgb_loss_denom: str = "rays"   # 'rays' | 'samples'
    target_sample_size: int = 2 ** 18
    adaptive_compaction: bool = False
    prune_sample_feedback: bool = True
    # cap on rays * steps * compaction budget, the compacted slots of one step
    max_compacted_samples: int = 2 ** 21


def _bucket(x: float) -> float:
    """Half-octave budget bucket, at most 1."""
    return min(1.0, 2.0 ** (math.ceil(2.0 * math.log2(max(x, 1.0 / 512))) / 2.0))


class MultiviewTrainer(BaseTrainer):
    # compaction shrinks look at the max valid fraction over this many recent steps
    FRAC_WINDOW_STEPS = 32
    # a shrink needs this much room over the window's max fraction
    SHRINK_MARGIN = 1.3

    def __init__(self, cfg: ConfigMultiviewTrainer, pipeline, train_dataset,
                 validation_dataset=None, tracker=None, device=None):
        super().__init__(cfg=cfg, pipeline=pipeline, train_dataset=train_dataset,
                         tracker=tracker, device=device)
        self.validation_dataset = validation_dataset
        self._prev_num_samples = None
        self._prev_seg_frac_max = None
        self._frac_window = []
        self._steps_since_retune = 0
        nef = pipeline.nef
        blas = getattr(getattr(nef, "grid", None), "blas", None)
        self._density_feedback = bool(
            cfg.prune_sample_feedback and cfg.prune_every > -1
            and getattr(nef, "prune_density_decay", None) is not None
            and getattr(blas, "max_level", None) is not None)
        self._density_max_grid = None
        if self._density_feedback:
            self._density_max_grid = torch.zeros((8 ** blas.max_level,), dtype=torch.float32,
                                                 device=self.device)

    def pre_training(self):
        super().pre_training()
        self.tracker.metrics.define_metric("rgb_loss", aggregation_type=float)

    # -- checkpoint extras (see BaseTrainer.extra_state) ---------------------------------------
    def extra_state(self) -> Dict[str, Any]:
        extra = super().extra_state()
        extra.update({"prev_num_samples": self._prev_num_samples,
                      "prev_seg_frac_max": self._prev_seg_frac_max,
                      "frac_window": list(self._frac_window),
                      "steps_since_retune": self._steps_since_retune,
                      "tracer_compaction": getattr(self.pipeline.tracer, "compaction", None)})
        transform = self.train_dataset.transform
        if isinstance(transform, SampleRays):
            extra["transform_num_samples"] = transform.num_samples
            extra["transform_rng"] = transform._rng.bit_generator.state
        if self._density_max_grid is not None:
            extra["density_max_grid"] = self._density_max_grid
        return extra

    def load_extra_state(self, extra: Dict[str, Any]) -> None:
        super().load_extra_state(extra)
        self._prev_num_samples = extra.get("prev_num_samples")
        self._prev_seg_frac_max = extra.get("prev_seg_frac_max")
        self._frac_window = list(extra.get("frac_window", []))
        self._steps_since_retune = extra.get("steps_since_retune", 0)
        budget = extra.get("tracer_compaction")
        if budget is not None and hasattr(self.pipeline.tracer, "compaction"):
            self.pipeline.tracer.compaction = budget
        transform = self.train_dataset.transform
        if isinstance(transform, SampleRays) and "transform_num_samples" in extra:
            transform.set_num_samples(int(extra["transform_num_samples"]))
            transform._rng.bit_generator.state = extra["transform_rng"]
        if self._density_max_grid is not None and extra.get("density_max_grid") is not None:
            self._density_max_grid.copy_(extra["density_max_grid"])

    # -- pruning ------------------------------------------------------------------------------
    def pre_step(self):
        super().pre_step()
        it = self.total_iterations
        if self.cfg.prune_every > -1 and it > 1 and it >= self.cfg.start_prune \
                and it % self.cfg.prune_every == 0:
            self.prune()

    def prune(self) -> None:
        """One prune of the nef with the carried training-sample maxima, which start anew."""
        nef = self.pipeline.nef
        if getattr(nef, "prune_density_decay", None) is None \
                or getattr(nef.grid, "occupancy", None) is None:
            return
        nef.prune(sample_max=self._density_max_grid, generator=self.generator)
        if self._density_max_grid is not None:
            self._density_max_grid.zero_()

    # -- adaptive ray batching and compaction ---------------------------------------------------
    def calc_adaptive_rays(self, num_rays_in_batch: int):
        if self._prev_num_samples is None:
            return
        samples_per_ray = self._prev_num_samples / max(num_rays_in_batch, 1)
        num_rays = self.cfg.target_sample_size / max(samples_per_ray, 1)
        num_rays = int(min(num_rays, 2 ** 18))
        num_rays = 2 ** int(math.floor(math.log2(max(num_rays, 256))))
        tracer = self.pipeline.tracer
        budget = getattr(tracer, "compaction", None) or 1.0
        steps = getattr(tracer, "num_steps", 1) or 1
        while num_rays > 256 and num_rays * steps * budget > self.cfg.max_compacted_samples:
            num_rays //= 2
        if isinstance(self.train_dataset.transform, SampleRays):
            self.train_dataset.transform.set_num_samples(num_rays)
        if self.cfg.adaptive_compaction:
            self.calc_adaptive_compaction(num_rays_in_batch)

    def calc_adaptive_compaction(self, num_rays_in_batch: int):
        """Retune the tracer's budget to the valid fraction with 1.5x headroom: grow at once
        (past a 15% deadband), shrink only once a full window of steps fits a lower bucket
        with ``SHRINK_MARGIN`` to spare, at most once a window."""
        tracer = self.pipeline.tracer
        if tracer is None or not hasattr(tracer, "compaction"):
            return
        current = tracer.compaction or 0.0
        total = max(num_rays_in_batch, 1) * tracer.num_steps
        frac = self._prev_num_samples / total
        if self._prev_seg_frac_max is not None:
            # the segmented cull's budgets are per segment: they must hold the peak segment
            frac = self._prev_seg_frac_max
        self._frac_window.append(frac)
        if len(self._frac_window) > self.FRAC_WINDOW_STEPS:
            self._frac_window.pop(0)
        self._steps_since_retune += 1
        budget = _bucket(frac * 1.5 / 1.15)
        shrink_to = _bucket(max(self._frac_window) * 1.5 * self.SHRINK_MARGIN)
        if budget > current + 1e-9:
            new_budget = budget
        elif len(self._frac_window) >= self.FRAC_WINDOW_STEPS \
                and self._steps_since_retune >= self.FRAC_WINDOW_STEPS \
                and shrink_to < current - 1e-9:
            new_budget = shrink_to
        else:
            return
        cap_budget = self.cfg.max_compacted_samples / total
        if new_budget > cap_budget:
            capped = min(1.0, 2.0 ** math.floor(math.log2(max(cap_budget, 1.0 / 512))))
            if capped <= current + 1e-9:
                log.warning("adaptive compaction: budget %.4f exceeds the "
                            "max_compacted_samples cap at %d slots; keeping %.4f",
                            new_budget, total, current)
                return
            new_budget = capped
        self._steps_since_retune = 0
        log.info("adaptive compaction: budget %.4f -> %.4f (valid fraction %.4f)", current,
                 new_budget, frac)
        tracer.compaction = new_budget

    # -- the step -------------------------------------------------------------------------------
    def compute_loss(self, rays: Rays, img_gts: torch.Tensor, key):
        """(loss, aux): the loss of one batch and the step's render buffer and stats."""
        rb = self.pipeline(rays=rays, channels=["rgb", "alpha"], key=key,
                           density_feedback=self._density_feedback)
        diff = rb.rgb - img_gts
        if self.cfg.rgb_loss_type == "l2":
            rgb_loss = diff ** 2
        elif self.cfg.rgb_loss_type == "l1":
            rgb_loss = torch.abs(diff)
        elif self.cfg.rgb_loss_type == "huber":
            adiff = torch.abs(diff)
            rgb_loss = torch.where(adiff < 1.0, 0.5 * diff ** 2, adiff - 0.5)
        else:
            raise NotImplementedError(self.cfg.rgb_loss_type)
        num_valid_samples = torch.clamp(rb.num_valid_samples, min=1.0)
        if self.cfg.rgb_loss_denom == "samples":
            rgb_loss = rgb_loss.sum() / num_valid_samples
        else:
            rgb_loss = rgb_loss.mean()
        loss = self.cfg.rgb_lambda * rgb_loss
        if self.cfg.opacity_loss > 0.0 and self.total_iterations < 1000:
            loss = loss + self.cfg.opacity_loss * torch.mean((1.0 - rb.alpha) ** 2)
        # num_overflow: the rays whose occupied voxels exceeded the 'voxel' march's budget,
        # and the samples that the segmented cull's budgets dropped
        return loss, {"rgb_loss": rgb_loss, "num_valid_samples": num_valid_samples,
                      "num_overflow": rb.channels.get("num_overflow"),
                      "seg_frac_max": rb.channels.get("seg_frac_max"),
                      "density_grid_update": rb.channels.get("density_max_grid")}

    def step(self, data, key=None):
        """One optimizer step on a batch. ``key`` overrides the trainer's generator: a
        jitter [R, S] in [0, 1) (the parity tests pass JAX's)."""
        rays: Rays = data["rays"]
        num_rays = int(rays.origins.shape[0])
        rays = Rays(rays.origins.contiguous(), rays.dirs.contiguous(), rays.dist_min,
                    rays.dist_max)
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.compute_loss(rays, data["rgb"], self.generator if key is None
                                      else key)
        loss.backward()
        self.optimizer_step()
        if self._density_feedback:
            torch.maximum(self._density_max_grid, aux["density_grid_update"],
                          out=self._density_max_grid)
        # one device read for the step's stats
        stats = {"loss": loss.detach(), "rgb_loss": aux["rgb_loss"].detach(),
                 "num_valid_samples": aux["num_valid_samples"],
                 "num_overflow": aux["num_overflow"], "seg_frac_max": aux["seg_frac_max"]}
        stats = {k: v.float().reshape(()) for k, v in stats.items() if v is not None}
        values = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
        self.last_loss = values["loss"]
        self.last_num_overflow = values.get("num_overflow")
        self._apply_stats(values["loss"], values["rgb_loss"], values["num_valid_samples"],
                          num_rays, values.get("seg_frac_max"))

    def _apply_stats(self, loss: float, rgb_loss: float, num_valid: float, num_rays: int,
                     seg_frac_max=None):
        self.tracker.metrics.total_loss += loss
        self.tracker.metrics.rgb_loss += rgb_loss
        self._prev_num_samples = num_valid or None
        self._prev_seg_frac_max = seg_frac_max
        self.calc_adaptive_rays(num_rays)

    def log_console(self):
        log.info("EPOCH %d/%d | total loss: %.3E | rgb loss: %.3E", self.epoch,
                 self.max_epochs, self.tracker.metrics.average_metric("total_loss"),
                 self.tracker.metrics.average_metric("rgb_loss"))

    # -- validation -----------------------------------------------------------------------------
    @torch.no_grad()
    def render_view(self, rays: Rays, chunk: int = 32768) -> torch.Tensor:
        """A whole view's rgb [N, 3], traced in chunks. As in JAX, the ray count is padded
        to a multiple of the chunk (origin 0, direction (1, 1, 1)), so every chunk has the
        same compaction budget; the chunk is capped by ``max_compacted_samples``."""
        n = rays.origins.shape[0]
        chunk = self.clamp_render_chunk(
            min(chunk, max(1024, int(2 ** np.ceil(np.log2(max(n, 1)))))))
        pad = (-n) % chunk
        dev = rays.origins.device
        origins = torch.cat([rays.origins, torch.zeros((pad, 3), device=dev)])
        dirs = torch.cat([rays.dirs, torch.ones((pad, 3), device=dev)])
        outs = []
        for i in range(0, n + pad, chunk):
            r = Rays(origins[i:i + chunk].contiguous(), dirs[i:i + chunk].contiguous(),
                     rays.dist_min, rays.dist_max)
            outs.append(self.pipeline(rays=r, channels=["rgb", "alpha", "depth"]).rgb)
        return torch.cat(outs)[:n]

    def clamp_render_chunk(self, chunk: int) -> int:
        """Halve the render chunk (not below 1,024) until chunk * num_steps * budget fits
        ``max_compacted_samples`` (JAX's ``_clamp_render_chunk``). Under the segmented cull a
        segment's budget covers ceil(num_steps / seg_count) steps, so the rule bounds a
        segment's slots with room to spare, as in JAX."""
        tracer = self.pipeline.tracer
        budget = getattr(tracer, "compaction", None) or 0.0
        if budget <= 0.0:
            return chunk
        cap = int(self.cfg.max_compacted_samples / ((tracer.num_steps or 1) * budget))
        while chunk > 1024 and chunk > cap:
            chunk //= 2
        return chunk

    def evaluate_metrics(self, dataset) -> Dict[str, float]:
        """The mean PSNR of the dataset's views (SSIM and LPIPS are not ported yet)."""
        psnrs = [psnr_fn(self.render_view(dataset.data["rays"][i]), dataset.data["rgb"][i])
                 for i in range(len(dataset))]
        return {"psnr": float(np.mean(psnrs))}

    def validate(self) -> Dict[str, Any]:
        dataset = self.validation_dataset if self.validation_dataset is not None \
            else self.train_dataset
        metrics = self.evaluate_metrics(dataset)
        for k, v in metrics.items():
            self.tracker.log_metric(f"validation/{k}", v, self.epoch)
        log.info("EPOCH %d/%d | %s", self.epoch, self.max_epochs,
                 " | ".join(f"{k}: {v:.2f}" for k, v in metrics.items()))
        self.return_dict.update(metrics)
        self.return_dict.setdefault("psnr_by_epoch", {})[self.epoch] = metrics.get("psnr")
        return metrics
