"""BaseTrainer — training lifecycle and optimizer state (counterpart of
wisp_tpu/trainers/base_trainer.py).

The lifecycle is JAX's: pre_training -> [begin_epoch -> [pre_step -> step -> post_step]* ->
end_epoch (validate on its cadence)]* -> post_training, driven one step at a time by
``iterate()``. Where JAX jits one function for forward, loss, backward and update, the port
runs them eagerly: autograd gives the gradients (the kernels' backward launches included)
and the optimizer of the config's preset applies them.

* The optimizer is built from any preset of ``wisp_tpu_torch.config.presets`` (``ConfigAdam``,
  JAX's default; ``ConfigAdamW``, ``ConfigRMSprop``, ``ConfigSGD``), each with the update of
  the optax optimizer JAX builds from it.
* Parameter groups by name, as JAX's pytree paths: 'decoder' (weight decay as configured),
  'grid' (lr x ``grid_lr_weight``, no weight decay) and 'rest' (no weight decay).
* The schedule is JAX's piecewise constant one: after ``int(max_steps*m)`` updates for each
  milestone m, the rate is multiplied by ``scheduler_gamma``.
* AMP is JAX's bf16 policy (``compute_dtype`` on every BasicDecoder), not
  ``torch.autocast``: parameters and gradients stay float32; bf16 needs no loss scaling.
* On their epoch cadences ``post_epoch`` renders a snapshot through the tracker's
  visualizer (``render_every``) and saves the pipeline (``save_every``, ``model_format``
  'full': the pickled module, or 'state_dict': ``pipeline_state_dict``); ``end_epoch``
  writes the whole training state (``checkpoint_every``, ``checkpoint.save_checkpoint``),
  which ``resume`` (a path, or 'auto' / 'latest': the newest under the run's log dir)
  restores at the first step, after which training goes on exactly as it would have.
* The trainer refuses any setting of ``config.utils.NOT_PORTED`` (``check_ported``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple, Union

import torch

from wisp_tpu_torch.config import yaml_subset
from wisp_tpu_torch.config.presets import ConfigAdam, ConfigAdamW, ConfigRMSprop, ConfigSGD
from wisp_tpu_torch.config.utils import check_ported, instantiate
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.decoders.basic_decoders import BasicDecoder
from wisp_tpu_torch.trainers import checkpoint
from wisp_tpu_torch.trainers.tracker.tracker import Tracker

log = logging.getLogger(__name__)

__all__ = ["BaseTrainer", "ConfigAdam", "ConfigAdamW", "ConfigBaseTrainer", "ConfigRMSprop",
           "ConfigSGD", "apply_amp_policy", "load_pipeline", "load_state_dict",
           "pipeline_state_dict"]


@dataclasses.dataclass
class ConfigBaseTrainer:
    optimizer: Union[ConfigAdam, ConfigAdamW, ConfigRMSprop, ConfigSGD] = \
        dataclasses.field(default_factory=ConfigAdam)
    exp_name: str = "wisp_experiment"
    max_epochs: int = 250
    # epoch cadences (-1: off) of the pipeline checkpoint and the render snapshot
    save_every: int = -1
    save_as_new: bool = False
    model_format: str = "full"  # 'full' | 'state_dict'
    render_every: int = 100
    valid_every: int = -1
    valid_split: str = "test"
    enable_amp: bool = True
    grid_lr_weight: float = 1.0
    scheduler: bool = False
    scheduler_milestones: Tuple[float, ...] = (0.5, 0.75, 0.9)
    scheduler_gamma: float = 0.333
    random_seed: int = 0
    # epoch cadence of the whole training state (checkpoint.py), and where to resume from:
    # a file, or 'auto' / 'latest' for the newest under the run's log dir (none: start anew)
    checkpoint_every: int = -1
    resume: Optional[str] = None


def pipeline_state_dict(pipeline) -> Dict[str, torch.Tensor]:
    """Every tensor of the pipeline by path, as JAX's path-keyed npz: the modules'
    parameters and buffers, and for each octree (a plain object, not a module) its
    occupancy ``<grid>.blas.occ_grid``, density field ``.cell_density`` and ``.dense``
    flag, so that a loaded pipeline marches on the pruned occupancy."""
    state = dict(pipeline.state_dict())
    for name, module in pipeline.named_modules():
        blas = getattr(module, "blas", None)
        if getattr(blas, "occ_grid", None) is not None:
            prefix = f"{name}.blas." if name else "blas."
            state[prefix + "occ_grid"] = blas.occ_grid
            state[prefix + "cell_density"] = blas.cell_density
            state[prefix + "dense"] = torch.tensor(blas.dense)
    return state


def _load_pipeline_state(pipeline, state: Dict[str, torch.Tensor], strict: bool = True):
    """Copy ``pipeline_state_dict`` entries into a pipeline of the same architecture."""
    blas_keys = set()
    for name, module in list(pipeline.named_modules()):
        blas = getattr(module, "blas", None)
        if getattr(blas, "occ_grid", None) is None:
            continue
        prefix = f"{name}.blas." if name else "blas."
        keys = [prefix + k for k in ("occ_grid", "cell_density", "dense")]
        if not all(k in state for k in keys):
            if strict:
                raise KeyError(f"state has no octree for {name or 'the pipeline'}")
            continue
        blas_keys.update(keys)
        occ, dens = (state[k].to(blas.occ_grid.device) for k in keys[:2])
        if tuple(occ.shape) != tuple(blas.occ_grid.shape):
            raise ValueError(f"shape mismatch at {keys[0]}: state {tuple(occ.shape)} vs "
                             f"pipeline {tuple(blas.occ_grid.shape)}")
        if blas.dense and not bool(state[keys[2]]):
            # a pruned octree: a new one, whose march tests the field
            module.blas = blas.update_occupancy(occ, cell_density=dens)
        else:
            blas.occ_grid.copy_(occ)
            blas.cell_density.copy_(dens)
    rest = {k: v for k, v in state.items() if k not in blas_keys}
    pipeline.load_state_dict(rest, strict=strict)
    return pipeline


def load_state_dict(pipeline, path: str, strict: bool = True):
    """Restore a 'state_dict' checkpoint of ``BaseTrainer.save_model`` into a pipeline built
    from the same config (in place; returned). With ``strict`` every stored tensor must
    find its slot and every slot must be filled."""
    return _load_pipeline_state(pipeline, torch.load(path, map_location="cpu",
                                                     weights_only=True), strict)


def load_pipeline(path: str, device: DeviceLike = None):
    """The pipeline of a 'full' checkpoint of ``BaseTrainer.save_model`` (a pickled module:
    torch.load needs ``weights_only=False``, so load only files you trust), on ``device``
    (the card unless "cpu")."""
    return torch.load(path, map_location=resolve_device(device), weights_only=False)


def apply_amp_policy(pipeline) -> None:
    """bf16 compute on every BasicDecoder of the pipeline."""
    for module in pipeline.modules():
        if isinstance(module, BasicDecoder):
            module.compute_dtype = torch.bfloat16


class BaseTrainer(ABC):
    def __init__(self, cfg: ConfigBaseTrainer, pipeline, train_dataset,
                 tracker: Optional[Tracker] = None, device: DeviceLike = None):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.train_dataset = train_dataset
        self.tracker = tracker if tracker is not None else Tracker(exp_name=cfg.exp_name)
        self.max_epochs = cfg.max_epochs
        self.epoch = 1
        self.iteration = 0
        self.iterations_per_epoch = len(train_dataset)
        # the trainer's random stream: march jitter and prune queries
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.random_seed)
        self.return_dict: Dict[str, Any] = {}
        self.is_optimization_running = True
        self._data_iter = None
        self._pre_training_done = False
        if cfg.enable_amp:
            apply_amp_policy(self.pipeline)
        self.init_optimizer()

    # -- optimizer ------------------------------------------------------------------------
    @staticmethod
    def _param_group(name: str) -> str:
        if "decoder" in name:
            return "decoder"
        if "grid" in name or "codebook" in name or "feats" in name:
            return "grid"
        return "rest"

    def init_optimizer(self) -> None:
        opt = self.cfg.optimizer
        settings = {"decoder": (opt.lr, opt.weight_decay),
                    "grid": (opt.lr * self.cfg.grid_lr_weight, 0.0),
                    "rest": (opt.lr, 0.0)}
        groups: Dict[str, list] = {k: [] for k in settings}
        for name, p in self.pipeline.named_parameters():
            if p.requires_grad:
                groups[self._param_group(name)].append(p)
        self.optimizer = instantiate(opt, params=[
            {"params": ps, "lr": settings[k][0], "base_lr": settings[k][0],
             "weight_decay": settings[k][1], "name": k}
            for k, ps in groups.items() if ps])
        self.num_updates = 0

    def lr_scale(self, count: int) -> float:
        """The schedule's factor for the update that follows ``count`` updates."""
        if not self.cfg.scheduler:
            return 1.0
        max_steps = self.iterations_per_epoch * self.cfg.max_epochs
        # one factor per distinct boundary, as the JAX schedule's dict of boundaries
        boundaries = {int(max_steps * m): self.cfg.scheduler_gamma
                      for m in self.cfg.scheduler_milestones}
        scale = 1.0
        for b, gamma in boundaries.items():
            if count >= b:
                scale *= gamma
        return scale

    def optimizer_step(self) -> None:
        scale = self.lr_scale(self.num_updates)
        for group in self.optimizer.param_groups:
            group["lr"] = group["base_lr"] * scale
        self.optimizer.step()
        self.num_updates += 1

    # -- lifecycle --------------------------------------------------------------------------
    @property
    def total_iterations(self) -> int:
        return (self.epoch - 1) * self.iterations_per_epoch + self.iteration

    def pre_training(self):
        self.tracker.metrics.define_metric("total_loss", aggregation_type=float)
        app_config = self.tracker.get_app_config(as_dict=True)
        if app_config is not None:
            path = os.path.join(self.tracker.ensure_log_dir(), "config.yaml")
            with open(path, "w") as fh:
                fh.write(yaml_subset.dumps(app_config))

    def post_training(self):
        self.tracker.teardown()
        log.info("Training completed.")

    def pre_epoch(self):
        pass

    def post_epoch(self):
        self.log_console()
        self.log_tracker()
        self.tracker.metrics.finalize_epoch()
        if self.is_time_to_render():
            self.render_snapshot()
        if self.is_time_to_save():
            self.save_model()

    def pre_step(self):
        pass

    def post_step(self):
        pass

    def reset_data_iterator(self):
        self._data_iter = iter(range(len(self.train_dataset)))

    def begin_epoch(self):
        self.reset_data_iterator()
        self.pre_epoch()

    def end_epoch(self):
        self.post_epoch()
        if self.cfg.valid_every > -1 and self.epoch % self.cfg.valid_every == 0:
            self.validate()
        completed_epoch = self.epoch
        if self.epoch < self.max_epochs:
            self.iteration = 0
            self.epoch += 1
        else:
            self.is_optimization_running = False
        # after the counters advance: a resume from this file starts at the next epoch
        if self.cfg.checkpoint_every > -1 and completed_epoch % self.cfg.checkpoint_every == 0:
            self.save_training_state()

    def next_batch(self):
        return self.train_dataset[next(self._data_iter)]

    def begin_training(self) -> None:
        """``pre_training`` and the resume, once, before the first step (``iterate`` calls
        it; a caller may call it first to look at the restored state)."""
        if not self._pre_training_done:
            self.pre_training()
            self._pre_training_done = True
            self._maybe_resume()

    def iterate(self):
        """One training step through all lifecycle hooks."""
        if not self.is_optimization_running:
            return
        self.begin_training()
        if not self.is_optimization_running:
            return
        data = None
        try:
            if self._data_iter is None:
                self.begin_epoch()
            self.iteration += 1
            data = self.next_batch()
        except StopIteration:
            self.end_epoch()
            if self.is_optimization_running:
                self.begin_epoch()
                self.iteration += 1
                data = self.next_batch()
            else:
                self.post_training()
        if self.is_optimization_running and data is not None:
            self.pre_step()
            self.step(data)
            self.post_step()

    def train(self) -> Dict[str, Any]:
        self.is_optimization_running = True
        while self.is_optimization_running:
            self.iterate()
        return self.return_dict

    @abstractmethod
    def step(self, data):
        """Advance training by one batch."""

    @abstractmethod
    def validate(self):
        pass

    def log_console(self):
        log.info("EPOCH %d/%d | total loss: %.3E", self.epoch, self.max_epochs,
                 self.tracker.metrics.average_metric("total_loss"))

    def log_tracker(self):
        for key in self.tracker.metrics.active_metrics:
            if "loss" in key:
                self.tracker.log_metric(f"loss/{key}",
                                        self.tracker.metrics.average_metric(key), self.epoch)

    # -- snapshots and checkpoints ------------------------------------------------------------
    def is_time_to_render(self) -> bool:
        return self.cfg.render_every > -1 and self.epoch % self.cfg.render_every == 0

    def is_time_to_save(self) -> bool:
        return self.cfg.save_every > -1 and self.epoch % self.cfg.save_every == 0 \
            and self.epoch != 0

    def render_snapshot(self) -> None:
        """Render one frame through the tracker's visualizer, if one is attached, from the
        tracker's snapshot camera, and log its channels as images."""
        if self.tracker.visualizer is None:
            return
        cam = self.tracker.cfg.vis_camera
        out = self.tracker.visualizer.render_snapshot(
            self.pipeline, f=cam.camera_origin, t=cam.camera_lookat, fov=cam.camera_fov,
            camera_clamp=cam.camera_clamp)
        img = out.image()
        for key in ("depth", "hit", "normal", "rgb", "alpha"):
            if key in img.channels:
                self.tracker.log_image(key, img.channels[key].cpu().numpy(), self.epoch)

    def save_model(self) -> str:
        """Save the pipeline into the run's log dir as ``model.ckpt`` ('full': the pickled
        module, for ``load_pipeline``) or ``model.ckpt.pt`` ('state_dict':
        ``pipeline_state_dict``, for ``load_state_dict``); ``save_as_new`` adds
        ``-ep<epoch>-it<iteration>``. Returns the file's path."""
        suffix = f"-ep{self.epoch}-it{self.iteration}" if self.cfg.save_as_new else ""
        path = os.path.join(self.tracker.ensure_log_dir(), f"model{suffix}.ckpt")
        if self.cfg.model_format == "full":
            torch.save(self.pipeline, path)
        elif self.cfg.model_format == "state_dict":
            path += checkpoint.SUFFIX
            torch.save(pipeline_state_dict(self.pipeline), path)
        else:
            raise ValueError(f"model_format must be 'full' or 'state_dict', got "
                             f"{self.cfg.model_format!r}")
        log.info("Saving model checkpoint to: %s", path)
        self.tracker.log_artifact(model_fname=path,
                                  names=["latest", f"ep{self.epoch}_it{self.iteration}"])
        return path

    def save_training_state(self) -> str:
        """The whole training state into the run's log dir (``checkpoint.py``)."""
        return checkpoint.save_checkpoint(
            self, os.path.join(self.tracker.ensure_log_dir(), checkpoint.TRAIN_STATE_BASENAME))

    def _maybe_resume(self) -> None:
        path = self.cfg.resume
        if not path:
            return
        if path in ("auto", "latest"):
            path = checkpoint.latest_checkpoint(self.tracker.log_dir)
            if path is None:
                log.info("resume=%s: no checkpoint in %s, starting anew", self.cfg.resume,
                         self.tracker.log_dir)
                return
        checkpoint.restore_checkpoint(self, path)

    def state_dict(self) -> Dict[str, Any]:
        """What a resumed trainer needs to go on exactly: the pipeline's tensors, the
        optimizer's state, the counters, the random stream and ``extra_state()``."""
        return {"pipeline": pipeline_state_dict(self.pipeline),
                "optimizer": self.optimizer.state_dict(),
                "meta": {"epoch": self.epoch, "iteration": self.iteration,
                         "num_updates": self.num_updates,
                         "generator": self.generator.get_state(),
                         "metrics": self.tracker.metrics.state_dict()},
                "extra": self.extra_state()}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Restore ``state_dict()`` into a trainer built from the same config."""
        _load_pipeline_state(self.pipeline, state["pipeline"])
        self.optimizer.load_state_dict(state["optimizer"])
        meta = state["meta"]
        self.epoch, self.iteration = int(meta["epoch"]), int(meta["iteration"])
        self.num_updates = int(meta["num_updates"])
        # a CUDA generator takes its state as a host byte tensor through its own set_state
        self.generator.set_state(meta["generator"].cpu())
        self.tracker.metrics.load_state_dict(meta["metrics"])
        # the data position: the epoch's batches already taken are skipped
        self._data_iter = None
        if self.iteration > 0:
            self.reset_data_iterator()
            for _ in range(self.iteration):
                next(self._data_iter, None)
        self.load_extra_state(state["extra"])

    def extra_state(self) -> Dict[str, Any]:
        """Subclass hook: the trainer's own state beyond the counters (JAX's extra_state).
        The octree's dense flag rides in ``pipeline_state_dict``."""
        return {"done": not self.is_optimization_running}

    def load_extra_state(self, extra: Dict[str, Any]) -> None:
        if extra.get("done", False) and self.epoch >= self.max_epochs:
            log.info("resume: the run had ended (epoch %d/%d); nothing to train", self.epoch,
                     self.max_epochs)
            self.is_optimization_running = False
