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
* Checkpoints (``save_every``) and render snapshots (``render_every``) are not ported yet
  (ROADMAP Queue 1, item 1): the trainer refuses a config whose cadence would fire within
  ``max_epochs``, and any setting of ``config.utils.NOT_PORTED``, by ``check_ported``.
"""

from __future__ import annotations

import dataclasses
import logging
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple, Union

import torch

from wisp_tpu_torch.config.presets import ConfigAdam, ConfigAdamW, ConfigRMSprop, ConfigSGD
from wisp_tpu_torch.config.utils import check_ported, instantiate
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.decoders.basic_decoders import BasicDecoder
from wisp_tpu_torch.trainers.tracker.tracker import Tracker

log = logging.getLogger(__name__)

__all__ = ["BaseTrainer", "ConfigAdam", "ConfigAdamW", "ConfigBaseTrainer", "ConfigRMSprop",
           "ConfigSGD", "apply_amp_policy"]


@dataclasses.dataclass
class ConfigBaseTrainer:
    optimizer: Union[ConfigAdam, ConfigAdamW, ConfigRMSprop, ConfigSGD] = \
        dataclasses.field(default_factory=ConfigAdam)
    exp_name: str = "wisp_experiment"
    max_epochs: int = 250
    # checkpoints and render snapshots are not ported: a cadence that would fire within
    # max_epochs is refused (render_every is 100 in JAX; off here, which is what the port does)
    save_every: int = -1
    render_every: int = -1
    valid_every: int = -1
    valid_split: str = "test"
    enable_amp: bool = True
    grid_lr_weight: float = 1.0
    scheduler: bool = False
    scheduler_milestones: Tuple[float, ...] = (0.5, 0.75, 0.9)
    scheduler_gamma: float = 0.333
    random_seed: int = 0


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

    def post_training(self):
        self.tracker.teardown()
        log.info("Training completed.")

    def pre_epoch(self):
        pass

    def post_epoch(self):
        self.log_console()
        self.tracker.metrics.finalize_epoch()

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
        if self.epoch < self.max_epochs:
            self.iteration = 0
            self.epoch += 1
        else:
            self.is_optimization_running = False

    def next_batch(self):
        return self.train_dataset[next(self._data_iter)]

    def iterate(self):
        """One training step through all lifecycle hooks."""
        if not self.is_optimization_running:
            return
        if not self._pre_training_done:
            self.pre_training()
            self._pre_training_done = True
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
