"""Tracker — experiment tracking (counterpart of wisp_tpu/trainers/tracker/tracker.py).

It owns the run's log directory (``log_dir/exp_name/run_name``, a timestamp when no run name
is given), the ``MetricsBoard``, the offline visualizer that render snapshots go through
(``set_visualizer``), the app's config (``save_app_config``) and the dashboards it fans
metrics, images and artifacts out to. The one dashboard is TensorBoard through
``torch.utils.tensorboard``; where that import fails the tracker warns once and carries on
without it, as JAX does. wandb publishes to an external service and stays refused
(``config.utils.NOT_PORTED``); ``log_artifact`` reaches no dashboard without it. Metrics
also stay in ``history`` and go to the log.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from wisp_tpu_torch.config.utils import config_to_dict
from wisp_tpu_torch.trainers.tracker.metrics import MetricsBoard

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ConfigVisCameras:
    """The camera of render snapshots (JAX's ConfigVisCameras without the keys of its 360°
    orbit, which is not ported: ``config.utils.DROPPED_KEYS``)."""
    camera_origin: Tuple[float, float, float] = (-3.0, 0.65, -3.0)
    camera_lookat: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_fov: float = 30.0
    camera_clamp: Tuple[float, float] = (0.0, 10.0)


@dataclasses.dataclass
class ConfigTracker:
    """JAX's ConfigTracker without its wandb names (``wandb: true`` is refused by
    ``config.utils``) and its ``visualizer`` flag, which nothing reads in either package
    (the app attaches its renderer)."""
    log_dir: str = "_results/logs/runs"
    # the run's subdirectory (default: a fresh timestamp); pin it to resume into a run
    run_name: Optional[str] = None
    tensorboard: bool = True
    vis_camera: ConfigVisCameras = dataclasses.field(default_factory=ConfigVisCameras)


class _Tensorboard:
    """TensorBoard dashboard (JAX tracker.py:77)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter
        self.writer = SummaryWriter(log_dir=log_dir)

    def log_metric(self, metric, value, step):
        self.writer.add_scalar(metric, value, step)

    def log_image(self, name, image, step):
        arr = np.asarray(image)
        if arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
            arr = np.moveaxis(arr, -1, 0)
        self.writer.add_image(name, arr, step)

    def teardown(self):
        self.writer.close()


class Tracker:
    def __init__(self, exp_name: str = "wisp_experiment", cfg: Optional[ConfigTracker] = None):
        self.cfg = cfg if cfg is not None else ConfigTracker(tensorboard=False)
        self.exp_name = exp_name
        self.log_dir = os.path.join(self.cfg.log_dir, exp_name,
                                    self.cfg.run_name or time.strftime("%Y%m%d-%H%M%S"))
        self.metrics = MetricsBoard()
        self.history: Dict[str, List[Tuple[int, float]]] = {}
        self.visualizer = None   # an OfflineRenderer, attached by the app
        self._app_config = None
        self.dashboards = []
        if self.cfg.tensorboard:
            try:
                self.dashboards.append(_Tensorboard(self.ensure_log_dir()))
            except ImportError:
                # a warning prints once (on stderr) however many trackers are made
                warnings.warn("tensorboard is not installed; the TensorBoard dashboard is "
                              "off and metrics go to the console", stacklevel=2)

    def ensure_log_dir(self) -> str:
        """The run's log directory, made on first use."""
        os.makedirs(self.log_dir, exist_ok=True)
        return self.log_dir

    def set_visualizer(self, visualizer) -> None:
        self.visualizer = visualizer

    def save_app_config(self, cfg) -> None:
        self._app_config = cfg

    def get_app_config(self, as_dict: bool = False):
        if self._app_config is None:
            return None
        return config_to_dict(self._app_config) if as_dict else self._app_config

    def log_metric(self, name: str, value: float, step: int) -> None:
        self.history.setdefault(name, []).append((step, float(value)))
        log.debug("%s %s @ %d: %g", self.exp_name, name, step, value)
        for d in self.dashboards:
            d.log_metric(name, value, step)

    def log_image(self, name: str, image, step: int) -> None:
        for d in self.dashboards:
            d.log_image(name, image, step)

    def log_artifact(self, model_fname: str, names) -> None:
        """wandb's model artifacts; no dashboard of the port takes them."""

    def teardown(self) -> None:
        for d in self.dashboards:
            d.teardown()
