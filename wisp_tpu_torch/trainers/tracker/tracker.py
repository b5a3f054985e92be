"""Tracker — console-only experiment tracker (counterpart of
wisp_tpu/trainers/tracker/tracker.py without its TensorBoard and wandb dashboards, which are
not ported yet: ROADMAP Queue 1, item 1). It writes no files: metrics go to the log and stay
in ``history``.

With ``ConfigTracker.tensorboard`` on (JAX's default) the tracker says once, on stderr, that
it logs to the console instead.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Dict, List, Optional, Tuple

from wisp_tpu_torch.trainers.tracker.metrics import MetricsBoard

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ConfigTracker:
    """JAX's ConfigTracker as far as the port acts on it: ``tensorboard``. Its other keys in
    the configs are dropped (``log_dir``) or refused (``wandb: true``) by
    ``config.utils``."""
    tensorboard: bool = True


class Tracker:
    def __init__(self, exp_name: str = "wisp_experiment", cfg: Optional[ConfigTracker] = None):
        self.cfg = cfg if cfg is not None else ConfigTracker(tensorboard=False)
        if self.cfg.tensorboard:
            # a warning prints once (on stderr) however many trackers are made
            warnings.warn("TensorBoard is not ported yet (ROADMAP Queue 1, item 1); metrics "
                          "go to the console", stacklevel=2)
        self.exp_name = exp_name
        self.metrics = MetricsBoard()
        self.history: Dict[str, List[Tuple[int, float]]] = {}

    def log_metric(self, name: str, value: float, step: int) -> None:
        self.history.setdefault(name, []).append((step, float(value)))
        log.debug("%s %s @ %d: %g", self.exp_name, name, step, value)

    def teardown(self) -> None:
        pass
