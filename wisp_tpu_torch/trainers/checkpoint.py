"""Checkpoint and resume of a whole training state (counterpart of
wisp_tpu/trainers/checkpoint.py).

One file, written atomically (``torch.save`` into ``<path>.tmp``, then a rename), holds what
a trainer needs to go on exactly where it stopped: the pipeline's tensors
(``pipeline_state_dict``: parameters, buffers and the octree's occupancy), the optimizer's
state, the counters, the data position, the random streams and the trainer's
``extra_state()``. The pipeline's structure is rebuilt from the config, as in JAX. JAX's
orbax backend is not ported: a torch file is one file, and the orbax restore template
(ADVICE low, ``checkpoint.py:85``) has no counterpart here.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

log = logging.getLogger(__name__)

TRAIN_STATE_BASENAME = "train_state"
SUFFIX = ".pt"


def save_checkpoint(trainer, path: str) -> str:
    """Write ``trainer.state_dict()`` to ``path`` (``.pt`` added) atomically: a kill during
    the write leaves only the stale ``.tmp``. Returns the file's path."""
    final = os.path.abspath(path if path.endswith(SUFFIX) else path + SUFFIX)
    tmp = final + ".tmp"
    torch.save(trainer.state_dict(), tmp)
    os.replace(tmp, final)
    log.info("checkpoint saved to %s", final)
    return final


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The state of a checkpoint file, on the host (tensors and plain Python values only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(trainer, path: str) -> None:
    """Restore a checkpoint into a trainer built from the same config."""
    trainer.load_state(load_checkpoint(path))
    log.info("checkpoint restored from %s (epoch %d, iteration %d)", path, trainer.epoch,
             trainer.iteration)


def latest_checkpoint(log_dir: str) -> Optional[str]:
    """The newest complete train-state checkpoint under ``log_dir`` (for ``resume: auto``);
    in-flight ``.tmp`` files are ignored."""
    if not os.path.isdir(log_dir):
        return None
    cands = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
             if f.startswith(TRAIN_STATE_BASENAME) and not f.endswith(".tmp")]
    cands = [c for c in cands if os.path.isfile(c)]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)
