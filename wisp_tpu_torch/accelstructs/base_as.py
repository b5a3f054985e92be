"""Ray-march, raytrace and point-query result containers (counterpart of
wisp_tpu/accelstructs/base_as.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ASRaymarchResults:
    """Rectangular masked march samples."""
    samples: torch.Tensor        # [R, S, 3] sample points
    depth_samples: torch.Tensor  # [R, S] depths along the ray
    deltas: torch.Tensor         # [R, 1] step per ray ('ray' mode: span / S)
    mask: torch.Tensor           # [R, S] bool, sample inside an occupied cell
    cell_density: Optional[torch.Tensor] = None  # [R, S] density estimate of the cell
    num_overflow: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ASRaytraceResults:
    """The occupied cells a ray crosses, in ray order, in a fixed number of slots K."""
    pidx: torch.Tensor     # [R, K] int32 cell index at the traced level; -1 = empty slot
    t_entry: torch.Tensor  # [R, K] float32 entry depth (0 in an empty slot)
    t_exit: torch.Tensor   # [R, K] float32 exit depth (0 in an empty slot)
    mask: torch.Tensor     # [R, K] bool, pidx >= 0
    overflow: torch.Tensor  # [R] bool, the ray crossed more occupied cells than K


@dataclasses.dataclass
class ASQueryResults:
    """Point query: cell index per point (-1 = unoccupied or outside), [N] or, with
    parents, [N, level+1]."""
    pidx: torch.Tensor
