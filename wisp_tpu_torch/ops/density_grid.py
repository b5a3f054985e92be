"""Density-feedback scatter-max (K5; counterpart of the inline keep-score update of
wisp_tpu/tracers/packed_rf_tracer.py:237-256).

The per-cell maximum of the densities of a step's training samples, on a grid of 8^level
cells that starts at zero; ids outside the grid are dropped, as JAX's ``mode="drop"`` does.
On a CUDA tensor ``scatter_max`` launches ``csrc/scatter_max.cu`` (atomicMax on the int bits
of the values, which orders floats >= 0 as their values); on a CPU tensor it runs
``scatter_max_plain``. Densities are relu'd, so both agree exactly; a NaN turns its cell
into NaN in both. Given ``out``, a grid carried from earlier calls, ``scatter_max`` maxes
into it in place (the segments of one segmented trace share one grid, as JAX's carried
``fb`` does, packed_rf_tracer.py:376-384).
"""

from __future__ import annotations

from typing import Optional

import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.ops.spc.core import quantize_points


def cell_ids(points: torch.Tensor, level: int) -> torch.Tensor:
    """[N, 3] points in [-1, 1]^3 -> flat int64 ids (x*res + y)*res + z of their cells."""
    res = 2 ** level
    q = quantize_points(points, level)
    return (q[:, 0] * res + q[:, 1]) * res + q[:, 2]


def scatter_max_plain(ids: torch.Tensor, values: torch.Tensor, size: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_max``."""
    keep = (ids >= 0) & (ids < size)
    grid = torch.zeros((size,), dtype=torch.float32, device=values.device) \
        if out is None else out
    return grid.scatter_reduce_(0, ids[keep], values[keep].to(torch.float32), "amax",
                                include_self=True)


def scatter_max(ids: torch.Tensor, values: torch.Tensor, size: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[size] float32 grid: 0 where no id lands, else the max of the ``values`` [K]
    (>= 0) whose ``ids`` [K] name the cell. With ``out`` ([size] float32, values >= 0),
    the max is taken into it in place and ``out`` is returned."""
    if not values.is_cuda:
        return scatter_max_plain(ids, values, size, out)
    k = values.shape[0]
    kernels.check(ids, "ids", torch.int64, (k,))
    kernels.check(values, "values", torch.float32, (k,))
    if out is None:
        grid = torch.zeros((size,), dtype=torch.float32, device=values.device)
    else:
        kernels.check(out, "out", torch.float32, (size,))
        grid = out
    if k > 0:
        kernels.launch("wisp_scatter_max", "scatter_max" if out is None else "scatter_max_acc",
                       ids.data_ptr(), values.data_ptr(), k, size, grid.data_ptr())
    return grid
