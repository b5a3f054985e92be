"""Density-feedback scatter-max (K5; counterpart of the inline keep-score update of
wisp_tpu/tracers/packed_rf_tracer.py:237-256).

The per-cell maximum of the densities of a step's training samples, on a grid of 8^level
cells that starts at zero. JAX computes it as one inline function: each sample's point
quantized to its cell (``quantize_points_jnp``), the cell's flat id, the drop of samples
off the mask, and ``.at[ids].max(density, mode="drop")``. ``scatter_max_points`` is that
whole function: on a CUDA tensor it launches ``csrc/scatter_max.cu`` once (the cell lookup
inside the kernel, then atomicMax on the int bits of the value, which orders floats >= 0 as
their values); on a CPU tensor it runs ``scatter_max_points_plain``, which is ``cell_ids``
and ``scatter_max_plain``. Densities are relu'd, so both agree exactly; a NaN turns its
cell into NaN in both. Given ``out``, a grid carried from earlier calls, the max is taken
into it in place (the segments of one segmented trace share one grid, as JAX's carried
``fb`` does, packed_rf_tracer.py:376-384).
"""

from __future__ import annotations

from typing import Optional

import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.ops.spc.core import MAX_OCTREE_LEVEL, quantize_points


def cell_ids(points: torch.Tensor, level: int) -> torch.Tensor:
    """[N, 3] points in [-1, 1]^3 -> flat int64 ids (x*res + y)*res + z of their cells."""
    res = 2 ** level
    q = quantize_points(points, level)
    return (q[:, 0] * res + q[:, 1]) * res + q[:, 2]


def scatter_max_plain(ids: torch.Tensor, values: torch.Tensor, size: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[size] float32 grid: the max of the ``values`` [K] whose ``ids`` [K] name a cell,
    into zeros or into ``out`` in place; ids outside [0, size) are dropped."""
    keep = (ids >= 0) & (ids < size)
    grid = torch.zeros((size,), dtype=torch.float32, device=values.device) \
        if out is None else out
    return grid.scatter_reduce_(0, ids[keep], values[keep].to(torch.float32), "amax",
                                include_self=True)


def scatter_max(ids: torch.Tensor, values: torch.Tensor, size: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``scatter_max_plain`` on CPU tensors: the scatter-max keyed by ready cell ids, JAX's
    ``.at[ids].max(mode="drop")``. No path calls it, and it has no kernel: the tracer's
    K5 is ``scatter_max_points``, which finds the cells itself (the earlier kernel keyed by
    ids is ``csrc/baselines/scatter_max_v1.cu``). Raises on a CUDA tensor."""
    if values.is_cuda:
        raise ValueError("scatter_max: no kernel takes ready ids; call scatter_max_points "
                         "with the samples' points")
    return scatter_max_plain(ids, values, size, out)


def scatter_max_points_plain(points: torch.Tensor, density: torch.Tensor, level: int,
                             out: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_max_points``."""
    size = 8 ** level
    ids = cell_ids(points, level)
    if keep is not None:
        # samples off the mask go to an id past the grid, which the scatter drops
        ids = torch.where(keep, ids, size)
    return scatter_max_plain(ids, density.to(torch.float32), size, out)


def scatter_max_points(points: torch.Tensor, density: torch.Tensor, level: int,
                       out: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[8^level] float32 grid: 0 where no sample lands, else the max of the densities
    (>= 0) of the samples whose ``points`` [K, 3] float32 fall in the cell (quantized as
    ``quantize_points`` at ``level``). ``density`` [K] is float32 or bfloat16 at any
    stride (the field's density column as it comes); ``keep`` [K] bool, if given, drops
    the samples where it is False. With ``out`` ([8^level] float32, values >= 0), the max
    is taken into it in place and ``out`` is returned. One launch a call, counted under
    ``scatter_max`` (a fresh grid) or ``scatter_max_acc`` (``out``)."""
    if not points.is_cuda:
        return scatter_max_points_plain(points, density, level, out, keep)
    k = points.shape[0]
    kernels.check(points, "points", torch.float32, (k, 3))
    if not (isinstance(density, torch.Tensor) and density.is_cuda
            and density.dtype in (torch.float32, torch.bfloat16)
            and tuple(density.shape) == (k,) and density.stride(0) >= 0):
        raise ValueError(f"density: expected a CUDA float32 or bfloat16 tensor of shape "
                         f"({k},), got {getattr(density, 'dtype', None)} "
                         f"{tuple(getattr(density, 'shape', ()))}")
    if keep is not None:
        kernels.check(keep, "keep", torch.bool, (k,))
    if not 0 <= level <= MAX_OCTREE_LEVEL:
        raise ValueError(f"scatter_max_points: level {level} outside [0, "
                         f"{MAX_OCTREE_LEVEL}]")
    size = 8 ** level
    if out is None:
        grid = torch.zeros((size,), dtype=torch.float32, device=points.device)
    else:
        kernels.check(out, "out", torch.float32, (size,))
        grid = out
    if k > 0:
        kernels.launch("wisp_scatter_max_points",
                       "scatter_max" if out is None else "scatter_max_acc", points.data_ptr(),
                       density.data_ptr(), density.stride(0),
                       int(density.dtype == torch.bfloat16), kernels.ptr(keep), k, level,
                       grid.data_ptr())
    return grid
