"""Geometric helpers (counterpart of wisp_tpu/ops/geometric.py: ``sample_fib_sphere`` and
``voxel_boundary_step``)."""

from __future__ import annotations

import numpy as np
import torch


def sample_fib_sphere(n: int) -> np.ndarray:
    """[n, 3] near-uniform Fibonacci-lattice points on the unit sphere (float32)."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1 - 2 * (i / (n - 1))
    r = np.sqrt(np.maximum(1 - y * y, 0.0))
    theta = phi * i
    return np.stack([np.cos(theta) * r, y, np.sin(theta) * r], axis=-1).astype(np.float32)


def voxel_boundary_step(pos: torch.Tensor, dirs: torch.Tensor, voxel: float,
                        eps_frac: float = 1e-3) -> torch.Tensor:
    """[N] distance along each ray from ``pos`` [N, 3] to the next plane of the uniform
    [-1,1]^3 lattice of cell size ``voxel``, plus ``eps_frac * voxel``: one step crosses
    exactly one cell boundary. Axes with |dir| <= 1e-12 never bound the step."""
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a product with its
    # reciprocal, which rounds differently from JAX's and the kernels' true division
    voxel_t = torch.full((1, 1), voxel, dtype=pos.dtype, device=pos.device)
    q = torch.floor((pos + 1.0) / voxel_t)
    next_plane = -1.0 + (q + (dirs > 0.0).to(pos.dtype)) * voxel
    moving = dirs.abs() > 1e-12
    dt = torch.where(moving, (next_plane - pos) / torch.where(moving, dirs, 1.0),
                     torch.full_like(pos, float("inf")))
    return dt.clamp(min=0.0).amin(dim=-1) + eps_frac * voxel
