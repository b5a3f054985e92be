"""Geometric helpers (counterpart of wisp_tpu/ops/geometric.py: ``normalized_grid``,
``normalized_slice``, ``sample_fib_sphere`` and ``voxel_boundary_step``)."""

from __future__ import annotations

import numpy as np
import torch


def normalized_grid(height: int, width: int, use_aspect: bool = True,
                    device=None) -> torch.Tensor:
    """[H, W, 2] float32 image-plane coordinates in [-1, 1] (x, then y); with
    ``use_aspect`` x is scaled by W/H."""
    ys = torch.linspace(-1.0, 1.0, height, dtype=torch.float32, device=device)
    xs = torch.linspace(-1.0, 1.0, width, dtype=torch.float32, device=device)
    if use_aspect:
        xs = xs * (width / height)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([grid_x, grid_y], dim=-1)


def normalized_slice(height: int, width: int, dim: int = 0, depth: float = 0.0,
                     device=None) -> torch.Tensor:
    """[H, W, 3] float32 points of the axis-aligned plane at ``depth`` along axis ``dim``
    through [-1, 1]^3 (the SDF cross-sections of the trainer's snapshots)."""
    window = normalized_grid(height, width, use_aspect=False, device=device)
    plane = torch.full((height, width, 1), float(depth), dtype=torch.float32, device=device)
    if dim == 0:
        return torch.cat([plane, window], dim=-1)
    if dim == 1:
        return torch.cat([window[..., 0:1], plane, window[..., 1:2]], dim=-1)
    if dim == 2:
        return torch.cat([window, plane], dim=-1)
    raise ValueError(f"dim must be 0, 1 or 2, got {dim}")


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
