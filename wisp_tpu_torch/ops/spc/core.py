"""Morton codes and the sparse octree's host builders (counterpart of
wisp_tpu/ops/spc/core.py).

The octree is a level table: per level, the sorted morton codes of the occupied cells.
Construction runs on the host in numpy (at build time only); ``quantize_points`` and
``morton3d`` are the device versions. The JAX package's optional C++ builder
(``wisp_tpu/csrc``) is not ported: ``build_level_table`` takes the numpy route.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

MAX_OCTREE_LEVEL = 10  # 3*10 = 30 morton bits


def quantize_points(x: torch.Tensor, level: int) -> torch.Tensor:
    """[-1,1]^3 floats -> int64 grid coords at ``level`` (res = 2^level), clipped
    (``quantize_points_jnp``)."""
    res = 2 ** level
    q = torch.floor((x + 1.0) * (res / 2.0)).to(torch.int64)
    return q.clamp(0, res - 1)


def quantize_points_np(x: np.ndarray, level: int) -> np.ndarray:
    """Host version (JAX ``quantize_points``): int32 grid coords at ``level``, clipped."""
    res = 2 ** level
    q = np.floor((np.asarray(x) + 1.0) * (res / 2.0)).astype(np.int32)
    return np.clip(q, 0, res - 1)


def _part1by2_np(v: np.ndarray) -> np.ndarray:
    """Spread the bits of v (uint64) to every third position."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _compact1by2_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v ^ (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v ^ (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v ^ (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v ^ (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v ^ (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def points_to_morton(points: np.ndarray) -> np.ndarray:
    """Integer grid coords [N,3] -> morton codes [N] (uint64, host)."""
    p = np.asarray(points).astype(np.uint64)
    return (_part1by2_np(p[:, 0]) | (_part1by2_np(p[:, 1]) << np.uint64(1))
            | (_part1by2_np(p[:, 2]) << np.uint64(2)))


def morton_to_points(codes: np.ndarray) -> np.ndarray:
    """Morton codes [N] -> integer grid coords [N,3] (int32, host)."""
    c = np.asarray(codes).astype(np.uint64)
    return np.stack([_compact1by2_np(c), _compact1by2_np(c >> np.uint64(1)),
                     _compact1by2_np(c >> np.uint64(2))], axis=-1).astype(np.int32)


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton3d(points: torch.Tensor) -> torch.Tensor:
    """Device: integer coords [..., 3] -> int64 morton codes (levels <= 10; JAX gives the
    same values as uint32)."""
    p = points.to(torch.int64)
    return _part1by2(p[..., 0]) | (_part1by2(p[..., 1]) << 1) | (_part1by2(p[..., 2]) << 2)


def build_level_table(quantized_points: np.ndarray, level: int
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """From occupied leaf cells at ``level``, all levels 0..level: (sorted morton codes,
    their grid coords) per level."""
    codes = np.unique(points_to_morton(quantized_points))
    codes_per_level = [None] * (level + 1)
    codes_per_level[level] = codes
    for l in range(level - 1, -1, -1):
        codes = np.unique(codes >> np.uint64(3))
        codes_per_level[l] = codes
    return codes_per_level, [morton_to_points(c) for c in codes_per_level]


# corner order of a cell: z fastest (ops/grid.py corner_offsets)
CORNER_OFFSETS = np.asarray([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                             [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int32)


def points_to_corners(points: np.ndarray) -> np.ndarray:
    """Cell coords [N,3] -> the 8 corner coords [N,8,3] (host)."""
    points = np.asarray(points)
    return points[..., None, :] + CORNER_OFFSETS.astype(points.dtype)


def dilate_points(quantized_points: np.ndarray, level: int) -> np.ndarray:
    """26-neighbourhood dilation of occupied cells, clipped to the grid, in morton order."""
    offsets = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij"),
                       axis=-1).reshape(-1, 3)
    pts = (quantized_points[:, None, :] + offsets[None]).reshape(-1, 3)
    pts = np.clip(pts, 0, 2 ** level - 1)
    return morton_to_points(np.unique(points_to_morton(pts)))


def make_dual(points_per_level: List[np.ndarray]
              ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The dual octree (the unique cell-corner vertices per level, [V_l,3] int32) and the
    trinkets (each cell's 8 dual-vertex indices, [N_l,8] int32)."""
    dual_points, trinkets = [], []
    for l, pts in enumerate(points_per_level):
        res_plus = 2 ** l + 1
        corners = points_to_corners(np.asarray(pts)).reshape(-1, 3).astype(np.int64)
        keys = (corners[:, 0] * res_plus + corners[:, 1]) * res_plus + corners[:, 2]
        uniq, inverse = np.unique(keys, return_inverse=True)
        dual_points.append(np.stack([uniq // (res_plus * res_plus), (uniq // res_plus)
                                     % res_plus, uniq % res_plus], axis=-1).astype(np.int32))
        trinkets.append(inverse.reshape(-1, 8).astype(np.int32))
    return dual_points, trinkets
