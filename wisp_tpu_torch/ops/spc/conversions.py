"""Point cloud and mesh to octree (counterpart of wisp_tpu/ops/spc/conversions.py). Host
numpy, run when a scene is built: with the same inputs they give the JAX package's tables
and attributes."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from wisp_tpu_torch.ops.spc.core import (build_level_table, dilate_points, morton_to_points,
                                         points_to_morton, quantize_points_np)


def pointcloud_to_octree(pointcloud: np.ndarray, level: int,
                         attributes: Optional[np.ndarray] = None, dilate: int = 0):
    """Points in [-1,1]^3 -> the sorted morton codes of each level 0..``level`` of the
    cells that hold them, dilated (26-neighbourhood) ``dilate`` times. With ``attributes``
    [N, C] also the leaf cells' attributes [num_leaves, C] float32 in morton order: the mean
    over each cell's points, zeros for the cells the dilation added."""
    q = quantize_points_np(np.asarray(pointcloud), level)
    codes = points_to_morton(q)
    if attributes is not None:
        order = np.argsort(codes)
        sorted_codes = codes[order]
        uniq, starts = np.unique(sorted_codes, return_index=True)
        sums = np.add.reduceat(np.asarray(attributes)[order], starts, axis=0)
        counts = np.diff(np.append(starts, len(sorted_codes)))[:, None]
        avg = sums / counts
    for _ in range(dilate):
        q = dilate_points(q, level)
    codes_per_level, _ = build_level_table(q, level)
    if attributes is None:
        return codes_per_level
    leaf = codes_per_level[level]
    attr_out = np.zeros((len(leaf), avg.shape[-1]), dtype=np.float32)
    attr_out[np.searchsorted(leaf, uniq)] = avg
    return codes_per_level, attr_out


def mesh_to_octree(vertices: np.ndarray, faces: np.ndarray, level: int,
                   num_samples: int = 100_000_000) -> List[np.ndarray]:
    """The level tables of the cells of ``num_samples`` area-weighted surface samples of the
    mesh and of the same samples jittered by up to a voxel (``default_rng(0)``)."""
    from wisp_tpu_torch.ops.mesh.ops import sample_surface
    samples = sample_surface(vertices, faces, num_samples)
    rng = np.random.default_rng(0)
    jitter = (rng.random(samples.shape).astype(np.float32) * 2 - 1) / (2 ** level)
    pts = np.clip(np.concatenate([samples, samples + jitter]), -1.0, 1.0 - 1e-6)
    codes_per_level, _ = build_level_table(quantize_points_np(pts, level), level)
    return codes_per_level


def mesh_to_spc(vertices: np.ndarray, faces: np.ndarray, level: int):
    """(level tables, each level's cell coords [N_l, 3] int32) of ``mesh_to_octree``."""
    codes_per_level = mesh_to_octree(vertices, faces, level)
    return codes_per_level, [morton_to_points(c) for c in codes_per_level]


def octree_to_spc(codes_per_level):
    """(every level's cell coords concatenated [sum N_l, 3] int32, the pyramid [2, L+1]:
    each level's cell count and its offset into the points)."""
    points = np.concatenate([morton_to_points(c) for c in codes_per_level])
    counts = [len(c) for c in codes_per_level]
    offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    return points, np.stack([np.asarray(counts), offsets])
