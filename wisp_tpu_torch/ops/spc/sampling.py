"""Samples inside the cells of an octree level (counterpart of wisp_tpu/ops/spc/sampling.py
``sample_spc``). Host numpy: with the same ``np.random.default_rng`` it draws the same
points as the JAX package."""

from __future__ import annotations

import numpy as np


def sample_spc(points: np.ndarray, level: int, num_samples_per_voxel: int,
               rng=None) -> np.ndarray:
    """Voxel coords [N,3] at ``level`` -> [N * num_samples_per_voxel, 3] float32 points,
    uniform inside each voxel, in [-1,1]^3."""
    rng = np.random.default_rng() if rng is None else rng
    res = 2 ** level
    base = np.repeat(np.asarray(points, dtype=np.float32), num_samples_per_voxel, axis=0)
    jitter = rng.random((base.shape[0], 3), dtype=np.float32)
    return (base + jitter) * (2.0 / res) - 1.0
