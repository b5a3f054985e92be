"""Mesh normalization and surface sampling on the host (counterpart of the numpy functions
of wisp_tpu/ops/mesh/ops.py). With the same ``np.random.default_rng`` they draw the same
samples as the JAX package."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def normalize(vertices: np.ndarray, faces: np.ndarray, mode: str = "sphere"
              ) -> Tuple[np.ndarray, np.ndarray]:
    """'sphere': centre the AABB at the origin and scale the farthest vertex to 0.9;
    'aabb': fit the AABB to [-1,1]^3; 'planar': the xz extent to 0.9; 'none': unchanged."""
    v = np.asarray(vertices, dtype=np.float32)
    if mode == "none":
        return v, faces
    v = v - (v.max(0) + v.min(0)) / 2.0
    if mode == "sphere":
        v = v / (np.linalg.norm(v, axis=-1).max() * (1.0 / 0.9))
    elif mode == "aabb":
        v = v / np.abs(v).max()
    elif mode == "planar":
        v = v / (np.abs(v[:, [0, 2]]).max() * (1.0 / 0.9))
    else:
        raise ValueError(f"unknown normalize mode {mode!r}")
    return v.astype(np.float32), faces


def face_areas(vertices, faces) -> np.ndarray:
    v, f = np.asarray(vertices), np.asarray(faces)
    return 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
                                axis=-1)


def area_weighted_distribution(vertices, faces) -> np.ndarray:
    """Face probabilities proportional to area."""
    areas = face_areas(vertices, faces)
    return areas / areas.sum()


def random_face(vertices, faces, num_samples: int, distrib=None, rng=None) -> np.ndarray:
    """Face indices drawn by area."""
    rng = np.random.default_rng() if rng is None else rng
    if distrib is None:
        distrib = area_weighted_distribution(vertices, faces)
    return rng.choice(len(faces), size=num_samples, p=distrib)


def sample_surface(vertices, faces, num_samples: int, rng=None) -> np.ndarray:
    """[N,3] float32 area-weighted surface samples."""
    rng = np.random.default_rng(0) if rng is None else rng
    fidx = random_face(vertices, faces, num_samples, rng=rng)
    v = np.asarray(vertices)
    f = np.asarray(faces)[fidx]
    u = rng.random((num_samples, 2)).astype(np.float32)
    flip = u.sum(-1) > 1.0
    u[flip] = 1.0 - u[flip]
    a, b = u[:, 0:1], u[:, 1:2]
    return (v[f[:, 0]] * (1 - a - b) + v[f[:, 1]] * a + v[f[:, 2]] * b).astype(np.float32)
