"""Mesh normalization, sampling and geometry (counterpart of wisp_tpu/ops/mesh/ops.py).

The sampling runs on the host in numpy: with the same ``np.random.default_rng`` it draws the
same samples as the JAX package. ``closest_point_on_triangle`` is PyTorch, in the JAX
version's branch-free form and float order; it is the arithmetic of the mesh distance and
closest-point kernels' plain versions (``ops/mesh/compute_sdf.py``).
``barycentric_coordinates`` is PyTorch too (the texture lookup's, ``closest_tex.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


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


def sample_surface(vertices, faces, num_samples: int, rng=None,
                   return_normals: bool = False):
    """[N,3] float32 area-weighted surface samples; with ``return_normals`` also the
    sampled faces' unit normals [N,3] float32."""
    rng = np.random.default_rng(0) if rng is None else rng
    fidx = random_face(vertices, faces, num_samples, rng=rng)
    v = np.asarray(vertices)
    f = np.asarray(faces)[fidx]
    u = rng.random((num_samples, 2)).astype(np.float32)
    flip = u.sum(-1) > 1.0
    u[flip] = 1.0 - u[flip]
    a, b = u[:, 0:1], u[:, 1:2]
    pts = (v[f[:, 0]] * (1 - a - b) + v[f[:, 1]] * a + v[f[:, 2]] * b).astype(np.float32)
    if return_normals:
        return pts, np.asarray(per_face_normals(vertices, faces), np.float32)[fidx]
    return pts


def per_face_normals(vertices, faces) -> np.ndarray:
    """[F,3] unit face normals (right-handed in the vertex order)."""
    v, f = np.asarray(vertices), np.asarray(faces)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)


def sample_near_surface(vertices, faces, num_samples: int, variance: float = 0.01,
                        rng=None) -> np.ndarray:
    """Surface samples moved by a gaussian offset of std ``variance``."""
    rng = np.random.default_rng(0) if rng is None else rng
    pts = sample_surface(vertices, faces, num_samples, rng=rng)
    return pts + rng.normal(0.0, variance, pts.shape).astype(np.float32)


def sample_uniform(num_samples: int, rng=None) -> np.ndarray:
    """[N,3] float32 uniform samples in [-1,1]^3."""
    rng = np.random.default_rng(0) if rng is None else rng
    return rng.random((num_samples, 3)).astype(np.float32) * 2.0 - 1.0


def point_sample(vertices, faces, modes: List[str], num_samples: int, rng=None) -> np.ndarray:
    """``num_samples`` points for each entry of ``modes``, in order: 'rand' (uniform in the
    box), 'near' (near the surface) or 'trace' (on the surface)."""
    rng = np.random.default_rng(0) if rng is None else rng
    out = []
    for mode in modes:
        if mode == "rand":
            out.append(sample_uniform(num_samples, rng=rng))
        elif mode == "near":
            out.append(sample_near_surface(vertices, faces, num_samples, rng=rng))
        elif mode == "trace":
            out.append(sample_surface(vertices, faces, num_samples, rng=rng))
        else:
            raise ValueError(f"unknown sample mode {mode!r}")
    return np.concatenate(out).astype(np.float32)


def barycentric_coordinates(points: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor) -> torch.Tensor:
    """[..., 3] barycentric coordinates (u, v, w) of ``points`` on triangles abc, all
    [..., 3]; the denominator is clamped at 1e-12 (JAX ops.py:126)."""
    v0, v1, v2 = b - a, c - a, points - a
    d00, d01, d11 = dot3(v0, v0), dot3(v0, v1), dot3(v1, v1)
    d20, d21 = dot3(v2, v0), dot3(v2, v1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-12)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return torch.stack([1.0 - v - w, v, w], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, added left to right (the kernels' order)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _edge_proj(p, e0, e1):
    d = e1 - e0
    t = dot3(p - e0, d) / torch.clamp(dot3(d, d), min=1e-20)
    return e0 + torch.clamp(t, 0.0, 1.0)[..., None] * d


def closest_point_on_triangle(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor) -> torch.Tensor:
    """Closest point on triangle(s) abc to point(s) p, all broadcastable [..., 3]: the
    in-plane projection where its barycentrics are all non-negative, else the nearest of
    the three clamped edge projections (which cover the vertices). Every candidate is valid
    on its own, so the masked minimum is exact; ties keep the earlier edge (ab, bc, ca)."""
    cand_ab = _edge_proj(p, a, b)
    cand_bc = _edge_proj(p, b, c)
    cand_ca = _edge_proj(p, c, a)
    ab, ac = b - a, c - a
    n = cross3(ab, ac)
    nn = torch.clamp(dot3(n, n), min=1e-20)
    dist_plane = dot3(p - a, n) / nn
    proj = p - dist_plane[..., None] * n
    v2 = proj - a
    d00, d01, d11 = dot3(ab, ab), dot3(ab, ac), dot3(ac, ac)
    d20, d21 = dot3(v2, ab), dot3(v2, ac)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    inside = (v >= 0.0) & (w >= 0.0) & (v + w <= 1.0)

    def d2(q):
        e = p - q
        return dot3(e, e)

    best = cand_ab
    best = torch.where((d2(cand_bc) < d2(best))[..., None], cand_bc, best)
    best = torch.where((d2(cand_ca) < d2(best))[..., None], cand_ca, best)
    return torch.where(inside[..., None], proj, best)
