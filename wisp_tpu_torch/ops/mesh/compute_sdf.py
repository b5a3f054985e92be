"""Exact point-to-mesh signed distance (counterpart of wisp_tpu/ops/mesh/compute_sdf.py
``compute_sdf``), kernel K16 (``csrc/mesh_sdf.cu``).

The distance is that of each point to its closest triangle. The sign is the
angle-weighted pseudonormal vote: every triangle whose squared distance lies within the
relative band 1e-8 + 1e-4 * d2min of the minimum votes alpha_t * dot(n_t, p - cp_t), with
alpha_t the face's interior angle where the closest point cp_t is a vertex, pi on an edge
and 2 pi inside; the sign is -1 iff the votes sum below 0.

A mesh enters the kernel as a triangle table [T, 15] float32 (``triangle_table``: the
corners a, b, c, the unit face normal and the interior angles at a, b and c, computed on
the host as JAX computes them). ``mesh_sdf`` launches K16 on a CUDA tensor and runs
``mesh_sdf_plain`` on a CPU tensor; the plain version repeats JAX's two passes over chunks
of points and triangles. The kernel makes one pass: each point keeps its running minimum
and up to ``MESH_SDF_CANDIDATES`` triangles of the band, and a point whose band holds more
takes a second pass (``csrc/mesh_sdf.cu``).

``closest_point`` (K17, counterpart of compute_sdf.py:144 ``closest_point``) is the first
pass with its argument kept: each point's nearest surface point, its distance and the
first triangle of least squared distance (``jnp.argmin``'s rule), from the same table.
"""

from __future__ import annotations

import numpy as np
import torch

from wisp_tpu_torch import kernels
from wisp_tpu_torch.ops.mesh.ops import closest_point_on_triangle, dot3, per_face_normals

TRI_FLOATS = 15
MESH_SDF_CANDIDATES = 8       # K16's candidate list a point (csrc/mesh_sdf.cu kCandidates)


def face_vertex_angles(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[T, 3] float32 interior angle of each face at each of its three vertices."""
    v, f = np.asarray(vertices), np.asarray(faces)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]

    def ang(at, p, q):
        u, w = p - at, q - at
        cosang = np.sum(u * w, -1) / np.maximum(
            np.linalg.norm(u, axis=-1) * np.linalg.norm(w, axis=-1), 1e-12)
        return np.arccos(np.clip(cosang, -1.0, 1.0))

    return np.stack([ang(a, b, c), ang(b, c, a), ang(c, a, b)], axis=-1).astype(np.float32)


def triangle_table(vertices: np.ndarray, faces: np.ndarray,
                   device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """[T, 15] float32 on ``device``: a, b, c, the unit face normal, the angles at a, b, c."""
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    normals = np.asarray(per_face_normals(v, f), dtype=np.float32)
    table = np.concatenate([v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], normals,
                            face_vertex_angles(v, f)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _split(tris: torch.Tensor):
    return tris[:, 0:3], tris[:, 3:6], tris[:, 6:9], tris[:, 9:12], tris[:, 12:15]


def _dist_chunk(p: torch.Tensor, va, vb, vc) -> torch.Tensor:
    """Pass 1: the minimum squared distance of [P,3] points to [T] triangles -> [P]."""
    cp = closest_point_on_triangle(p[:, None], va[None], vb[None], vc[None])
    e = p[:, None] - cp
    return dot3(e, e).amin(dim=-1)


def _sign_chunk(p: torch.Tensor, va, vb, vc, normals, angles, d2min) -> torch.Tensor:
    """Pass 2: the vote of these triangles for each point -> [P]."""
    q = p[:, None]
    cp = closest_point_on_triangle(q, va[None], vb[None], vc[None])     # [P, T, 3]
    diff = q - cp
    d2 = dot3(diff, diff)
    near = d2 <= (d2min + (1e-8 + 1e-4 * d2min))[:, None]
    v0, v1, v2 = (vb - va)[None], (vc - va)[None], cp - va[None]
    d00, d01, d11 = dot3(v0, v0), dot3(v0, v1), dot3(v1, v1)
    d20, d21 = dot3(v2, v0), dot3(v2, v1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    bv = (d11 * d20 - d01 * d21) / denom
    bw = (d00 * d21 - d01 * d20) / denom
    bu = 1.0 - bv - bw
    eb = 1e-4
    at_a = (bv < eb) & (bw < eb)
    at_b = (bu < eb) & (bw < eb)
    at_c = (bu < eb) & (bv < eb)
    on_vertex = at_a | at_b | at_c
    on_edge = ~on_vertex & ((bu < eb) | (bv < eb) | (bw < eb))
    vertex_angle = torch.where(at_a, angles[None, :, 0],
                               torch.where(at_b, angles[None, :, 1], angles[None, :, 2]))
    pi = torch.full_like(vertex_angle, np.pi)
    alpha = torch.where(on_vertex, vertex_angle, torch.where(on_edge, pi, 2.0 * pi))
    vote = dot3(diff, normals[None])
    return torch.where(near, alpha * vote, torch.zeros_like(vote)).sum(dim=-1)


def mesh_sdf_plain(points: torch.Tensor, tris: torch.Tensor, point_chunk: int = 16384,
                   tri_chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of ``mesh_sdf``: JAX's ``_compute_sdf_host`` (chunks of
    ``point_chunk`` points; the minimum over chunks of ``tri_chunk`` triangles, then their
    votes summed chunk by chunk)."""
    va, vb, vc, normals, angles = _split(tris)
    num_tris = tris.shape[0]
    out = torch.empty((points.shape[0],), dtype=torch.float32, device=points.device)
    for i in range(0, points.shape[0], point_chunk):
        p = points[i:i + point_chunk]
        d2min = None
        for j in range(0, num_tris, tri_chunk):
            sl = slice(j, j + tri_chunk)
            d2j = _dist_chunk(p, va[sl], vb[sl], vc[sl])
            d2min = d2j if d2min is None else torch.minimum(d2min, d2j)
        s = None
        for j in range(0, num_tris, tri_chunk):
            sl = slice(j, j + tri_chunk)
            sj = _sign_chunk(p, va[sl], vb[sl], vc[sl], normals[sl], angles[sl], d2min)
            s = sj if s is None else s + sj
        d = torch.sqrt(d2min)
        out[i:i + point_chunk] = torch.where(s < 0.0, -d, d)
    return out


def mesh_sdf(points: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Signed distance [P] float32 of ``points`` [P,3] float32 to the mesh of the triangle
    table ``tris`` [T, 15] (K16)."""
    if not points.is_cuda:
        return mesh_sdf_plain(points, tris)
    n = points.shape[0]
    kernels.check(points, "points", torch.float32, (n, 3))
    kernels.check(tris, "tris", torch.float32, (None, TRI_FLOATS))
    if tris.shape[0] < 1 or tris.shape[0] >= 2 ** 31:
        raise ValueError(f"mesh_sdf: {tris.shape[0]} triangles")
    out = torch.empty((n,), dtype=torch.float32, device=points.device)
    if n:
        kernels.launch("wisp_mesh_sdf", "mesh_sdf", points.data_ptr(), n, tris.data_ptr(),
                       tris.shape[0], out.data_ptr())
    return out


def compute_sdf(vertices: np.ndarray, faces: np.ndarray, points: torch.Tensor) -> torch.Tensor:
    """Signed distance [N] float32 of ``points`` [N,3] to the mesh (host vertices [V,3] and
    faces [T,3]), on the points' device."""
    return mesh_sdf(points.contiguous(), triangle_table(vertices, faces, points.device))


def compute_sdf_plain(vertices: np.ndarray, faces: np.ndarray, points: torch.Tensor,
                      point_chunk: int = 16384, tri_chunk: int = 8192) -> torch.Tensor:
    """``compute_sdf`` through the plain version, on any device."""
    return mesh_sdf_plain(points, triangle_table(vertices, faces, points.device),
                          point_chunk, tri_chunk)


def closest_point_plain(points: torch.Tensor, tris: torch.Tensor, point_chunk: int = 8192):
    """Plain PyTorch version of ``closest_point``: [P, T] candidates a chunk of points,
    ``argmin`` (its first minimum) over the triangles."""
    va, vb, vc = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    n = points.shape[0]
    dist = torch.empty((n,), dtype=torch.float32, device=points.device)
    nearest = torch.empty((n, 3), dtype=torch.float32, device=points.device)
    tidx = torch.empty((n,), dtype=torch.int64, device=points.device)
    for i in range(0, n, point_chunk):
        p = points[i:i + point_chunk]
        cp = closest_point_on_triangle(p[:, None], va[None], vb[None], vc[None])
        e = p[:, None] - cp
        d2 = dot3(e, e)
        tmin = torch.argmin(d2, dim=-1)
        rows = torch.arange(p.shape[0], device=points.device)
        nearest[i:i + point_chunk] = cp[rows, tmin]
        dist[i:i + point_chunk] = torch.sqrt(d2[rows, tmin])
        tidx[i:i + point_chunk] = tmin
    return dist, nearest, tidx


def closest_point(points: torch.Tensor, tris: torch.Tensor):
    """(distance [P] float32, nearest surface point [P, 3] float32, triangle [P] int64) of
    ``points`` [P, 3] float32 on the mesh of the triangle table ``tris`` [T, 15] (K17)."""
    if not points.is_cuda:
        return closest_point_plain(points, tris)
    n = points.shape[0]
    kernels.check(points, "points", torch.float32, (n, 3))
    kernels.check(tris, "tris", torch.float32, (None, TRI_FLOATS))
    if tris.shape[0] < 1 or tris.shape[0] >= 2 ** 31:
        raise ValueError(f"closest_point: {tris.shape[0]} triangles")
    dev = points.device
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    nearest = torch.empty((n, 3), dtype=torch.float32, device=dev)
    tidx = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        kernels.launch("wisp_closest_point", "closest_point", points.data_ptr(), n,
                       tris.data_ptr(), tris.shape[0], dist.data_ptr(), nearest.data_ptr(),
                       tidx.data_ptr())
    return dist, nearest, tidx
