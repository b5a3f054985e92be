"""Procedural test meshes (counterpart of wisp_tpu/ops/mesh/io.py ``make_sphere_mesh``).
OBJ loading is not ported yet."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_sphere_mesh(radius: float = 0.7, subdivisions: int = 3
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Icosphere (analytic SDF |x| - radius): vertices [V,3] float32, faces [F,3] int32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdivisions):
        edge_mid: Dict[Tuple[int, int], int] = {}
        verts_list = verts.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(verts_list[a]) + np.asarray(verts_list[b])) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m.tolist())
            return edge_mid[key]

        new_faces = []
        for tri in faces:
            a, b, c = (int(x) for x in tri)
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)
