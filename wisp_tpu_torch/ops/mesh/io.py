"""Mesh I/O and procedural test meshes (counterpart of wisp_tpu/ops/mesh/io.py): the OBJ
parser ``load_obj`` (v / vt / f, fan-triangulated n-gons, per-face materials from
``mtllib`` / ``usemtl``), its .mtl reader, the writers ``write_obj`` and ``write_mtl``, and
``make_sphere_mesh`` and ``make_box_mesh``.

Materials are dicts as in JAX: ``{'diffuse': float32[3]}`` from a flat ``Kd``. A ``map_Kd``
image texture is refused with ``NotImplementedError``: JAX reads it with PIL, which the
card's machine does not have (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


def _load_mtl(path: str) -> Dict[str, dict]:
    """A .mtl file -> {name: material dict} (``Kd``; a ``map_Kd`` raises)."""
    mats: Dict[str, dict] = {}
    cur = None
    if not os.path.exists(path):
        log.warning("mtllib %s not found; materials will be empty", path)
        return mats
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {}
            elif parts[0] == "Kd" and cur is not None:
                mats[cur]["diffuse"] = np.asarray([float(x) for x in parts[1:4]], np.float32)
            elif parts[0] == "map_Kd" and cur is not None:
                raise NotImplementedError(
                    f"{path}: material {cur!r} has an image texture (map_Kd {parts[-1]}); "
                    f"image textures are not ported yet (ROADMAP Queue 1, item 7), flat Kd "
                    f"colours are")
    return mats


def load_obj(path: str, load_materials: bool = False):
    """An OBJ file -> (vertices [V,3] float32, faces [F,3] int32) or, with
    ``load_materials``, (v, f, texv [TV,2] or None, texf [F,3] or None, face_mats [F]
    int32, materials list of dicts): JAX's parser, line for line."""
    vertices, faces = [], []
    texcoords, texfaces = [], []
    mat_defs: Dict[str, dict] = {}
    face_mats = []
    cur_mat = -1
    mat_names = []
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif tag == "mtllib" and load_materials:
                mtl_path = parts[1]
                if not os.path.isabs(mtl_path):
                    mtl_path = os.path.join(os.path.dirname(path), mtl_path)
                mat_defs.update(_load_mtl(mtl_path))
            elif tag == "usemtl" and load_materials:
                if parts[1] not in mat_names:
                    mat_names.append(parts[1])
                cur_mat = mat_names.index(parts[1])
            elif tag == "f":
                idx, tidx = [], []
                for corner in parts[1:]:
                    comps = corner.split("/")
                    idx.append(int(comps[0]) - 1 if int(comps[0]) > 0
                               else len(vertices) + int(comps[0]))
                    if len(comps) > 1 and comps[1]:
                        tidx.append(int(comps[1]) - 1)
                for i in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[i], idx[i + 1]])
                    face_mats.append(cur_mat)
                    if tidx:
                        texfaces.append([tidx[0], tidx[i], tidx[i + 1]])
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    if load_materials:
        tv = np.asarray(texcoords, dtype=np.float32) if texcoords else None
        tf = np.asarray(texfaces, dtype=np.int32) if texfaces else None
        materials = [mat_defs.get(n, {}) for n in mat_names]
        return v, f, tv, tf, np.asarray(face_mats, dtype=np.int32), materials
    return v, f


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
              texv: Optional[np.ndarray] = None, texf: Optional[np.ndarray] = None,
              mtl_name: Optional[str] = None) -> None:
    """A triangle mesh as OBJ; with ``texv``/``texf`` the faces carry UV indices (f v/vt),
    and ``mtl_name`` adds ``mtllib <stem>.mtl`` and ``usemtl`` (write that file with
    ``write_mtl``)."""
    with open(path, "w") as fh:
        if mtl_name is not None:
            fh.write(f"mtllib {os.path.splitext(os.path.basename(path))[0]}.mtl\n")
        for v in vertices:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if texv is not None:
            for t in texv:
                fh.write(f"vt {t[0]} {t[1]}\n")
        if mtl_name is not None:
            fh.write(f"usemtl {mtl_name}\n")
        for i, f in enumerate(faces):
            if texv is not None and texf is not None:
                t = texf[i]
                fh.write(f"f {f[0] + 1}/{t[0] + 1} {f[1] + 1}/{t[1] + 1} "
                         f"{f[2] + 1}/{t[2] + 1}\n")
            else:
                fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def write_mtl(path: str, mtl_name: str, diffuse=None, texture_path: Optional[str] = None
              ) -> None:
    """The .mtl of ``write_obj``'s ``mtl_name``: ``Kd`` and/or ``map_Kd``."""
    with open(path, "w") as fh:
        fh.write(f"newmtl {mtl_name}\n")
        if diffuse is not None:
            fh.write(f"Kd {diffuse[0]} {diffuse[1]} {diffuse[2]}\n")
        if texture_path is not None:
            fh.write(f"map_Kd {texture_path}\n")


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


def make_box_mesh(half_extents=(0.5, 0.5, 0.5)) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box centred at the origin, 12 outward-facing triangles."""
    hx, hy, hz = half_extents
    v = np.asarray([
        [-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz], [-hx, hy, -hz],
        [-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz],
    ], dtype=np.float32)
    f = np.asarray([
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
    ], dtype=np.int32)
    return v, f
