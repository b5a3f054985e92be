"""The colour of each point's nearest surface point on a materialed mesh (counterpart of
wisp_tpu/ops/mesh/closest_tex.py ``sample_tex`` and ``closest_tex``).

``closest_tex`` finds the nearest surface point (K17, ``compute_sdf.closest_point``), takes
its barycentric coordinates on its triangle (clipped to [0, 1]), interpolates the
triangle's UVs (or uses the barycentrics as UVs where the mesh has none) and looks up the
triangle's material with ``sample_tex``: a flat ``diffuse`` colour, or a texture image
([H, W, 3] float32 in [0, 1]) read bilinearly with reflection padding, ``align_corners``
and the UV y-flip of the reference's ``grid_sample``. Material -1 is black. Everything runs
as tensor code on the points' device, where JAX runs host numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from wisp_tpu_torch.ops.mesh.compute_sdf import closest_point, triangle_table
from wisp_tpu_torch.ops.mesh.ops import barycentric_coordinates


def _reflect(v: torch.Tensor, size: int) -> torch.Tensor:
    """Reflection padding of a continuous pixel coordinate (period 2*(size-1))."""
    if size == 1:
        return torch.zeros_like(v)
    period = 2.0 * (size - 1)
    v = torch.remainder(v.abs(), period)
    return torch.where(v > (size - 1), period - v, v)


def sample_tex(tp: torch.Tensor, tm: torch.Tensor, materials: List[dict]) -> torch.Tensor:
    """[N, 3] float32 colours of the UVs ``tp`` [N, 2] in material ``tm`` [N] int64."""
    rgb = torch.zeros((tp.shape[0], 3), dtype=torch.float32, device=tp.device)
    if len(materials) == 0:
        return rgb
    top = int(tm.max()) if tm.numel() else -1
    if top < 0:
        raise ValueError("No materials detected! Check the material definition on your mesh.")
    gx = tp[:, 0] * 2.0 - 1.0
    gy = -(tp[:, 1] * 2.0 - 1.0)
    for i in range(min(top + 1, len(materials))):
        mask = tm == i
        mat = materials[i]
        if "diffuse_texname" not in mat:
            if "diffuse" in mat:
                colour = torch.as_tensor(np.asarray(mat["diffuse"], np.float32)[:3],
                                         device=tp.device)
                rgb[mask] = colour
            continue
        img = torch.as_tensor(np.asarray(mat["diffuse_texname"], np.float32)[..., :3],
                              device=tp.device)
        h, w = img.shape[:2]
        fx = _reflect((gx[mask] + 1.0) * (w - 1) / 2.0, w)
        fy = _reflect((gy[mask] + 1.0) * (h - 1) / 2.0, h)
        x0 = torch.floor(fx).to(torch.int64).clamp(0, w - 1)
        y0 = torch.floor(fy).to(torch.int64).clamp(0, h - 1)
        x1 = (x0 + 1).clamp(max=w - 1)
        y1 = (y0 + 1).clamp(max=h - 1)
        ax = (fx - x0)[:, None]
        ay = (fy - y0)[:, None]
        upper = img[y0, x0] * (1 - ax) + img[y0, x1] * ax
        lower = img[y1, x0] * (1 - ax) + img[y1, x1] * ax
        rgb[mask] = upper * (1 - ay) + lower * ay
    return rgb


def closest_tex(vertices: np.ndarray, faces: np.ndarray, texv: Optional[np.ndarray],
                texf: Optional[np.ndarray], materials: List[dict],
                face_mats: Optional[np.ndarray], points: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rgb [N, 3], nearest surface point [N, 3], unsigned distance [N]) of ``points``
    [N, 3] float32 on the mesh (host arrays), on the points' device."""
    dev = points.device
    v = torch.from_numpy(np.asarray(vertices, np.float32)).to(dev)
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(dev)
    dist, hit_pts, hit_tidx = closest_point(points.contiguous(),
                                            triangle_table(vertices, faces, dev))
    hit_f = f[hit_tidx]
    bc = barycentric_coordinates(hit_pts, v[hit_f[:, 0]], v[hit_f[:, 1]], v[hit_f[:, 2]])
    bc = bc.clamp(0.0, 1.0)
    if face_mats is not None:
        tm = torch.from_numpy(np.asarray(face_mats, np.int64)).to(dev)[hit_tidx]
    else:
        tm = torch.full((points.shape[0],), -1, dtype=torch.int64, device=dev)
    if texv is not None and texf is not None and len(texv) > 0:
        tf = torch.from_numpy(np.asarray(texf, np.int64)).to(dev)[hit_tidx]
        uvs = torch.from_numpy(np.asarray(texv, np.float32)).to(dev)[tf]     # [N, 3, 2]
        tp = (uvs * bc[..., None]).sum(dim=1)
    else:
        tp = bc[:, :2]
    return sample_tex(tp, tm, materials), hit_pts, dist
