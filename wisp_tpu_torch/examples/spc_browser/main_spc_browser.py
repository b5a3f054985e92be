"""SPC browser (counterpart of examples/spc_browser/main_spc_browser.py): turn a mesh, or a
procedural sphere, into a coloured SPC and render it with the first-hit ``PackedSPCTracer``.

    python -m wisp_tpu_torch.examples.spc_browser.main_spc_browser [mesh.obj]

renders 256x256 orthographic rays along +z on the card and writes the PNG to
``_results/spc_browser.png`` under the working directory.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.nefs.spc_field import SPCField
from wisp_tpu_torch.models.pipeline import Pipeline
from wisp_tpu_torch.ops.image.io import write_png
from wisp_tpu_torch.ops.mesh.io import load_obj, make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import normalize, sample_surface
from wisp_tpu_torch.ops.spc.conversions import pointcloud_to_octree
from wisp_tpu_torch.tracers.packed_spc_tracer import PackedSPCTracer

DEFAULT_OUT = os.path.join("_results", "spc_browser.png")


def mesh_to_colored_spc(mesh_path: Optional[str] = None, level: int = 6,
                        device: DeviceLike = None):
    """(octree, cell colours [num_leaves, 3] float32): 500,000 surface samples of the mesh
    (or of a subdivision-3 icosphere), normalized to 'sphere', coloured by their position
    ((p + 1) / 2) and averaged per level-``level`` cell."""
    if mesh_path:
        v, f = load_obj(mesh_path)
    else:
        v, f = make_sphere_mesh(radius=1.0, subdivisions=3)
    v, f = normalize(v, f, "sphere")
    samples = sample_surface(v, f, 500000)
    codes_per_level, cell_colors = pointcloud_to_octree(samples, level,
                                                        attributes=(samples + 1.0) / 2.0)
    return OctreeAS.from_codes(codes_per_level, device=device), cell_colors


def main(mesh_path: Optional[str] = None, out_path: str = DEFAULT_OUT, res: int = 256,
         device: DeviceLike = None):
    """Render the coloured SPC of ``mesh_path`` with res x res rays from z = -3 along +z
    over [-1, 1]^2 (depths 0-6), in one trace, and write the rgb to ``out_path``. Returns
    the RenderBuffer."""
    device = resolve_device(device)
    blas, cell_colors = mesh_to_colored_spc(mesh_path, device=device)
    pipeline = Pipeline(nef=SPCField(blas=blas, colors=cell_colors, device=device),
                        tracer=PackedSPCTracer())
    ys, xs = np.mgrid[-1:1:res * 1j, -1:1:res * 1j].astype(np.float32)
    origins = np.stack([xs, ys, np.full_like(xs, -3.0)], -1).reshape(-1, 3)
    dirs = np.broadcast_to(np.asarray([0, 0, 1.0], np.float32), origins.shape)
    rays = Rays(torch.from_numpy(origins).to(device),
                torch.from_numpy(np.ascontiguousarray(dirs)).to(device), 0.0, 6.0)
    with torch.no_grad():
        rb = pipeline(rays=rays)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, rb.rgb.reshape(res, res, 3).cpu().numpy())
    print(f"wrote {out_path}")
    return rb


if __name__ == "__main__":
    main(mesh_path=sys.argv[1] if len(sys.argv) > 1 else None)
