"""SPCField — renders the raw attributes of an octree's cells (counterpart of
wisp_tpu/models/nefs/spc_field.py): no decoder, the colour of a hit cell is its stored
colour, looked up by the cell index the tracer found (``PackedSPCTracer``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.nefs.base_nef import BaseNeuralField


class SPCField(BaseNeuralField):
    def __init__(self, blas=None, colors: Optional[np.ndarray] = None,
                 normals: Optional[np.ndarray] = None, device: DeviceLike = None):
        """``blas``: the OctreeAS whose leaf cells carry the attributes; ``colors``
        [num_leaves, 3 or 4], in morton order (``pointcloud_to_octree``'s averages; only
        the first three channels are kept); ``normals`` [num_leaves, 3], optional."""
        super().__init__()
        device = resolve_device(device)
        self.grid = _SPCGridShim(blas)
        self.colors = None if colors is None else \
            torch.as_tensor(np.asarray(colors)[..., :3]).to(device)
        self.normals = None if normals is None else torch.as_tensor(np.asarray(normals)).to(device)

    def register_forward_functions(self):
        self._register_forward_function(self.rgba, ["rgb", "alpha"])

    def rgba(self, pidx: Optional[torch.Tensor] = None, coords: Optional[torch.Tensor] = None):
        """rgb [N, 3] and alpha [N, 1] of the cells ``pidx`` [N] (-1 = none): the cell's
        colour (white without colours) times alpha, alpha 1 where there is a cell. Without
        ``pidx`` every point of ``coords`` reads cell 0."""
        if pidx is None:
            n = coords.shape[0] if coords is not None else 0
            device = coords.device if coords is not None else None
            pidx = torch.zeros((n,), dtype=torch.int32, device=device)
        if self.colors is not None:
            rgb = self.colors[pidx.clamp(min=0).long()]
        else:
            rgb = torch.ones((pidx.shape[0], 3), dtype=torch.float32, device=pidx.device)
        alpha = (pidx >= 0).to(torch.float32)[:, None]
        return {"rgb": rgb * alpha, "alpha": alpha}


class _SPCGridShim:
    """The little of a grid that the tracer and a user of the field read: the octree, one
    LOD, and the octree's ray ops."""

    def __init__(self, blas):
        self.blas = blas
        self.num_lods = 1
        self.active_lods = (blas.max_level,) if blas is not None else (0,)

    def raytrace(self, rays, level=None, with_exit=False):
        return self.blas.raytrace(rays, level=level)

    def raymarch(self, rays, **kw):
        return self.blas.raymarch(rays, **kw)
