"""TriplanarGrid — a pyramid of triplanes (counterpart of
wisp_tpu/models/grids/triplanar_grid.py).

Each LOD l (``log_base_resolution`` + 0..num_lods-1) holds three learned planes
[2^l + 1, 2^l + 1, feature_dim] (``TriplanarFeatureVolume``: fmx sampled at (y, z), fmy at
(x, z), fmz at (x, y)); a point's features are the three planes' bilinear samples side by
side (the grid's ``feature_dim`` is three times the planes'), summed over LODs 0..lod_idx
('sum') or concatenated and zero-padded to ``num_lods`` ('cat'). Both go through K18
(``ops/triplane.py triplane_sample``), JAX's mirrored coordinate fold included.

The grid marches at its blas's finest level: an ``AxisAlignedBBoxAS`` (the box) by
default, or the octree the app hands it. ``freeze`` stops the planes' gradients, as JAX's
stop_gradient does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from wisp_tpu_torch.accelstructs.aabb_as import AxisAlignedBBoxAS
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.grids.blas_grid import BLASGrid
from wisp_tpu_torch.ops.triplane import triplane_sample


class TriplanarFeatureVolume(nn.Module):
    """One LOD's three planes [fsize + 1, fsize + 1, fdim]: feature_bias + feature_std *
    N(0, 1), drawn fmx, fmy, fmz in turn from ``generator``."""

    def __init__(self, fdim: int, fsize: int, std: float, bias: float,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        self.fsize = fsize
        self.fdim = fdim
        shape = (fsize + 1, fsize + 1, fdim)
        device = resolve_device(device)
        self.fmx, self.fmy, self.fmz = (
            nn.Parameter((bias + std * torch.randn(shape, generator=generator)).to(device))
            for _ in range(3))

    def planes(self):
        return self.fmx, self.fmy, self.fmz

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, 3 * fdim]: the three planes' samples side by side."""
        return triplane_sample(coords, [self.planes()])


class TriplanarGrid(BLASGrid):
    def __init__(self, blas=None, feature_dim: int = 4, log_base_resolution: int = 4,
                 num_lods: int = 1, interpolation_type: str = "linear",
                 multiscale_type: str = "sum", feature_std: float = 0.0,
                 feature_bias: float = 0.0, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if multiscale_type not in ("sum", "cat"):
            raise NotImplementedError(multiscale_type)
        device = resolve_device(device)
        self.blas = blas if blas is not None else AxisAlignedBBoxAS(device=device)
        self.feature_dim = feature_dim * 3  # three planes a LOD
        self.num_lods = num_lods
        self.log_base_resolution = log_base_resolution
        self.interpolation_type = interpolation_type
        self.multiscale_type = multiscale_type
        self.feature_std = feature_std
        self.feature_bias = feature_bias
        self.active_lods = tuple(log_base_resolution + x for x in range(num_lods))
        self.frozen = False
        self.occupancy = None  # triplanar grids do not prune
        self.features = nn.ModuleList([
            TriplanarFeatureVolume(feature_dim, 2 ** lod, feature_std, feature_bias,
                                   generator=generator, device=device)
            for lod in self.active_lods])
        self.num_feat = sum(((2 ** lod + 1) ** 2) * self.feature_dim
                            for lod in self.active_lods)

    def freeze(self) -> "TriplanarGrid":
        """Stop the planes' gradients (``interpolate`` detaches them)."""
        self.frozen = True
        return self

    def interpolate(self, coords: torch.Tensor, lod_idx: int) -> torch.Tensor:
        """Features of LODs 0..lod_idx at coords [..., 3]: [..., 3F] ('sum') or
        [..., 3F * num_lods] ('cat', zeros above lod_idx)."""
        output_shape = coords.shape[:-1]
        flat = coords.reshape(-1, 3).contiguous()
        planes = [v.planes() for v in list(self.features)[:lod_idx + 1]]
        if self.frozen:
            planes = [tuple(p.detach() for p in lod) for lod in planes]
        feats = triplane_sample(flat, planes, self.multiscale_type, out_lods=self.num_lods)
        return feats.reshape(*output_shape, feats.shape[-1])

    def raymarch(self, rays, raymarch_type, num_samples, level=None, key=None, **kwargs):
        """March over the blas's finest level."""
        return self.blas.raymarch(rays, raymarch_type=raymarch_type, num_samples=num_samples,
                                  level=self.blas.max_level, key=key, **kwargs)
