"""BLASGrid — a feature grid backed by an acceleration structure (counterpart of
wisp_tpu/models/grids/blas_grid.py): ray ops go to the blas, feature lookup is the grid's."""

from __future__ import annotations

from torch import nn


class BLASGrid(nn.Module):
    blas = None  # set by subclasses

    def raymarch(self, rays, *args, **kwargs):
        return self.blas.raymarch(rays, *args, **kwargs)

    def raytrace(self, rays, *args, **kwargs):
        return self.blas.raytrace(rays, *args, **kwargs)

    def interpolate(self, coords, lod_idx):
        raise NotImplementedError
