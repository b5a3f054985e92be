"""HashGrid — instant-ngp multiresolution hash feature grid (counterpart of
wisp_tpu/models/grids/hash_grid.py). The table is a parameter; its gradient comes from K1
backward on the card. ``occupancy`` [8^level] is the prune keep-score of the blas's cells
(a buffer: it is not trained, the prune rewrites it).

The reference quirks stay: under 'cat' the columns from ``lod_idx*feature_dim`` on are
zeroed, so those LODs are never computed; 'sum' adds all LODs.

``stoch_grad`` selects JAX's stochastic single-corner backward (``ops.grid.stoch_lods``
names the LODs it reaches). ``dense_lod_matmul`` is JAX's TPU matrix-product layout of the
dense LODs; the port always gathers in float32, and the option acts only through JAX's
rule that keeps the exact gradient on dense LODs where it is set.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.grids.blas_grid import BLASGrid
from wisp_tpu_torch.models.grids.utils import MultiTable
from wisp_tpu_torch.ops import grid as grid_ops


class HashGrid(BLASGrid):
    # interpolate takes max_compute_lod (the tracer's spacing-based LOD cap)
    SUPPORTS_COMPUTE_CAP = True

    def __init__(self, blas=None, feature_dim: int = 2,
                 resolutions: Sequence[int] = (16, 32, 64, 128), multiscale_type: str = "sum",
                 feature_std: float = 0.0, feature_bias: float = 0.0,
                 codebook_bitwidth: int = 8, coord_dim: int = 3,
                 dense_lod_matmul: Optional[str] = None, stoch_grad: bool = False,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        if coord_dim not in (2, 3):
            raise ValueError(f"coord_dim must be 2 or 3, got {coord_dim}")
        if multiscale_type not in ("cat", "sum"):
            raise NotImplementedError(multiscale_type)
        if dense_lod_matmul not in (None, "bf16", "f32", "f32_highest"):
            raise ValueError(f"dense_lod_matmul must be None, 'bf16', 'f32' or "
                             f"'f32_highest', got {dense_lod_matmul!r}")
        device = resolve_device(device)
        self.blas = blas
        self.feature_dim = feature_dim
        self.multiscale_type = multiscale_type
        self.codebook_bitwidth = codebook_bitwidth
        self.codebook_size = 2 ** codebook_bitwidth
        self.coord_dim = coord_dim
        # The JAX package interpolates dense LODs with one TPU matrix product when this is
        # set ('bf16' is ~2e-2 off). That is a TPU layout trick: the port always gathers. It
        # still decides which LODs take the stochastic backward (ops.grid.stoch_lods).
        self.dense_lod_matmul = dense_lod_matmul
        self.stoch_grad = bool(stoch_grad)
        self.resolutions = tuple(int(r) for r in resolutions)
        self.num_lods = len(self.resolutions)
        self.active_lods = tuple(range(self.num_lods))
        self.codebook = MultiTable(self.resolutions, coord_dim, feature_dim, std=feature_std,
                                   max_feats=self.codebook_size, mean=feature_bias,
                                   generator=generator, device=device)
        occupancy = None
        if getattr(blas, "max_level", None) is not None:
            occupancy = torch.zeros((8 ** blas.max_level,), dtype=torch.float32,
                                    device=device)
        self.register_buffer("occupancy", occupancy)

    @classmethod
    def from_geometric(cls, blas=None, feature_dim: int = 2, num_lods: int = 16,
                       multiscale_type: str = "sum", feature_std: float = 0.0,
                       feature_bias: float = 0.0, codebook_bitwidth: int = 8,
                       min_grid_res: int = 16, max_grid_res: int = 2048, coord_dim: int = 3,
                       dense_lod_matmul: Optional[str] = None, stoch_grad: bool = False,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = None) -> "HashGrid":
        """Geometric growth of the resolutions (instant-ngp eq. 2-3)."""
        b = np.exp((np.log(max_grid_res) - np.log(min_grid_res)) / (num_lods - 1))
        resolutions = [int(np.floor(min_grid_res * (b ** l))) for l in range(num_lods)]
        return cls(blas=blas, feature_dim=feature_dim, resolutions=resolutions,
                   multiscale_type=multiscale_type, feature_std=feature_std,
                   feature_bias=feature_bias, codebook_bitwidth=codebook_bitwidth,
                   coord_dim=coord_dim, dense_lod_matmul=dense_lod_matmul,
                   stoch_grad=stoch_grad, generator=generator, device=device)

    def interpolate(self, coords: torch.Tensor, lod_idx, max_compute_lod: Optional[int] = None,
                    stoch_rows: Optional[int] = None) -> torch.Tensor:
        """[..., d] -> features; LODs above ``max_compute_lod`` give zeros. ``stoch_rows``:
        the row count of the JAX call (the tracer's budget), for ``stoch_lods``."""
        output_shape = coords.shape[:-1]
        flat = coords.reshape(-1, coords.shape[-1])
        num_compute = self.num_lods
        if self.multiscale_type == "cat":
            # the columns from lod_idx*F on must be zero: hashgrid writes zeros from column
            # num_compute*F on, and num_compute <= lod_idx
            num_compute = min(num_compute, int(lod_idx))
        if max_compute_lod is not None:
            num_compute = min(num_compute, int(max_compute_lod) + 1)
        width = self.num_lods * self.feature_dim
        table = self.codebook.feats
        if num_compute <= 0:
            feats = flat.new_zeros((flat.shape[0], width))
        else:
            feats = grid_ops.hashgrid(flat, self.codebook.resolutions, self.codebook_bitwidth,
                                      num_compute - 1, table, self.codebook.begin_idxes,
                                      self.codebook.num_feats, out_lods=self.num_lods,
                                      stoch_grad=self.stoch_grad,
                                      dense_lod_matmul=self.dense_lod_matmul,
                                      stoch_rows=stoch_rows)
        if self.multiscale_type == "cat":
            return feats.reshape(*output_shape, width)
        return feats.reshape(*output_shape, self.num_lods, self.feature_dim).sum(-2)

    def raymarch(self, rays, raymarch_type, num_samples, level=None, key=None, **kwargs):
        """March over the blas's finest level."""
        return self.blas.raymarch(rays, raymarch_type=raymarch_type, num_samples=num_samples,
                                  level=self.blas.max_level, key=key, **kwargs)
