"""OctreeGrid — NGLOD features on the dual vertices of a sparse octree (counterpart of
wisp_tpu/models/grids/octree_grid.py).

Features live on the dual octree's vertices (cell corners) of each active LOD
(base_lod = max_level - num_lods + 1 .. max_level), one ``nn.Parameter`` [V_l, F] per LOD;
the trinkets [N_l, 8] give each cell's 8 corner rows. ``interpolate`` queries the cells of
every LOD in one ancestor-chain query (K9), then blends each LOD's 8 corner features
trilinearly and sums or concatenates the LODs; a point in an empty cell gets zeros.

``octree_interp`` is kernel K15 (``csrc/octree_grid.cu``): on a CUDA tensor it launches the
kernel, on a CPU tensor it runs ``octree_interp_plain``. The kernel has no backward yet (the
SDF training slice adds it): on the card, a call that would need the features' gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from wisp_tpu_torch import kernels
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.grids.blas_grid import BLASGrid
from wisp_tpu_torch.ops.grid import grid_interpolate
from wisp_tpu_torch.ops.spc.core import make_dual, quantize_points

MAX_LODS = 16  # LOD slots in the kernel's argument block


def octree_interp_plain(coords: torch.Tensor, pidx: torch.Tensor, col0: int,
                        trinkets: Sequence[torch.Tensor], features: Sequence[torch.Tensor],
                        levels: Sequence[int], multiscale_type: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of ``octree_interp`` (octree_grid.py:96-137)."""
    outs = []
    for i, (trk, feats, level) in enumerate(zip(trinkets, features, levels)):
        p = pidx[:, col0 + i]
        res = 2 ** level
        corner_feats = feats[trk[p.clamp(min=0)]]                              # [N, 8, F]
        cell = quantize_points(coords, level).to(coords.dtype)
        frac = torch.clamp((coords + 1.0) * (res / 2.0) - cell, 0.0, 1.0)
        fs = grid_interpolate(frac, corner_feats)
        outs.append(torch.where((p >= 0)[:, None], fs, torch.zeros_like(fs)))
    return _combine_lods(outs, multiscale_type)


def _combine_lods(outs: Sequence[torch.Tensor], multiscale_type: str) -> torch.Tensor:
    """[N, F] per LOD -> their sum in LOD order ('sum') or [N, F * LODs] ('cat')."""
    if multiscale_type == "sum":
        return torch.stack(outs, dim=1).sum(dim=1)
    return torch.cat(outs, dim=-1)


def octree_interp(coords: torch.Tensor, pidx: torch.Tensor, col0: int,
                  trinkets: Sequence[torch.Tensor], features: Sequence[torch.Tensor],
                  levels: Sequence[int], multiscale_type: str = "sum") -> torch.Tensor:
    """Multi-LOD trilinear interpolation of dual-vertex features (K15).

    ``coords`` [N, 3] float32; ``pidx`` [N, P] int32 cell indices, LOD i reading column
    ``col0 + i`` (-1 = empty cell: zero features); per LOD ``trinkets[i]`` [N_i, 8] int32,
    ``features[i]`` [V_i, F] float32 and its octree level. Corner c of a cell sits at offset
    (c>>2, (c>>1)&1, c&1), z fastest; the fraction inside the cell is
    clip((c+1)*(res/2) - cell, 0, 1). Returns [N, F] ('sum', LODs added in order) or
    [N, F * LODs] ('cat')."""
    if not coords.is_cuda:
        return octree_interp_plain(coords, pidx, col0, trinkets, features, levels,
                                   multiscale_type)
    n_lods = len(levels)
    if multiscale_type not in ("sum", "cat") or not 1 <= n_lods <= MAX_LODS:
        raise ValueError(f"octree_interp: {multiscale_type!r} over {n_lods} LODs")
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        raise NotImplementedError("octree_interp: the feature gradient (K15 backward) is "
                                  "not ported yet; call under torch.no_grad()")
    n = coords.shape[0]
    f_dim = features[0].shape[1]
    kernels.check(coords, "coords", torch.float32, (n, 3))
    kernels.check(pidx, "pidx", torch.int32, (n, None))
    if not 0 <= col0 <= pidx.shape[1] - n_lods:
        raise ValueError(f"octree_interp: columns {col0}..{col0 + n_lods - 1} of pidx "
                         f"[{n}, {pidx.shape[1]}]")
    for i in range(n_lods):
        kernels.check(trinkets[i], f"trinkets[{i}]", torch.int32, (None, 8))
        kernels.check(features[i], f"features[{i}]", torch.float32, (None, f_dim))
    out = torch.empty((n, f_dim if multiscale_type == "sum" else f_dim * n_lods),
                      dtype=torch.float32, device=coords.device)
    if n:
        trk, fts = kernels.pointers(trinkets), kernels.pointers(features)
        lvl = np.asarray(levels, dtype=np.int32)
        kernels.launch("wisp_octree_interp", "octree_interp", coords.data_ptr(),
                       pidx.data_ptr(), n, pidx.shape[1], int(col0), n_lods, f_dim,
                       ctypes.addressof(trk), ctypes.addressof(fts), lvl.ctypes.data,
                       int(multiscale_type == "sum"), out.data_ptr())
    return out


class OctreeGrid(BLASGrid):
    def __init__(self, blas=None, feature_dim: int = 16, num_lods: int = 1,
                 interpolation_type: str = "linear", multiscale_type: str = "cat",
                 feature_std: float = 0.0, feature_bias: float = 0.0,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        if blas is None or blas.codes is None:
            raise ValueError("OctreeGrid requires a sparse OctreeAS (with level tables)")
        if interpolation_type not in ("linear", "closest"):
            raise NotImplementedError(interpolation_type)
        if multiscale_type not in ("sum", "cat"):
            raise NotImplementedError(multiscale_type)
        self.device = resolve_device(device)
        self.blas = blas
        self.feature_dim = feature_dim
        self.max_lod = blas.max_level
        self.num_lods = num_lods
        self.base_lod = self.max_lod - num_lods + 1
        self.interpolation_type = interpolation_type
        self.multiscale_type = multiscale_type
        self.feature_std = feature_std
        self.feature_bias = feature_bias
        self.active_lods = tuple(self.base_lod + x for x in range(num_lods))
        self.frozen = False
        self.occupancy = None  # octree grids do not prune
        self.trinkets = None
        self.features = nn.ParameterList()
        if num_lods > 0:
            self.init_feature_structure(generator)

    def init_feature_structure(self, generator: Optional[torch.Generator] = None) -> None:
        """Dual octree and trinkets of the active LODs (host), and one feature table a LOD
        drawn from ``generator``: feature_bias + feature_std * N(0, 1)."""
        points = [np.asarray(p) for p in self.blas.points]
        if self.interpolation_type == "linear":
            dual_points, trinkets = make_dual(points)
            self.trinkets = [torch.from_numpy(trinkets[lod]).to(self.device)
                             for lod in self.active_lods]
            counts = [dual_points[lod].shape[0] for lod in self.active_lods]
        else:  # 'closest': one feature per cell
            counts = [points[lod].shape[0] for lod in self.active_lods]
        self.num_feat = sum(counts) * self.feature_dim
        self.features = nn.ParameterList([
            nn.Parameter((self.feature_bias + self.feature_std * torch.randn(
                (n, self.feature_dim), generator=generator)).to(self.device))
            for n in counts])

    def freeze(self) -> "OctreeGrid":
        """Stop the feature gradients."""
        self.frozen = True
        for f in self.features:
            f.requires_grad_(False)
        return self

    def interpolate(self, coords: torch.Tensor, lod_idx: int) -> torch.Tensor:
        """Features of LODs 0..lod_idx at coords [..., 3]: [..., F] ('sum') or
        [..., F * (lod_idx+1)] ('cat'). LOD 0 alone is queried without parents."""
        output_shape = coords.shape[:-1]
        flat = coords.reshape(-1, 3).contiguous()
        n = lod_idx + 1
        if lod_idx == 0:
            pidx = self.blas.query(flat, self.active_lods[0]).pidx[:, None]
            col0 = 0
        else:
            pidx = self.blas.query(flat, self.active_lods[lod_idx], with_parents=True).pidx
            col0 = self.base_lod
        if self.interpolation_type == "linear":
            # list() first: slicing the ParameterList would build a new module each call
            feats = octree_interp(flat, pidx, col0, self.trinkets[:n], list(self.features)[:n],
                                  self.active_lods[:n], self.multiscale_type)
        else:
            feats = self._closest(pidx, col0, n)
        return feats.reshape(*output_shape, feats.shape[-1])

    def _closest(self, pidx: torch.Tensor, col0: int, n: int) -> torch.Tensor:
        """'closest': each LOD's feature row of the cell itself (a plain gather)."""
        outs = []
        for i in range(n):
            p = pidx[:, col0 + i]
            fs = self.features[i][p.clamp(min=0)]
            outs.append(torch.where((p >= 0)[:, None], fs, torch.zeros_like(fs)))
        return _combine_lods(outs, self.multiscale_type)

    def raymarch(self, rays, raymarch_type, num_samples, level=None, key=None, **kwargs):
        """March at base_lod, the coarsest featured level."""
        return self.blas.raymarch(rays, raymarch_type=raymarch_type, num_samples=num_samples,
                                  level=self.base_lod, key=key, **kwargs)
