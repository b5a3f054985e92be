"""OctreeGrid — NGLOD features on the dual vertices of a sparse octree (counterpart of
wisp_tpu/models/grids/octree_grid.py).

Features live on the dual octree's vertices (cell corners) of each active LOD
(base_lod = max_level - num_lods + 1 .. max_level), one ``nn.Parameter`` [V_l, F] per LOD;
the trinkets [N_l, 8] give each cell's 8 corner rows. ``interpolate`` finds each point's
cell at every LOD (the ancestor-chain query, K9), blends each LOD's 8 corner features
trilinearly and sums or concatenates the LODs; a point in an empty cell gets zeros. With
'linear' interpolation both run in one kernel, ``octree_query_interp``; 'closest' queries,
then gathers.

``octree_interp`` is kernel K15 (``csrc/octree_grid.cu``) at given cells: on a CUDA tensor it
launches the kernel's forward, on a CPU tensor it runs ``octree_interp_plain``. No path of
the package calls it any more: it is the unfused design that the fused one is timed
against. ``interp_vector_width`` picks the forward's route (features a lane) from F and the
tables' alignment, and the backward's too (with ``bwd_shared_lods``, the LODs it sums in
shared memory first). ``lod_tables`` builds and keeps the tables' argument block that every
forward entry point reads.
``octree_query_interp`` is the query folded into K15's forward (the same source): each LOD's
first load is the cell's lookup by its level's route (``OctreeAS.query_routes``), so K9's
pidx never goes through memory. On the card, a call that needs the features' gradient goes
through an ``autograd.Function`` whose backward launches K15's backward kernel
(``octree_interp_bwd``) on the cells the forward looked up (its side output); the gradient
with respect to the coordinates is not ported, and asking for it on the card raises. On the
CPU the plain versions keep their own autograd.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from wisp_tpu_torch import kernels
from wisp_tpu_torch.accelstructs.octree_as import octree_query_plain, route_args
from wisp_tpu_torch.device import DeviceLike, resolve_device
from wisp_tpu_torch.models.grids.blas_grid import BLASGrid
from wisp_tpu_torch.ops.grid import grid_interpolate
from wisp_tpu_torch.ops.spc.core import make_dual, quantize_points

MAX_LODS = 16  # LOD slots in the kernel's argument block
LOD_TABLES_MAX = 64  # entries of the forward kernels' cache of LOD tables (lod_tables)
# K15 backward: the shared memory one LOD's table may take (csrc/octree_grid.cu
# kBwdSharedBytes), and the corner adds a row, on average, from which a LOD that fits is
# summed there first (a shared float add costs about a quarter of a scattered L2 one, so a
# block's copy pays where many adds meet on a row)
BWD_SHARED_BYTES = 112 * 1024
BWD_SHARED_MIN_ADDS = 64


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


def _check_geometry(coords, pidx, col0, trinkets, levels, multiscale_type):
    n_lods = len(levels)
    if multiscale_type not in ("sum", "cat") or not 1 <= n_lods <= MAX_LODS:
        raise ValueError(f"octree_interp: {multiscale_type!r} over {n_lods} LODs")
    n = coords.shape[0]
    kernels.check(coords, "coords", torch.float32, (n, 3))
    kernels.check(pidx, "pidx", torch.int32, (n, None))
    if not 0 <= col0 <= pidx.shape[1] - n_lods:
        raise ValueError(f"octree_interp: columns {col0}..{col0 + n_lods - 1} of pidx "
                         f"[{n}, {pidx.shape[1]}]")
    for i in range(n_lods):
        kernels.check(trinkets[i], f"trinkets[{i}]", torch.int32, (None, 8))
    return n, n_lods


def interp_vector_width(f_dim: int, feature_ptrs: Sequence[int]) -> int:
    """K15's route, forward and backward: 4 features a lane (F/4 lanes a point, 16-byte
    loads and stores, float4 atomics) where F % 4 == 0 and every table (and the backward's
    cotangent) starts on 16 bytes, else 1 (a lane a feature)."""
    return 4 if f_dim % 4 == 0 and all(p % 16 == 0 for p in feature_ptrs) else 1


def _interp_fwd(coords, pidx, col0, trinkets, features, levels, multiscale_type):
    """Launch K15's forward kernel."""
    f_dim = features[0].shape[1]
    n, n_lods = _check_geometry(coords, pidx, col0, trinkets, levels, multiscale_type)
    tabs = lod_tables(trinkets, features, levels)
    out = torch.empty((n, f_dim if multiscale_type == "sum" else f_dim * n_lods),
                      dtype=torch.float32, device=coords.device)
    if n:
        kernels.launch("wisp_octree_interp", "octree_interp", coords.data_ptr(),
                       pidx.data_ptr(), n, pidx.shape[1], int(col0), n_lods, f_dim,
                       tabs.address, int(multiscale_type == "sum"), tabs.vec, out.data_ptr())
    return out


def octree_interp_bwd_plain(coords: torch.Tensor, pidx: torch.Tensor, col0: int,
                            trinkets: Sequence[torch.Tensor], rows: Sequence[int], f_dim: int,
                            levels: Sequence[int], multiscale_type: str,
                            grad_out: torch.Tensor) -> List[torch.Tensor]:
    """Plain PyTorch version of ``octree_interp_bwd``: autograd of ``octree_interp_plain``
    (the blend is linear in the features, so zero tables give the same gradient)."""
    feats = [torch.zeros((v, f_dim), dtype=torch.float32, device=coords.device,
                         requires_grad=True) for v in rows]
    with torch.enable_grad():
        out = octree_interp_plain(coords, pidx, col0, trinkets, feats, levels,
                                  multiscale_type)
        return list(torch.autograd.grad(out, feats, grad_out))


def bwd_shared_lods(rows: Sequence[int], f_dim: int, n: int) -> List[int]:
    """K15 backward's route a LOD: its rows where its table (rows x F floats) fits in
    ``BWD_SHARED_BYTES`` and its 8 N corner adds average at least ``BWD_SHARED_MIN_ADDS`` a
    row, so that each block first sums its own adds in shared memory (adds to one row
    serialise in L2); else 0, atomics straight to the table."""
    return [int(v) if v * f_dim * 4 <= BWD_SHARED_BYTES and 8 * n >= BWD_SHARED_MIN_ADDS * v
            else 0 for v in rows]


def grad_tables(rows: Sequence[int], f_dim: int, device) -> List[torch.Tensor]:
    """The backward's zeroed [rows[i], F] float32 tables: views, in LOD order, of one buffer
    that one fill zeroes (a fill a table cost a launch each)."""
    flat = torch.zeros((sum(rows) * f_dim,), dtype=torch.float32, device=device)
    return [t.view(v, f_dim) for t, v in zip(torch.split(flat, [v * f_dim for v in rows]),
                                               rows)]


def octree_interp_bwd(coords: torch.Tensor, pidx: torch.Tensor, col0: int,
                      trinkets: Sequence[torch.Tensor], rows: Sequence[int], f_dim: int,
                      levels: Sequence[int], multiscale_type: str,
                      grad_out: torch.Tensor) -> List[torch.Tensor]:
    """The feature gradient of ``octree_interp`` (K15 backward): for the cotangent
    ``grad_out`` ([N, F] for 'sum', [N, F * LODs] for 'cat'), one [rows[i], F] float32 table a
    LOD holding the sum over points and corners of w_c * g. Points in empty cells add
    nothing. On the card the tables are views of one buffer (``grad_tables``)."""
    if not coords.is_cuda:
        return octree_interp_bwd_plain(coords, pidx, col0, trinkets, rows, f_dim, levels,
                                       multiscale_type, grad_out)
    n, n_lods = _check_geometry(coords, pidx, col0, trinkets, levels, multiscale_type)
    width = f_dim if multiscale_type == "sum" else f_dim * n_lods
    kernels.check(grad_out, "grad_out", torch.float32, (n, width))
    grads = grad_tables(rows, f_dim, coords.device)
    if n:
        trk, gps = kernels.pointers(trinkets), kernels.pointers(grads)
        lvl = np.asarray(levels, dtype=np.int32)
        shared = np.asarray(bwd_shared_lods(rows, f_dim, n), dtype=np.int32)
        vec = interp_vector_width(f_dim, [g.data_ptr() for g in grads] + [grad_out.data_ptr()])
        kernels.launch("wisp_octree_interp_bwd", "octree_interp_bwd", coords.data_ptr(),
                       pidx.data_ptr(), n, pidx.shape[1], int(col0), n_lods, f_dim,
                       ctypes.addressof(trk), ctypes.addressof(gps), lvl.ctypes.data,
                       shared.ctypes.data, int(multiscale_type == "sum"), vec,
                       grad_out.data_ptr())
    return grads


def octree_interp(coords: torch.Tensor, pidx: torch.Tensor, col0: int,
                  trinkets: Sequence[torch.Tensor], features: Sequence[torch.Tensor],
                  levels: Sequence[int], multiscale_type: str = "sum") -> torch.Tensor:
    """Multi-LOD trilinear interpolation of dual-vertex features (K15).

    ``coords`` [N, 3] float32; ``pidx`` [N, P] int32 cell indices, LOD i reading column
    ``col0 + i`` (-1 = empty cell: zero features); per LOD ``trinkets[i]`` [N_i, 8] int32,
    ``features[i]`` [V_i, F] float32 and its octree level. Corner c of a cell sits at offset
    (c>>2, (c>>1)&1, c&1), z fastest; the fraction inside the cell is
    clip((c+1)*(res/2) - cell, 0, 1). Returns [N, F] ('sum', LODs added in order) or
    [N, F * LODs] ('cat'). On the CPU (the plain version) it is differentiable; on the card it
    is the forward alone (the features' gradient goes through ``octree_query_interp``), and
    asking for a gradient raises."""
    if not coords.is_cuda:
        return octree_interp_plain(coords, pidx, col0, trinkets, features, levels,
                                   multiscale_type)
    if torch.is_grad_enabled() and (coords.requires_grad
                                    or any(f.requires_grad for f in features)):
        raise NotImplementedError("octree_interp: no gradient on the card; "
                                  "octree_query_interp carries the features' gradient")
    return _interp_fwd(coords, pidx, col0, trinkets, features, levels, multiscale_type)


class _LodTables(ctypes.Structure):
    """The LODs' tables, levels and cell lookups as ``csrc/octree_grid.cu``'s ``Lods``
    (every forward entry point copies it into its kernel's parameters)."""
    _fields_ = [("trinkets", ctypes.c_void_p * MAX_LODS),
                ("feats", ctypes.c_void_p * MAX_LODS),
                ("table", ctypes.c_void_p * MAX_LODS), ("len", ctypes.c_longlong * MAX_LODS),
                ("level", ctypes.c_int * MAX_LODS), ("route", ctypes.c_int * MAX_LODS)]


class LodTables(NamedTuple):
    """A set of LOD tables as the forward kernels read them: the address of their
    ``_LodTables``, the features a lane and a ray's lanes in ``sphere_iter`` (``ray_lanes``),
    and the struct itself, kept alive."""
    address: int
    vec: int
    group: int
    struct: _LodTables


def ray_lanes(features: Sequence[torch.Tensor]) -> Tuple[int, int]:
    """(features a lane, lanes a ray) of the forward kernels on these feature tables [V_i,
    F]: ``interp_vector_width`` of their addresses, and ``sphere_iter``'s group, F / vec
    rounded up to a power of two (a group lies in one warp: more than 32 lanes cannot take
    the fused iteration)."""
    f_dim = features[0].shape[1]
    vec = interp_vector_width(f_dim, [f.data_ptr() for f in features])
    group = 1
    while group * vec < f_dim:
        group *= 2
    return vec, group


def _table_key(t: Optional[torch.Tensor]):
    """What the checks and the struct read of a table: its address, dtype, shape and
    layout (an address alone may come back for another table once the first is freed)."""
    return None if t is None else (t.data_ptr(), t.dtype, t.shape, t.is_contiguous())


# the tables' keys (trinkets, features, levels, routes) -> their LodTables
_LOD_TABLES = {}


def lod_tables(trinkets, features, levels, routes=None) -> LodTables:
    """The ``LodTables`` of the LODs' trinkets [N_i, 8] int32 and features [V_i, F] float32
    at ``levels`` and, where ``routes`` is given (the fused query), each level's cell lookup
    ``routes[level]``: checked and built once and kept, keyed on everything that the checks
    and the struct read of each table, so that a new table at a freed one's address is
    checked and read anew."""
    key = (tuple(_table_key(t) for t in trinkets), tuple(_table_key(f) for f in features),
           tuple(levels), None if routes is None else
           tuple(None if routes[l] is None else (routes[l].kind, _table_key(routes[l].table))
                 for l in levels))
    found = _LOD_TABLES.get(key)
    if found is None:
        n_lods, f_dim = len(levels), features[0].shape[1]
        if not 1 <= n_lods <= MAX_LODS or len(trinkets) != n_lods or len(features) != n_lods:
            raise ValueError(f"octree_interp: {n_lods} LODs")
        tables = _LodTables()
        for i, level in enumerate(levels):
            kernels.check(trinkets[i], f"trinkets[{i}]", torch.int32, (None, 8))
            kernels.check(features[i], f"features[{i}]", torch.float32, (None, f_dim))
            tables.trinkets[i] = trinkets[i].data_ptr()
            tables.feats[i] = features[i].data_ptr()
            tables.level[i] = level
        if routes is not None:
            if list(levels) != list(range(levels[0], levels[0] + n_lods)) or levels[-1] > 10:
                raise ValueError(f"octree_query_interp: LOD levels {list(levels)} are not "
                                 f"consecutive levels of an octree of at most 10")
            for i, level in enumerate(levels):
                if routes[level] is None:
                    raise ValueError(f"octree_query_interp: level {level} has no query route")
                code, table, length = route_args(routes[level], level, f"routes[{level}]")
                tables.table[i], tables.len[i], tables.route[i] = table, length, code
        if len(_LOD_TABLES) >= LOD_TABLES_MAX:
            _LOD_TABLES.clear()
        found = _LOD_TABLES[key] = LodTables(ctypes.addressof(tables), *ray_lanes(features),
                                             tables)
    return found


def octree_query_interp_plain(coords: torch.Tensor, routes: Sequence, trinkets, features,
                              levels: Sequence[int], multiscale_type: str = "sum"):
    """Plain PyTorch version of ``octree_query_interp``: the query (``octree_query_plain``,
    without parents for one LOD, else with them at the last LOD's level), then
    ``octree_interp_plain``; (features, the looked-up cells [N, LODs] int32)."""
    n_lods = len(levels)
    if n_lods == 1:
        pidx, col0 = octree_query_plain(coords, routes, levels[0])[:, None], 0
    else:
        pidx = octree_query_plain(coords, routes, levels[-1], with_parents=True)
        col0 = levels[0]
    feats = octree_interp_plain(coords, pidx, col0, trinkets, features, levels,
                                multiscale_type)
    return feats, pidx[:, col0:col0 + n_lods].contiguous()


def _query_interp_fwd(coords, routes, trinkets, features, levels, multiscale_type,
                      with_cells: bool):
    """Launch the fused query and K15 forward (on the CPU: its plain version); (features,
    the cells [N, LODs] or None)."""
    if not coords.is_cuda:
        feats, cells = octree_query_interp_plain(coords, routes, trinkets, features, levels,
                                                 multiscale_type)
        return feats, cells if with_cells else None
    n, n_lods, f_dim = coords.shape[0], len(levels), features[0].shape[1]
    if multiscale_type not in ("sum", "cat"):
        raise ValueError(f"octree_query_interp: {multiscale_type!r}")
    kernels.check(coords, "coords", torch.float32, (n, 3))
    tabs = lod_tables(trinkets, features, levels, routes)
    out = torch.empty((n, f_dim if multiscale_type == "sum" else f_dim * n_lods),
                      dtype=torch.float32, device=coords.device)
    cells = (torch.empty((n, n_lods), dtype=torch.int32, device=coords.device)
             if with_cells else None)
    if n:
        kernels.launch("wisp_octree_query_interp", "octree_query_interp", coords.data_ptr(),
                       n, levels[-1], n_lods, f_dim, tabs.address, int(multiscale_type == "sum"),
                       tabs.vec, out.data_ptr(), kernels.ptr(cells))
    return out, cells


class _OctreeQueryInterpFn(torch.autograd.Function):
    """The fused query and K15 forward with K15's backward kernel. Saves coords and the
    cells the forward looked up; the weights are recomputed in the backward."""

    @staticmethod
    def forward(ctx, coords, routes, trinkets, levels, multiscale_type, *features):
        out, cells = _query_interp_fwd(coords, routes, trinkets, features, levels,
                                       multiscale_type, with_cells=True)
        ctx.save_for_backward(coords, cells)
        ctx.geometry = (trinkets, levels, multiscale_type, [f.shape[0] for f in features],
                        features[0].shape[1])
        return out

    @staticmethod
    def backward(ctx, grad_out):
        coords, cells = ctx.saved_tensors
        trinkets, levels, multiscale_type, rows, f_dim = ctx.geometry
        grads = octree_interp_bwd(coords, cells, 0, trinkets, rows, f_dim, levels,
                                  multiscale_type, grad_out.float().contiguous())
        return (None,) * 5 + tuple(g if need else None
                                   for g, need in zip(grads, ctx.needs_input_grad[5:]))


def octree_query_interp(coords: torch.Tensor, routes: Sequence,
                        trinkets: Sequence[torch.Tensor], features: Sequence[torch.Tensor],
                        levels: Sequence[int], multiscale_type: str = "sum") -> torch.Tensor:
    """``octree_interp`` at the cells that the octree query finds, in one kernel: LOD i
    reads the cell of K9's with_parents column ``levels[i]`` at the last LOD's level (the
    point's parent cell at level ``levels[i]``, looked up by ``routes[levels[i]]``, a
    ``QueryRoute``; -1 everywhere outside [-1, 1]^3). ``levels`` are consecutive. Returns
    [N, F] ('sum') or [N, F * LODs] ('cat'), differentiable in the features."""
    if not coords.is_cuda:
        return octree_query_interp_plain(coords, routes, trinkets, features, levels,
                                         multiscale_type)[0]
    if torch.is_grad_enabled():
        if coords.requires_grad:
            raise NotImplementedError("octree_query_interp: the gradient with respect to the "
                                      "coordinates is not ported; detach them")
        if any(f.requires_grad for f in features):
            return _OctreeQueryInterpFn.apply(coords, routes, list(trinkets), list(levels),
                                              multiscale_type, *features)
    return _query_interp_fwd(coords, routes, trinkets, features, levels, multiscale_type,
                             with_cells=False)[0]


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
        if self.interpolation_type == "linear":
            feats = octree_query_interp(flat, *self.query_interp_args(lod_idx))
        else:
            if lod_idx == 0:
                pidx = self.blas.query(flat, self.active_lods[0]).pidx[:, None]
                col0 = 0
            else:
                pidx = self.blas.query(flat, self.active_lods[lod_idx],
                                       with_parents=True).pidx
                col0 = self.base_lod
            feats = self._closest(pidx, col0, n)
        return feats.reshape(*output_shape, feats.shape[-1])

    def query_interp_args(self, lod_idx: int):
        """``octree_query_interp``'s arguments after the coordinates for LODs 0..lod_idx:
        (routes, trinkets, features, levels, multiscale_type)."""
        n = lod_idx + 1
        # list() first: slicing the ParameterList would build a new module each call
        return (self.blas.query_routes, self.trinkets[:n], list(self.features)[:n],
                self.active_lods[:n], self.multiscale_type)

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
