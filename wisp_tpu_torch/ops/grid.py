"""Multi-resolution hash-grid interpolation (counterpart of wisp_tpu/ops/grid.py).

``hashgrid`` is the JAX ``hashgrid`` (:335) with the exact backward: on a CUDA tensor it
launches the hand-written kernel ``csrc/hashgrid.cu`` (K1 forward) inside an autograd
Function whose backward launches K1 backward (``hashgrid_bwd``, the table gradient; coords
get none, as they are not parameters); on a CPU tensor it runs ``hashgrid_plain``, written
like the JAX ``hashgrid_naive`` (:407) but with the coordinate transform of
``_lod_features`` (:165), ``(c+1)*(res/2)``, so that corner choices agree. Autograd through
the plain version is its plain backward: the row gather's backward is a scatter-add, as
JAX's ``_gather_rows_bwd`` (:55).

With ``stoch_grad`` the backward is JAX's stochastic one (``interp_rows_stoch``, :66): on
the LODs that ``stoch_lods`` names, the whole cotangent of a (sample, LOD) goes to one
corner, drawn with probability equal to its weight from the per-sample uniform
``stoch_u0`` shifted by ``fold_u``. The forward is unchanged. ``hashgrid_bwd`` and its
plain version take the LOD flags (``stoch_mask``): on the card one launch covers the mixed
set of stochastic and exact LODs, counted as ``hashgrid_bwd_stoch``; on the CPU an autograd
Function runs ``hashgrid_plain`` forward and ``hashgrid_bwd_plain`` backward.

``hashgrid_query`` is JAX's raw corner query (K14): the 2^d corner rows of every LOD, no
blend; on a CUDA tensor it launches ``wisp_hashgrid_query`` (``csrc/hashgrid.cu``), on a CPU
tensor it runs ``hashgrid_query_plain``. ``grid_interpolate`` is the JAX blend of given
corner features; the octree grid's kernel (K15) folds it in on the card.

The JAX package's dense-LOD MXU matmul (``_lod_features_dense_matmul``) is a TPU layout
trick and is not ported: every LOD gathers its corner rows in float32. Its branch rule
survives in ``stoch_lods``, since it decides which LODs take the exact gradient.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wisp_tpu_torch import kernels

# uint32 primes of the instant-ngp spatial hash (reference ops/grid.py:14)
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# JAX's cap on rows * res^2 of its dense-LOD matrix product (ops/grid.py:202); above it a
# dense LOD gathers, and takes the stochastic backward again
DENSE_MM_MAX_ELEMS = 2 ** 30
# the golden-ratio shift that decorrelates the draws of the LODs (_fold_u, ops/grid.py:295)
GOLDEN_SHIFT = 0.61803398875
# a block's shared memory on the H100 (sm_90: 227 KB), and the part of it in which K1's
# backward accumulates its leading dense LODs (``shared_lods``): a quarter of an SM's 228 KB
# less the 1 KB each block reserves, so that four blocks of 512 threads stay resident. On
# the card that was as fast as LODs 0-1 or 0-2 for the exact backward and the fastest for
# the stochastic one (PERF.md, section 6)
SHARED_MEMORY_BYTES = 232_448
SHARED_LOD_BYTES = 57_344


def stoch_lods(resolutions: Sequence[int], codebook_bitwidth: int, dim: int, rows: int,
               dense_lod_matmul: Optional[str]) -> Tuple[bool, ...]:
    """Which LODs take the stochastic backward under ``stoch_grad``: JAX's branch condition
    (``_hashgrid_impl`` :322-331, ``_lod_features_dense_matmul`` :235). A hash LOD
    (res^dim above the table) always does. A dense LOD takes JAX's matrix product, with the
    exact gradient, when ``dense_lod_matmul`` is set and ``rows * res^2`` is at most
    ``DENSE_MM_MAX_ELEMS``; otherwise it gathers, and draws. ``rows`` is the row count of
    JAX's call (on a compacted trace, the budget)."""
    codebook_size = 2 ** int(codebook_bitwidth)
    out = []
    for r in resolutions:
        r = int(r)
        dense = r ** dim <= codebook_size
        out.append(not (dense_lod_matmul is not None and dense
                        and int(rows) * r * r <= DENSE_MM_MAX_ELEMS))
    return tuple(out)


def shared_lods(resolutions: Sequence[int], codebook_bitwidth: int, dim: int, f_dim: int,
                n_lods: int, limit: int = SHARED_LOD_BYTES) -> int:
    """How many leading LODs K1's backward accumulates in each block's shared memory before
    it adds them to the table gradient once a block: the longest prefix of LODs
    0..n_lods-1 that are dense (res^dim rows fit the 2^bitwidth table) and whose rows,
    res^dim x ``f_dim`` float32 each, fit ``limit`` bytes together (at most a block's
    ``SHARED_MEMORY_BYTES``). The coarsest LODs are the smallest and take the most samples
    a row, so their atomics are the ones that contend in L2. A LOD whose float32 clip
    bound res-1-1e-5 rounds up to res-1 (res above 256) could put a corner past its rows,
    so it ends the prefix too (it would not fit anyway). A launch over fewer than 65,536
    samples spreads each sample's LODs over several threads and privatizes none
    (``csrc/hashgrid.cu``)."""
    codebook_size = 2 ** int(codebook_bitwidth)
    budget = min(int(limit), SHARED_MEMORY_BYTES)
    total, count = 0, 0
    for i in range(int(n_lods)):
        r = int(resolutions[i])
        rows = r ** dim
        total += rows * f_dim * 4
        if rows > codebook_size or total > budget or not np.float32(r - 1 - 1e-5) < r - 1:
            break
        count += 1
    return count


def stoch_u0(coords: torch.Tensor) -> torch.Tensor:
    """[N] per-sample uniforms of the stochastic backward, the sin hash of
    ``_hashgrid_impl`` (:313-317): frac(|sin(12.9898x + 78.233y [+ 37.719z])| * 43758.5453).
    It amplifies the phase's last bits ~4e4-fold, so it agrees with XLA's and CUDA's only
    statistically."""
    phase = coords[:, 0] * 12.9898 + coords[:, 1] * 78.233
    if coords.shape[1] == 3:
        phase = phase + coords[:, 2] * 37.719
    u0 = torch.abs(torch.sin(phase)) * 43758.5453
    return u0 - torch.floor(u0)


def ushift(lod: int) -> float:
    """float32 of LOD ``lod``'s golden-ratio shift, as the JAX sum rounds it."""
    return float(np.float32(GOLDEN_SHIFT * (lod + 1)))


def fold_u(u0: torch.Tensor, lod: int) -> torch.Tensor:
    """LOD ``lod``'s uniforms: frac(u0 + 0.61803398875 (lod+1)) (``_fold_u``)."""
    u = u0 + torch.tensor(ushift(lod), dtype=u0.dtype, device=u0.device)
    return u - torch.floor(u)


def corner_offsets(dim: int) -> np.ndarray:
    """[2^dim, dim] binary corner offsets: corner bit k toggles coordinate dim-1-k."""
    corners = np.zeros((2 ** dim, dim), dtype=np.int64)
    for c in range(2 ** dim):
        for d in range(dim):
            corners[c, d] = (c >> (dim - 1 - d)) & 1
    return corners


def hash_index(corner_coords: torch.Tensor, res: int, codebook_size: int) -> torch.Tensor:
    """Integer corner coords [..., dim] -> int64 table rows: dense row-major when res^dim
    fits the table, else the uint32 xor-prime hash mod ``codebook_size``. The uint32
    arithmetic is done in int64 with every product masked to 32 bits, so the xor and the
    modulo see the same bits as the JAX and CUDA versions."""
    dim = corner_coords.shape[-1]
    cc = corner_coords.to(torch.int64)
    if res ** dim <= codebook_size:
        idx = cc[..., 0]
        stride = 1
        for d in range(1, dim):
            stride *= res
            idx = idx + cc[..., d] * stride
        return idx
    idx = (cc[..., 0] * PRIMES[0]) & _U32
    for d in range(1, dim):
        idx = idx ^ ((cc[..., d] * PRIMES[d % len(PRIMES)]) & _U32)
    return idx % codebook_size


def _corners(coords: torch.Tensor, res: int, codebook_size: int):
    """One LOD's corner rows [N, C] (within the LOD's table) and trilinear weights [N, C], in
    ``corner_offsets`` order and the kernels' float order."""
    dim = coords.shape[1]
    offsets = torch.as_tensor(corner_offsets(dim), device=coords.device)      # [C, d]
    x = torch.clamp((coords + 1.0) * (res / 2.0), 0.0, res - 1 - 1e-5)
    c0 = torch.floor(x)
    frac = x - c0
    corners = c0.to(torch.int64)[:, None, :] + offsets[None]                  # [N, C, d]
    idx = hash_index(corners, res, codebook_size)                             # [N, C]
    w = None
    for d in range(dim):
        wd = torch.where(offsets[None, :, d].bool(), frac[:, None, d], 1.0 - frac[:, None, d])
        w = wd if w is None else w * wd                                       # [N, C]
    return idx, w


def hashgrid_plain(coords: torch.Tensor, resolutions: Sequence[int], codebook_bitwidth: int,
                   lod_idx: int, codebook: torch.Tensor, codebook_first_idx: Sequence[int],
                   codebook_sizes: Sequence[int], out_lods: Optional[int] = None
                   ) -> torch.Tensor:
    """Plain PyTorch version of K1 forward: [N, d] coords in [-1, 1] -> [N, out_lods*F],
    LODs 0..lod_idx computed, the remaining columns zero."""
    codebook_size = 2 ** codebook_bitwidth
    f_dim = codebook.shape[-1]
    feats = []
    for i in range(lod_idx + 1):
        idx, w = _corners(coords, int(resolutions[i]), codebook_size)
        level = codebook[codebook_first_idx[i]:codebook_first_idx[i] + codebook_sizes[i]]
        rows = level[idx]                                                     # [N, C, F]
        feats.append(torch.sum(rows * w[..., None], dim=1))
    out = torch.cat(feats, dim=-1)
    if out_lods is not None and out_lods > lod_idx + 1:
        out = torch.nn.functional.pad(out, (0, (out_lods - lod_idx - 1) * f_dim))
    return out


def _lod_args(coords: torch.Tensor, table: torch.Tensor, resolutions, codebook_bitwidth,
              lod_idx, codebook_first_idx, codebook_sizes, out_lods):
    """Check the shapes the kernels take and build their per-LOD argument arrays."""
    n_lods = int(lod_idx) + 1
    out_lods = n_lods if out_lods is None else int(out_lods)
    dim = coords.shape[1]
    f_dim = table.shape[-1]
    kernels.check(coords, "coords", torch.float32, (None, dim))
    kernels.check(table, "codebook", torch.float32, (None, f_dim))
    if dim not in (2, 3) or f_dim not in (1, 2, 4, 8):
        raise ValueError(f"hashgrid kernel takes dim 2/3 and F in 1/2/4/8, got {dim}, {f_dim}")
    if not 1 <= n_lods <= out_lods <= 32:
        raise ValueError(f"hashgrid kernel takes 1 <= lod_idx+1 <= out_lods <= 32, got "
                         f"{n_lods}, {out_lods}")
    codebook_size = 2 ** int(codebook_bitwidth)
    res = [int(resolutions[i]) for i in range(n_lods)]
    for i in range(n_lods):
        if int(codebook_sizes[i]) != min(res[i] ** dim, codebook_size):
            raise ValueError(f"LOD {i}: table size {codebook_sizes[i]} does not match "
                             f"min(res^dim, 2^bitwidth)")
    if int(codebook_first_idx[n_lods - 1]) + int(codebook_sizes[n_lods - 1]) > table.shape[0]:
        raise ValueError("hashgrid: codebook is smaller than its LOD tables")
    # per-LOD parameters as host arrays; the C entry point copies them into the kernel's
    # argument block before it returns
    arrays = (np.asarray(res, np.int32), np.asarray([r / 2.0 for r in res], np.float32),
              np.asarray([r - 1 - 1e-5 for r in res], np.float32),
              np.asarray([int(codebook_first_idx[i]) for i in range(n_lods)], np.int64),
              np.asarray([int(r ** dim <= codebook_size) for r in res], np.int32))
    return dim, f_dim, n_lods, out_lods, codebook_size, arrays


def _launch(name: str, counter: str, coords, src, n, geometry, out) -> None:
    dim, f_dim, n_lods, out_lods, codebook_size, arrays = geometry
    kernels.launch(name, counter, coords.data_ptr(), src.data_ptr(), n, dim, f_dim, n_lods,
                   out_lods, *(a.ctypes.data for a in arrays), codebook_size, out.data_ptr())


def _hashgrid_fwd(coords, codebook, geometry) -> torch.Tensor:
    n = coords.shape[0]
    out = torch.empty((n, geometry[3] * geometry[1]), dtype=torch.float32,
                      device=coords.device)
    if n > 0:
        _launch("wisp_hashgrid_fwd", "hashgrid_fwd", coords, codebook, n, geometry, out)
    return out


def lod_stoch_bwd_plain(coords: torch.Tensor, grad: torch.Tensor, res: int,
                        codebook_size: int, table_rows: int, u: torch.Tensor) -> torch.Tensor:
    """One LOD's stochastic table gradient [table_rows, F] (JAX ``_lod_features`` with
    ``stoch_u``, :182-191, and ``_irs_bwd``): the cotangent ``grad`` [N, F] of each sample
    goes whole to the corner drawn by ``u`` [N]: the first whose running weight sum exceeds
    u * (sum of the weights). The sum runs corner by corner, in the kernel's order."""
    idx, w = _corners(coords, res, codebook_size)
    wcum = [w[:, 0]]
    for c in range(1, w.shape[1]):
        wcum.append(wcum[-1] + w[:, c])
    wcum = torch.stack(wcum, dim=1)
    chosen = (wcum < (u * wcum[:, -1])[:, None]).sum(dim=1).clamp(max=w.shape[1] - 1)
    out = torch.zeros((table_rows, grad.shape[1]), dtype=torch.float32, device=coords.device)
    return out.index_add_(0, idx.gather(1, chosen[:, None])[:, 0], grad)


def stoch_tie_rows(coords: torch.Tensor, resolutions, codebook_bitwidth: int, lod_idx: int,
                   codebook_first_idx, stoch_mask: Sequence[bool], u0: torch.Tensor,
                   ulps: float = 4.0) -> Tuple[torch.Tensor, int]:
    """(table rows, count) of the draws that may fall either way: the (sample, stochastic
    LOD) pairs whose target u * wcum[last] lies within ``ulps`` float32 ulps of a running
    weight sum, and the 2^d corner rows of each. Two implementations that round one
    operation differently may pick different corners there, and only there."""
    codebook_size = 2 ** int(codebook_bitwidth)
    rows, count = [], 0
    for i in range(int(lod_idx) + 1):
        if not stoch_mask[i]:
            continue
        idx, w = _corners(coords, int(resolutions[i]), codebook_size)
        wcum = torch.cumsum(w, dim=1)
        target = fold_u(u0, i) * wcum[:, -1]
        eps = ulps * torch.finfo(torch.float32).eps * wcum[:, -1:].abs()
        tie = ((wcum - target[:, None]).abs() <= eps).any(dim=1)
        count += int(tie.sum())
        rows.append((idx[tie] + int(codebook_first_idx[i])).reshape(-1))
    rows = torch.unique(torch.cat(rows)) if rows else \
        torch.zeros(0, dtype=torch.int64, device=coords.device)
    return rows, count


def hashgrid_bwd_plain(coords: torch.Tensor, grad_out: torch.Tensor, resolutions,
                       codebook_bitwidth: int, lod_idx: int, table_rows: int,
                       codebook_first_idx, codebook_sizes, out_lods: Optional[int] = None,
                       stoch_mask: Optional[Sequence[bool]] = None,
                       u0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``hashgrid_bwd``: per LOD the scatter-add of w*g into the
    2^d corner rows (JAX ``_gather_rows_bwd``), or, on a LOD that ``stoch_mask`` flags,
    ``lod_stoch_bwd_plain`` with the uniforms ``fold_u(u0, lod)``; ``u0`` [N] defaults to
    ``stoch_u0``."""
    n_lods = int(lod_idx) + 1
    f_dim = grad_out.shape[1] // (out_lods if out_lods is not None else n_lods)
    codebook_size = 2 ** int(codebook_bitwidth)
    if stoch_mask is not None and u0 is None:
        u0 = stoch_u0(coords)
    grad = torch.zeros((table_rows, f_dim), dtype=torch.float32, device=coords.device)
    for i in range(n_lods):
        res = int(resolutions[i])
        first, size = int(codebook_first_idx[i]), int(codebook_sizes[i])
        g = grad_out[:, i * f_dim:(i + 1) * f_dim].float()
        if stoch_mask is not None and stoch_mask[i]:
            grad[first:first + size] += lod_stoch_bwd_plain(coords, g, res, codebook_size,
                                                            size, fold_u(u0, i))
        else:
            idx, w = _corners(coords, res, codebook_size)
            grad.index_add_(0, (idx + first).reshape(-1),
                            (w[..., None] * g[:, None, :]).reshape(-1, f_dim))
    return grad


def hashgrid_bwd(coords: torch.Tensor, grad_out: torch.Tensor, resolutions,
                 codebook_bitwidth: int, lod_idx: int, table_rows: int, codebook_first_idx,
                 codebook_sizes, out_lods: Optional[int] = None,
                 stoch_mask: Optional[Sequence[bool]] = None, u0: Optional[torch.Tensor] = None,
                 u0_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 backward: the [table_rows, F] table gradient of ``hashgrid`` for the cotangent
    ``grad_out`` [N, out_lods*F] (LODs above ``lod_idx`` take none). With ``stoch_mask`` the
    LODs it flags take the stochastic backward (one drawn corner a sample); ``u0`` [N]
    injects the uniforms (None: the sin hash), and ``u0_out`` [N], given without ``u0``,
    receives the hash's. The kernel on the card, the plain version on the CPU."""
    if not coords.is_cuda:
        if u0_out is not None:
            u0_out.copy_(stoch_u0(coords))
        return hashgrid_bwd_plain(coords, grad_out, resolutions, codebook_bitwidth, lod_idx,
                                  table_rows, codebook_first_idx, codebook_sizes, out_lods,
                                  stoch_mask, u0)
    f_dim = grad_out.shape[1] // (out_lods if out_lods is not None else int(lod_idx) + 1)
    grad = torch.zeros((table_rows, f_dim), dtype=torch.float32, device=coords.device)
    geometry = _lod_args(coords, grad, resolutions, codebook_bitwidth, lod_idx,
                         codebook_first_idx, codebook_sizes, out_lods)
    return _hashgrid_bwd(coords, grad_out, geometry, grad, stoch_mask, u0, u0_out)


def _hashgrid_bwd(coords, grad_out, geometry, grad, stoch_mask=None, u0=None,
                  u0_out=None) -> torch.Tensor:
    """K1 backward into the zeroed table gradient ``grad``: the stochastic instantiation,
    counted as ``hashgrid_bwd_stoch``, when ``stoch_mask`` is given, else the exact one."""
    dim, f_dim, n_lods, out_lods, codebook_size, arrays = geometry
    n = coords.shape[0]
    kernels.check(grad_out, "grad_out", torch.float32, (n, out_lods * f_dim))
    flags = None
    if stoch_mask is not None:
        if len(stoch_mask) < n_lods:
            raise ValueError(f"hashgrid_bwd: {len(stoch_mask)} LOD flags for {n_lods} LODs")
        flags = np.asarray([int(bool(stoch_mask[i])) for i in range(n_lods)], np.int32)
    elif u0 is not None or u0_out is not None:
        raise ValueError("hashgrid_bwd: u0 and u0_out need stoch_mask")
    if u0 is not None and u0_out is not None:
        raise ValueError("hashgrid_bwd: give u0 or u0_out, not both")
    for t, name in ((u0, "u0"), (u0_out, "u0_out")):
        if t is not None:
            kernels.check(t, name, torch.float32, (n,))
    n_shared = shared_lods(arrays[0], codebook_size.bit_length() - 1, dim, f_dim, n_lods,
                           SHARED_LOD_BYTES)
    if n > 0:
        kernels.launch("wisp_hashgrid_bwd",
                       "hashgrid_bwd" if flags is None else "hashgrid_bwd_stoch",
                       coords.data_ptr(), grad_out.data_ptr(), kernels.ptr(u0),
                       kernels.ptr(u0_out), n, dim, f_dim, n_lods, out_lods,
                       *(a.ctypes.data for a in arrays),
                       None if flags is None else flags.ctypes.data, n_shared, codebook_size,
                       grad.data_ptr())
    return grad


class _HashGridFn(torch.autograd.Function):
    """K1 forward with K1 backward as its gradient (the table's; coords get none): the
    stochastic backward when ``stoch_mask`` is given (it flags a LOD), else the exact one."""

    @staticmethod
    def forward(ctx, coords, codebook, geometry, stoch_mask):
        ctx.save_for_backward(coords)
        ctx.geometry = geometry
        ctx.stoch_mask = stoch_mask
        ctx.table_shape = codebook.shape
        return _hashgrid_fwd(coords, codebook, geometry)

    @staticmethod
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = torch.zeros(ctx.table_shape, dtype=torch.float32, device=coords.device)
            _hashgrid_bwd(coords, grad_out.contiguous(), ctx.geometry, grad, ctx.stoch_mask)
        return None, grad, None, None


class _HashGridStochPlainFn(torch.autograd.Function):
    """The CPU route of ``hashgrid`` under ``stoch_grad``: ``hashgrid_plain`` forward and
    ``hashgrid_bwd_plain`` backward with the LOD flags (autograd through the plain forward
    would give the exact gradient)."""

    @staticmethod
    def forward(ctx, coords, codebook, args, stoch_mask):
        ctx.save_for_backward(coords)
        ctx.args = args
        ctx.stoch_mask = stoch_mask
        ctx.table_rows = codebook.shape[0]
        resolutions, bitwidth, lod_idx, first, sizes, out_lods = args
        return hashgrid_plain(coords, resolutions, bitwidth, lod_idx, codebook, first, sizes,
                              out_lods)

    @staticmethod
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            resolutions, bitwidth, lod_idx, first, sizes, out_lods = ctx.args
            grad = hashgrid_bwd_plain(coords, grad_out, resolutions, bitwidth, lod_idx,
                                      ctx.table_rows, first, sizes, out_lods, ctx.stoch_mask)
        return None, grad, None, None


def hashgrid(coords: torch.Tensor, resolutions: Sequence[int], codebook_bitwidth: int,
             lod_idx: int, codebook: torch.Tensor, codebook_first_idx: Sequence[int],
             codebook_sizes: Sequence[int], out_lods: Optional[int] = None,
             stoch_grad: bool = False, dense_lod_matmul: Optional[str] = None,
             stoch_rows: Optional[int] = None) -> torch.Tensor:
    """Multi-LOD hash interpolation: [N, d] -> [N, out_lods*F] with LODs 0..lod_idx
    computed and the columns of later LODs zero (``out_lods`` defaults to lod_idx+1, the
    JAX ``hashgrid`` output). Differentiable in ``codebook``. K1 on the card, the plain
    version on the CPU.

    ``stoch_grad`` selects the stochastic backward on the LODs of ``stoch_lods(...,
    stoch_rows, dense_lod_matmul)``; ``stoch_rows`` is the row count of the JAX call this
    one stands for (default: this call's rows). ``dense_lod_matmul`` acts only there."""
    stoch_mask = None
    if stoch_grad:
        rows = coords.shape[0] if stoch_rows is None else int(stoch_rows)
        stoch_mask = stoch_lods([resolutions[i] for i in range(int(lod_idx) + 1)],
                                codebook_bitwidth, coords.shape[1], rows, dense_lod_matmul)
        if not any(stoch_mask):
            stoch_mask = None
    if not coords.is_cuda:
        if stoch_mask is None:
            return hashgrid_plain(coords, resolutions, codebook_bitwidth, lod_idx, codebook,
                                  codebook_first_idx, codebook_sizes, out_lods)
        args = (tuple(resolutions), codebook_bitwidth, int(lod_idx), tuple(codebook_first_idx),
                tuple(codebook_sizes), out_lods)
        return _HashGridStochPlainFn.apply(coords, codebook, args, stoch_mask)
    geometry = _lod_args(coords, codebook, resolutions, codebook_bitwidth, lod_idx,
                         codebook_first_idx, codebook_sizes, out_lods)
    return _HashGridFn.apply(coords, codebook, geometry, stoch_mask)


def grid_interpolate(coords: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Blend of given corner features (JAX ``grid_interpolate``, :393): ``coords`` [N, d]
    in [0, 1]^d are the fractions inside the cell, ``feats`` [N, 2^d, F] the corner features
    in ``corner_offsets`` order. On the card the octree grid's kernel (K15) folds it in."""
    offsets = torch.as_tensor(corner_offsets(coords.shape[-1]), device=coords.device).bool()
    w = torch.where(offsets[None], coords[:, None, :], 1.0 - coords[:, None, :])
    return torch.sum(feats * torch.prod(w, dim=-1)[..., None].to(feats.dtype), dim=1)


def hashgrid_query_plain(coords: torch.Tensor, resolutions: Sequence[int],
                         codebook_bitwidth: int, lod_idx: int, codebook: torch.Tensor,
                         codebook_first_idx: Sequence[int], codebook_sizes: Sequence[int]
                         ) -> torch.Tensor:
    """Plain PyTorch version of ``hashgrid_query``: JAX's body (ops/grid.py:369-390)."""
    codebook_size = 2 ** int(codebook_bitwidth)
    offsets = torch.as_tensor(corner_offsets(coords.shape[-1]), device=coords.device)
    out = []
    for i in range(int(lod_idx) + 1):
        res = int(resolutions[i])
        x = torch.clamp((coords + 1.0) / 2.0 * res, 0.0, res - 1 - 1e-5)
        corners = torch.floor(x).to(torch.int64)[:, None, :] + offsets[None]
        idx = hash_index(corners, res, codebook_size)                          # [N, C]
        size = int(codebook_sizes[i])
        level = codebook[int(codebook_first_idx[i]):int(codebook_first_idx[i]) + size]
        rows = level[idx.clamp(max=size - 1)]
        # jnp.take's default fill mode: a row past the LOD's slice reads NaN
        out.append(torch.where((idx < size)[..., None], rows,
                               torch.full_like(rows, float("nan"))))
    return torch.stack(out, dim=1)


@functools.lru_cache(maxsize=64)
def _query_arrays(res: Tuple[int, ...], first: Tuple[int, ...], sizes: Tuple[int, ...],
                  dim: int, codebook_size: int) -> tuple:
    """K14's per-LOD argument arrays (res, hi, first, sizes, dense), built once a set of
    LOD tables: an API caller's short calls would otherwise spend more host time on them
    than the card spends on the kernel. Read only (the kernel gets their addresses)."""
    return (np.asarray(res, np.int32), np.asarray([r - 1 - 1e-5 for r in res], np.float32),
            np.asarray(first, np.int64), np.asarray(sizes, np.int64),
            np.asarray([int(r ** dim <= codebook_size) for r in res], np.int32))


def query_args(coords: torch.Tensor, resolutions: Sequence[int], codebook_bitwidth: int,
               lod_idx: int, codebook: torch.Tensor, codebook_first_idx: Sequence[int],
               codebook_sizes: Sequence[int]) -> tuple:
    """Check what K14 takes and give its per-LOD argument arrays: (N, dim, F, LODs,
    codebook size, (res, hi, first, sizes, dense))."""
    n_lods = int(lod_idx) + 1
    n, dim = coords.shape[0], coords.shape[1]
    f_dim = codebook.shape[-1]
    kernels.check(coords, "coords", torch.float32, (n, dim))
    kernels.check(codebook, "codebook", torch.float32, (None, f_dim))
    if dim not in (2, 3) or f_dim < 1 or not 1 <= n_lods <= 32:
        raise ValueError(f"hashgrid_query takes dim 2/3, F >= 1 and 1-32 LODs, got "
                         f"{dim}, {f_dim}, {n_lods}")
    codebook_size = 2 ** int(codebook_bitwidth)
    first = tuple(int(codebook_first_idx[i]) for i in range(n_lods))
    sizes = tuple(int(codebook_sizes[i]) for i in range(n_lods))
    if any(f + s > codebook.shape[0] for f, s in zip(first, sizes)):
        raise ValueError("hashgrid_query: codebook is smaller than its LOD tables")
    arrays = _query_arrays(tuple(int(resolutions[i]) for i in range(n_lods)), first, sizes,
                           dim, codebook_size)
    return n, dim, f_dim, n_lods, codebook_size, arrays


def hashgrid_query(coords: torch.Tensor, resolutions: Sequence[int], codebook_bitwidth: int,
                   lod_idx: int, codebook: torch.Tensor, codebook_first_idx: Sequence[int],
                   codebook_sizes: Sequence[int]) -> torch.Tensor:
    """The raw feature rows of the 2^d cell corners of every point at LODs 0..``lod_idx``
    (K14): [N, d] coords in [-1, 1] -> [N, lod_idx+1, 2^d, F] at any F, corners in
    ``corner_offsets`` order. The cell is that of clip((c+1)/2 * res, 0, res-1-1e-5) (JAX's
    transform, not K1's), its corners' rows ``hash_index`` within the LOD's table; a row past
    the LOD's ``codebook_sizes`` entry reads NaN, as in JAX."""
    if not coords.is_cuda:
        return hashgrid_query_plain(coords, resolutions, codebook_bitwidth, lod_idx, codebook,
                                    codebook_first_idx, codebook_sizes)
    n, dim, f_dim, n_lods, codebook_size, arrays = query_args(
        coords, resolutions, codebook_bitwidth, lod_idx, codebook, codebook_first_idx,
        codebook_sizes)
    out = torch.empty((n, n_lods, 2 ** dim, f_dim), dtype=torch.float32, device=coords.device)
    if n:
        kernels.launch("wisp_hashgrid_query", "hashgrid_query", coords.data_ptr(),
                       codebook.data_ptr(), n, dim, f_dim, n_lods,
                       *(a.ctypes.data for a in arrays), codebook_size, out.data_ptr())
    return out
