"""Multi-resolution hash-grid interpolation (counterpart of wisp_tpu/ops/grid.py).

``hashgrid`` is the JAX ``hashgrid`` (:335) with the exact backward: on a CUDA tensor it
launches the hand-written kernel ``csrc/hashgrid.cu`` (K1 forward) inside an autograd
Function whose backward launches K1 backward (``hashgrid_bwd``, the table gradient; coords
get none, as they are not parameters); on a CPU tensor it runs ``hashgrid_plain``, written
like the JAX ``hashgrid_naive`` (:407) but with the coordinate transform of
``_lod_features`` (:165), ``(c+1)*(res/2)``, so that corner choices agree. Autograd through
the plain version is its plain backward: the row gather's backward is a scatter-add, as
JAX's ``_gather_rows_bwd`` (:55).

``grid_interpolate`` is the JAX blend of given corner features (K14's blend); the octree
grid's kernel (K15) folds it in on the card.

The JAX package's dense-LOD MXU matmul (``_lod_features_dense_matmul``) is a TPU layout
trick and is not ported: every LOD gathers its corner rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from wisp_tpu_torch import kernels

# uint32 primes of the instant-ngp spatial hash (reference ops/grid.py:14)
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


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


def hashgrid_plain(coords: torch.Tensor, resolutions: Sequence[int], codebook_bitwidth: int,
                   lod_idx: int, codebook: torch.Tensor, codebook_first_idx: Sequence[int],
                   codebook_sizes: Sequence[int], out_lods: Optional[int] = None
                   ) -> torch.Tensor:
    """Plain PyTorch version of K1 forward: [N, d] coords in [-1, 1] -> [N, out_lods*F],
    LODs 0..lod_idx computed, the remaining columns zero."""
    codebook_size = 2 ** codebook_bitwidth
    n, dim = coords.shape
    f_dim = codebook.shape[-1]
    offsets = torch.as_tensor(corner_offsets(dim), device=coords.device)      # [C, d]
    feats = []
    for i in range(lod_idx + 1):
        res = int(resolutions[i])
        x = torch.clamp((coords + 1.0) * (res / 2.0), 0.0, res - 1 - 1e-5)
        c0 = torch.floor(x)
        frac = x - c0
        corners = c0.to(torch.int64)[:, None, :] + offsets[None]              # [N, C, d]
        idx = hash_index(corners, res, codebook_size)                         # [N, C]
        level = codebook[codebook_first_idx[i]:codebook_first_idx[i] + codebook_sizes[i]]
        rows = level[idx]                                                     # [N, C, F]
        w = None
        for d in range(dim):
            wd = torch.where(offsets[None, :, d].bool(), frac[:, None, d],
                             1.0 - frac[:, None, d])
            w = wd if w is None else w * wd                                   # [N, C]
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


def hashgrid_bwd_plain(coords: torch.Tensor, grad_out: torch.Tensor, resolutions,
                       codebook_bitwidth: int, lod_idx: int, table_rows: int,
                       codebook_first_idx, codebook_sizes, out_lods: Optional[int] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of ``hashgrid_bwd``: autograd through ``hashgrid_plain``."""
    f_dim = grad_out.shape[1] // (out_lods if out_lods is not None else int(lod_idx) + 1)
    table = torch.zeros((table_rows, f_dim), dtype=torch.float32, device=coords.device,
                        requires_grad=True)
    with torch.enable_grad():
        out = hashgrid_plain(coords, resolutions, codebook_bitwidth, lod_idx, table,
                             codebook_first_idx, codebook_sizes, out_lods)
        (grad,) = torch.autograd.grad(out, table, grad_out)
    return grad


def hashgrid_bwd(coords: torch.Tensor, grad_out: torch.Tensor, resolutions,
                 codebook_bitwidth: int, lod_idx: int, table_rows: int, codebook_first_idx,
                 codebook_sizes, out_lods: Optional[int] = None) -> torch.Tensor:
    """K1 backward: the [table_rows, F] table gradient of ``hashgrid`` for the cotangent
    ``grad_out`` [N, out_lods*F] (LODs above ``lod_idx`` take none). The kernel on the
    card, the plain version on the CPU."""
    if not coords.is_cuda:
        return hashgrid_bwd_plain(coords, grad_out, resolutions, codebook_bitwidth, lod_idx,
                                  table_rows, codebook_first_idx, codebook_sizes, out_lods)
    f_dim = grad_out.shape[1] // (out_lods if out_lods is not None else int(lod_idx) + 1)
    grad = torch.zeros((table_rows, f_dim), dtype=torch.float32, device=coords.device)
    geometry = _lod_args(coords, grad, resolutions, codebook_bitwidth, lod_idx,
                         codebook_first_idx, codebook_sizes, out_lods)
    return _hashgrid_bwd(coords, grad_out, geometry, grad)


def _hashgrid_bwd(coords, grad_out, geometry, grad) -> torch.Tensor:
    """K1 backward into the zeroed table gradient ``grad``."""
    n = coords.shape[0]
    kernels.check(grad_out, "grad_out", torch.float32, (n, geometry[3] * geometry[1]))
    if n > 0:
        _launch("wisp_hashgrid_bwd", "hashgrid_bwd", coords, grad_out, n, geometry, grad)
    return grad


class _HashGridFn(torch.autograd.Function):
    """K1 forward with K1 backward as its gradient (the table's; coords get none)."""

    @staticmethod
    def forward(ctx, coords, codebook, geometry):
        ctx.save_for_backward(coords)
        ctx.geometry = geometry
        ctx.table_shape = codebook.shape
        return _hashgrid_fwd(coords, codebook, geometry)

    @staticmethod
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = torch.zeros(ctx.table_shape, dtype=torch.float32, device=coords.device)
            _hashgrid_bwd(coords, grad_out.contiguous(), ctx.geometry, grad)
        return None, grad, None


def hashgrid(coords: torch.Tensor, resolutions: Sequence[int], codebook_bitwidth: int,
             lod_idx: int, codebook: torch.Tensor, codebook_first_idx: Sequence[int],
             codebook_sizes: Sequence[int], out_lods: Optional[int] = None) -> torch.Tensor:
    """Multi-LOD hash interpolation: [N, d] -> [N, out_lods*F] with LODs 0..lod_idx
    computed and the columns of later LODs zero (``out_lods`` defaults to lod_idx+1, the
    JAX ``hashgrid`` output). Differentiable in ``codebook``. K1 on the card, the plain
    version on the CPU."""
    if not coords.is_cuda:
        return hashgrid_plain(coords, resolutions, codebook_bitwidth, lod_idx, codebook,
                              codebook_first_idx, codebook_sizes, out_lods)
    geometry = _lod_args(coords, codebook, resolutions, codebook_bitwidth, lod_idx,
                         codebook_first_idx, codebook_sizes, out_lods)
    return _HashGridFn.apply(coords, codebook, geometry)


def grid_interpolate(coords: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Blend of given corner features (JAX ``grid_interpolate``, :393): ``coords`` [N, d]
    in [0, 1]^d are the fractions inside the cell, ``feats`` [N, 2^d, F] the corner features
    in ``corner_offsets`` order. On the card the octree grid's kernel (K15) folds it in."""
    offsets = torch.as_tensor(corner_offsets(coords.shape[-1]), device=coords.device).bool()
    w = torch.where(offsets[None], coords[:, None, :], 1.0 - coords[:, None, :])
    return torch.sum(feats * torch.prod(w, dim=-1)[..., None].to(feats.dtype), dim=1)
