"""The triplane sample (K18): a point's bilinear samples of three orthogonal feature planes
a LOD, summed or concatenated over the LODs (counterpart of
wisp_tpu/models/grids/triplanar_grid.py ``_reflect`` :21, ``bilinear_sample`` :29,
``TriplanarFeatureVolume.__call__`` :70 and ``TriplanarGrid.interpolate`` :125).

A LOD holds three planes [W, W, F] (W = 2^l + 1): ``fmx`` sampled at (y, z), ``fmy`` at
(x, z), ``fmz`` at (x, y), the first coordinate of each pair along the plane's width. Both
coordinates are folded into [-1, 1] by JAX's ``_reflect``, |mod(x + 1, 4) - 2| - 1 with the
floor semantics of ``jnp.mod``: inside [-1, 1] it maps x to -x, so every plane is sampled at
negated coordinates (a fold the port keeps for parity; it is not ``grid_sample``'s
reflection padding, which is the identity there). Then x = (u + 1) * 0.5 * (W - 1), the
corners floor(x) clipped to [0, W - 1] and min(x0 + 1, W - 1), and the blend
p00 (1-fx)(1-fy) + p01 fx(1-fy) + p10 (1-fx) fy + p11 fx fy, in JAX's order.

``triplane_sample`` is the entry point: on a CPU tensor it runs ``triplane_sample_plain``
(PyTorch's autograd gives the planes' gradient); on a CUDA tensor it launches K18's
forward (``csrc/triplane.cu``) and, where a plane needs a gradient, goes through an
``autograd.Function`` whose backward launches K18's backward (``triplane_sample_bwd``).
The gradient with respect to the coordinates is not ported: asking for it on the card
raises (a NeRF's triplanar grid takes none, ``position_input: false``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from wisp_tpu_torch import kernels

MAX_LODS = 16  # LOD slots in the kernels' argument block (csrc/triplane.cu kMaxLods)

Planes = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def reflect(x: torch.Tensor, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """JAX's ``_reflect``: |mod(x - lo, 2 span) - span| + lo, ``torch.remainder`` taking
    ``jnp.mod``'s floor semantics."""
    span = hi - lo
    return torch.abs(torch.remainder(x - lo, 2 * span) - span) + lo


def bilinear_sample_plain(plane: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """Plane [H, W, F] at u (width) and v (height) in [-1, 1] after the fold: [N, F]."""
    h, w = plane.shape[:2]
    u = reflect(u)
    v = reflect(v)
    x = (u + 1.0) * 0.5 * (w - 1)
    y = (v + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x).to(torch.int32).clamp(0, w - 1)
    y0 = torch.floor(y).to(torch.int32).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = plane.reshape(h * w, plane.shape[-1])
    p00 = flat[(y0 * w + x0).long()]
    p01 = flat[(y0 * w + x1).long()]
    p10 = flat[(y1 * w + x0).long()]
    p11 = flat[(y1 * w + x1).long()]
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


def triplane_sample_plain(coords: torch.Tensor, planes: Planes, multiscale_type: str = "sum",
                          out_lods: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``triplane_sample``."""
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    feats = [torch.cat([bilinear_sample_plain(fmx, y, z), bilinear_sample_plain(fmy, x, z),
                        bilinear_sample_plain(fmz, x, y)], dim=-1) for fmx, fmy, fmz in planes]
    if multiscale_type == "sum":
        return torch.stack(feats, dim=1).sum(dim=1)
    pad = (len(planes) if out_lods is None else out_lods) - len(planes)
    if pad > 0:
        feats.append(feats[0].new_zeros((coords.shape[0], pad * feats[0].shape[1])))
    return torch.cat(feats, dim=-1)


def triplane_sample_bwd_plain(coords: torch.Tensor, shapes: Sequence[Tuple[int, int, int]],
                              multiscale_type: str, grad_out: torch.Tensor
                              ) -> List[torch.Tensor]:
    """Plain PyTorch version of ``triplane_sample_bwd``: autograd of
    ``triplane_sample_plain`` (linear in the planes, so zero planes give the same
    gradient)."""
    flat = [torch.zeros(s, dtype=torch.float32, device=coords.device, requires_grad=True)
            for s in shapes]
    with torch.enable_grad():
        planes = [tuple(flat[3 * i:3 * i + 3]) for i in range(len(flat) // 3)]
        width = grad_out.shape[1] // (3 * shapes[0][2])
        out = triplane_sample_plain(coords, planes, multiscale_type, out_lods=width)
        return list(torch.autograd.grad(out, flat, grad_out))


class _Planes(ctypes.Structure):
    """The LODs' planes as ``csrc/triplane.cu``'s ``Planes``: three pointers a LOD (fmx,
    fmy, fmz) and each LOD's plane width W."""
    _fields_ = [("p", ctypes.c_void_p * (3 * MAX_LODS)), ("w", ctypes.c_int * MAX_LODS)]


def _plane_block(tensors: Sequence[torch.Tensor], f_dim: int) -> _Planes:
    block = _Planes()
    for i, t in enumerate(tensors):
        w = t.shape[0]
        kernels.check(t, f"planes[{i}]", torch.float32, (w, w, f_dim))
        if i % 3:
            if w != block.w[i // 3]:
                raise ValueError(f"triplane: the planes of LOD {i // 3} differ in size")
        else:
            block.w[i // 3] = w
        block.p[i] = t.data_ptr()
    return block


def _check(coords, n_lods, multiscale_type, out_lods):
    if multiscale_type not in ("sum", "cat") or not 1 <= n_lods <= out_lods <= MAX_LODS:
        raise ValueError(f"triplane_sample: {multiscale_type!r} over {n_lods} of {out_lods} "
                         f"LODs")
    kernels.check(coords, "coords", torch.float32, (coords.shape[0], 3))


def _sample_fwd(coords, flat_planes, multiscale_type, out_lods):
    """Launch K18's forward."""
    n, n_lods, f_dim = coords.shape[0], len(flat_planes) // 3, flat_planes[0].shape[2]
    _check(coords, n_lods, multiscale_type, out_lods)
    block = _plane_block(flat_planes, f_dim)
    width = 3 * f_dim * (1 if multiscale_type == "sum" else out_lods)
    out = torch.empty((n, width), dtype=torch.float32, device=coords.device)
    if n:
        vec = kernels.vector_width(f_dim,
                                   [t.data_ptr() for t in flat_planes] + [out.data_ptr()])
        kernels.launch("wisp_triplane_fwd", "triplane_fwd", coords.data_ptr(), n, n_lods,
                       out_lods, f_dim, ctypes.addressof(block),
                       int(multiscale_type == "sum"), vec, out.data_ptr())
    return out


def triplane_sample_bwd(coords: torch.Tensor, shapes: Sequence[Tuple[int, int, int]],
                        multiscale_type: str, grad_out: torch.Tensor) -> List[torch.Tensor]:
    """The planes' gradient of ``triplane_sample`` (K18 backward) for the cotangent
    ``grad_out`` ([N, 3F] for 'sum', [N, 3F * out_lods] for 'cat'): one [W, W, F] float32
    table a plane, in the order of ``shapes`` (fmx, fmy, fmz a LOD), each row the sum over
    points of w_c * g. On the card the tables are views of one buffer that one fill
    zeroes; the kernel adds with atomics, in no fixed order."""
    if not coords.is_cuda:
        return triplane_sample_bwd_plain(coords, shapes, multiscale_type, grad_out)
    n, n_lods, f_dim = coords.shape[0], len(shapes) // 3, shapes[0][2]
    out_lods = 1 if multiscale_type == "sum" else grad_out.shape[1] // (3 * f_dim)
    _check(coords, n_lods, multiscale_type, max(out_lods, n_lods))
    kernels.check(grad_out, "grad_out", torch.float32, (n, 3 * f_dim * out_lods))
    sizes = [a * b * c for a, b, c in shapes]
    flat = torch.zeros((sum(sizes),), dtype=torch.float32, device=coords.device)
    grads = [t.view(s) for t, s in zip(torch.split(flat, sizes), shapes)]
    if n:
        block = _plane_block(grads, f_dim)
        vec = kernels.vector_width(f_dim, [g.data_ptr() for g in grads] + [grad_out.data_ptr()])
        kernels.launch("wisp_triplane_bwd", "triplane_bwd", coords.data_ptr(), n, n_lods,
                       max(out_lods, n_lods), f_dim, ctypes.addressof(block),
                       int(multiscale_type == "sum"), vec, grad_out.data_ptr())
    return grads


class _TriplaneSampleFn(torch.autograd.Function):
    """K18's forward with K18's backward kernel; saves the coordinates alone."""

    @staticmethod
    def forward(ctx, coords, multiscale_type, out_lods, *flat_planes):
        ctx.save_for_backward(coords)
        ctx.geometry = (multiscale_type, [tuple(p.shape) for p in flat_planes])
        return _sample_fwd(coords, flat_planes, multiscale_type, out_lods)

    @staticmethod
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        multiscale_type, shapes = ctx.geometry
        grads = triplane_sample_bwd(coords, shapes, multiscale_type,
                                    grad_out.float().contiguous())
        return (None,) * 3 + tuple(g if need else None
                                   for g, need in zip(grads, ctx.needs_input_grad[3:]))


def triplane_sample(coords: torch.Tensor, planes: Planes, multiscale_type: str = "sum",
                    out_lods: Optional[int] = None) -> torch.Tensor:
    """The triplane features of points ``coords`` [N, 3] float32 over the LODs of
    ``planes`` ((fmx, fmy, fmz) a LOD, each [W, W, F] float32): [N, 3F] ('sum', the LODs
    added in order) or [N, 3F * out_lods] ('cat', zeros past the given LODs; ``out_lods``
    defaults to their number). Differentiable in the planes."""
    n_lods = len(planes)
    out_lods = n_lods if out_lods is None else int(out_lods)
    if not coords.is_cuda:
        return triplane_sample_plain(coords, planes, multiscale_type, out_lods)
    flat = [p for lod in planes for p in lod]
    if torch.is_grad_enabled():
        if coords.requires_grad:
            raise NotImplementedError("triplane_sample: the gradient with respect to the "
                                      "coordinates is not ported; detach them")
        if any(p.requires_grad for p in flat):
            return _TriplaneSampleFn.apply(coords, multiscale_type, out_lods, *flat)
    return _sample_fwd(coords, flat, multiscale_type, out_lods)
