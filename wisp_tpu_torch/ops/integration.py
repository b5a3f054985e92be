"""Volume integration forward (K4; counterpart of wisp_tpu/tracers/packed_rf_tracer.py
PackedRFTracer.trace :258-274).

tau = sigma*delta*mask; sum_prev = cumsum(tau) - tau (the inclusive sum minus tau, as JAX
computes it); w = exp(-sum_prev)*(1-exp(-tau)); rgb = bg*(1-alpha) + sum w*c; alpha = sum w;
depth = sum w*t; hit = alpha > 0; each extra channel alpha * sum w*f. On a CUDA tensor
``integrate`` launches ``csrc/integrate.cu``, on a CPU tensor it runs ``integrate_plain``.

``integrate`` is differentiable in density, colour and the extra channels (each extra
output alpha * sum w*f passes its cotangent to the weights, so to density, and to f): on
the card its backward is K4 backward (``integrate_bwd``, with the extra columns where the
call has them), on the CPU autograd through the plain version.

``integrate_segment`` is one depth segment of the segmented trace (K6b forward, K6c
backward; packed_rf_tracer.py _trace_segmented :362-375, :385): the same compositing with
the optical depth ``acc_tau`` [R] of the segments before carried into the exponent,
w = exp(-(acc_tau + sum_prev))*(1-exp(-tau)). It returns the segment's partial sums (rgb
without background, alpha, depth, extra columns not scaled by alpha) and ``acc_tau`` plus
the segment's optical depth, and is differentiable in density, colour and ``acc_tau``, so
that autograd chains the segments; the extra columns take no gradient there (ROADMAP
Queue 3): the call raises where one would need it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from wisp_tpu_torch import kernels

MAX_EXTRA = 16  # extra channel columns the kernel integrates


def integrate_plain(density, deltas, depths, mask, color, bg_color: Sequence[float],
                    extra: Optional[torch.Tensor] = None, with_depth: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of ``integrate``."""
    tau = density * deltas.reshape(-1, 1) * mask.to(density.dtype)
    sum_prev = torch.cumsum(tau, dim=-1) - tau
    w = torch.exp(-sum_prev) * (1.0 - torch.exp(-tau))
    bg = torch.as_tensor(bg_color, dtype=color.dtype, device=color.device)
    alpha = torch.sum(w, dim=-1, keepdim=True)
    out = {"rgb": bg[None, :] * (1.0 - alpha) + torch.sum(w[..., None] * color, dim=1),
           "alpha": alpha, "hit": alpha > 0.0}
    if with_depth:
        out["depth"] = torch.sum(w * depths, dim=-1, keepdim=True)
    if extra is not None:
        out["extra"] = alpha * torch.sum(w[..., None] * extra, dim=1)
    return out


def _out_keys(with_depth: bool, extra) -> tuple:
    """The outputs of ``integrate`` in the order the autograd Function returns them."""
    return ("rgb", "alpha", "hit") + (("depth",) if with_depth else ()) \
        + (("extra",) if extra is not None else ())


def _integrate_fwd(density, deltas, depths, mask, color, bg_color, extra, with_depth):
    r, s = density.shape
    kernels.check(density, "density", torch.float32, (r, s))
    kernels.check(deltas, "deltas", torch.float32, (r,))
    kernels.check(depths, "depths", torch.float32, (r, s))
    kernels.check(mask, "mask", torch.bool, (r, s))
    kernels.check(color, "color", torch.float32, (r, s, 3))
    ce = 0
    if extra is not None:
        ce = extra.shape[-1]
        kernels.check(extra, "extra", torch.float32, (r, s, ce))
        if not 0 < ce <= MAX_EXTRA:
            raise ValueError(f"integrate: 1..{MAX_EXTRA} extra columns, got {ce}")
    if len(bg_color) != 3:
        raise ValueError("integrate: bg_color needs 3 values")
    shapes = {"rgb": (3, torch.float32), "alpha": (1, torch.float32), "hit": (1, torch.bool),
              "depth": (1, torch.float32), "extra": (ce, torch.float32)}
    out = {k: torch.empty((r, shapes[k][0]), dtype=shapes[k][1], device=density.device)
           for k in _out_keys(with_depth, extra)}
    kernels.launch("wisp_integrate_fwd", "integrate_fwd", density.data_ptr(),
                   deltas.data_ptr(), depths.data_ptr(), mask.data_ptr(), color.data_ptr(),
                   kernels.ptr(extra), r, s, ce, *(float(b) for b in bg_color),
                   out["rgb"].data_ptr(), out["alpha"].data_ptr(),
                   kernels.ptr(out.get("depth")), out["hit"].data_ptr(),
                   kernels.ptr(out.get("extra")))
    return out


def integrate_bwd_plain(density, deltas, depths, mask, color, bg_color, g_rgb,
                        g_alpha=None, g_depth=None, extra=None, g_extra=None):
    """Plain PyTorch version of ``integrate_bwd``: autograd through ``integrate_plain``."""
    with torch.enable_grad():
        d = density.detach().requires_grad_(True)
        c = color.detach().requires_grad_(True)
        e = None if extra is None else extra.detach().requires_grad_(True)
        out = integrate_plain(d, deltas, depths, mask, c, bg_color, e,
                              with_depth=g_depth is not None)
        outs, grads = [], []
        for name, g in (("rgb", g_rgb), ("alpha", g_alpha), ("depth", g_depth),
                        ("extra", g_extra)):
            if g is not None:
                outs.append(out[name])
                grads.append(g.reshape(out[name].shape))
        inputs = (d, c) if e is None else (d, c, e)
        got = torch.autograd.grad(outs, inputs, grads, allow_unused=True)
    got = tuple(torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs))
    return got


def integrate_bwd(density, deltas, depths, mask, color, bg_color, g_rgb,
                  g_alpha=None, g_depth=None, extra=None, g_extra=None):
    """K4 backward: the gradients of density [R, S] and colour [R, S, 3] from the
    cotangents of rgb [R, 3], alpha [R, 1] and depth [R, 1] (each may be None: zero); with
    ``extra`` [R, S, Ce] and its output's cotangent ``g_extra`` [R, Ce] (both or neither),
    also the gradient of ``extra``, and the extra output's share in density's. The kernel
    on the card, the plain version on the CPU."""
    if (extra is None) != (g_extra is None):
        raise ValueError("integrate_bwd: extra and g_extra go together")
    if not density.is_cuda:
        return integrate_bwd_plain(density, deltas, depths, mask, color, bg_color, g_rgb,
                                   g_alpha, g_depth, extra, g_extra)
    r, s = density.shape
    deltas = deltas.reshape(-1)
    kernels.check(density, "density", torch.float32, (r, s))
    kernels.check(deltas, "deltas", torch.float32, (r,))
    kernels.check(depths, "depths", torch.float32, (r, s))
    kernels.check(mask, "mask", torch.bool, (r, s))
    kernels.check(color, "color", torch.float32, (r, s, 3))
    ce = 0
    if extra is not None:
        ce = extra.shape[-1]
        kernels.check(extra, "extra", torch.float32, (r, s, ce))
        if not 0 < ce <= MAX_EXTRA:
            raise ValueError(f"integrate_bwd: 1..{MAX_EXTRA} extra columns, got {ce}")
    gs = []
    for name, g, width in (("g_rgb", g_rgb, 3), ("g_alpha", g_alpha, 1),
                           ("g_depth", g_depth, 1), ("g_extra", g_extra, ce)):
        if g is not None:
            g = g.reshape(r, width).contiguous()
            kernels.check(g, name, torch.float32, (r, width))
        gs.append(g)
    if len(bg_color) != 3:
        raise ValueError("integrate_bwd: bg_color needs 3 values")
    if s > 8 * 1024:
        raise ValueError(f"integrate_bwd: at most 8192 steps a ray, got {s}")
    grad_density = torch.empty((r, s), dtype=torch.float32, device=density.device)
    grad_color = torch.empty((r, s, 3), dtype=torch.float32, device=density.device)
    grad_extra = None if extra is None else torch.empty_like(extra)
    kernels.launch("wisp_integrate_bwd", "integrate_bwd", density.data_ptr(),
                   deltas.data_ptr(), depths.data_ptr(), mask.data_ptr(), color.data_ptr(),
                   kernels.ptr(extra), r, s, ce, *(float(b) for b in bg_color),
                   *(kernels.ptr(g) for g in gs), grad_density.data_ptr(),
                   grad_color.data_ptr(), kernels.ptr(grad_extra))
    if extra is None:
        return grad_density, grad_color
    return grad_density, grad_color, grad_extra


class _IntegrateFn(torch.autograd.Function):
    """K4 forward with K4 backward as the gradient of density, colour and the extra
    channels (hit: none)."""

    @staticmethod
    def forward(ctx, density, color, deltas, depths, mask, bg_color, extra, with_depth):
        out = _integrate_fwd(density, deltas, depths, mask, color, bg_color, extra,
                             with_depth)
        ctx.save_for_backward(density, color, deltas, depths, mask, extra)
        ctx.bg_color = bg_color
        ctx.keys = tuple(out)
        ctx.mark_non_differentiable(out["hit"])
        ctx.set_materialize_grads(False)
        return tuple(out.values())

    @staticmethod
    def backward(ctx, *grads):
        density, color, deltas, depths, mask, extra = ctx.saved_tensors
        g = dict(zip(ctx.keys, grads))
        g_extra = g.get("extra")
        if g_extra is None:
            extra = None
        elif extra is not None:
            g_extra = g_extra.contiguous()
        got = integrate_bwd(density, deltas, depths, mask, color, ctx.bg_color, g.get("rgb"),
                            g.get("alpha"), g.get("depth"), extra, g_extra)
        ge = got[2] if len(got) > 2 else None
        return got[0], got[1], None, None, None, None, ge, None


def integrate(density: torch.Tensor, deltas: torch.Tensor, depths: torch.Tensor,
              mask: torch.Tensor, color: torch.Tensor, bg_color: Sequence[float],
              extra: Optional[torch.Tensor] = None, with_depth: bool = True
              ) -> Dict[str, torch.Tensor]:
    """Composite per-sample density [R, S], colour [R, S, 3] and optional extra channels
    [R, S, Ce] along each ray; ``deltas`` is the per-ray step [R] or [R, 1]. Returns rgb
    [R, 3], alpha [R, 1], hit [R, 1] bool, depth [R, 1] (if ``with_depth``) and extra
    [R, Ce] (if given). Differentiable in density, colour and ``extra``."""
    if not density.is_cuda:
        return integrate_plain(density, deltas, depths, mask, color, bg_color, extra,
                               with_depth)
    deltas = deltas.reshape(-1)
    bg_color = tuple(float(b) for b in bg_color)
    # without a gradient to take (rendering runs under no_grad) apply() records no graph
    outs = _IntegrateFn.apply(density, color, deltas, depths, mask, bg_color, extra,
                              with_depth)
    return dict(zip(_out_keys(with_depth, extra), outs))


# -- one segment of the segmented trace (K6b, K6c) ---------------------------------------------

def _seg_keys(with_depth: bool, extra) -> tuple:
    """The outputs of ``integrate_segment`` in the order the autograd Function returns them."""
    return ("rgb", "alpha", "acc_tau") + (("depth",) if with_depth else ()) \
        + (("extra",) if extra is not None else ())


def integrate_segment_plain(density, deltas, depths, mask, color, acc_tau,
                            extra: Optional[torch.Tensor] = None, with_depth: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of ``integrate_segment`` (JAX's scan body, :362-375, :385)."""
    tau = density * deltas.reshape(-1, 1) * mask.to(density.dtype)
    sum_prev = torch.cumsum(tau, dim=-1) - tau
    w = torch.exp(-(acc_tau[:, None] + sum_prev)) * (1.0 - torch.exp(-tau))
    out = {"rgb": torch.sum(w[..., None] * color, dim=1),
           "alpha": torch.sum(w, dim=-1, keepdim=True),
           "acc_tau": acc_tau + torch.sum(tau, dim=-1)}
    if with_depth:
        out["depth"] = torch.sum(w * depths, dim=-1, keepdim=True)
    if extra is not None:
        out["extra"] = torch.sum(w[..., None] * extra, dim=1)
    return out


def _check_seg(density, deltas, depths, mask, color, acc_tau):
    r, s = density.shape
    kernels.check(density, "density", torch.float32, (r, s))
    kernels.check(deltas, "deltas", torch.float32, (r,))
    kernels.check(depths, "depths", torch.float32, (r, s))
    kernels.check(mask, "mask", torch.bool, (r, s))
    kernels.check(color, "color", torch.float32, (r, s, 3))
    kernels.check(acc_tau, "acc_tau", torch.float32, (r,))
    if s > 8 * 1024:
        raise ValueError(f"integrate_segment: at most 8192 steps a segment, got {s}")
    return r, s


def _integrate_seg_fwd(density, deltas, depths, mask, color, acc_tau, extra, with_depth):
    r, s = _check_seg(density, deltas, depths, mask, color, acc_tau)
    ce = 0
    if extra is not None:
        ce = extra.shape[-1]
        kernels.check(extra, "extra", torch.float32, (r, s, ce))
        if not 0 < ce <= MAX_EXTRA:
            raise ValueError(f"integrate_segment: 1..{MAX_EXTRA} extra columns, got {ce}")
    widths = {"rgb": 3, "alpha": 1, "acc_tau": None, "depth": 1, "extra": ce}
    out = {k: torch.empty((r,) if widths[k] is None else (r, widths[k]),
                          dtype=torch.float32, device=density.device)
           for k in _seg_keys(with_depth, extra)}
    kernels.launch("wisp_integrate_seg_fwd", "integrate_seg_fwd", density.data_ptr(),
                   deltas.data_ptr(), depths.data_ptr(), mask.data_ptr(), color.data_ptr(),
                   kernels.ptr(extra), acc_tau.data_ptr(), r, s, ce, out["rgb"].data_ptr(),
                   out["alpha"].data_ptr(), kernels.ptr(out.get("depth")),
                   kernels.ptr(out.get("extra")), out["acc_tau"].data_ptr())
    return out


def integrate_segment_bwd_plain(density, deltas, depths, mask, color, acc_tau, g_rgb,
                                g_alpha=None, g_depth=None, g_acc=None):
    """Plain PyTorch version of ``integrate_segment_bwd``: autograd through
    ``integrate_segment_plain``."""
    with torch.enable_grad():
        d = density.detach().requires_grad_(True)
        c = color.detach().requires_grad_(True)
        a = acc_tau.detach().requires_grad_(True)
        out = integrate_segment_plain(d, deltas, depths, mask, c, a,
                                      with_depth=g_depth is not None)
        outs, grads = [], []
        for name, g in (("rgb", g_rgb), ("alpha", g_alpha), ("depth", g_depth),
                        ("acc_tau", g_acc)):
            if g is not None:
                outs.append(out[name])
                grads.append(g.reshape(out[name].shape))
        gd, gc, ga = torch.autograd.grad(outs, (d, c, a), grads, allow_unused=True)
    return (torch.zeros_like(density) if gd is None else gd,
            torch.zeros_like(color) if gc is None else gc,
            torch.zeros_like(acc_tau) if ga is None else ga)


def integrate_segment_bwd(density, deltas, depths, mask, color, acc_tau, g_rgb,
                          g_alpha=None, g_depth=None, g_acc=None):
    """K6c: the gradients of density [R, S], colour [R, S, 3] and ``acc_tau`` [R] from the
    cotangents of the segment's rgb [R, 3], alpha [R, 1], depth [R, 1] and ``acc_tau`` out
    [R] (each may be None: zero). The kernel on the card, the plain version on the CPU."""
    if not density.is_cuda:
        return integrate_segment_bwd_plain(density, deltas, depths, mask, color, acc_tau,
                                           g_rgb, g_alpha, g_depth, g_acc)
    deltas = deltas.reshape(-1)
    r, s = _check_seg(density, deltas, depths, mask, color, acc_tau)
    gs = []
    for name, g, width in (("g_rgb", g_rgb, 3), ("g_alpha", g_alpha, 1),
                           ("g_depth", g_depth, 1), ("g_acc", g_acc, 1)):
        if g is not None:
            g = g.reshape(r, width).contiguous()
            kernels.check(g, name, torch.float32, (r, width))
        gs.append(g)
    grad_density = torch.empty((r, s), dtype=torch.float32, device=density.device)
    grad_color = torch.empty((r, s, 3), dtype=torch.float32, device=density.device)
    grad_acc = torch.empty((r,), dtype=torch.float32, device=density.device)
    kernels.launch("wisp_integrate_seg_bwd", "integrate_seg_bwd", density.data_ptr(),
                   deltas.data_ptr(), depths.data_ptr(), mask.data_ptr(), color.data_ptr(),
                   acc_tau.data_ptr(), r, s, *(kernels.ptr(g) for g in gs),
                   grad_density.data_ptr(), grad_color.data_ptr(), grad_acc.data_ptr())
    return grad_density, grad_color, grad_acc


class _IntegrateSegmentFn(torch.autograd.Function):
    """K6b forward with K6c as the gradient of density, colour and the carried acc_tau
    (extra channels: none)."""

    @staticmethod
    def forward(ctx, density, color, acc_tau, deltas, depths, mask, extra, with_depth):
        out = _integrate_seg_fwd(density, deltas, depths, mask, color, acc_tau, extra,
                                 with_depth)
        ctx.save_for_backward(density, color, acc_tau, deltas, depths, mask)
        ctx.keys = tuple(out)
        if "extra" in out:
            ctx.mark_non_differentiable(out["extra"])
        ctx.set_materialize_grads(False)
        return tuple(out.values())

    @staticmethod
    def backward(ctx, *grads):
        density, color, acc_tau, deltas, depths, mask = ctx.saved_tensors
        g = dict(zip(ctx.keys, grads))
        gd, gc, ga = integrate_segment_bwd(density, deltas, depths, mask, color, acc_tau,
                                           g.get("rgb"), g.get("alpha"), g.get("depth"),
                                           g.get("acc_tau"))
        return gd, gc, ga, None, None, None, None, None


def integrate_segment(density: torch.Tensor, deltas: torch.Tensor, depths: torch.Tensor,
                      mask: torch.Tensor, color: torch.Tensor, acc_tau: torch.Tensor,
                      extra: Optional[torch.Tensor] = None, with_depth: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """Composite one depth segment: density [R, S], colour [R, S, 3], optional extra
    [R, S, Ce], the per-ray step ``deltas`` [R] or [R, 1] and the optical depth ``acc_tau``
    [R] carried from the segments before. Returns the partial rgb [R, 3] (no background),
    alpha [R, 1], ``acc_tau`` [R] (carried plus this segment's), depth [R, 1] (if
    ``with_depth``) and the extra columns' partial sums [R, Ce] (if given). Differentiable
    in density, colour and ``acc_tau``, not in ``extra``."""
    if extra is not None and extra.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("integrate_segment: extra channels take no gradient in the "
                                  "segmented trace (not ported, ROADMAP Queue 3); pass them "
                                  "detached")
    if not density.is_cuda:
        return integrate_segment_plain(density, deltas, depths, mask, color, acc_tau, extra,
                                       with_depth)
    outs = _IntegrateSegmentFn.apply(density, color, acc_tau, deltas.reshape(-1), depths,
                                     mask, extra, with_depth)
    return dict(zip(_seg_keys(with_depth, extra), outs))
