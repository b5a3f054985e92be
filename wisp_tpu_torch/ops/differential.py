"""Finite-difference gradients of scalar fields (counterpart of
wisp_tpu/ops/differential.py ``finitediff_gradient``; the sphere tracer's normals)."""

from __future__ import annotations

import torch


def finitediff_gradient(x: torch.Tensor, f, eps: float = 0.005) -> torch.Tensor:
    """Central differences, 6 taps: [N, 3] gradient of the first output of ``f`` at x."""
    n = x.shape[0]
    e = torch.eye(3, dtype=x.dtype, device=x.device) * eps
    # a tensor divisor: true division, as JAX divides (see ops/geometric.py)
    two_eps = torch.full((1, 1), 2 * eps, dtype=x.dtype, device=x.device)
    grads = []
    for i in range(3):
        hi = f(x + e[i]).reshape(n, -1)[:, :1]
        lo = f(x - e[i]).reshape(n, -1)[:, :1]
        grads.append((hi - lo) / two_eps)
    return torch.cat(grads, dim=-1)
