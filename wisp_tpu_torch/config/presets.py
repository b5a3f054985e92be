"""Optimizer presets (counterpart of wisp_tpu/config/presets.py, whose presets build optax
transforms). Each preset's target builds a ``torch.optim`` optimizer over the trainer's
parameter groups, with the update of the optax optimizer JAX builds from the same preset:

* ``ConfigAdam``: ``optax.adam``, or ``optax.adamw`` when weight_decay > 0, as JAX's
  ``_adam``: ``torch.optim.AdamW`` (with weight decay 0 its update is Adam's);
* ``ConfigAdamW``: ``optax.adamw``: ``torch.optim.AdamW``;
* ``ConfigRMSprop``: ``optax.rmsprop`` with ``add_decayed_weights`` chained before it:
  ``RMSprop`` below. ``torch.optim.RMSprop`` divides by sqrt(nu) + eps where optax
  multiplies by rsqrt(nu + eps), so it would step up to 10^4 times further on gradients
  of 1e-7 at eps 1e-8; it is not used;
* ``ConfigSGD``: ``optax.sgd`` with ``add_decayed_weights`` before it:
  ``torch.optim.SGD``, whose momentum buffer (g + m * buf, then the learning rate) and
  coupled weight decay are optax's.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from wisp_tpu_torch.config.utils import configure


class RMSprop(torch.optim.Optimizer):
    """``optax.chain(optax.add_decayed_weights(weight_decay), optax.rmsprop(lr, decay=alpha,
    eps=eps, momentum=momentum or None))``, group by group:

    g <- g + weight_decay * p;  nu <- (1 - alpha) * g^2 + alpha * nu (nu_0 = 0, no bias
    correction);  u = lr * g * rsqrt(nu + eps);  with momentum, trace <- u + momentum *
    trace and u = trace;  p <- p - u."""

    def __init__(self, params: Iterable, lr: float = 1e-3, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0, weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or not 0.0 <= alpha <= 1.0 or momentum < 0.0 \
                or weight_decay < 0.0:
            raise ValueError(f"RMSprop: bad lr {lr}, alpha {alpha}, eps {eps}, momentum "
                             f"{momentum} or weight_decay {weight_decay}")
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, alpha, eps = group["lr"], group["alpha"], group["eps"]
            momentum, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd > 0.0:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum > 0.0:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - alpha) * (g * g) + alpha * nu)
                update = torch.rsqrt(nu + eps) * g * lr
                if momentum > 0.0:
                    trace = state["trace"]
                    trace.copy_(update + momentum * trace)
                    update = trace
                p.sub_(update)
        return loss


def _adam(params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
          eps: float = 1e-8, weight_decay: float = 0.0):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _rmsprop(params, lr: float = 1e-3, alpha: float = 0.99, eps: float = 1e-8,
             momentum: float = 0.0, weight_decay: float = 0.0):
    return RMSprop(params, lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                   weight_decay=weight_decay)


def _sgd(params, lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0):
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


@configure(target=_adam, name="Adam")
class ConfigAdam:
    """Adam (AdamW when weight_decay > 0, as JAX's preset)."""
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0


@configure(target=_adam, name="AdamW")
class ConfigAdamW:
    """AdamW."""
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-2


@configure(target=_rmsprop, name="RMSprop")
class ConfigRMSprop:
    """RMSprop with optax's update (see ``RMSprop``)."""
    lr: float = 1e-3
    alpha: float = 0.99
    eps: float = 1e-8
    momentum: float = 0.0
    weight_decay: float = 0.0


@configure(target=_sgd, name="SGD")
class ConfigSGD:
    """SGD with optax's momentum and coupled weight decay."""
    lr: float = 1e-3
    momentum: float = 0.0
    weight_decay: float = 0.0
