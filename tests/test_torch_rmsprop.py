"""The port's optimizer presets against the optax optimizers JAX builds from the same
presets: RMSprop (and SGD) over 5 steps on parameters whose gradients span 1e-7..1, to 1e-6
relative, plus 1e-6 of the largest parameter (an entry that crosses zero keeps the rounding
of its larger terms, which differs by an ulp between the packages). The control:
``torch.optim.RMSprop`` (sqrt(nu) + eps in the denominator) must fail the RMSprop
comparison."""

import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)

from wisp_tpu.config.presets import ConfigRMSprop as JConfigRMSprop
from wisp_tpu.config.presets import ConfigSGD as JConfigSGD
from wisp_tpu.config.utils import instantiate as jinstantiate

from wisp_tpu_torch.config.presets import ConfigRMSprop, ConfigSGD
from wisp_tpu_torch.config.utils import instantiate

RTOL = 1e-6
STEPS = 5


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _problem(seed=0, n=400):
    """Parameters ~N(0, 1) and 5 gradients of magnitude 10^U(-7, 0), random signs."""
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=(n,)).astype(np.float32)
    grads = [(rng.choice([-1.0, 1.0], size=n) * 10.0 ** rng.uniform(-7.0, 0.0, size=n))
             .astype(np.float32) for _ in range(STEPS)]
    return p0, grads


def _optax_run(tx, p0, grads):
    p = jnp.asarray(p0)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    return np.asarray(p)


def _torch_run(make, p0, grads):
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make([p])
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
    return p.detach().numpy()


KW = [dict(), dict(momentum=0.9), dict(weight_decay=1e-2), dict(momentum=0.5,
                                                                 weight_decay=1e-3)]


@pytest.mark.parametrize("kw", KW, ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items())
                         or "plain")
def test_rmsprop_matches_optax(kw):
    p0, grads = _problem()
    want = _optax_run(jinstantiate(JConfigRMSprop(**kw)), p0, grads)
    got = _torch_run(lambda ps: instantiate(ConfigRMSprop(**kw), params=ps), p0, grads)
    _assert_close(got, want)
    assert np.abs(want - p0).max() > 1e-3  # the steps moved the parameters


@pytest.mark.parametrize("kw", KW, ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items())
                         or "plain")
def test_sgd_matches_optax(kw):
    p0, grads = _problem(1)
    want = _optax_run(jinstantiate(JConfigSGD(lr=0.1, **kw)), p0, grads)
    got = _torch_run(lambda ps: instantiate(ConfigSGD(lr=0.1, **kw), params=ps), p0, grads)
    _assert_close(got, want)


def test_torch_rmsprop_fails_the_comparison():
    """torch.optim.RMSprop floors the denominator at eps (1e-8) where optax floors it at
    sqrt(eps) (1e-4): on gradients of 1e-7 it steps up to 10^4 times further."""
    p0, grads = _problem()
    cfg = JConfigRMSprop()
    want = _optax_run(jinstantiate(cfg), p0, grads)
    got = _torch_run(lambda ps: torch.optim.RMSprop(ps, lr=cfg.lr, alpha=cfg.alpha,
                                                    eps=cfg.eps), p0, grads)
    with pytest.raises(AssertionError):
        _assert_close(got, want)
    small = np.abs(np.stack(grads)).max(0) < 1e-6
    assert small.any()
    ratio = np.abs(got - p0)[small] / np.maximum(np.abs(want - p0)[small], 1e-30)
    assert ratio.max() > 100.0
