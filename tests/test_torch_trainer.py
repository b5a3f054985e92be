"""The port's trainer against the JAX package's, on the CPU.

* One step (loss, backward, AdamW with the grid's lr weight and the decoder's weight decay)
  on the same weights, rays and march jitter ``u`` (what the JAX step draws from its key).
  Without AMP: the loss to 1e-5, every gradient before the update to 1e-5 of its norm, and
  the updated parameters to 1e-5. With AMP (both decoders in bf16): the loss to 4e-7, a few
  float32 ulps, well under what float32 decoders change; every decoder gradient a bf16
  value, since its backward ran in bf16; every gradient's error norm within 2^-6 of JAX's
  (bf16 keeps 8 bits, and XLA and PyTorch sum the bf16 products in other orders, which
  shows most on a bias whose sum cancels); and the updated parameters to 2e-3. A control
  holds a float32 port to the same AMP comparison, which must fail. The first AdamW
  step moves a parameter by lr * g / (|g| + eps), which turns a rounding-level difference of
  a near-zero gradient into a step of up to the learning rate when eps is tiny; these tests
  set eps to 1e-4 so that the comparison holds the optimizer's arithmetic and not that
  amplification.
* The trainer's carried density-feedback grid after that step (K5) against JAX's, 1e-5
  (the densities come from two float32 forwards); K5 itself against JAX's scatter-max on
  the same inputs, exactly.
* ``prune`` with JAX's jitter and view directions injected: the occupancy bitfield equal
  except in cells whose keep-score lies within 1e-4 of ``prune_min_density``; the keep-score
  and the density field to 1e-5; with and without the grace streak.
* ``calc_adaptive_rays`` / ``calc_adaptive_compaction``: the same decisions on a scripted
  sequence of valid-sample counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.core import Rays as JRays
from wisp_tpu.config.presets import ConfigAdamW as JConfigAdamW
from wisp_tpu.datasets.transforms.ray_sampler import SampleRays as JSampleRays
from wisp_tpu.trainers.multiview_trainer import (ConfigMultiviewTrainer as JConfig,
                                                 MultiviewTrainer as JTrainer)
from wisp_tpu.trainers.tracker.tracker import ConfigTracker, Tracker as JTracker

from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
from wisp_tpu_torch.interop import build_pipeline
from wisp_tpu_torch.ops.density_grid import scatter_max
from wisp_tpu_torch.trainers.base_trainer import ConfigAdamW
from wisp_tpu_torch.trainers.multiview_trainer import ConfigMultiviewTrainer, MultiviewTrainer

from test_torch_helpers import (AMP_LOSS_TOL, amp_mismatches, grad_errors, jax_pipeline,
                                np_of, params_from_jax, ray_arrays)

TRAIN_KW = dict(grid_lr_weight=500.0, rgb_loss_type="huber", scheduler=True, max_epochs=4,
                valid_every=-1)
OPT_KW = dict(lr=1e-3, eps=1e-4, weight_decay=1e-2)


class _Views:
    """The little of a dataset that the trainers read in these tests."""
    cameras = {}

    def __init__(self, transform=None, n=2):
        self.transform = transform
        self.n = n

    def __len__(self):
        return self.n


def _trainers(tmp_path, amp=False, transforms=(None, None), with_port=True, **kw):
    """(JAX trainer, port trainer) on the same weights; without the port's, (JAX trainer,
    (params, config)) of the weights it started from."""
    jpipe = jax_pipeline(carve_seed=7, compaction=0.25, feature_std=0.1)
    params, config = params_from_jax(jpipe)
    cfg = dict(TRAIN_KW, **kw)
    jtracker = JTracker(ConfigTracker(log_dir=str(tmp_path), tensorboard=False), "parity")
    jt = JTrainer(JConfig(optimizer=JConfigAdamW(**OPT_KW), enable_amp=amp, **cfg), jpipe,
                  _Views(transforms[0]), tracker=jtracker)
    if not with_port:
        return jt, (params, config)
    tpipe = build_pipeline(params, config, device="cpu")
    tt = MultiviewTrainer(ConfigMultiviewTrainer(optimizer=ConfigAdamW(**OPT_KW),
                                                 enable_amp=amp, **cfg),
                          tpipe, _Views(transforms[1]), device="cpu")
    return jt, tt


def _jax_one_step(tmp_path, amp):
    """JAX's trainer takes one step on a seeded batch. Returns the starting weights (for
    the port), the step's jitter, loss and gradients (taken before its update), and what
    the step left: its logged loss, its updated weights and its density-feedback grid."""
    jt, (params, config) = _trainers(tmp_path, amp=amp, with_port=False)
    n = 128
    origins, dirs = ray_arrays(n, seed=21)
    rgb = np.random.default_rng(21).uniform(size=(n, 3)).astype(np.float32)
    jt.pre_training()  # builds the step function and its base key
    key = jax.random.fold_in(jt._step_base_key, np.uint32(jt.total_iterations))
    u = np.array(jax.random.uniform(key, (n, jt.pipeline.tracer.num_steps)))
    jrays = JRays(origins, dirs, 0.0, 8.0)
    batch = (jrays, jnp.asarray(rgb), np.int32(jt.total_iterations))

    def loss_of(diff):
        return jt.compute_loss(jt._spec.unflatten(diff, jt._nondiff), batch, key)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(dict(jt._diff))
    jgrads = {path: np.asarray(g) for path, g in jgrads.items()}
    jt.step({"rays": jrays, "rgb": rgb})
    jt._flush_stats()
    new, _ = params_from_jax(jt.sync_pipeline())
    return {"params": params, "config": config, "origins": origins, "dirs": dirs,
            "rgb": rgb, "u": u, "loss": float(jloss), "grads": jgrads,
            "logged_loss": jt.tracker.metrics.average_metric("total_loss"), "new": new,
            "density_max_grid": np.asarray(jt._density_max_grid)}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """JAX's one step by AMP setting, taken once for the tests that compare with it."""
    done = {}

    def get(amp):
        if amp not in done:
            done[amp] = _jax_one_step(tmp_path_factory.mktemp("jax"), amp)
        return done[amp]
    return get


def _one_step(jax_step, amp, port_amp=None):
    """The port's trainer takes JAX's step (``jax_step(amp)``) on the same weights, batch
    and jitter. Returns it with JAX's step."""
    j = jax_step(amp)
    tpipe = build_pipeline(j["params"], j["config"], device="cpu")
    port_amp = amp if port_amp is None else port_amp
    tt = MultiviewTrainer(ConfigMultiviewTrainer(optimizer=ConfigAdamW(**OPT_KW),
                                                 enable_amp=port_amp, **TRAIN_KW),
                          tpipe, _Views(), device="cpu")
    tt.pre_training()
    tt.step({"rays": Rays(torch.from_numpy(j["origins"]), torch.from_numpy(j["dirs"]), 0.0,
                          8.0), "rgb": torch.from_numpy(j["rgb"])},
            key=torch.from_numpy(j["u"]))
    return tt, j


@pytest.mark.parametrize("amp,loss_tol,param_tol", [(False, 1e-5, 1e-5),
                                                    (True, AMP_LOSS_TOL, 2e-3)])
def test_one_step_matches_jax(jax_step, amp, loss_tol, param_tol):
    tt, j = _one_step(jax_step, amp)
    jloss, jgrads = j["loss"], j["grads"]
    assert abs(jloss - j["logged_loss"]) <= 1e-6
    if amp:
        assert amp_mismatches(tt, jloss, jgrads) == []
    else:
        assert abs(jloss - tt.last_loss) <= loss_tol
        for name, (_, err) in grad_errors(tt, jgrads).items():
            assert err <= 1e-5, (name, err)
    for name, got in tt.pipeline.named_parameters():
        np.testing.assert_allclose(np_of(got), j["new"][name[len("nef."):]], atol=param_tol,
                                   rtol=0, err_msg=name)
    if not amp:
        # the density feedback the step carried for the next prune
        np.testing.assert_allclose(np_of(tt._density_max_grid), j["density_max_grid"],
                                   atol=1e-5, rtol=0)
        assert float(tt._density_max_grid.max()) > 0.0


def test_amp_comparison_fails_a_float32_port(jax_step):
    """The control: a port whose decoders stay in float32 fails the AMP comparison, on the
    loss and on every decoder gradient."""
    tt, j = _one_step(jax_step, amp=True, port_amp=False)
    bad = amp_mismatches(tt, j["loss"], j["grads"])
    assert "loss" in bad
    decoders = [name for name, _ in tt.pipeline.named_parameters() if "decoder" in name]
    assert decoders and all(f"{name} not bf16" in bad for name in decoders), bad


def test_scatter_max_matches_jax_exactly():
    rng = np.random.default_rng(3)
    ids = rng.integers(-5, 520, size=4000)
    vals = np.maximum(rng.normal(size=4000), 0.0).astype(np.float32)
    want = jnp.zeros((512,), jnp.float32).at[jnp.asarray(ids)].max(jnp.asarray(vals),
                                                                   mode="drop")
    # JAX's negative ids wrap around under "drop"; the port drops every id outside
    keep = ids >= 0
    want_in = jnp.zeros((512,), jnp.float32).at[jnp.asarray(ids[keep])].max(
        jnp.asarray(vals[keep]), mode="drop")
    got = scatter_max(torch.from_numpy(ids), torch.from_numpy(vals), 512)
    np.testing.assert_array_equal(np_of(got), np.asarray(want_in))
    assert np.asarray(want).shape == (512,)


@pytest.mark.parametrize("grace", [1, 2])
def test_prune_matches_jax(grace):
    jpipe = jax_pipeline(carve_seed=9, compaction=0.25, feature_std=0.5)
    nef = jpipe.nef
    cells = nef.grid.occupancy.shape[0]
    rng = np.random.default_rng(grace)
    occupancy = rng.uniform(0.0, 0.6, cells).astype(np.float32)
    streak = rng.integers(0, 2, cells).astype(np.int32)
    min_density = 1.0
    nef = nef.replace(prune_min_density=min_density, prune_grace=grace,
                      prune_streak=streak if grace > 1 else None,
                      grid=nef.grid.replace(occupancy=jnp.asarray(occupancy)))
    jpipe = jpipe.replace(nef=nef)
    params, config = params_from_jax(jpipe)
    tpipe = build_pipeline(params, config, device="cpu")
    sample_max = np.where(rng.random(cells) < 0.2, rng.uniform(0.0, 3.0, cells),
                          0.0).astype(np.float32)
    key = jax.random.PRNGKey(17)
    k1, k2 = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k1, (cells, 3)))
    views = jax.random.normal(k2, (cells, 3))
    views = np.array(views / jnp.linalg.norm(views, axis=-1, keepdims=True))

    jnew = jax.jit(lambda m, k, sm: m.prune(key=k, sample_max=sm))(
        nef, key, jnp.asarray(sample_max))
    tnef = tpipe.nef
    tnef.prune(sample_max=torch.from_numpy(sample_max), jitter=torch.from_numpy(jitter),
               views=torch.from_numpy(views))

    want_occ = np.asarray(jnew.grid.occupancy)
    np.testing.assert_allclose(np_of(tnef.grid.occupancy), want_occ, atol=1e-5, rtol=0)
    want_bits = np.asarray(jnew.grid.blas.occ_grid)
    got_bits = np_of(tnef.grid.blas.occ_grid)
    near = np.abs(want_occ - min_density) <= 1e-4
    assert 0.05 < want_bits.mean() < 0.95, "the threshold should split the cells"
    np.testing.assert_array_equal(got_bits[~near], want_bits[~near])
    dens_ok = ~near
    np.testing.assert_allclose(np_of(tnef.grid.blas.cell_density)[dens_ok],
                               np.asarray(jnew.grid.blas.cell_density)[dens_ok], atol=1e-5,
                               rtol=0)
    if grace > 1:
        np.testing.assert_array_equal(np_of(tnef.prune_streak)[~near],
                                      np.asarray(jnew.prune_streak)[~near])
    assert not tnef.grid.blas.dense


def test_adaptive_decisions_match_jax(tmp_path):
    jt, tt = _trainers(tmp_path, adaptive_compaction=True, target_sample_size=2 ** 14,
                       max_compacted_samples=2 ** 17,
                       transforms=(JSampleRays(4096), SampleRays(4096)))
    steps = jt.pipeline.tracer.num_steps
    # valid fractions: a dense start (grows the budget to the cap), a long sparse stretch
    # (the windowed shrink), a mid-size stretch, then a spike
    fracs = [0.6] * 3 + [0.02] * 40 + [0.1] * 10 + [0.3] * 2 + [0.004] * 36
    decisions = []
    for i, frac in enumerate(fracs):
        n_rays = jt.train_dataset.transform.num_samples
        assert n_rays == tt.train_dataset.transform.num_samples, i
        valid = max(1.0, float(int(frac * n_rays * steps)))
        jt.iteration = tt.iteration = i
        jt._prev_num_samples = valid
        jt.calc_adaptive_rays(n_rays)
        tt._prev_num_samples = valid
        tt.calc_adaptive_rays(n_rays)
        want = (jt.train_dataset.transform.num_samples, jt.pipeline.tracer.compaction)
        got = (tt.train_dataset.transform.num_samples, tt.pipeline.tracer.compaction)
        assert got == want, (i, frac, got, want)
        decisions.append(got)
    assert len(set(d[1] for d in decisions)) >= 3, "the script should retune the budget"
    assert len(set(d[0] for d in decisions)) >= 2, "the script should retune the rays"
