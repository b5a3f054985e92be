"""The port's SDF training path against the JAX package, on the CPU (every kernel wrapper
takes its plain version here).

* K15's backward route: the feature gradients of ``OctreeGrid.interpolate`` against
  ``jax.grad`` of JAX's, for 'sum' and 'cat', the first and the last LOD, with points in
  empty cells, to 1e-5 of the largest entry (the corner sums are taken in other orders).
* ``OctreeSampledSDFDataset`` at level 4: the same coords as JAX's exactly (the same host
  draws and the same octree query), the sdf to 1e-5 with a sign flip allowed only where
  |d| < 1e-5 (see tests/test_torch_mesh_sdf.py).
* One ``SDFTrainer`` step on the same weights (JAX's seeded init, whose loss is of order
  0.1; under the sphere decoder of ``interop`` the residuals would lie at bf16's rounding
  scale and the AMP gradients would be rounding noise) and batch indices. Without AMP: the loss,
  every gradient before the update (to 1e-5 of its norm) and the updated parameters to
  1e-5. With AMP: the standard of tests/test_torch_trainer.py's AMP case: every decoder
  gradient a bf16 value, since its backward ran in bf16; every gradient's error norm
  within 2^-6 of JAX's, since bf16 keeps 8 bits and XLA and PyTorch sum the bf16 products
  in other orders; the updated parameters to 2e-3; and the loss to 4e-7, a few float32
  ulps. Here the loss is the squared error of the decoder's bf16 output itself, which
  JAX's compiled step leaves unrounded (XLA drops the output cast's round trip through
  bf16), so the port's loss is held to the loss of JAX's predictions rounded to bf16 as
  the function is written, and that to the compiled loss within what half a bf16 ulp a
  prediction allows. A float32 port must fail the comparison. Both
  set Adam's eps to 1e-4: the first step moves a parameter by lr * g / (|g| + eps), which
  with a tiny eps turns a rounding-level difference of a near-zero gradient into a step of
  up to the learning rate.
* ``validate()`` on the same weights (float32 decoders): both IoUs within 1e-3 of JAX's
  (the narrowband one on a common ground truth, see the test).
* The default optimizer: the port's default trainer config and JAX's build the same
  update rule (Adam, no weight decay).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import (amp_mismatches, grad_errors, jax_sdf_pipeline, np_of,
                                sdf_params_from_jax, sphere_octree_points, with_decoder)

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.config.presets import ConfigAdam as JConfigAdam
from wisp_tpu.config.utils import instantiate
from wisp_tpu.datasets.formats.octree_sampled_sdf import \
    OctreeSampledSDFDataset as JDataset
from wisp_tpu.models.grids import OctreeGrid as JOctreeGrid
from wisp_tpu.trainers.base_trainer import ConfigBaseTrainer as JConfigBase
from wisp_tpu.trainers.sdf_trainer import ConfigSDFTrainer as JConfig, SDFTrainer as JTrainer
from wisp_tpu.trainers.tracker.tracker import ConfigTracker, Tracker as JTracker

from wisp_tpu_torch import interop
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.datasets.formats.octree_sampled_sdf import OctreeSampledSDFDataset
from wisp_tpu_torch.models.grids.octree_grid import OctreeGrid
from wisp_tpu_torch.ops.sdf.metrics import compute_sdf_iou
from wisp_tpu_torch.trainers.base_trainer import BaseTrainer, ConfigAdam, ConfigBaseTrainer
from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer

DATA_KW = dict(sample_mode=["rand", "near", "near", "trace", "trace"], num_samples=2000,
               samples_per_voxel=2, seed=3)
TRAIN_KW = dict(batch_size=256, max_epochs=2, only_last=True, resample=True,
                grid_lr_weight=1.0)
SDF_ATOL = 1e-5


# -- K15's backward: the feature gradients ------------------------------------------------

@pytest.fixture(scope="module")
def octrees():
    q = sphere_octree_points(5, num_samples=50_000)
    return (JOctreeAS.from_quantized_points(q, 5),
            OctreeAS.from_quantized_points(q, 5, device="cpu"))


def _grad_points(n, seed):
    """Half near the sphere's surface (occupied cells), half anywhere (mostly empty)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n // 2, 3))
    near = 0.9 * u / np.linalg.norm(u, axis=-1, keepdims=True) \
        + rng.normal(scale=0.02, size=(n // 2, 3))
    return np.concatenate([near, rng.uniform(-1.05, 1.05, (n - n // 2, 3))]).astype(np.float32)


@pytest.mark.parametrize("multiscale,lod_idx", [("sum", 0), ("sum", 2), ("cat", 0),
                                                ("cat", 2)])
def test_feature_gradients_match_jax(octrees, multiscale, lod_idx):
    jblas, blas = octrees
    jgrid = JOctreeGrid(blas=jblas, feature_dim=16, num_lods=3, multiscale_type=multiscale,
                        feature_std=0.5, key=jax.random.PRNGKey(lod_idx))
    grid = OctreeGrid(blas=blas, feature_dim=16, num_lods=3, multiscale_type=multiscale,
                      device="cpu")
    with torch.no_grad():
        for f, jf in zip(grid.features, jgrid.features):
            f.copy_(torch.from_numpy(np.array(jf)))
    pts = _grad_points(3000, seed=lod_idx)
    width = 16 * (lod_idx + 1) if multiscale == "cat" else 16
    cot = np.random.default_rng(7).normal(size=(3000, width)).astype(np.float32)

    def loss(feats):
        out = jgrid.replace(features=feats).interpolate(jnp.asarray(pts), lod_idx)
        return jnp.sum(out * cot)

    want = jax.jit(jax.grad(loss))(list(jgrid.features))
    out = grid.interpolate(torch.from_numpy(pts), lod_idx)
    out.backward(torch.from_numpy(cot))
    empty = (np_of(out) == 0).all(axis=-1)
    assert empty.any() and not empty.all()
    for i, (f, w) in enumerate(zip(grid.features, want)):
        w = np.asarray(w)
        got = np.zeros_like(w) if f.grad is None else np_of(f.grad)
        if i > lod_idx:
            assert not w.any() and not got.any()
            continue
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(got, w, atol=1e-5 * scale, rtol=0, err_msg=str(i))


def test_frozen_grid_has_no_feature_gradient(octrees):
    grid = OctreeGrid(blas=octrees[1], feature_dim=16, num_lods=3, multiscale_type="sum",
                      feature_std=0.5, device="cpu").freeze()
    out = grid.interpolate(torch.from_numpy(_grad_points(200, seed=9)), 2)
    assert not out.requires_grad
    assert all(f.grad is None for f in grid.features)


# -- the dataset, one trainer step, validation ---------------------------------------------

@pytest.fixture(scope="module")
def sdf_setup():
    """A JAX NGLOD pipeline at level 4 (3 LODs, hidden 32, its own seeded init) carrying an
    icosphere, the port's pipeline with the same weights, and each one's dataset. The
    icosphere has subdivisions 1: 80 triangles keep the exact distances of the datasets
    and of the volumetric IoU cheap on the CPU."""
    jpipe = jax_sdf_pipeline(level=4, num_lods=3, hidden_dim=32, with_mesh=True,
                             subdivisions=1)
    params, config = sdf_params_from_jax(jpipe)
    jdata = JDataset(blas=jpipe.nef.grid.blas, **DATA_KW)
    tdata = OctreeSampledSDFDataset(blas=interop.build_sdf_pipeline(
        params, config, device="cpu").nef.grid.blas, device="cpu", **DATA_KW)
    return jpipe, params, config, jdata, tdata


def test_dataset_matches_jax(sdf_setup):
    _, _, _, jdata, tdata = sdf_setup
    assert len(tdata) == len(jdata) > 1000
    np.testing.assert_array_equal(np_of(tdata.coordinates), jdata.coordinates)
    got, want = np_of(tdata.sdf_data)[:, 0], jdata.sdf_data[:, 0]
    flip = (got < 0) != (want < 0)
    assert (np.abs(want[flip]) < SDF_ATOL).all()
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=SDF_ATOL, rtol=0)
    np.testing.assert_allclose(got[~flip], want[~flip], atol=SDF_ATOL, rtol=0)
    assert (want < 0).any() and (want > 0).any()
    batch = tdata[np.asarray([0, 5, 5])]
    assert tuple(batch.coords.shape) == (3, 3) and tuple(batch.sdf.shape) == (3, 1)


def _trainers(setup, tmp_path, amp, port_amp=None):
    jpipe, params, config, jdata, tdata = setup
    opt = dict(lr=1e-3, eps=1e-4)
    jt = JTrainer(JConfig(optimizer=JConfigAdam(**opt), enable_amp=amp, **TRAIN_KW), jpipe,
                  jdata, tracker=JTracker(ConfigTracker(log_dir=str(tmp_path),
                                                        tensorboard=False), "parity"))
    tt = _port_trainer(setup, amp if port_amp is None else port_amp)
    assert tt.iterations_per_epoch == jt.iterations_per_epoch
    return jt, tt


def _port_trainer(setup, amp):
    _, params, config, _, tdata = setup
    tpipe = interop.build_sdf_pipeline(params, config, device="cpu")
    return SDFTrainer(ConfigSDFTrainer(optimizer=ConfigAdam(lr=1e-3, eps=1e-4),
                                       enable_amp=amp, **TRAIN_KW), tpipe, tdata, device="cpu")


@pytest.mark.parametrize("amp", [False, True])
def test_one_step_matches_jax(sdf_setup, tmp_path, amp):
    jt, tt = _trainers(sdf_setup, tmp_path, amp)
    jt.pre_training()
    tt.pre_training()
    jt.reset_data_iterator()
    tt.reset_data_iterator()
    jbatch, tbatch = jt.next_batch(), tt.next_batch()
    np.testing.assert_array_equal(np_of(tbatch.coords), jbatch.coords)
    n = len(jbatch.coords)
    batch = (jnp.asarray(jbatch.coords), jnp.asarray(jbatch.sdf).reshape(n, 1), None)

    def loss_of(diff):
        return jt.compute_loss(jt._spec.unflatten(diff, jt._nondiff), batch, None)

    @jax.jit
    def jax_step(diff, opt_state):
        """JAX's step, unrolled: its loss and gradients, then its optimizer's update."""
        (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(diff)
        updates, _ = jt.optimizer.update(grads, opt_state, diff)
        return loss, grads, optax.apply_updates(diff, updates)

    jloss, jgrads, jdiff = jax_step(dict(jt._diff), jt.opt_state)
    jnew = jt._spec.unflatten(jdiff, jt._nondiff)
    jloss = float(jloss)
    jgrads = {path: np.asarray(g) for path, g in jgrads.items()}
    tt.step(tbatch)
    assert jloss > 0.01
    if amp:
        # the loss of JAX's function as written, whose decoder output is a bf16 value: the
        # compiled step's output rounded to bf16 (see the module's docstring)
        out = np.asarray(jax.jit(lambda c: jt.pipeline.nef.sdf(c))(batch[0]))
        pred = np.asarray(jnp.asarray(out).astype(jnp.bfloat16).astype(jnp.float32))
        res = pred - np.asarray(batch[1])
        eager_loss = float(np.sum(res * res) / np.float32(n))
        half_ulp = np.abs(pred - out).max()
        assert 0 < abs(eager_loss - jloss) <= float(np.mean(2 * np.abs(res) * half_ulp
                                                              + half_ulp ** 2))
        assert amp_mismatches(tt, eager_loss, jgrads) == []
        # the control: a port whose decoder stays in float32 fails the comparison
        f32 = _port_trainer(sdf_setup, amp=False)
        f32.pre_training()
        f32.step(tbatch)
        bad = amp_mismatches(f32, eager_loss, jgrads)
        decoders = [k for k, _ in f32.pipeline.named_parameters() if "decoder" in k]
        assert "loss" in bad and all(f"{k} not bf16" in bad for k in decoders), bad
    else:
        assert abs(jloss - tt.last_loss) <= 1e-5
        for name, (_, err) in grad_errors(tt, jgrads).items():
            assert err <= 1e-5, (name, err)
    new, _ = sdf_params_from_jax(jnew)
    param_tol = 2e-3 if amp else 1e-5
    for name, got in tt.pipeline.named_parameters():
        np.testing.assert_allclose(np_of(got), new[name[len("nef."):]], atol=param_tol,
                                   rtol=0, err_msg=name)


def test_validate_matches_jax(sdf_setup, tmp_path):
    """With the sphere decoder, so that both IoUs are far from 0. The narrowband IoU is
    taken over the training samples, whose on-surface ('trace') samples have a ground-truth
    sign of rounding noise (|d| < 1e-7), and there the two packages' signs differ
    (test_dataset_matches_jax allows it). So the narrowband IoU of the port's predictions
    is held to JAX's on JAX's ground truth, and to its own validate() on its own."""
    jpipe = with_decoder(sdf_setup[0], interop.sphere_sdf_decoder(16, 32, seed=0))
    params, config = sdf_params_from_jax(jpipe)
    setup = (jpipe, params, config) + sdf_setup[3:]
    jt, tt = _trainers(setup, tmp_path, amp=False)
    want = jt.validate()
    got = tt.validate()
    assert set(got) == set(want) == {"iou", "volumetric_iou"}
    assert abs(got["volumetric_iou"] - want["volumetric_iou"]) <= 1e-3
    assert 0.5 < want["volumetric_iou"] <= 1.0
    jdata, tdata = setup[3:]
    with torch.no_grad():
        pred = tt.pipeline.nef(channels="sdf", coords=tdata.coordinates)
    assert got["iou"] == compute_sdf_iou(pred, tdata.sdf_data)
    assert abs(compute_sdf_iou(np_of(pred), jdata.sdf_data) - want["iou"]) <= 1e-3
    assert 0.3 < want["iou"] < 1.0


# -- the default optimizer ------------------------------------------------------------------

class _OneModule(BaseTrainer):
    def step(self, data):
        raise NotImplementedError

    def validate(self):
        raise NotImplementedError


def test_default_optimizer_matches_jax():
    """One step of the default trainer config's optimizer on a decoder parameter (the group
    that takes the weight decay) gives JAX's parameters."""
    rng = np.random.default_rng(11)
    w0 = rng.normal(size=(4, 5)).astype(np.float32)
    g = rng.normal(size=(4, 5)).astype(np.float32)
    jcfg = JConfigBase().optimizer
    assert isinstance(jcfg, JConfigAdam)
    tx = instantiate(jcfg)
    updates, _ = tx.update(jnp.asarray(g), tx.init(jnp.asarray(w0)), jnp.asarray(w0))
    want = np.asarray(optax.apply_updates(jnp.asarray(w0), updates))

    cfg = ConfigBaseTrainer(enable_amp=False)
    assert isinstance(cfg.optimizer, ConfigAdam)
    assert dataclasses.asdict(cfg.optimizer) == {k: getattr(jcfg, k) for k in
                                                 ("lr", "betas", "eps", "weight_decay")}
    module = torch.nn.Module()
    module.decoder = torch.nn.Linear(5, 4, bias=False)
    with torch.no_grad():
        module.decoder.weight.copy_(torch.from_numpy(w0))
    trainer = _OneModule(cfg, module, [], device="cpu")
    module.decoder.weight.grad = torch.from_numpy(g)
    trainer.optimizer_step()
    np.testing.assert_allclose(np_of(module.decoder.weight), want, atol=1e-6, rtol=0)
    assert np.abs(want - w0).max() > 1e-4
