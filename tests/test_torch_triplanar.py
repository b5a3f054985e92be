"""The triplanar NeRF of the port (TriplanarGrid, K18's triplane sample) against the JAX
package's, on the CPU, at a small size: 2 LODs at log_base_resolution 2, 4 features a
plane, hidden 16, a level-3 ``make_dense`` octree and its 'ray' march; the point inputs and
rays come from numpy seeds, and JAX's results are jitted and shared at module scope.

* JAX's mirrored fold (``_reflect``: x -> -x inside [-1, 1]) on points inside and outside
  the box, exactly.
* ``interpolate`` at every ``lod_idx``, 'sum' and 'cat' (zero-padded to ``num_lods``): K18's
  plain forward within 1e-6; the planes' gradients (the grid's autograd and
  ``triplane_sample_bwd``) within 1e-5 of the largest entry of ``jax.grad``'s; a frozen grid
  passes none, as JAX's stop_gradient.
* The slice: one trace with a loss, weights carried by ``interop.build_pipeline``, its
  channels within 1e-4 and every parameter's gradient within 1e-5 of its norm (the octree
  NeRF test's tolerances).
* ``nerf_triplanar_lego_proxy.yaml`` through ``main_nerf`` on the CPU (its widths, 2 views
  of 8x8, 256 rays a batch): two steps, a ``save_model`` -> ``--pretrained`` round trip and
  a ``resume`` that restore the planes and the optimizer bit for bit.
* ``AxisAlignedBBoxAS`` (its level-0 'ray' march) and ``HashGrid.from_octree`` against JAX.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.accelstructs import AxisAlignedBBoxAS as JAABB
from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.models.grids import HashGrid as JHashGrid
from wisp_tpu.models.grids import TriplanarGrid as JTriplanarGrid
from wisp_tpu.models.grids.triplanar_grid import _reflect as jreflect
from wisp_tpu.models.nefs.nerf import NeuralRadianceField as JNeRF
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.tracers import PackedRFTracer as JPackedRFTracer
from wisp_tpu.utils.filter import TreeSpec

from wisp_tpu_torch.accelstructs.aabb_as import AxisAlignedBBoxAS
from wisp_tpu_torch.app.nerf import main_nerf
from wisp_tpu_torch.interop import build_pipeline
from wisp_tpu_torch.models.grids.hash_grid import HashGrid
from wisp_tpu_torch.models.grids.triplanar_grid import TriplanarGrid
from wisp_tpu_torch.ops.triplane import reflect, triplane_sample_bwd
from wisp_tpu_torch.trainers.base_trainer import pipeline_state_dict

from test_torch_helpers import both_rays, np_of, port_name, ray_arrays

LODS, BASE, FEAT, HIDDEN, STEPS = 2, 2, 4, 16, 32
NEF_KW = dict(view_embedder="positional", view_multires=4, hidden_dim=HIDDEN, num_layers=1,
              bias=True, activation_type="relu", layer_type="linear", pos_embedder="none",
              position_input=False)
TRACER_KW = dict(raymarch_type="ray", num_steps=STEPS, bg_color=(1.0, 1.0, 1.0),
                 compaction=0.5)
CHANNELS = ["rgb", "alpha", "depth"]
CONFIG = "app/nerf/configs/nerf_triplanar_lego_proxy.yaml"


def _jax_grid(multiscale_type, blas=None):
    return JTriplanarGrid(blas=blas, feature_dim=FEAT, log_base_resolution=BASE,
                          num_lods=LODS, multiscale_type=multiscale_type, feature_std=0.5,
                          key=jax.random.PRNGKey(7))


def _port_grid(jgrid):
    grid = TriplanarGrid(feature_dim=FEAT, log_base_resolution=BASE, num_lods=LODS,
                         multiscale_type=jgrid.multiscale_type, device="cpu")
    with torch.no_grad():
        for volume, jvolume in zip(grid.features, jgrid.features):
            for name in ("fmx", "fmy", "fmz"):
                getattr(volume, name).copy_(torch.from_numpy(np.array(getattr(jvolume, name))))
    return grid


def _points(n=600, seed=3):
    """Points inside the box and up to 1.6 outside it (the fold's both sides)."""
    return np.random.default_rng(seed).uniform(-1.6, 1.6, (n, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_samples(multiscale_type):
    """JAX's features at every lod_idx and its planes' gradient of the loss
    sum(interpolate(x, LODS - 1) * w), w seeded."""
    grid = _jax_grid(multiscale_type)
    x = jnp.asarray(_points())
    width = 3 * FEAT * (1 if multiscale_type == "sum" else LODS)
    w = np.random.default_rng(4).normal(size=(x.shape[0], width)).astype(np.float32)

    def loss(planes):
        vols = [v.replace(fmx=p[0], fmy=p[1], fmz=p[2]) for v, p in zip(grid.features, planes)]
        g = grid.replace(features=vols)
        feats = [g.interpolate(x, l) for l in range(LODS)]
        return (feats[-1] * w).sum(), feats

    planes = [(v.fmx, v.fmy, v.fmz) for v in grid.features]
    grads, feats = jax.jit(jax.grad(loss, has_aux=True))(planes)
    return (grid, [np.asarray(f) for f in feats], w,
            [np.asarray(g) for lod in grads for g in lod])


def test_reflect_matches_jax():
    x = np.concatenate([np.asarray([-1.2, -1.0, -0.5, 0.0, 0.5, 1.0, 1.2, 3.1, -5.0, 7.0],
                                   np.float32), _points(200).reshape(-1) * 3.0])
    got = np_of(reflect(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, np.asarray(jreflect(jnp.asarray(x), -1.0, 1.0)))
    np.testing.assert_allclose(got[:8], [0.8, 1.0, 0.5, 0.0, -0.5, -1.0, -0.8, 0.9], atol=1e-6)


@pytest.mark.parametrize("multiscale_type", ["sum", "cat"])
@pytest.mark.parametrize("lod_idx", [0, 1])
def test_interpolate_matches_jax(multiscale_type, lod_idx):
    jgrid, feats, _, _ = _jax_samples(multiscale_type)
    grid = _port_grid(jgrid)
    got = grid.interpolate(torch.from_numpy(_points()), lod_idx)
    width = 3 * FEAT * (1 if multiscale_type == "sum" else LODS)
    assert got.shape == (600, width) and grid.feature_dim == 3 * FEAT
    np.testing.assert_allclose(np_of(got), feats[lod_idx], atol=1e-6, rtol=0)
    if lod_idx == 0:  # one volume's own call gives LOD 0's columns
        volume = np_of(grid.features[0](torch.from_numpy(_points())))
        np.testing.assert_array_equal(volume, np_of(got)[:, :3 * FEAT])
    if multiscale_type == "cat" and lod_idx == 0:
        assert not np.any(np_of(got)[:, 3 * FEAT:])
    assert np.abs(feats[lod_idx]).max() > 0.5


@pytest.mark.parametrize("multiscale_type", ["sum", "cat"])
def test_plane_grads_match_jax(multiscale_type):
    jgrid, _, w, want = _jax_samples(multiscale_type)
    grid = _port_grid(jgrid)
    x = torch.from_numpy(_points())
    (grid.interpolate(x, LODS - 1) * torch.from_numpy(w)).sum().backward()
    got = [getattr(v, n).grad for v in grid.features for n in ("fmx", "fmy", "fmz")]
    shapes = [tuple(g.shape) for g in got]
    bwd = triplane_sample_bwd(x, shapes, multiscale_type, torch.from_numpy(w))
    scale = max(np.abs(g).max() for g in want)
    for a, b, ref in zip(got, bwd, want):
        np.testing.assert_allclose(np_of(a), ref, atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(np_of(b), ref, atol=1e-5 * scale, rtol=0)
    grid.zero_grad()
    grid.freeze()
    out = grid.interpolate(x, LODS - 1)
    assert not out.requires_grad


def _jax_pipeline():
    grid = _jax_grid("sum", blas=JOctreeAS.make_dense(3))
    nef = JNeRF(grid=grid, key=jax.random.PRNGKey(8), **NEF_KW)
    return JPipeline(nef=nef, tracer=JPackedRFTracer(**TRACER_KW))


def test_trace_and_grads_match_jax():
    """One trace with a loss, mean((rgb - target)^2), and its gradients."""
    jpipe = _jax_pipeline()
    grid = jpipe.nef.grid
    params = {}
    for i, v in enumerate(grid.features):
        for name in ("fmx", "fmy", "fmz"):
            params[f"grid.features.{i}.{name}"] = np.asarray(getattr(v, name))
    nef = jpipe.nef
    for prefix, dec in (("decoder_density", nef.decoder_density),
                        ("decoder_color", nef.decoder_color)):
        for name, layer in [(f"layers.{i}", l) for i, l in enumerate(dec.layers)] \
                + [("lout", dec.lout)]:
            params[f"{prefix}.{name}.weight"] = np.asarray(layer.weight)
            params[f"{prefix}.{name}.bias"] = np.asarray(layer.bias)
    config = {"blas_level": 3, "blas_dense": True,
              "grid": {"constructor": "TriplanarGrid", "feature_dim": FEAT,
                       "log_base_resolution": BASE, "num_lods": LODS,
                       "multiscale_type": "sum"},
              "nef": NEF_KW, "tracer": TRACER_KW}
    tpipe = build_pipeline(params, config, device="cpu")
    origins, dirs = ray_arrays(128, seed=11)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    target = np.random.default_rng(12).uniform(size=(128, 3)).astype(np.float32)
    spec = TreeSpec(jpipe)

    def loss(diff):
        rb = spec.unflatten(diff, spec.nondiff)(rays=jr, channels=CHANNELS)
        return jnp.mean((rb.rgb - target) ** 2), rb

    (jloss, jrb), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(dict(spec.diff))
    rb = tpipe(rays=tr, channels=CHANNELS)
    tloss = torch.mean((rb.rgb - torch.from_numpy(target)) ** 2)
    tloss.backward()
    for k in CHANNELS:
        np.testing.assert_allclose(np_of(rb.channels[k]), np.asarray(jrb.channels[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert float(rb.num_valid_samples) == float(jrb.num_valid_samples) > 0
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    named = dict(tpipe.named_parameters())
    assert set(named) == {port_name(p) for p in jgrads}
    for path, want in jgrads.items():
        got = np_of(named[port_name(path)].grad)
        want = np.asarray(want)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), path
    assert np.linalg.norm(np.asarray(jgrads[".nef.grid.features[0].fmx"])) > 0


TINY = ["--device", "cpu", "--dataset.num-views", "2", "--dataset.height", "8",
        "--dataset.width", "8", "--dataset-transform.num-samples", "256",
        "--tracker.tensorboard", "false", "--tracker.run-name", "run"]


def _build(tmp_path, *extra):
    cfg = main_nerf.parse_args(["--config", os.path.abspath(CONFIG), *TINY,
                                "--dataset.dataset-path", str(tmp_path),
                                "--tracker.log-dir", str(tmp_path), *extra])
    return main_nerf.build(cfg)


def _planes(pipeline):
    return {k: v for k, v in pipeline_state_dict(pipeline).items() if ".features." in k}


def test_yaml_trains_saves_and_resumes(tmp_path):
    """The yaml's grid at its widths (4 LODs from 5, 4 features, 'sum'; the make_dense
    level-7 octree and 512 steps) takes two steps; its saved model loads back through
    --pretrained, and a resumed trainer holds the saved planes and optimizer state."""
    pipeline, trainer, _ = _build(tmp_path)
    grid = pipeline.nef.grid
    assert isinstance(grid, TriplanarGrid) and grid.active_lods == (5, 6, 7, 8)
    assert [v.fmx.shape for v in grid.features] == [(w, w, 4) for w in (33, 65, 129, 257)]
    assert grid.blas.max_level == 7 and grid.blas.dense
    before = {k: v.clone() for k, v in _planes(pipeline).items()}
    for _ in range(2):
        trainer.iterate()
        assert math.isfinite(trainer.last_loss)
    after = _planes(pipeline)
    assert all(not torch.equal(before[k], after[k]) for k in before)
    path = trainer.save_model()
    loaded, _, _ = _build(tmp_path, "--pretrained", path)
    saved = _planes(loaded)
    assert after.keys() == saved.keys()
    assert all(torch.equal(after[k], saved[k]) for k in after)
    state = trainer.save_training_state()
    _, resumed, _ = _build(tmp_path, "--trainer.resume", state)
    resumed.begin_training()
    assert all(torch.equal(after[k], v) for k, v in _planes(resumed.pipeline).items())
    opt, ropt = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert opt["state"].keys() == ropt["state"].keys() and len(opt["state"]) > 0
    for i in opt["state"]:
        for name, t in opt["state"][i].items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(ropt["state"][i][name]))


def test_aabb_march_matches_jax():
    """AxisAlignedBBoxAS is make_dense(0): its 'ray' march equals JAX's AABB march."""
    blas = AxisAlignedBBoxAS(device="cpu")
    jblas = JAABB()
    assert blas.max_level == 0 and blas.dense and blas.name() == "AABB"
    origins, dirs = ray_arrays(64, seed=13)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    got = blas.raymarch(tr, raymarch_type="ray", num_samples=24)
    want = jblas.raymarch(jr, raymarch_type="ray", num_samples=24)
    np.testing.assert_array_equal(np_of(got.mask), np.asarray(want.mask))
    for name in ("samples", "depth_samples", "deltas"):
        np.testing.assert_allclose(np_of(getattr(got, name)), np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert 0 < int(np_of(got.mask).sum()) < got.mask.numel()
    assert TriplanarGrid(num_lods=1, device="cpu").blas.max_level == 0


def test_hash_grid_from_octree_matches_jax():
    jgrid = JHashGrid.from_octree(feature_dim=2, base_lod=2, num_lods=3, codebook_bitwidth=8,
                                  feature_std=0.5, key=jax.random.PRNGKey(2))
    grid = HashGrid.from_octree(feature_dim=2, base_lod=2, num_lods=3, codebook_bitwidth=8,
                                device="cpu")
    assert grid.resolutions == tuple(jgrid.resolutions) == (4, 8, 16)
    with torch.no_grad():
        grid.codebook.feats.copy_(torch.from_numpy(np.array(jgrid.codebook.feats)))
    x = np.random.default_rng(5).uniform(-1, 1, (300, 3)).astype(np.float32)
    want = jax.jit(lambda g, c: g.interpolate(c, 2))(jgrid, jnp.asarray(x))
    np.testing.assert_allclose(np_of(grid.interpolate(torch.from_numpy(x), 2)),
                               np.asarray(want), atol=1e-6, rtol=0)
