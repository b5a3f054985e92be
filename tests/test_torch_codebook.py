"""The VQAD codebook NeRF of the port (CodebookOctreeGrid, K19's codebook lookup resolved
once a vertex, then the octree grid's fused query) against the JAX package's, on the CPU,
at a small size: a level-3 sparse octree from a seeded point cloud, 2 LODs of 5 features,
bitwidth 3, hidden 16, a 'voxel' march of 16 steps; JAX's results are jitted and shared at
module scope.

* The resolved tables E (``codebook_resolve``'s plain versions) against JAX's
  ``_index_features`` at every vertex, and ``interpolate`` at every ``lod_idx`` ('sum'),
  in the train, eval and baked modes, within 1e-6; 'cat' and 'closest' likewise.
* The logits' and dictionaries' gradients of a loss on ``interpolate`` (through
  ``_CodebookResolveFn``, whose backward is K19's plain backward) within 1e-5 of the largest
  entry of ``jax.grad``'s, 'sum' and 'cat'; ``freeze()`` stops nothing, as in JAX.
* E stays in the grid's own buffer from call to call (the fused query's table cache keys
  on its address).
* The slice: one trace with a loss, weights carried by ``interop.build_pipeline``, within
  the octree NeRF test's tolerances.
* ``nerf_codebook_lego_proxy.yaml`` through ``main_nerf`` on the CPU: two steps, a
  ``save_model`` -> ``--pretrained`` round trip (logits and dictionaries; a baked grid's
  indices) and a ``resume`` of the logits, dictionaries and optimizer, bit for bit.

The logits are drawn with std 1 (the config's 0.01 puts every softmax near 1/2^bw): two
implementations may round two close softmax values apart, and a test asserts that no
vertex's two largest lie within 1e-6 of each other, where the argmax could differ.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.models.grids import CodebookOctreeGrid as JCodebookGrid
from wisp_tpu.models.nefs.nerf import NeuralRadianceField as JNeRF
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.tracers import PackedRFTracer as JPackedRFTracer
from wisp_tpu.utils.filter import TreeSpec

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.app.nerf import main_nerf
from wisp_tpu_torch.interop import build_pipeline
from wisp_tpu_torch.models.grids.codebook_grid import CodebookOctreeGrid
from wisp_tpu_torch.ops.codebook import codebook_resolve, softmax_plain
from wisp_tpu_torch.trainers.base_trainer import load_pipeline, pipeline_state_dict

from test_torch_helpers import both_rays, np_of, port_name, ray_arrays

LEVEL, LODS, FEAT, BITS, HIDDEN, STEPS = 3, 2, 5, 3, 16, 16
NEF_KW = dict(view_embedder="positional", view_multires=4, hidden_dim=HIDDEN, num_layers=1,
              bias=True, activation_type="relu", layer_type="linear", pos_embedder="none",
              position_input=False)
TRACER_KW = dict(raymarch_type="voxel", num_steps=STEPS, bg_color=(1.0, 1.0, 1.0),
                 compaction=0.25, march_budget=1024)
CHANNELS = ["rgb", "alpha", "depth"]
CONFIG = "app/nerf/configs/nerf_codebook_lego_proxy.yaml"


def _pointcloud(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    centres = np.asarray([[0.25, -0.2, 0.1], [-0.3, 0.3, -0.25]], np.float32)
    pts = centres[rng.integers(0, 2, n)] + rng.normal(scale=0.2, size=(n, 3))
    return np.clip(pts, -1.0, 0.999).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_blas():
    return JOctreeAS.from_pointcloud(_pointcloud(), LEVEL, dilate=1)


@functools.lru_cache(maxsize=None)
def _jax_grid(multiscale_type="sum", interpolation_type="linear"):
    """The JAX grid (immutable: eval, bake and freeze return copies), built once a kind."""
    return JCodebookGrid(blas=_jax_blas(), feature_dim=FEAT, num_lods=LODS,
                         interpolation_type=interpolation_type,
                         multiscale_type=multiscale_type, feature_std=1.0,
                         codebook_bitwidth=BITS, key=jax.random.PRNGKey(5))


def _port_grid(jgrid):
    blas = OctreeAS.from_codes([np.asarray(c).astype(np.uint64) for c in _jax_blas().codes],
                               device="cpu")
    grid = CodebookOctreeGrid(blas=blas, feature_dim=FEAT, num_lods=LODS,
                              interpolation_type=jgrid.interpolation_type,
                              multiscale_type=jgrid.multiscale_type, codebook_bitwidth=BITS,
                              device="cpu")
    with torch.no_grad():
        for i in range(LODS):
            grid.features[i].copy_(torch.from_numpy(np.array(jgrid.features[i])))
            grid.dictionary[i].copy_(torch.from_numpy(np.array(jgrid.dictionary[i])))
    return grid


def _points(n=800, seed=3):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)


def _in_mode(grid, mode):
    """A JAX grid's copy, or the port's grid itself, in ``mode``."""
    if mode == "eval":
        return grid.eval()
    if mode == "baked":
        return grid.bake()
    return grid


@functools.lru_cache(maxsize=None)
def _jax_forward(mode, multiscale_type="sum", interpolation_type="linear"):
    """JAX's features at every lod_idx and its lookup at every vertex of each LOD."""
    jgrid = _in_mode(_jax_grid(multiscale_type, interpolation_type), mode)
    x = jnp.asarray(_points())

    def run(g):
        rows = [g._index_features(g.features[i], jnp.arange(g.features[i].shape[0]), i)
                for i in range(LODS)]
        return [g.interpolate(x, l) for l in range(LODS)], rows

    feats, rows = jax.jit(run)(jgrid)
    return [np.asarray(f) for f in feats], [np.asarray(r) for r in rows]


def test_no_close_softmax_pairs():
    """The tests' logits leave every vertex's two largest softmax values apart."""
    grid = _jax_grid()
    for logits in grid.features:
        s = np.sort(np_of(softmax_plain(torch.from_numpy(np.array(logits)))), axis=-1)
        assert (s[:, -1] - s[:, -2]).min() > 1e-6


@pytest.mark.parametrize("mode", ["train", "eval", "baked"])
def test_forward_matches_jax(mode):
    want, want_rows = _jax_forward(mode)
    grid = _in_mode(_port_grid(_jax_grid()), mode)
    assert grid.mode == mode
    tables, arg = codebook_resolve(list(grid.features), list(grid.dictionary), mode)
    for got, ref in zip(tables, want_rows):
        np.testing.assert_allclose(np_of(got), ref, atol=1e-6, rtol=0)
    assert int(arg.max()) < 2 ** BITS and len(set(np_of(arg).tolist())) > 2
    x = torch.from_numpy(_points())
    for lod_idx in range(LODS):
        got = grid.interpolate(x, lod_idx)
        assert got.shape == (800, FEAT)
        np.testing.assert_allclose(np_of(got), want[lod_idx], atol=1e-6, rtol=0)
    assert np.abs(want[-1]).max() > 0.5 and (np.abs(want[-1]).sum(-1) == 0).any()


@pytest.mark.parametrize("multiscale_type,interpolation_type", [("cat", "linear"),
                                                                ("sum", "closest")])
def test_cat_and_closest_match_jax(multiscale_type, interpolation_type):
    want, _ = _jax_forward("train", multiscale_type, interpolation_type)
    grid = _port_grid(_jax_grid(multiscale_type, interpolation_type))
    x = torch.from_numpy(_points())
    for lod_idx in range(LODS):
        np.testing.assert_allclose(np_of(grid.interpolate(x, lod_idx)), want[lod_idx],
                                   atol=1e-6, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_grads(multiscale_type, frozen=False):
    """JAX's logits' and dictionaries' gradients of sum(interpolate(x, LODS - 1) * w)."""
    grid = _jax_grid(multiscale_type)
    if frozen:
        grid = grid.freeze()
    x = jnp.asarray(_points())
    width = FEAT * (1 if multiscale_type == "sum" else LODS)
    w = np.random.default_rng(4).normal(size=(x.shape[0], width)).astype(np.float32)

    def loss(tables):
        g = grid.replace(features=tables[0], dictionary=tables[1])
        return (g.interpolate(x, LODS - 1) * w).sum()

    grads = jax.jit(jax.grad(loss))((list(grid.features), list(grid.dictionary)))
    return w, [np.asarray(g) for g in grads[0]], [np.asarray(g) for g in grads[1]]


@pytest.mark.parametrize("multiscale_type", ["sum", "cat"])
def test_grads_match_jax(multiscale_type):
    w, want_logits, want_dict = _jax_grads(multiscale_type)
    grid = _port_grid(_jax_grid(multiscale_type))
    (grid.interpolate(torch.from_numpy(_points()), LODS - 1) * torch.from_numpy(w)).sum() \
        .backward()
    for got, ref in zip(list(grid.features) + list(grid.dictionary), want_logits + want_dict):
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(np_of(got.grad), ref, atol=1e-5 * scale, rtol=0)


def test_freeze_stops_nothing_as_in_jax():
    """JAX's ``freeze()`` on a codebook grid marks it frozen, and its lookup never reads
    the mark: the gradients are those of the grid unfrozen (a reference fault kept)."""
    w, want_logits, want_dict = _jax_grads("sum", frozen=True)
    _, unfrozen_logits, _ = _jax_grads("sum")
    np.testing.assert_array_equal(want_logits[0], unfrozen_logits[0])
    grid = _port_grid(_jax_grid()).freeze()
    assert grid.frozen and all(f.requires_grad for f in grid.features)
    (grid.interpolate(torch.from_numpy(_points()), LODS - 1) * torch.from_numpy(w)).sum() \
        .backward()
    for got, ref in zip(list(grid.features) + list(grid.dictionary), want_logits + want_dict):
        np.testing.assert_allclose(np_of(got.grad), ref, atol=1e-5 * np.abs(ref).max(),
                                   rtol=0)


def test_resolved_tables_stay_in_the_grid_buffer():
    grid = _port_grid(_jax_grid())
    first = grid.feature_tables(LODS)
    with torch.no_grad():
        grid.features[0].mul_(-1.0)
    second = grid.feature_tables(LODS)
    assert [t.data_ptr() for t in first] == [t.data_ptr() for t in second]
    assert second[0].data_ptr() == grid._resolved.data_ptr()
    assert grid.feature_tables(1)[0].data_ptr() == first[0].data_ptr()


def test_trace_and_grads_match_jax():
    """One 'voxel' trace with a loss, mean((rgb - target)^2), and its gradients."""
    jgrid = _jax_grid()
    jnef = JNeRF(grid=jgrid, key=jax.random.PRNGKey(8), **NEF_KW)
    jpipe = JPipeline(nef=jnef, tracer=JPackedRFTracer(**TRACER_KW))
    params = {f"blas.codes.{l}": np.asarray(c).astype(np.uint64)
              for l, c in enumerate(jgrid.blas.codes)}
    for i in range(LODS):
        params[f"grid.features.{i}"] = np.asarray(jgrid.features[i])
        params[f"grid.dictionary.{i}"] = np.asarray(jgrid.dictionary[i])
    for prefix, dec in (("decoder_density", jnef.decoder_density),
                        ("decoder_color", jnef.decoder_color)):
        for name, layer in [(f"layers.{i}", l) for i, l in enumerate(dec.layers)] \
                + [("lout", dec.lout)]:
            params[f"{prefix}.{name}.weight"] = np.asarray(layer.weight)
            params[f"{prefix}.{name}.bias"] = np.asarray(layer.bias)
    config = {"blas_level": LEVEL,
              "grid": {"constructor": "CodebookOctreeGrid", "feature_dim": FEAT,
                       "num_lods": LODS, "multiscale_type": "sum",
                       "codebook_bitwidth": BITS},
              "nef": NEF_KW, "tracer": TRACER_KW}
    tpipe = build_pipeline(params, config, device="cpu")
    origins, dirs = ray_arrays(96, seed=5)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    target = np.random.default_rng(12).uniform(size=(96, 3)).astype(np.float32)
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
        got, want = np_of(named[port_name(path)].grad), np.asarray(want)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), path
    assert np.linalg.norm(np.asarray(jgrads[".nef.grid.dictionary[1]"])) > 0


TINY = ["--device", "cpu", "--dataset.num-views", "2", "--dataset.height", "8",
        "--dataset.width", "8", "--dataset-transform.num-samples", "256",
        "--tracker.tensorboard", "false", "--tracker.run-name", "run"]


def _build(tmp_path, *extra):
    cfg = main_nerf.parse_args(["--config", os.path.abspath(CONFIG), *TINY,
                                "--dataset.dataset-path", str(tmp_path),
                                "--tracker.log-dir", str(tmp_path), *extra])
    return main_nerf.build(cfg)


def _tables(pipeline):
    return {k: v for k, v in pipeline_state_dict(pipeline).items()
            if ".features." in k or ".dictionary." in k}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_yaml_trains_saves_and_resumes(tmp_path):
    """The yaml's grid at its widths (the sparse level-7 octree, LODs 4-7, F = 5, 2^4
    entries, 'sum'; the 'voxel' march of 16 steps) takes two steps; the saved model loads
    back through --pretrained; a resumed trainer holds the saved logits, dictionaries and
    optimizer state; a baked grid's saved indices load back and render as saved."""
    pipeline, trainer, _ = _build(tmp_path)
    grid = pipeline.nef.grid
    assert isinstance(grid, CodebookOctreeGrid) and grid.active_lods == (4, 5, 6, 7)
    assert [d.shape for d in grid.dictionary] == [(16, 5)] * 4
    assert all(f.shape[1] == 16 for f in grid.features) and not grid.blas.dense
    groups = {g["name"]: len(g["params"]) for g in trainer.optimizer.param_groups}
    assert groups == {"decoder": 10, "grid": 8}
    before = {k: v.clone() for k, v in _tables(pipeline).items()}
    for _ in range(2):
        trainer.iterate()
        assert math.isfinite(trainer.last_loss)
    after = _tables(pipeline)
    assert all(not torch.equal(before[k], after[k]) for k in before)
    loaded, _, _ = _build(tmp_path, "--pretrained", trainer.save_model())
    assert _same(after, _tables(loaded))
    _, resumed, _ = _build(tmp_path, "--trainer.resume", trainer.save_training_state())
    resumed.begin_training()
    assert _same(after, _tables(resumed.pipeline))
    opt, ropt = trainer.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert opt["state"].keys() == ropt["state"].keys() and len(opt["state"]) == 18
    for i in opt["state"]:
        for name, t in opt["state"][i].items():
            assert torch.equal(torch.as_tensor(t), torch.as_tensor(ropt["state"][i][name]))
    grid.bake()
    x = torch.rand((500, 3), generator=torch.Generator().manual_seed(0)) * 2.0 - 1.0
    with torch.no_grad():
        want = grid.interpolate(x, grid.num_lods - 1)
    baked = load_pipeline(trainer.save_model(), device="cpu").nef.grid
    assert baked.baked and all(f.ndim == 1 for f in baked.features)
    assert _same({i: f for i, f in enumerate(grid.features)},
                 {i: f for i, f in enumerate(baked.features)})
    with torch.no_grad():
        assert torch.equal(baked.interpolate(x, grid.num_lods - 1), want)
