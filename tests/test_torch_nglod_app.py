"""The port's NGLOD app (``wisp_tpu_torch.app.nglod.main_nglod``) against JAX's
(app/nglod/main_nglod.py) on the CPU, at tiny sizes:

* ``parse_args`` of nglod_octree.yaml, as shipped and with the texture flags, equals JAX's
  ``parse_config`` on every field both configs have;
* ``build()`` makes JAX's octree (codes exactly) and dataset (points exactly; distances
  and colours within 1e-5), for the octree-sampled and the textured mesh-sampled dataset;
* one SDFTrainer step of a NeuralSDFTex (the rgb loss branch) and one of a NeuralSDF on
  ``HashGrid.from_geometric``, weights carried across by ``interop``: the loss within 1e-5
  and every gradient within 1e-5 of its norm (float32; sums in other orders);
* ``OfflineRenderer.sdf_slice`` within 1e-6 of JAX's image;
* ``--pretrained <model> --valid-only`` reloads a saved 'full' model with its IoUs, and a
  render snapshot writes the three slices.
"""

import dataclasses
import functools
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import (grad_errors, jax_sdf_pipeline, np_of, sdf_params_from_jax,
                                sphere_octree_points)

import app.nglod.main_nglod as jmain
from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.config.presets import ConfigAdam as JConfigAdam
from wisp_tpu.config.utils import config_to_dict as jconfig_to_dict
from wisp_tpu.config.utils import parse_config as jparse_config
from wisp_tpu.models.grids import HashGrid as JHashGrid
from wisp_tpu.models.grids import OctreeGrid as JOctreeGrid
from wisp_tpu.models.nefs.neural_sdf import NeuralSDF as JNeuralSDF
from wisp_tpu.models.nefs.neural_sdf import NeuralSDFTex as JNeuralSDFTex
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.ops.geometric import normalized_slice as jnormalized_slice
from wisp_tpu.trainers.sdf_trainer import ConfigSDFTrainer as JConfig, SDFTrainer as JTrainer
from wisp_tpu.trainers.tracker.offline_renderer import OfflineRenderer as JOfflineRenderer
from wisp_tpu.tracers.packed_sdf_tracer import PackedSDFTracer as JPackedSDFTracer
from wisp_tpu.trainers.tracker.tracker import ConfigTracker, Tracker as JTracker

from wisp_tpu_torch import interop
from wisp_tpu_torch.app.nglod import main_nglod
from wisp_tpu_torch.config import yaml_subset
from wisp_tpu_torch.config.utils import DROPPED_KEYS, config_to_dict
from wisp_tpu_torch.datasets.batch import SDFBatch
from wisp_tpu_torch.trainers.base_trainer import ConfigAdam
from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer
from wisp_tpu_torch.trainers.tracker import offline_renderer
from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer

ROOT = pathlib.Path(__file__).resolve().parents[1]
YAML = str(ROOT / "app/nglod/configs/nglod_octree.yaml")
TEX = ["--dataset.constructor", "MeshSampledSDFDataset", "--dataset.sample-tex", "true",
       "--nef.constructor", "NeuralSDFTex"]
TINY = ["--blas-level", "4", "--grid.num-lods", "2", "--dataset.num-samples", "2000",
        "--trainer.max-epochs", "1", "--trainer.batch-size", "256",
        "--tracker.tensorboard", "false"]
OCTREE = ["--dataset.samples-per-voxel", "2"]      # the octree-sampled dataset's


def _shared(a, b, path=""):
    """(leaf fields compared, mismatches) over the keys both config dicts have."""
    count, bad = 0, []
    for key in sorted(set(a) & set(b)):
        if path == "" and key == "device":          # 'tpu' / 'cuda', by design
            continue
        va, vb = a[key], b[key]
        if isinstance(va, dict) and isinstance(vb, dict):
            c, m = _shared(va, vb, f"{path}{key}.")
            count, bad = count + c, bad + m
        else:
            count += 1
            if va != vb:
                bad.append((f"{path}{key}", va, vb))
    return count, bad


@pytest.mark.parametrize("extra", [[], TEX + ["--blas-level", "8", "--trainer.render-every",
                                              "2", "--tracer.compaction", "0.55"]],
                         ids=["yaml", "yaml+tex"])
def test_parse_matches_jax(extra):
    args = ["--config", YAML] + extra
    want = jconfig_to_dict(jparse_config(jmain.NGLODAppConfig, args=args))
    got = config_to_dict(main_nglod.parse_args(args))
    count, bad = _shared(got, want)
    assert not bad, bad
    assert count > 40 and got["device"] == "cuda"
    for section in ("grid", "nef", "tracer", "dataset"):
        assert got[section]["constructor"] == want[section]["constructor"]
    # every key of the yaml is a field of the port's config (the texture flags switch the
    # dataset to a constructor without samples_per_voxel, in both packages)
    raw = yaml_subset.load_file(YAML)
    missing = [k for s, v in raw.items() if isinstance(v, dict) for k in v
               if k != "constructor" and k not in got[s]]
    assert missing == ([] if not extra else ["samples_per_voxel"]), missing
    assert set(want["tracer"]) - set(got["tracer"]) == {"raytrace_capacity"}
    assert "log_2d" in want["trainer"] and "log_2d" in DROPPED_KEYS


def _jax_build(monkeypatch, argv):
    """JAX's app wiring (its main with --valid-only): (its octree, dataset and the name of
    its field's config). The trainer it makes is captured instead of validated, and its
    grid and field, which this test does not compare, are not built (their eager JAX
    init compiles for seconds)."""
    captured = {}
    original = jmain.instantiate

    def instantiate(cfg, **kw):
        name = type(cfg).__name__
        if "blas" in kw:
            captured["blas"] = kw["blas"]
        if "Grid" in name or "NeuralSDF" in name:
            captured.setdefault("configs", []).append(name)
            return None
        return original(cfg, **kw)

    class Capture:
        def __init__(self, cfg, pipeline, train_dataset, tracker):
            captured["dataset"] = train_dataset
            self.return_dict = {}

        def validate(self):
            return {}

    monkeypatch.setattr(jmain, "instantiate", instantiate)
    monkeypatch.setattr(jmain, "SDFTrainer", Capture)
    jmain.main(argv + ["--valid-only", "true"])
    return captured["blas"], captured["dataset"], captured["configs"]


def _small_mesh(tmp_path):
    """--mesh-path flags of a subdivision-1 icosphere (80 faces: cheap exact distances on
    the CPU), written as .obj."""
    from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh, write_obj
    path = str(tmp_path / "ball.obj")
    write_obj(path, *make_sphere_mesh(radius=0.6, subdivisions=1))
    return ["--mesh-path", path, "--num-samples-on-mesh", "20000"]


@pytest.mark.parametrize("extra", [OCTREE, TEX], ids=["mesh_path", "tex"])
def test_build_matches_jax(monkeypatch, tmp_path, extra):
    """The octree-sampled dataset on an .obj of --mesh-path (OctreeAS.from_mesh), the
    textured dataset on the procedural icosphere."""
    monkeypatch.chdir(tmp_path)
    argv = ["--config", YAML] + TINY + extra
    if extra == OCTREE:
        argv += _small_mesh(tmp_path)
    jblas, jdata, jconfigs = _jax_build(monkeypatch, argv)
    pipe, trainer = main_nglod.build(main_nglod.parse_args(argv + ["--device", "cpu"]))
    blas = pipe.nef.grid.blas
    assert len(blas.codes) == len(jblas.codes) == 5
    for a, b in zip(blas.codes, jblas.codes):
        np.testing.assert_array_equal(a.astype(np.uint64), np.asarray(b).astype(np.uint64))
    data = trainer.train_dataset
    assert type(data).__name__ == type(jdata).__name__
    assert jconfigs == ["Config" + type(pipe.nef.grid).__name__,
                        "Config" + type(pipe.nef).__name__]
    np.testing.assert_array_equal(np_of(data.coordinates), np.asarray(jdata.coordinates))
    got, want = np_of(data.sdf_data)[:, 0], np.asarray(jdata.sdf_data)[:, 0]
    flip = (got < 0) != (want < 0)
    assert (np.abs(want[flip]) < 1e-5).all()
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-5, rtol=0)
    if extra == TEX:
        np.testing.assert_allclose(np_of(data.rgb_data), jdata.rgb_data, atol=1e-5, rtol=0)
        assert np.asarray(jdata.rgb_data).std() > 0.05


class _Data:
    """Fixed training samples (with colours) for both trainers."""

    def __init__(self, pts, sdf, rgb, torch_side):
        self.pts, self.sdf, self.rgb, self.torch_side = pts, sdf, rgb, torch_side
        self.coordinates, self.sdf_data = pts, sdf

    def __len__(self):
        return len(self.pts)

    def __getitem__(self, idx):
        cols = dict(coords=self.pts[idx], sdf=self.sdf[idx])
        if self.rgb is not None:
            cols["rgb"] = self.rgb[idx]
        if self.torch_side:
            return SDFBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in cols.items()})
        return cols


@functools.lru_cache(maxsize=None)
def _samples():
    rng = np.random.default_rng(21)
    u = rng.normal(size=(512, 3))
    pts = (0.9 * u / np.linalg.norm(u, axis=-1, keepdims=True)
           + rng.normal(scale=0.05, size=(512, 3))).astype(np.float32)
    sdf = (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.9).astype(np.float32)
    rgb = ((pts + 1.0) / 2.0).astype(np.float32)
    return pts, sdf, rgb


def _step_matches_jax(jpipe, tmp_path, with_rgb):
    """One step of each package's SDFTrainer on the same weights and batch (no AMP)."""
    pts, sdf, rgb = _samples()
    rgb = rgb if with_rgb else None
    kw = dict(batch_size=256, max_epochs=1, only_last=True, enable_amp=False)
    jt = JTrainer(JConfig(optimizer=JConfigAdam(lr=1e-3, eps=1e-4), **kw), jpipe,
                  _Data(pts, sdf, rgb, False),
                  tracker=JTracker(ConfigTracker(log_dir=str(tmp_path), tensorboard=False),
                                   "parity"))
    params, config = sdf_params_from_jax(jpipe)
    tt = SDFTrainer(ConfigSDFTrainer(optimizer=ConfigAdam(lr=1e-3, eps=1e-4), **kw),
                    interop.build_sdf_pipeline(params, config, device="cpu"),
                    _Data(pts, sdf, rgb, True), device="cpu")
    idx = np.random.default_rng(22).integers(0, len(pts), 256)
    batch = (jnp.asarray(pts[idx]), jnp.asarray(sdf[idx]),
             None if rgb is None else jnp.asarray(rgb[idx]))

    def loss_of(diff):
        return jt.compute_loss(jt._spec.unflatten(diff, jt._nondiff), batch, None)

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        dict(jt._diff))
    tt.pre_training()
    tt.step(tt.train_dataset[idx])
    assert abs(float(jloss) - tt.last_loss) <= 1e-5 * max(1.0, abs(float(jloss)))
    rgb_loss = tt.tracker.metrics.rgb_loss
    assert abs(float(jaux["rgb_loss"]) - rgb_loss) <= 1e-5
    assert (rgb_loss > 0.01) == with_rgb
    for name, (_, err) in grad_errors(tt, {p: np.asarray(g) for p, g in jgrads.items()}
                                      ).items():
        assert err <= 1e-5, (name, err)


def test_texture_step_matches_jax(tmp_path):
    q = sphere_octree_points(4, num_samples=20_000)
    jblas = JOctreeAS.from_quantized_points(q, 4)
    grid = JOctreeGrid(blas=jblas, feature_dim=8, num_lods=2, multiscale_type="sum",
                       feature_std=0.1, key=jax.random.PRNGKey(5))
    nef = JNeuralSDFTex(grid=grid, position_input=True, hidden_dim=32,
                        key=jax.random.PRNGKey(6))
    _step_matches_jax(JPipeline(nef=nef, tracer=JPackedSDFTracer(num_steps=8)), tmp_path,
                      with_rgb=True)


def test_hash_grid_step_matches_jax(tmp_path):
    q = sphere_octree_points(4, num_samples=20_000)
    jblas = JOctreeAS.from_quantized_points(q, 4)
    grid = JHashGrid.from_geometric(blas=jblas, feature_dim=2, num_lods=4,
                                    multiscale_type="cat", feature_std=0.1,
                                    codebook_bitwidth=10, min_grid_res=4, max_grid_res=32,
                                    key=jax.random.PRNGKey(7))
    nef = JNeuralSDF(grid=grid, position_input=True, hidden_dim=32, key=jax.random.PRNGKey(8))
    _step_matches_jax(JPipeline(nef=nef, tracer=JPackedSDFTracer(num_steps=8)), tmp_path,
                      with_rgb=False)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_sdf_slice_matches_jax(monkeypatch, dim):
    """The slice's points within 2 ulp of JAX's (XLA on the CPU contracts linspace's
    arithmetic into a fused multiply-add, which the port does not copy), and on JAX's
    points the port's image within 1e-6 of JAX's (the field's float32 sums differ by
    ulps, which the colour map scales by 4)."""
    dec = interop.sphere_sdf_decoder(16, 32, seed=0)
    jpipe = jax_sdf_pipeline(level=4, num_lods=2, hidden_dim=32, decoder=dec,
                             num_samples=20_000)
    params, config = sdf_params_from_jax(jpipe)
    nef = interop.build_sdf_pipeline(params, config, device="cpu").nef
    jpoints = np.asarray(jnormalized_slice(64, 64, dim=dim, depth=0.1))
    points = np_of(offline_renderer.normalized_slice(64, 64, dim=dim, depth=0.1))
    np.testing.assert_allclose(points, jpoints, atol=2 * np.finfo(np.float32).eps, rtol=0)
    want = JOfflineRenderer(render_res=(32, 32)).sdf_slice(
        jax.jit(lambda c: jpipe.nef(channels="sdf", coords=c)), dim=dim, depth=0.1, res=64)
    monkeypatch.setattr(offline_renderer, "normalized_slice",
                        lambda *a, **k: torch.from_numpy(jpoints))
    got = OfflineRenderer(render_res=(32, 32), device="cpu").sdf_slice(
        lambda c: nef(channels="sdf", coords=c), dim=dim, depth=0.1, res=64)
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (want[..., 2] == 1.0).mean() > 0.1 and (want[..., 0] < 1.0).mean() > 0.1


def test_pretrained_valid_only_round_trip(tmp_path, monkeypatch):
    """Train one tiny epoch, save the 'full' model and render the snapshot's slices, then
    reload it with --pretrained --valid-only: the same IoUs (the dataset is not resampled,
    so both validations see the same samples), and a compacted render of the reloaded
    field equals the uncompacted one."""
    monkeypatch.chdir(tmp_path)
    argv = ["--config", YAML, "--device", "cpu", "--trainer.resample", "false",
            "--trainer.save-every", "1", "--trainer.render-every", "1",
            "--tracker.run-name", "run"] + TINY + OCTREE + _small_mesh(tmp_path)
    first = main_nglod.main(argv)
    run = tmp_path / "_results/logs/runs/nglod-octree/run"
    assert sorted(os.listdir(run)) == ["config.yaml", "model.ckpt", "slice_d0_ep1.png",
                                       "slice_d1_ep1.png", "slice_d2_ep1.png"]
    assert (run / "slice_d0_ep1.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    argv_reload = argv + ["--pretrained", str(run / "model.ckpt"), "--valid-only", "true",
                          "--tracker.run-name", "reload"]
    again = main_nglod.main(argv_reload)
    assert set(again) == {"iou", "volumetric_iou"}
    assert again["iou"] == first["iou"] and again["volumetric_iou"] == first["volumetric_iou"]
    pipeline, _ = main_nglod.build(main_nglod.parse_args(
        argv_reload + ["--tracer.compaction", "0.55", "--tracer.mid-compaction", "0.3"]))
    assert pipeline.tracer.compaction is None          # the saved pipeline's own tracer
    renderer = OfflineRenderer(render_res=(24, 24), device="cpu")
    plain = renderer.render_lookat(pipeline, f=(0.0, 0.6, -3.0))
    pipeline.tracer.compaction = 1.0       # every ray has a slot: nothing is dropped
    pipeline.tracer.mid_compaction = 1.0
    compacted = renderer.render_lookat(pipeline, f=(0.0, 0.6, -3.0))
    assert float(compacted.num_overflow) == 0.0
    assert torch.equal(compacted.hit, plain.hit) and torch.equal(compacted.depth, plain.depth)


def test_app_needs_a_card_or_the_cpu():
    """The app runs on the card unless --device cpu: without one, build() raises before
    it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path cannot be shown here")
    cfg = main_nglod.parse_args(["--config", YAML])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_nglod.build(cfg)
