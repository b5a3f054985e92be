"""The octree-grid NeRF of the port (OctreeGrid features on a sparse octree, the 'voxel'
march) against the JAX package's, on the CPU, at a small size: blas level 4 from a seeded
point cloud, 2 LODs of 5 features, 'sum', hidden 16, 16 samples a voxel.

* ``rgba`` to 1e-5 (features and colours) and a voxel-mode trace with compaction to 1e-4
  (pixels), with the same mask and valid count.
* One ``MultiviewTrainer`` step with RMSprop (grid lr weight 100) against ``jax.grad`` of
  JAX's ``compute_loss`` and JAX's updated parameters, on the same weights, rays and march
  jitter (JAX's draw from its step key): without AMP, at the config's eps 1e-8, the loss,
  the gradients (to 1e-5 of their norm) and each parameter to 1e-5 of the largest first
  step, lr / sqrt(1 - alpha), ten times its group's rate (7.5e-7 of it seen); with AMP the
  comparison of
  ``tests/test_torch_trainer.py`` (every decoder gradient a bf16 value, every gradient's
  error norm within 2^-6) with the loss to 2e-6 (this step's loss is 0.138: the bf16
  products summed in other orders leave 9.2e-7), and the parameters to 2e-3. The control:
  a port whose decoders stay in float32 misses JAX's AMP loss by 5.2e-6 and fails the same
  comparison. RMSprop's first step moves a
  parameter by lr * g * rsqrt(0.01 g^2 + eps), whose slope at g = 0 is lr / sqrt(eps); under
  AMP eps is 1e-4, as the AdamW tests set it, so that a bf16-level gradient difference is
  not amplified.
* Adaptive rays and compaction on the voxel march: JAX's decisions.
* The feature tables fall in the optimizer's 'grid' group, as JAX's labels put them.
* ``rgba`` with ``max_compute_lod`` on an octree grid (which takes no cap): a TypeError
  before the repair.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.config.presets import ConfigRMSprop as JConfigRMSprop
from wisp_tpu.core import Rays as JRays
from wisp_tpu.datasets.transforms.ray_sampler import SampleRays as JSampleRays
from wisp_tpu.models.grids import OctreeGrid as JOctreeGrid
from wisp_tpu.models.nefs.nerf import NeuralRadianceField as JNeRF
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.tracers import PackedRFTracer as JPackedRFTracer
from wisp_tpu.trainers.multiview_trainer import (ConfigMultiviewTrainer as JConfig,
                                                 MultiviewTrainer as JTrainer)
from wisp_tpu.trainers.tracker.tracker import ConfigTracker, Tracker as JTracker

from wisp_tpu_torch.config.presets import ConfigRMSprop
from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
from wisp_tpu_torch.interop import build_pipeline
from wisp_tpu_torch.trainers.multiview_trainer import ConfigMultiviewTrainer, MultiviewTrainer

from test_torch_helpers import (amp_mismatches, both_rays, grad_errors, np_of, port_name,
                                ray_arrays)

LEVEL, LODS, FEAT, HIDDEN, STEPS = 4, 2, 5, 16, 16
NEF_KW = dict(view_embedder="positional", view_multires=4, hidden_dim=HIDDEN, num_layers=1,
              bias=True, activation_type="relu", layer_type="linear")
TRACER_KW = dict(raymarch_type="voxel", num_steps=STEPS, bg_color=(1.0, 1.0, 1.0),
                 compaction=0.25, march_budget=1024)
TRAIN_KW = dict(grid_lr_weight=100.0, rgb_loss_type="huber", scheduler=True, max_epochs=4,
                valid_every=-1, prune_every=-1)
OPT_KW = dict(lr=1e-3, eps=1e-4)
CHANNELS = ["rgb", "alpha", "depth"]


def _pointcloud(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    centres = np.asarray([[0.25, -0.2, 0.1], [-0.3, 0.3, -0.25]], np.float32)
    pts = centres[rng.integers(0, 2, n)] + rng.normal(scale=0.18, size=(n, 3))
    return np.clip(pts, -1.0, 0.999).astype(np.float32)


def jax_octree_pipeline(feature_std=0.5):
    blas = JOctreeAS.from_pointcloud(_pointcloud(), LEVEL, dilate=1)
    grid = JOctreeGrid(blas=blas, feature_dim=FEAT, num_lods=LODS, multiscale_type="sum",
                       feature_std=feature_std, key=jax.random.PRNGKey(5))
    nef = JNeRF(grid=grid, key=jax.random.PRNGKey(6), **NEF_KW)
    return JPipeline(nef=nef, tracer=JPackedRFTracer(**TRACER_KW))


def octree_params_from_jax(pipe):
    """(params, config) of a JAX octree-grid NeRF for interop.build_pipeline."""
    nef, grid = pipe.nef, pipe.nef.grid
    params = {f"blas.codes.{l}": np.asarray(c).astype(np.uint64)
              for l, c in enumerate(grid.blas.codes)}
    for i, f in enumerate(grid.features):
        params[f"grid.features.{i}"] = np.asarray(f)
    for prefix, dec in (("decoder_density", nef.decoder_density),
                        ("decoder_color", nef.decoder_color)):
        for name, layer in [(f"layers.{i}", l) for i, l in enumerate(dec.layers)] \
                + [("lout", dec.lout)]:
            params[f"{prefix}.{name}.weight"] = np.asarray(layer.weight)
            params[f"{prefix}.{name}.bias"] = np.asarray(layer.bias)
    config = {"blas_level": grid.blas.max_level,
              "grid": {"constructor": "OctreeGrid", "feature_dim": grid.feature_dim,
                       "num_lods": grid.num_lods, "multiscale_type": grid.multiscale_type},
              "nef": NEF_KW, "tracer": TRACER_KW}
    return params, config


# the pipeline of the tests that only read it, built once (a JAX trainer donates, and so
# deletes, its pipeline's arrays: the trainer tests build their own)
_shared_jax_pipeline = functools.lru_cache(maxsize=None)(jax_octree_pipeline)


def _pair(feature_std=0.5, shared=True):
    jpipe = (_shared_jax_pipeline if shared else jax_octree_pipeline)(feature_std)
    params, config = octree_params_from_jax(jpipe)
    return jpipe, build_pipeline(params, config, device="cpu")


def test_rgba_matches_jax():
    jpipe, tpipe = _pair()
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1.0, 1.0, (3000, 3)).astype(np.float32)
    dirs = rng.normal(size=(3000, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want, feats_j = jax.jit(lambda p, c, d: (p.nef.rgba(c, d),
                                             p.nef.grid.interpolate(c, LODS - 1)))(
        jpipe, jnp.asarray(coords), jnp.asarray(dirs))
    got = tpipe.nef.rgba(torch.from_numpy(coords), torch.from_numpy(dirs))
    feats_t = tpipe.nef.grid.interpolate(torch.from_numpy(coords), LODS - 1)
    assert tpipe.nef.effective_feature_dim() == FEAT and feats_t.shape == (3000, FEAT)
    np.testing.assert_allclose(np_of(feats_t), np.asarray(feats_j), atol=1e-5, rtol=0)
    for k in ("rgb", "density"):
        np.testing.assert_allclose(np_of(got[k]), np.asarray(want[k]), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(feats_j)).max() > 0.1
    assert tpipe.nef.prune_streak is None  # an octree grid does not prune


def test_voxel_trace_matches_jax():
    jpipe, tpipe = _pair()
    origins, dirs = ray_arrays(96, seed=5)
    jr, tr = both_rays(origins, dirs, 0.0, 8.0)
    want = jax.jit(lambda p, r: p(rays=r, channels=CHANNELS))(jpipe, jr)
    got = tpipe(rays=tr, channels=CHANNELS)
    for k in CHANNELS:
        np.testing.assert_allclose(np_of(got.channels[k]), np.asarray(want.channels[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_array_equal(np_of(got.hit), np.asarray(want.hit))
    assert float(got.num_valid_samples) == float(want.num_valid_samples) > 0
    assert float(got.num_overflow) == float(want.num_overflow) == 0.0
    assert np.asarray(want.alpha).max() > 0.3


class _Views:
    cameras = {}

    def __init__(self, n=2, transform=None):
        self.transform = transform
        self.n = n

    def __len__(self):
        return self.n


AMP_LOSS_TOL_OCTREE = 2e-6


def _trainers(tmp_path, transforms=(None, None), **kw):
    jpipe, tpipe = _pair(feature_std=0.1, shared=False)
    cfg = dict(TRAIN_KW, **kw)
    jtracker = JTracker(ConfigTracker(log_dir=str(tmp_path), tensorboard=False), "parity")
    jt = JTrainer(JConfig(optimizer=JConfigRMSprop(**OPT_KW), **cfg), jpipe,
                  _Views(transform=transforms[0]), tracker=jtracker)
    tt = MultiviewTrainer(ConfigMultiviewTrainer(optimizer=ConfigRMSprop(**OPT_KW), **cfg),
                          tpipe, _Views(transform=transforms[1]), device="cpu")
    return jt, tt


def _jax_one_step(tmp_path, amp, eps):
    """JAX's trainer takes one RMSprop step on a seeded batch. Returns the starting weights
    (for the port), the step's jitter, loss and gradients (taken before its update) and its
    updated weights."""
    jpipe = jax_octree_pipeline(0.1)
    params, config = octree_params_from_jax(jpipe)
    jtracker = JTracker(ConfigTracker(log_dir=str(tmp_path), tensorboard=False), "parity")
    jt = JTrainer(JConfig(optimizer=JConfigRMSprop(**dict(OPT_KW, eps=eps)), enable_amp=amp,
                          **TRAIN_KW), jpipe, _Views(), tracker=jtracker)
    n = 96
    origins, dirs = ray_arrays(n, seed=21)
    rgb = np.random.default_rng(21).uniform(size=(n, 3)).astype(np.float32)
    jt.pre_training()
    key = jax.random.fold_in(jt._step_base_key, np.uint32(jt.total_iterations))
    k_vox = 15  # every coarse segment at level 3 (budget 1024 // 16 = 64 > 15)
    u = np.array(jax.random.uniform(key, (n, k_vox, STEPS)))
    jrays = JRays(origins, dirs, 0.0, 8.0)
    batch = (jrays, jnp.asarray(rgb), np.int32(jt.total_iterations))

    def loss_of(diff):
        return jt.compute_loss(jt._spec.unflatten(diff, jt._nondiff), batch, key)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(dict(jt._diff))
    jgrads = {path: np.asarray(g) for path, g in jgrads.items()}
    jt.step({"rays": jrays, "rgb": rgb})
    jt._flush_stats()
    new, _ = octree_params_from_jax(jt.sync_pipeline())
    return {"params": params, "config": config, "origins": origins, "dirs": dirs,
            "rgb": rgb, "u": u, "loss": float(jloss), "grads": jgrads, "new": new}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """JAX's one step by (AMP, eps), taken once for the tests that compare with it."""
    done = {}

    def get(amp, eps):
        if (amp, eps) not in done:
            done[amp, eps] = _jax_one_step(tmp_path_factory.mktemp("jax"), amp, eps)
        return done[amp, eps]
    return get


def _one_step(jax_step, amp, port_amp=None, eps=OPT_KW["eps"]):
    """The port's trainer takes JAX's step on the same weights, batch and jitter."""
    j = jax_step(amp, eps)
    tpipe = build_pipeline(j["params"], j["config"], device="cpu")
    port_amp = amp if port_amp is None else port_amp
    tt = MultiviewTrainer(ConfigMultiviewTrainer(optimizer=ConfigRMSprop(
        **dict(OPT_KW, eps=eps)), enable_amp=port_amp, **TRAIN_KW), tpipe, _Views(),
        device="cpu")
    tt.pre_training()
    tt.step({"rays": Rays(torch.from_numpy(j["origins"]), torch.from_numpy(j["dirs"]), 0.0,
                          8.0), "rgb": torch.from_numpy(j["rgb"])},
            key=torch.from_numpy(j["u"]))
    return tt, j


@pytest.mark.parametrize("amp,eps", [(False, 1e-8), (True, 1e-4)])
def test_rmsprop_step_matches_jax(jax_step, amp, eps):
    tt, j = _one_step(jax_step, amp, eps=eps)
    jloss, jgrads = j["loss"], j["grads"]
    if amp:
        assert amp_mismatches(tt, jloss, jgrads, loss_tol=AMP_LOSS_TOL_OCTREE) == []
    else:
        assert abs(jloss - tt.last_loss) <= 1e-5
        for name, (_, err) in grad_errors(tt, jgrads).items():
            assert err <= 1e-5, (name, err)
    assert tt.last_num_overflow == 0.0
    group_of = {id(p): g for g in tt.optimizer.param_groups for p in g["params"]}
    for name, got in tt.pipeline.named_parameters():
        group = group_of[id(got)]
        assert group["eps"] == eps
        # the first step moves a parameter by up to lr / sqrt(1 - alpha)
        step = group["lr"] / math.sqrt(1.0 - group["alpha"])
        np.testing.assert_allclose(np_of(got), j["new"][name[len("nef."):]],
                                   atol=2e-3 if amp else 1e-5 * step, rtol=0, err_msg=name)
    assert set(group_of[id(p)]["name"] for p in tt.pipeline.parameters()) == {"decoder", "grid"}


def test_adaptive_decisions_match_jax_on_a_voxel_march(tmp_path):
    """Adaptive rays and compaction on a 'voxel' march, whose rays have K x num_steps slots
    (15 x 16 here): both packages count num_steps slots a ray, so the port takes JAX's
    decisions, the budget going to 1.0 once the valid samples pass num_steps a ray (a fault
    of the reference, kept: ROADMAP Queue 3)."""
    jt, tt = _trainers(tmp_path, adaptive_compaction=True, target_sample_size=2 ** 14,
                       max_compacted_samples=2 ** 17,
                       transforms=(JSampleRays(4096), SampleRays(4096)))
    assert tt.pipeline.tracer.raymarch_type == jt.pipeline.tracer.raymarch_type == "voxel"
    slots = 15 * STEPS
    # valid shares of the march's slots: dense (to 1.0 at once), sparse (one shrink after
    # the window), mid, dense again
    shares = [0.3] * 3 + [0.001] * 40 + [0.01] * 6 + [0.05] * 3
    decisions = []
    for i, share in enumerate(shares):
        n_rays = jt.train_dataset.transform.num_samples
        assert n_rays == tt.train_dataset.transform.num_samples, i
        valid = max(1.0, float(int(share * n_rays * slots)))
        jt.iteration = tt.iteration = i
        jt._prev_num_samples = tt._prev_num_samples = valid
        jt.calc_adaptive_rays(n_rays)
        tt.calc_adaptive_rays(n_rays)
        want = (jt.train_dataset.transform.num_samples, jt.pipeline.tracer.compaction)
        got = (tt.train_dataset.transform.num_samples, tt.pipeline.tracer.compaction)
        assert got == want, (i, share, got, want)
        decisions.append(got)
    assert len(set(d[1] for d in decisions)) >= 3, "the script should retune the budget"
    assert len(set(d[0] for d in decisions)) >= 2, "the script should retune the rays"
    assert max(d[1] for d in decisions) == 1.0


def test_amp_comparison_fails_a_float32_port(jax_step):
    tt, j = _one_step(jax_step, amp=True, port_amp=False)
    bad = amp_mismatches(tt, j["loss"], j["grads"], loss_tol=AMP_LOSS_TOL_OCTREE)
    assert "loss" in bad
    decoders = [name for name, _ in tt.pipeline.named_parameters() if "decoder" in name]
    assert decoders and all(f"{name} not bf16" in bad for name in decoders), bad


def test_feature_tables_are_in_the_grid_group(tmp_path):
    """JAX labels the OctreeGrid's feature tables 'grid' (lr x grid_lr_weight, no weight
    decay); so does the port, by name."""
    jpipe, tpipe = _pair(shared=False)
    jtracker = JTracker(ConfigTracker(log_dir=str(tmp_path), tensorboard=False), "parity")
    jt = JTrainer(JConfig(optimizer=JConfigRMSprop(**OPT_KW), **TRAIN_KW), jpipe, _Views(),
                  tracker=jtracker)
    tt = MultiviewTrainer(ConfigMultiviewTrainer(optimizer=ConfigRMSprop(**OPT_KW),
                                                 **TRAIN_KW), tpipe, _Views(), device="cpu")
    jlabels = {port_name(path): jt._param_group(path) for path in jt._diff}
    tlabels = {name: tt._param_group(name) for name, _ in tt.pipeline.named_parameters()}
    assert tlabels == jlabels
    assert [n for n, g in tlabels.items() if g == "grid"] == \
        [f"nef.grid.features.{i}" for i in range(LODS)]
    grid = next(g for g in tt.optimizer.param_groups if g["name"] == "grid")
    assert grid["lr"] == pytest.approx(OPT_KW["lr"] * TRAIN_KW["grid_lr_weight"])
    assert grid["weight_decay"] == 0.0 and len(grid["params"]) == LODS


def test_rgba_takes_max_compute_lod_on_an_octree_grid():
    """The tracer hands every grid its LOD cap; only a grid that takes one (a hash grid)
    gets it, as in JAX. An octree grid ignores it."""
    _, tpipe = _pair()
    coords = torch.rand((50, 3)) * 2.0 - 1.0
    dirs = torch.nn.functional.normalize(torch.randn((50, 3)), dim=-1)
    got = tpipe.nef.rgba(coords, dirs, max_compute_lod=0)
    want = tpipe.nef.rgba(coords, dirs)
    assert torch.equal(got["rgb"], want["rgb"]) and torch.equal(got["density"],
                                                                 want["density"])
