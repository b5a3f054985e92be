"""The segmented true-transmittance cull (K6) of the port against the JAX package, on the CPU
(plain versions of the kernels).

The port's ``PackedRFTracer._trace_segmented`` against JAX's, with the weights carried across
by ``interop.build_pipeline``, at the sizes of JAX's own tests (tests/core/test_seg_cull.py:
a dense level-3 octree, 4 LODs at bitwidth 10 over 4..32, hidden 32, 32 steps, 48 rays from
z = -3, no jitter):

* eps 1e-20 (nothing culled) with G = 4 and G = 5 (a padded tail segment): rgb, alpha and
  depth within 1e-5 of the port's unsegmented trace and of JAX's segmented one;
* eps 1e-3 on a field made opaque (the density decoder's output bias raised, so that rays
  saturate inside the box and the cull drops samples): rgb, alpha, depth,
  ``num_overflow`` and ``seg_frac_max`` within 1e-5 of JAX's, the valid count exact;
* the gradients of a loss on rgb for the codebook and both decoders against ``jax.grad`` of
  JAX's segmented trace (8 rays, 16 steps, eps 1e-3 on the opaque field), within 1e-5 of each
  gradient's norm;
* overflow at compaction 1/32 and ``density_max_grid`` (K5 accumulated over the segments)
  equal to JAX's; the overflow under the cull with a 'voxel' march that itself overflows is
  the segments' plus the march's, as JAX sums it;
* the three refusals (with early_stop, without compaction, and seg_count <= 1, which JAX
  runs unsegmented without the cull);
* ``integrate_segment_plain`` chained over G segments equals ``integrate_plain``, and its
  autograd backward equals ``integrate_segment_bwd_plain``'s carry rule;
* the trainer's budget decisions equal JAX's on a scripted ``seg_frac_max`` sequence, its
  render chunk equals JAX's ``_clamp_render_chunk``, and a resume carries
  ``_prev_seg_frac_max``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.config.presets import ConfigAdamW as JConfigAdamW
from wisp_tpu.datasets.transforms.ray_sampler import SampleRays as JSampleRays
from wisp_tpu.models.grids import HashGrid as JHashGrid
from wisp_tpu.models.nefs.nerf import NeuralRadianceField as JNeRF
from wisp_tpu.models.pipeline import Pipeline as JPipeline
from wisp_tpu.tracers import PackedRFTracer as JPackedRFTracer
from wisp_tpu.trainers.multiview_trainer import (ConfigMultiviewTrainer as JConfig,
                                                 MultiviewTrainer as JTrainer)
from wisp_tpu.trainers.tracker.tracker import ConfigTracker, Tracker as JTracker
from wisp_tpu.utils.filter import TreeSpec

from wisp_tpu_torch.core.rays import Rays
from wisp_tpu_torch.datasets.transforms.ray_sampler import SampleRays
from wisp_tpu_torch.interop import build_pipeline
from wisp_tpu_torch.ops.integration import (integrate_plain, integrate_segment_bwd_plain,
                                            integrate_segment_plain)
from wisp_tpu_torch.trainers.base_trainer import ConfigAdamW
from wisp_tpu_torch.trainers.multiview_trainer import ConfigMultiviewTrainer, MultiviewTrainer

from test_torch_helpers import NEF_KW, np_of, params_from_jax, port_name

TOL = 1e-5
OPAQUE_BIAS = 15.0  # added to the density decoder's output bias: rays saturate in the box


def _jax_pipe(num_steps=32, opaque=False, raymarch_type="ray", march_budget=1024):
    blas = JOctreeAS.make_dense(3)
    grid = JHashGrid.from_geometric(blas=blas, feature_dim=2, num_lods=4,
                                    codebook_bitwidth=10, min_grid_res=4, max_grid_res=32,
                                    multiscale_type="cat", feature_std=0.05,
                                    dense_lod_matmul=None, key=jax.random.PRNGKey(3))
    nef = JNeRF(grid=grid, key=jax.random.PRNGKey(4), **NEF_KW)
    if opaque:
        lout = nef.decoder_density.lout
        lout = lout.replace(bias=lout.bias.at[0].add(OPAQUE_BIAS))
        nef = nef.replace(decoder_density=nef.decoder_density.replace(lout=lout))
    tracer = JPackedRFTracer(raymarch_type=raymarch_type, num_steps=num_steps,
                             bg_color=(1.0, 1.0, 1.0), compaction=1.0,
                             march_budget=march_budget)
    return JPipeline(nef=nef, tracer=tracer)


def _with(jpipe, **tracer_kw):
    return jpipe.replace(tracer=jpipe.tracer.replace(**tracer_kw))


def _port(jpipe):
    params, config = params_from_jax(jpipe)
    t = jpipe.tracer
    config["tracer"].update(march_budget=t.march_budget, seg_early_stop=t.seg_early_stop,
                            seg_count=t.seg_count)
    return build_pipeline(params, config, device="cpu")


def _rays(n):
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.tile(np.asarray([[0.0, 0.0, -3.0]], np.float32), (n, 1))
    from wisp_tpu.core import Rays as JRays
    return (JRays(jnp.asarray(origins), jnp.asarray(dirs), 0.0, 8.0),
            Rays(torch.from_numpy(origins), torch.from_numpy(dirs), 0.0, 8.0))


CHANNELS = ["rgb", "alpha", "depth"]


def _jax_trace(jpipe, jrays, density_feedback=False):
    return jax.jit(lambda p, r: p(rays=r, channels=CHANNELS,
                                  density_feedback=density_feedback))(jpipe, jrays)


def _port_trace(jpipe, trays, density_feedback=False, **tracer_kw):
    tpipe = _port(jpipe)
    for k, v in tracer_kw.items():
        setattr(tpipe.tracer, k, v)
    with torch.no_grad():
        return tpipe(rays=trays, channels=CHANNELS, density_feedback=density_feedback)


def _close(got, want, keys=("rgb", "alpha", "depth")):
    for k in keys:
        np.testing.assert_allclose(np_of(got.channels[k]), np.asarray(getattr(want, k)),
                                   atol=TOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def base():
    return _jax_pipe()


@pytest.fixture(scope="module")
def opaque():
    return _jax_pipe(opaque=True)


@pytest.mark.parametrize("seg_count", [4, 5])
def test_negligible_eps_matches_unsegmented_and_jax(base, seg_count):
    jr, tr = _rays(48)
    jpipe = _with(base, seg_early_stop=1e-20, seg_count=seg_count)
    want = _jax_trace(jpipe, jr)
    got = _port_trace(jpipe, tr)
    _close(got, want)
    unseg = _port_trace(jpipe, tr, seg_early_stop=0.0)
    for k in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(np_of(got.channels[k]), np_of(unseg.channels[k]),
                                   atol=TOL, rtol=0, err_msg=k)
    assert float(got.num_valid_samples) == float(unseg.num_valid_samples) \
        == float(want.num_valid_samples) > 0


def test_real_eps_matches_jax(opaque):
    jr, tr = _rays(48)
    jpipe = _with(opaque, seg_early_stop=1e-3, seg_count=4)
    want = _jax_trace(jpipe, jr)
    got = _port_trace(jpipe, tr)
    _close(got, want)
    assert float(got.num_valid_samples) == float(want.num_valid_samples)
    for k in ("num_overflow", "seg_frac_max"):
        assert abs(float(got.channels[k]) - float(getattr(want, k))) <= TOL, k
    unseg = _port_trace(jpipe, tr, seg_early_stop=0.0)
    assert float(got.num_valid_samples) < 0.7 * float(unseg.num_valid_samples), \
        "the opaque field should cull the saturated tail of the rays that hit it"
    # a culled ray's remaining weight is below eps
    assert float((got.rgb - unseg.rgb).abs().max()) <= 1e-3 + TOL


def test_gradients_match_jax(opaque):
    jr, tr = _rays(8)
    jpipe = _with(_jax_pipe(num_steps=16, opaque=True), seg_early_stop=1e-3, seg_count=4)
    g_rgb = np.random.default_rng(5).normal(size=(8, 3)).astype(np.float32)
    spec = TreeSpec(jpipe)

    def jloss(diff):
        rb = spec.unflatten(diff, spec.nondiff)(rays=jr, channels=["rgb"])
        return jnp.sum(rb.rgb * g_rgb)

    jgrads = jax.jit(jax.grad(jloss))(dict(spec.diff))
    tpipe = _port(jpipe)
    rb = tpipe(rays=tr, channels=["rgb"])
    unseg_valid = 0
    with torch.no_grad():
        tpipe.tracer.seg_early_stop = 0.0
        unseg_valid = float(tpipe(rays=tr, channels=["rgb"]).num_valid_samples)
        tpipe.tracer.seg_early_stop = 1e-3
    assert float(rb.num_valid_samples) < unseg_valid, "the case should cull"
    (rb.rgb * torch.from_numpy(g_rgb)).sum().backward()
    tgrads = {n: p.grad for n, p in tpipe.named_parameters()}
    assert set(port_name(k) for k in jgrads) == set(tgrads)
    for path, want in jgrads.items():
        want = np.asarray(want)
        got = np_of(tgrads[port_name(path)])
        scale = float(np.linalg.norm(want))
        assert scale > 0.0, path
        assert float(np.abs(got - want).max()) <= TOL * scale, path


def test_overflow_and_density_feedback_match_jax(base):
    jr, tr = _rays(48)
    jpipe = _with(base, compaction=1.0 / 32, seg_early_stop=1e-20, seg_count=4)
    want = _jax_trace(jpipe, jr, density_feedback=True)
    got = _port_trace(jpipe, tr, density_feedback=True)
    assert float(want.num_overflow) > 0.0
    assert float(got.num_overflow) == float(want.num_overflow)
    assert float(got.num_valid_samples) == float(want.num_valid_samples)
    grid = np_of(got.density_max_grid)
    assert grid.max() > 0.0
    np.testing.assert_allclose(grid, np.asarray(want.density_max_grid), atol=TOL, rtol=0)


def test_overflow_sums_segments_and_voxel_march():
    """The voxel march keeps 2 of a ray's occupied voxels (march_budget 16 at 8 steps) and
    counts the rays with more; the segments' 128-slot budgets drop samples too. JAX's
    num_overflow is the sum of both."""
    jr, tr = _rays(96)
    jpipe = _with(_jax_pipe(num_steps=8, raymarch_type="voxel", march_budget=16),
                  compaction=1.0 / 8, seg_early_stop=1e-20, seg_count=2)
    want = _jax_trace(jpipe, jr)
    got = _port_trace(jpipe, tr)
    with torch.no_grad():
        tpipe = _port(jpipe)
        march = tpipe.nef.grid.raymarch(tr, raymarch_type="voxel", num_samples=8, budget=16)
    assert float(march.num_overflow) > 0.0
    assert float(got.num_overflow) > float(march.num_overflow), "the segments overflow too"
    assert float(got.num_overflow) == float(want.num_overflow)
    _close(got, want)


@pytest.mark.parametrize("kw,match", [
    (dict(early_stop=0.01), "mutually exclusive"),
    (dict(compaction=0.0), "compaction"),
    (dict(seg_count=1), "seg_count"),
])
def test_refusals(base, kw, match):
    tpipe = _port(_with(base, seg_early_stop=1e-3, seg_count=4))
    for k, v in kw.items():
        setattr(tpipe.tracer, k, v)
    _, tr = _rays(8)
    with pytest.raises(ValueError, match=match):
        tpipe(rays=tr, channels=["rgb"])


@pytest.mark.parametrize("g_cnt", [1, 3, 4])
def test_segments_chain_to_integrate_plain(g_cnt):
    rng = np.random.default_rng(g_cnt)
    r, s = 16, 24
    density = torch.from_numpy(rng.uniform(0.0, 3.0, (r, s)).astype(np.float32))
    deltas = torch.from_numpy(rng.uniform(0.05, 0.2, (r,)).astype(np.float32))
    depths = torch.from_numpy(np.cumsum(rng.uniform(0.05, 0.2, (r, s)), 1).astype(np.float32))
    mask = torch.from_numpy(rng.random((r, s)) < 0.7)
    color = torch.from_numpy(rng.uniform(size=(r, s, 3)).astype(np.float32))
    extra = torch.from_numpy(rng.normal(size=(r, s, 2)).astype(np.float32))
    whole = integrate_plain(density, deltas, depths, mask, color, (1.0, 1.0, 1.0),
                            extra=extra)
    s_g = s // g_cnt
    acc = torch.zeros((r,))
    sums = {}
    for g in range(g_cnt):
        cols = slice(g * s_g, (g + 1) * s_g)
        out = integrate_segment_plain(density[:, cols], deltas, depths[:, cols],
                                      mask[:, cols], color[:, cols], acc,
                                      extra=extra[:, cols])
        acc = out["acc_tau"]
        for k in ("rgb", "alpha", "depth", "extra"):
            sums[k] = out[k] if k not in sums else sums[k] + out[k]
    alpha = sums["alpha"]
    torch.testing.assert_close(alpha, whole["alpha"], atol=1e-6, rtol=0)
    torch.testing.assert_close(1.0 - alpha + sums["rgb"], whole["rgb"], atol=1e-6, rtol=0)
    torch.testing.assert_close(sums["depth"], whole["depth"], atol=1e-6, rtol=0)
    torch.testing.assert_close(alpha * sums["extra"], whole["extra"], atol=1e-6, rtol=0)
    tau = density * deltas[:, None] * mask
    torch.testing.assert_close(acc, tau.sum(-1), atol=1e-6, rtol=1e-6)


def test_segment_backward_carry_rule():
    """The K6c rule, dL/dA = g_acc - sum w*gw and dL/dtau_i = T_i e^-tau_i gw_i -
    sum_{k>i} w_k gw_k + g_acc, against autograd of the plain segment (the plain backward
    that the card's kernel is held to)."""
    rng = np.random.default_rng(9)
    r, s = 8, 12
    density = torch.from_numpy(rng.uniform(0.0, 2.0, (r, s)).astype(np.float64))
    deltas = torch.from_numpy(rng.uniform(0.05, 0.3, (r,)).astype(np.float64))
    depths = torch.from_numpy(np.cumsum(rng.uniform(0.05, 0.2, (r, s)), 1))
    mask = torch.from_numpy(rng.random((r, s)) < 0.8)
    color = torch.from_numpy(rng.uniform(size=(r, s, 3)))
    acc = torch.from_numpy(rng.uniform(0.0, 2.0, (r,)))
    g_rgb, g_alpha, g_depth, g_acc = (torch.from_numpy(rng.normal(size=sh))
                                      for sh in ((r, 3), (r, 1), (r, 1), (r,)))
    gd, gc, ga = integrate_segment_bwd_plain(density, deltas, depths, mask, color, acc,
                                             g_rgb, g_alpha, g_depth, g_acc)
    tau = density * deltas[:, None] * mask
    prev = torch.cumsum(tau, -1) - tau
    trans = torch.exp(-(acc[:, None] + prev))
    w = trans * (1.0 - torch.exp(-tau))
    gw = (color * g_rgb[:, None, :]).sum(-1) + g_alpha + g_depth * depths
    later = torch.flip(torch.cumsum(torch.flip(w * gw, [1]), 1), [1]) - w * gw
    dtau = trans * torch.exp(-tau) * gw - later + g_acc[:, None]
    torch.testing.assert_close(gd, dtau * deltas[:, None] * mask, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(gc, w[..., None] * g_rgb[:, None, :], atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(ga, g_acc - (w * gw).sum(-1), atol=1e-12, rtol=1e-10)


# -- the trainer ----------------------------------------------------------------------------

class _Views:
    """The little of a dataset that the trainers read in these tests."""
    cameras = {}

    def __init__(self, transform=None, n=2):
        self.transform = transform
        self.n = n

    def __len__(self):
        return self.n


@pytest.fixture(scope="module")
def trainers(tmp_path_factory, base):
    jpipe = _with(base, compaction=0.25, seg_early_stop=1e-3, seg_count=4)
    tpipe = _port(jpipe)
    cfg = dict(max_epochs=4, valid_every=-1, adaptive_compaction=True,
               target_sample_size=2 ** 14, max_compacted_samples=2 ** 17)
    opt = dict(lr=1e-3, eps=1e-4, weight_decay=1e-2)
    jtracker = JTracker(ConfigTracker(log_dir=str(tmp_path_factory.mktemp("j")),
                                      tensorboard=False), "parity")
    jt = JTrainer(JConfig(optimizer=JConfigAdamW(**opt), **cfg), jpipe,
                  _Views(JSampleRays(4096)), tracker=jtracker)
    tt = MultiviewTrainer(ConfigMultiviewTrainer(optimizer=ConfigAdamW(**opt), **cfg), tpipe,
                          _Views(SampleRays(4096)), device="cpu")
    return jt, tt


def test_adaptive_decisions_key_on_seg_frac_max(trainers):
    jt, tt = trainers
    steps = jt.pipeline.tracer.num_steps
    # (mean valid fraction, peak segment fraction): the peak grows the budget past what
    # the mean asks for, a long low stretch shrinks it, a spike grows it again
    script = [(0.05, 0.3)] * 3 + [(0.01, 0.03)] * 40 + [(0.02, 0.12)] * 6 \
        + [(0.004, 0.01)] * 36
    decisions = []
    for i, (frac, peak) in enumerate(script):
        n_rays = jt.train_dataset.transform.num_samples
        assert n_rays == tt.train_dataset.transform.num_samples, i
        valid = max(1.0, float(int(frac * n_rays * steps)))
        jt.iteration = tt.iteration = i
        jt._prev_num_samples = tt._prev_num_samples = valid
        jt._prev_seg_frac_max = tt._prev_seg_frac_max = peak
        jt.calc_adaptive_rays(n_rays)
        tt.calc_adaptive_rays(n_rays)
        want = (jt.train_dataset.transform.num_samples, jt.pipeline.tracer.compaction)
        got = (tt.train_dataset.transform.num_samples, tt.pipeline.tracer.compaction)
        assert got == want, (i, frac, peak, got, want)
        decisions.append(got)
    assert len(set(d[1] for d in decisions)) >= 3, "the script should retune the budget"


@pytest.mark.parametrize("chunk,num_steps,budget,cap", [
    (32768, 512, 0.25, 2 ** 21), (32768, 512, 0.0625, 2 ** 21), (16384, 192, 1.0, 2 ** 20),
    (4096, 512, 1.0, 2 ** 16), (32768, 64, 0.0, 2 ** 10)])
def test_render_chunk_cap_matches_jax(trainers, chunk, num_steps, budget, cap):
    jt, tt = trainers
    jpipe = _with(jt.pipeline, num_steps=num_steps, compaction=budget)
    jt.cfg.max_compacted_samples = tt.cfg.max_compacted_samples = cap
    tt.pipeline.tracer.num_steps, tt.pipeline.tracer.compaction = num_steps, budget
    try:
        assert tt.clamp_render_chunk(chunk) == jt._clamp_render_chunk(chunk, jpipe)
    finally:
        jt.cfg.max_compacted_samples = tt.cfg.max_compacted_samples = 2 ** 17
        tt.pipeline.tracer.num_steps, tt.pipeline.tracer.compaction = 32, 0.25


def test_resume_carries_seg_frac_max(tmp_path, base):
    from wisp_tpu_torch.trainers import checkpoint
    tpipe = _port(_with(base, compaction=0.25, seg_early_stop=1e-3, seg_count=4))
    cfg = ConfigMultiviewTrainer(optimizer=ConfigAdamW(), max_epochs=2, valid_every=-1,
                                 adaptive_compaction=True)
    tt = MultiviewTrainer(cfg, tpipe, _Views(SampleRays(256)), device="cpu")
    tt._prev_seg_frac_max = 0.1875
    tt._prev_num_samples = 1234.0
    path = checkpoint.save_checkpoint(tt, str(tmp_path / "state"))
    again = MultiviewTrainer(cfg, _port(_with(base, compaction=0.25, seg_early_stop=1e-3,
                                              seg_count=4)),
                             _Views(SampleRays(256)), device="cpu")
    checkpoint.restore_checkpoint(again, path)
    assert again._prev_seg_frac_max == 0.1875
    assert again._prev_num_samples == 1234.0
