"""Gradients of the port against the JAX package, on the CPU (plain versions of the kernels).

* K1 backward: the hash-table gradient against ``jax.grad`` of the JAX ``hashgrid`` (gather
  path, ``dense_matmul=None``); atol 1e-5.
* The whole trace: the gradient of every field parameter of a loss of rgb and alpha, through
  the jittered march, the compaction (also with the budget overflowing), the field, the
  scatter-back and the integration, against ``jax.grad`` of the JAX ``PackedRFTracer.trace``
  loss. The port gets JAX's own jitter, ``u = jax.random.uniform(key, (R, S))``. Tolerance:
  atol 1e-4 (float32 sums in another order; JAX differentiates the inclusive-sum-minus-tau
  form of the transmittance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wisp_tpu.ops import grid as jgrid
from wisp_tpu.utils.filter import TreeSpec

from wisp_tpu_torch.interop import build_pipeline
from wisp_tpu_torch.models.grids.utils import MultiTable
from wisp_tpu_torch.ops import grid as tgrid
from wisp_tpu_torch.ops.compaction import compaction_budget

from test_torch_helpers import (both_rays, jax_pipeline, np_of, params_from_jax, port_name,
                                ray_arrays)

TABLE_ATOL = 1e-5
TRACE_ATOL = 1e-4


@pytest.mark.parametrize("lod_idx", [3, 1])
def test_table_gradient_matches_jax(lod_idx):
    resolutions, bitwidth, f_dim = [4, 8, 16, 32], 10, 2
    mt = MultiTable(resolutions, 3, f_dim, max_feats=2 ** bitwidth, device="cpu")
    first, sizes, rows = mt.begin_idxes, mt.num_feats, mt.total_feats
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1.05, 1.05, (600, 3)).astype(np.float32)
    table = (0.5 * rng.normal(size=(rows, f_dim))).astype(np.float32)
    g = rng.normal(size=(600, 4 * f_dim)).astype(np.float32)
    width = (lod_idx + 1) * f_dim

    def loss(t):
        out = jgrid.hashgrid(jnp.asarray(coords), resolutions, bitwidth, lod_idx, t, first,
                             sizes, dense_matmul=None)
        return jnp.sum(out * g[:, :width])

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(table)))
    got = tgrid.hashgrid_bwd(torch.from_numpy(coords), torch.from_numpy(g), resolutions,
                             bitwidth, lod_idx, rows, first, sizes, out_lods=4)
    np.testing.assert_allclose(np_of(got), want, atol=TABLE_ATOL, rtol=0)
    # autograd through the forward gives the same
    t = torch.from_numpy(table).requires_grad_(True)
    out = tgrid.hashgrid(torch.from_numpy(coords), resolutions, bitwidth, lod_idx, t, first,
                         sizes, out_lods=4)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(np_of(t.grad), want, atol=TABLE_ATOL, rtol=0)


def _trace_grads(carve_seed, compaction, n_rays=96, seed=11):
    jpipe = jax_pipeline(carve_seed=carve_seed, compaction=compaction)
    params, config = params_from_jax(jpipe)
    tpipe = build_pipeline(params, config, device="cpu")
    jr, tr = both_rays(*ray_arrays(n_rays, seed=seed))
    steps = jpipe.tracer.num_steps
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, (n_rays, steps)))
    rng = np.random.default_rng(seed)
    g_rgb = rng.normal(size=(n_rays, 3)).astype(np.float32)
    g_alpha = rng.normal(size=(n_rays, 1)).astype(np.float32)

    spec = TreeSpec(jpipe)

    def jloss(diff):
        p = spec.unflatten(diff, spec.nondiff)
        rb = p(rays=jr, channels=["rgb", "alpha"], key=key)
        return jnp.sum(rb.rgb * g_rgb) + jnp.sum(rb.alpha * g_alpha), rb.num_valid_samples

    (jl, jvalid), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(dict(spec.diff))
    rb = tpipe(rays=tr, channels=["rgb", "alpha"], key=torch.from_numpy(u.copy()))
    tl = (rb.rgb * torch.from_numpy(g_rgb)).sum() + (rb.alpha * torch.from_numpy(g_alpha)).sum()
    tl.backward()
    tgrads = {n: p.grad for n, p in tpipe.named_parameters()}
    budget = compaction_budget(n_rays, steps, compaction) if compaction else None
    return float(jl), float(tl.detach()), float(jvalid), budget, jgrads, tgrads


@pytest.mark.parametrize("carve_seed,compaction", [(None, 0.1), (5, 0.5), (5, 0.0)])
def test_trace_gradients_match_jax(carve_seed, compaction):
    jl, tl, valid, budget, jgrads, tgrads = _trace_grads(carve_seed, compaction)
    if carve_seed is None:
        assert valid > budget, "the overflow case must overflow the budget"
    assert abs(jl - tl) <= TRACE_ATOL * max(1.0, abs(jl))
    assert set(port_name(k) for k in jgrads) == set(tgrads)
    for path, want in jgrads.items():
        got = tgrads[port_name(path)]
        assert got is not None, path
        np.testing.assert_allclose(np_of(got), np.asarray(want), atol=TRACE_ATOL, rtol=0,
                                   err_msg=path)


def _feat_pair(compaction):
    """The small JAX pipeline with an extra channel 'feat' [N, 4] (test_torch_render's
    field) and the port's pipeline with the same weights."""
    from test_torch_render import JFeatNeRF, TFeatNeRF
    from test_torch_helpers import NEF_KW
    jpipe = jax_pipeline(carve_seed=5, compaction=compaction)
    jpipe = jpipe.replace(nef=JFeatNeRF(grid=jpipe.nef.grid, key=jax.random.PRNGKey(4),
                                        **NEF_KW))
    params, config = params_from_jax(jpipe)
    tpipe = build_pipeline(params, config, device="cpu")
    tnef = TFeatNeRF(grid=tpipe.nef.grid, device="cpu", **NEF_KW)
    tnef.load_state_dict(tpipe.nef.state_dict())
    tpipe.nef = tnef
    return jpipe, tpipe


@pytest.mark.parametrize("compaction", [0.5, 0.0])
def test_extra_channel_gradients_match_jax(compaction):
    """A loss on an extra channel (and on rgb) trains the field as JAX's does: the gradient
    of every parameter through the channel itself and through the weights (the extra
    output is alpha * sum w*f), against jax.grad of the JAX trace. Before the port passed
    the extras undetached, the loss on 'feat' reached no parameter."""
    jpipe, tpipe = _feat_pair(compaction)
    n_rays = 64
    jr, tr = both_rays(*ray_arrays(n_rays, seed=12))
    rng = np.random.default_rng(13)
    g_feat = rng.normal(size=(n_rays, 4)).astype(np.float32)
    g_rgb = rng.normal(size=(n_rays, 3)).astype(np.float32)
    channels = ["rgb", "feat"]
    spec = TreeSpec(jpipe)

    def jloss(diff):
        rb = spec.unflatten(diff, spec.nondiff)(rays=jr, channels=channels)
        return jnp.sum(rb.feat * g_feat) + jnp.sum(rb.rgb * g_rgb)

    jgrads = jax.jit(jax.grad(jloss))(dict(spec.diff))
    rb = tpipe(rays=tr, channels=channels)
    ((rb.feat * torch.from_numpy(g_feat)).sum() + (rb.rgb * torch.from_numpy(g_rgb)).sum()
     ).backward()
    tgrads = {n: p.grad for n, p in tpipe.named_parameters()}
    assert set(port_name(k) for k in jgrads) == set(tgrads)
    for path, want in jgrads.items():
        got = tgrads[port_name(path)]
        assert got is not None, path
        np.testing.assert_allclose(np_of(got), np.asarray(want), atol=TRACE_ATOL, rtol=0,
                                   err_msg=path)
    assert max(float(np.abs(np.asarray(w)).max()) for w in jgrads.values()) > 10 * TRACE_ATOL


def test_segmented_trace_refuses_extra_channel_gradients():
    """The segmented trace does not differentiate extra channels (ROADMAP Queue 3): it
    raises where a gradient would need them, and renders them without one."""
    _, tpipe = _feat_pair(0.5)
    _, tr = both_rays(*ray_arrays(32, seed=14))
    kw = dict(rays=tr, channels=["rgb", "feat"], seg_early_stop=1e-3, seg_count=2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        tpipe(**kw)
    with torch.no_grad():
        assert tpipe(**kw).feat.shape == (32, 4)
