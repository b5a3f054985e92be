"""The NGLOD sphere tracer of the port (K11, K12, K9 and K15 by their plain versions here)
against the JAX package: an analytic sphere field traced by both tracers, and the whole
slice, ``OfflineRenderer.render_lookat`` of a NeuralSDF pipeline with its weights carried
across.

Tolerances. Both tracers take the same steps in the same float order, so on rays that hit
in both the depth and the points agree to 1e-5 (a few ulps of t ~ 2.5, from the field's
own rounding); normals are finite differences of the field over an epsilon of 1e-4, which
scales those ulps up, so they agree to 1e-4. A hit is decided by |sdf| < min_dis: a ray
may hit in one package and not the other only where the field at its final point lies
within ``MARGIN`` of min_dis. On these inputs no ray is such a ray: the masks are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import both_rays, jax_sdf_pipeline, np_of, sdf_params_from_jax

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.models.nefs.base_nef import BaseNeuralField as JBaseNeuralField
from wisp_tpu.ops.mesh import make_sphere_mesh as jmake_sphere_mesh
from wisp_tpu.ops.mesh import sample_surface as jsample_surface
from wisp_tpu.ops.spc.core import quantize_points as jquantize_points
from wisp_tpu.trainers.tracker.offline_renderer import OfflineRenderer as JOfflineRenderer
from wisp_tpu.tracers.packed_sdf_tracer import PackedSDFTracer as JPackedSDFTracer

from wisp_tpu_torch import interop
from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.models.nefs.base_nef import BaseNeuralField
from wisp_tpu_torch.ops.mesh.io import make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import sample_surface
from wisp_tpu_torch.ops.spc.core import quantize_points_np
from wisp_tpu_torch.trainers.tracker.offline_renderer import OfflineRenderer
from wisp_tpu_torch.tracers.packed_sdf_tracer import PackedSDFTracer

DEPTH_ATOL = 1e-5
NORMAL_ATOL = 1e-4
MARGIN = 1e-5


class _Grid:
    def __init__(self, blas):
        self.blas = blas
        self.num_lods = 1
        self.active_lods = (blas.max_level,)


class JSphereNef(JBaseNeuralField):
    """|x| - 0.5 (tests/apps/test_nglod.py's analytic field)."""

    def __init__(self, grid):
        self.grid = grid
        super().__init__()

    def register_forward_functions(self):
        self._register_forward_function(self.sdf, ["sdf"])

    def sdf(self, coords, lod_idx=None):
        return jnp.linalg.norm(coords, axis=-1, keepdims=True) - 0.5


class SphereNef(BaseNeuralField):
    def __init__(self, grid):
        super().__init__()
        self.grid = grid

    def register_forward_functions(self):
        self._register_forward_function(self.sdf, ["sdf"])

    def sdf(self, coords, lod_idx=None):
        return torch.linalg.norm(coords, dim=-1, keepdim=True) - 0.5


def _assert_trace_close(got, want, sdf_at_want_xyz, min_dis):
    """The hit-mask rule and tolerances of the module docstring."""
    hj, hp = np.asarray(want.hit)[..., 0], np_of(got.hit)[..., 0]
    differ = hj != hp
    near = np.abs(np.abs(sdf_at_want_xyz) - min_dis) <= MARGIN
    assert not (differ & ~near).any(), f"{differ.sum()} rays hit in one package only"
    both = hj & hp
    assert both.mean() > 0.2
    for key, atol in (("depth", DEPTH_ATOL), ("xyz", DEPTH_ATOL), ("normal", NORMAL_ATOL),
                      ("rgb", NORMAL_ATOL)):
        a, b = np.asarray(want.channels[key]), np_of(got.channels[key])
        assert a.shape == b.shape, key
        np.testing.assert_allclose(b[both], a[both], atol=atol, rtol=0, err_msg=key)
    for key in ("depth", "normal", "alpha"):
        assert (np_of(got.channels[key])[~hp] == 0).all(), key
    return differ.sum()


def test_analytic_sphere_trace_matches_jax():
    """The analytic sphere on the level-4 octree of its surface samples: the 64 rays of
    tests/apps/test_nglod.py and 448 seeded rays towards the box."""
    v, f = make_sphere_mesh(radius=0.5, subdivisions=3)
    jv, jf = jmake_sphere_mesh(radius=0.5, subdivisions=3)
    q = quantize_points_np(sample_surface(v, f, 200000), 4)
    np.testing.assert_array_equal(q, jquantize_points(jsample_surface(jv, jf, 200000), 4))
    jnef = JSphereNef(_Grid(JOctreeAS.from_quantized_points(q, 4)))
    nef = SphereNef(_Grid(OctreeAS.from_quantized_points(q, 4, device="cpu")))

    n = 64
    ys = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    o64 = np.stack([ys, np.zeros(n, np.float32), np.full(n, -3.0, np.float32)], -1)
    d64 = np.broadcast_to(np.asarray([0.0, 0.0, 1.0], np.float32), (n, 3))
    rng = np.random.default_rng(30)
    o_rand = rng.normal(size=(448, 3)).astype(np.float32)
    o_rand = 3.0 * o_rand / np.linalg.norm(o_rand, axis=-1, keepdims=True)
    d_rand = rng.normal(scale=0.3, size=(448, 3)).astype(np.float32) - o_rand / 3.0
    d_rand /= np.linalg.norm(d_rand, axis=-1, keepdims=True)
    origins = np.concatenate([o64, o_rand]).astype(np.float32)
    dirs = np.concatenate([d64, d_rand]).astype(np.float32)
    jrays, rays = both_rays(origins, dirs, 0.0, 10.0)

    kw = dict(num_steps=64, step_size=0.8, min_dis=1e-3)
    want = jax.jit(lambda r: JPackedSDFTracer(**kw)(jnef, r))(jrays)
    got = PackedSDFTracer(**kw)(nef, rays)
    sdf = np.linalg.norm(np.asarray(want.xyz), axis=-1) - 0.5
    assert _assert_trace_close(got, want, sdf, kw["min_dis"]) == 0
    hit = np_of(got.hit)[:n, 0]
    assert hit[np.abs(ys) < 0.4].all() and not hit[np.abs(ys) > 0.55].any()
    assert float(got.num_overflow) == 0.0
    # a tracer that holds the field gives the same trace
    held = PackedSDFTracer(**kw).with_free_dist(nef.grid.blas)(nef, rays)
    assert torch.equal(held.depth, got.depth) and torch.equal(held.hit, got.hit)
    # compaction is ported (tests/test_torch_sdf_compaction.py): an ample budget gives the
    # same trace
    ample = PackedSDFTracer(compaction=0.9, **kw)(nef, rays)
    assert float(ample.num_overflow) == 0.0
    assert torch.equal(ample.depth, got.depth) and torch.equal(ample.hit, got.hit)


def test_render_lookat_sdf_slice_matches_jax():
    """The whole slice at 32x32: a NeuralSDF pipeline (level 5, 3 LODs, hidden 32) whose
    decoder is ``sphere_sdf_decoder``, rendered from (0, 0.6, -3) by both packages."""
    dec = interop.sphere_sdf_decoder(16, 32, seed=0)
    jpipe = jax_sdf_pipeline(level=5, num_lods=3, hidden_dim=32, decoder=dec)
    params, config = sdf_params_from_jax(jpipe)
    pipe = interop.build_sdf_pipeline(params, config, device="cpu")
    eye = (0.0, 0.6, -3.0)
    want = JOfflineRenderer(render_res=(32, 32)).render_lookat(jpipe, f=eye)
    got = OfflineRenderer(render_res=(32, 32), device="cpu").render_lookat(pipe, f=eye)
    assert tuple(got.depth.shape) == (32, 32, 1) and tuple(got.normal.shape) == (32, 32, 3)
    xyz = np.asarray(want.xyz).reshape(-1, 3)
    sdf = np.asarray(jax.jit(jpipe.nef.sdf)(jnp.asarray(xyz))).reshape(32, 32)
    assert _assert_trace_close(got, want, sdf, jpipe.tracer.min_dis) == 0
    assert np_of(got.hit).mean() >= 0.5
