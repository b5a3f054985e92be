"""The port's mesh sampling and exact mesh distance (K16's plain version) against the JAX
package, on the CPU.

* ``compute_sdf_plain`` against JAX's ``compute_sdf`` on the hard meshes of
  tests/core/test_compute_sdf.py (the cube's corners and edges, a thin slab's midplane, the
  L-prism's concave edge), on a subdivision-1 icosphere with seeded points near and far,
  and with triangle chunks smaller than the mesh, so that the vote sums over chunks. Both
  do the same float operations, but XLA and PyTorch may order the sum of the votes
  differently: the signed distance is held to 1e-5, and a sign may differ only where
  |d| < 1e-5 (a point on the surface, where the vote is noise).
* ``closest_point_on_triangle`` to 1e-6 (the same branch-free arithmetic).
* ``sample_spc``, ``point_sample`` and ``sample_uniform`` equal to JAX's under the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)

from wisp_tpu.ops.mesh.compute_sdf import compute_sdf as jax_compute_sdf
from wisp_tpu.ops.mesh import ops as jops
from wisp_tpu.ops.spc import sampling as jsampling

from wisp_tpu_torch.ops.mesh import ops
from wisp_tpu_torch.ops.mesh.compute_sdf import compute_sdf_plain
from wisp_tpu_torch.ops.mesh.io import make_box_mesh, make_sphere_mesh
from wisp_tpu_torch.ops.spc.sampling import sample_spc

SDF_ATOL = 1e-5


def l_prism():
    """Watertight non-convex L-shaped prism with a concave edge along z (the mesh of
    tests/core/test_compute_sdf.py)."""
    outline = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]], np.float32)
    n = len(outline)
    bot = np.concatenate([outline, np.full((n, 1), -0.5, np.float32)], -1)
    top = np.concatenate([outline, np.full((n, 1), 0.5, np.float32)], -1)
    cap = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 5]], np.int32)
    sides = []
    for i in range(n):
        j = (i + 1) % n
        sides += [[i, j, j + n], [i, j + n, i + n]]
    return (np.concatenate([bot, top], 0),
            np.concatenate([cap[:, ::-1], cap + n, np.asarray(sides, np.int32)], 0))


def hard_cases():
    """(name, vertices, faces, points): the queries of tests/core/test_compute_sdf.py plus
    seeded points around each mesh."""
    rng = np.random.default_rng(5)
    cube = make_box_mesh((0.5, 0.5, 0.5))
    slab = make_box_mesh((1.0, 1.0, 0.02))
    prism = l_prism()
    cube_pts = [[0.6, 0.6, 0.6], [0.7, 0.55, 0.55], [-0.6, 0.6, -0.6], [0.55, 0.55, 0.0],
                [0.0, -0.6, 0.6], [0.45, 0.45, 0.45], [0.49, 0.49, 0.0], [0.0, 0.0, 0.0]]
    slab_pts = [[0.0, 0.0, 0.0], [0.5, -0.3, 0.0], [0.0, 0.0, 0.021], [1.001, 0.0, 0.0],
                [0.999, 0.999, 0.0]]
    prism_pts = [[1.05, 1.05, 0.0], [1.0001, 1.0001, 0.0], [0.95, 0.95, 0.0],
                 [1.2, 1.2, 0.0], [1.05, 1.05, 0.49]]
    out = []
    for name, (v, f), pts, lo, hi in (("cube", cube, cube_pts, -0.8, 0.8),
                                      ("slab", slab, slab_pts, -1.2, 1.2),
                                      ("l_prism", prism, prism_pts, -0.3, 2.3)):
        extra = rng.uniform(lo, hi, (200, 3))
        out.append((name, v, f, np.concatenate([np.asarray(pts), extra]).astype(np.float32)))
    return out


def assert_sdf_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    flip = (got < 0) != (want < 0)
    assert (np.abs(want[flip]) < SDF_ATOL).all(), (got[flip], want[flip])
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=SDF_ATOL, rtol=0)
    np.testing.assert_allclose(got[~flip], want[~flip], atol=SDF_ATOL, rtol=0)


@pytest.mark.parametrize("case", hard_cases(), ids=lambda c: c[0])
def test_compute_sdf_plain_matches_jax_on_hard_meshes(case):
    _, v, f, pts = case
    want = jax_compute_sdf(v, f, pts)
    got = compute_sdf_plain(v, f, torch.from_numpy(pts)).numpy()
    assert_sdf_close(got, want)
    assert (want < 0).any() and (want > 0).any()


def sphere_points(v, n, seed):
    """Seeded points around a mesh of radius ~0.7: half within 0.03 of the surface, half
    anywhere in the box."""
    rng = np.random.default_rng(seed)
    base = v[rng.integers(0, len(v), n // 2)]
    near = base + rng.normal(scale=0.03, size=base.shape)
    far = rng.uniform(-1.0, 1.0, (n - n // 2, 3))
    return np.concatenate([near, far]).astype(np.float32)


@pytest.mark.parametrize("tri_chunk", [8192, 23])
def test_compute_sdf_plain_matches_jax_on_icosphere(tri_chunk):
    v, f = make_sphere_mesh(0.7, subdivisions=1)
    pts = sphere_points(v, 2000, seed=tri_chunk)
    want = jax_compute_sdf(v, f, pts, tri_chunk=tri_chunk)
    got = compute_sdf_plain(v, f, torch.from_numpy(pts), point_chunk=700,
                            tri_chunk=tri_chunk).numpy()
    assert len(f) > tri_chunk or tri_chunk == 8192
    assert_sdf_close(got, want)
    # the icosphere's distance is close to the sphere's, the signs are the sphere's
    assert np.abs(np.abs(got) - np.abs(np.linalg.norm(pts, axis=-1) - 0.7)).max() < 0.1


def test_closest_point_on_triangle_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    tri = rng.uniform(-1.0, 1.0, (3, 500, 3)).astype(np.float32)
    tri[:, :20] = tri[:, :1]                      # some degenerate (point) triangles
    tri[1, 20:40] = tri[0, 20:40]                 # and some with a collapsed edge
    want = np.asarray(jops.closest_point_on_triangle(*(jnp.asarray(x) for x in (p, *tri))))
    got = ops.closest_point_on_triangle(*(torch.from_numpy(x) for x in (p, *tri))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sampling_matches_jax_exactly():
    v, f = make_sphere_mesh(1.0, subdivisions=2)
    v, f = ops.normalize(v, f, "sphere")
    leaves = np.random.default_rng(0).integers(0, 16, (50, 3)).astype(np.int32)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(sample_spc(leaves, 4, 8, rng=a),
                                  jsampling.sample_spc(leaves, 4, 8, rng=b))
    modes = ["rand", "near", "near", "trace", "trace"]
    np.testing.assert_array_equal(ops.point_sample(v, f, modes, 300, rng=a),
                                  jops.point_sample(v, f, modes, 300, rng=b))
    np.testing.assert_array_equal(ops.sample_uniform(1000, rng=a),
                                  jops.sample_uniform(1000, rng=b))
    np.testing.assert_array_equal(ops.per_face_normals(v, f), jops.per_face_normals(v, f))


def test_sdf_iou_matches_jax():
    from wisp_tpu.ops.sdf import metrics as jmetrics
    from wisp_tpu_torch.ops.sdf import metrics
    rng = np.random.default_rng(6)
    pred, gt = rng.normal(size=(2, 1000, 1)).astype(np.float32)
    pts = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    want = jmetrics.compute_sdf_iou(pred, gt)
    assert metrics.compute_sdf_iou(torch.from_numpy(pred), gt) == want
    assert metrics.compute_sdf_iou(pred, gt) == want
    field = lambda p: (p ** 2).sum(-1) - 0.5             # noqa: E731
    assert (metrics.compute_sparse_sdf_iou(field, torch.from_numpy(pts), gt)
            == jmetrics.compute_sparse_sdf_iou(lambda p: jnp.sum(p ** 2, -1) - 0.5, pts, gt))
    assert metrics.compute_sdf_iou(np.ones(4), np.ones(4)) == 0.0   # empty union
