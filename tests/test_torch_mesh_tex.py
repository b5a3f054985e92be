"""The texture path of the NGLOD app against the JAX package: the nearest surface point
(K17 by its plain version here), barycentric coordinates, the texture lookup and
``closest_tex``, the OBJ reader and writers, ``OctreeAS.from_mesh`` and
``MeshSampledSDFDataset``.

Tolerances. ``closest_point``: the triangle equal except where two triangles lie within
2 ulp of each other's squared distance (argmin's choice then rests on rounding), distance
and point within 1e-6. Colours within 1e-5 (a bilinear blend of the same texels, through
barycentrics that differ by ulps). Points, codes, UVs and materials exactly; the signed
distance within 1e-5 (tests/test_torch_mesh_sdf.py's tolerance)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import np_of

from wisp_tpu.accelstructs import OctreeAS as JOctreeAS
from wisp_tpu.datasets.formats.mesh_sampled_sdf import (MeshSampledSDFDataset as
                                                        JMeshSampledSDFDataset)
from wisp_tpu.ops import mesh as jmesh
from wisp_tpu.ops.mesh.closest_tex import closest_tex as jclosest_tex
from wisp_tpu.ops.mesh.closest_tex import sample_tex as jsample_tex
from wisp_tpu.ops.mesh.compute_sdf import closest_point as jclosest_point

from wisp_tpu_torch.accelstructs.octree_as import OctreeAS
from wisp_tpu_torch.app.nglod.main_nglod import procedural_texture
from wisp_tpu_torch.datasets.formats.mesh_sampled_sdf import MeshSampledSDFDataset
from wisp_tpu_torch.ops.mesh import closest_tex as tex
from wisp_tpu_torch.ops.mesh.compute_sdf import closest_point, triangle_table
from wisp_tpu_torch.ops.mesh.io import load_obj, make_sphere_mesh, write_mtl, write_obj
from wisp_tpu_torch.ops.mesh.ops import (barycentric_coordinates, closest_point_on_triangle,
                                         dot3, normalize, sample_surface)

RGB_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _mesh():
    """The normalized subdivision-2 icosphere, its planar UVs and seeded query points."""
    v, f = normalize(*make_sphere_mesh(radius=1.0, subdivisions=2), "sphere")
    texv = ((v[:, :2] + 1.0) / 2.0).astype(np.float32)
    rng = np.random.default_rng(17)
    base = v[rng.integers(0, len(v), 600)]
    pts = np.concatenate([base + rng.normal(scale=0.03, size=base.shape),
                          rng.uniform(-1.0, 1.0, (600, 3)), v[:40]]).astype(np.float32)
    return v, f, texv, pts


def test_closest_point_matches_jax():
    v, f, _, pts = _mesh()
    jd, jn, jt = jclosest_point(v, f, pts)
    tris = triangle_table(v, f)
    d, n, t = closest_point(torch.from_numpy(pts), tris)
    assert t.dtype == torch.int64 and tuple(n.shape) == (len(pts), 3)
    np.testing.assert_allclose(np_of(d), jd, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np_of(n), jn, atol=1e-6, rtol=0)
    differ = np_of(t) != jt
    if differ.any():
        p = torch.from_numpy(pts[differ])

        def d2_to(ti):
            ti = torch.from_numpy(np.asarray(ti))
            cp = closest_point_on_triangle(p, tris[ti, 0:3], tris[ti, 3:6], tris[ti, 6:9])
            return dot3(p - cp, p - cp)

        a, b = d2_to(np_of(t)[differ]), d2_to(jt[differ])
        assert bool(((a - b).abs() <= 2 * torch.finfo(torch.float32).eps * b).all())
    assert differ.mean() < 0.05


def test_barycentrics_and_sample_tex_match_jax():
    v, f, texv, pts = _mesh()
    rng = np.random.default_rng(18)
    tri = f[rng.integers(0, len(f), len(pts))]
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    want = np.asarray(jmesh.barycentric_coordinates(*(jnp.asarray(x) for x in (pts, a, b, c))))
    got = barycentric_coordinates(*(torch.from_numpy(x) for x in (pts, a, b, c)))
    np.testing.assert_allclose(np_of(got), want, atol=1e-5, rtol=1e-5)
    # UVs outside [0, 1] exercise the reflection padding; material -1 is black
    tp = rng.uniform(-0.6, 1.6, (len(pts), 2)).astype(np.float32)
    tm = rng.integers(-1, 3, len(pts))
    materials = procedural_texture() + [{"diffuse": np.float32([0.2, 0.5, 0.9])}, {}]
    want = jsample_tex(tp, tm, materials)
    got = tex.sample_tex(torch.from_numpy(tp), torch.from_numpy(tm), materials)
    np.testing.assert_allclose(np_of(got), want, atol=RGB_ATOL, rtol=0)
    assert (want[tm == 1] == np.float32([0.2, 0.5, 0.9])).all() and (want[tm < 0] == 0).all()


def test_closest_tex_matches_jax():
    v, f, texv, pts = _mesh()
    face_mats = np.zeros(len(f), np.int32)
    for uv, tf in ((texv, f.copy()), (None, None)):
        want = jclosest_tex(v, f, uv, tf, procedural_texture(), face_mats, pts)
        got = tex.closest_tex(v, f, uv, tf, procedural_texture(), face_mats,
                              torch.from_numpy(pts))
        np.testing.assert_allclose(np_of(got[0]), want[0], atol=RGB_ATOL, rtol=0)
        np.testing.assert_allclose(np_of(got[1]), want[1], atol=1e-6, rtol=0)
        np.testing.assert_allclose(np_of(got[2]), want[2], atol=1e-6, rtol=0)


def test_obj_round_trip_matches_jax(tmp_path):
    """A written .obj with UVs and a flat Kd material reads back as JAX reads it; an image
    texture (map_Kd) is refused, naming its ROADMAP item."""
    v, f, texv, _ = _mesh()
    path = str(tmp_path / "ball.obj")
    write_obj(path, v, f, texv=texv, texf=f, mtl_name="paint")
    write_mtl(str(tmp_path / "ball.mtl"), "paint", diffuse=(0.25, 0.5, 0.75))
    got = load_obj(path, load_materials=True)
    want = jmesh.load_obj(path, load_materials=True)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a, b)
    assert len(got[5]) == len(want[5]) == 1
    np.testing.assert_array_equal(got[5][0]["diffuse"], want[5][0]["diffuse"])
    for a, b in zip(load_obj(path), jmesh.load_obj(path)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], v, rtol=1e-6)
    plain = str(tmp_path / "plain.obj")
    write_obj(plain, v, f)
    for a, b in zip(load_obj(plain, load_materials=True), jmesh.load_obj(plain, True)):
        assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b))
    write_mtl(str(tmp_path / "ball.mtl"), "paint", texture_path="paint.png")
    with pytest.raises(NotImplementedError, match="map_Kd.*item 7"):
        load_obj(path, load_materials=True)


def test_sample_surface_normals_match_jax():
    v, f, _, _ = _mesh()
    got = sample_surface(v, f, 3000, rng=np.random.default_rng(5), return_normals=True)
    want = jmesh.sample_surface(v, f, 3000, rng=np.random.default_rng(5), return_normals=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_from_mesh_matches_jax(tmp_path):
    v, f, _, _ = _mesh()
    path = str(tmp_path / "ball.obj")
    write_obj(path, v * 0.7, f)
    got = OctreeAS.from_mesh(path, level=4, num_samples=20_000, device="cpu")
    want = JOctreeAS.from_mesh(path, level=4, num_samples=20_000)
    assert len(got.codes) == len(want.codes) == 5
    for a, b in zip(got.codes, want.codes):
        np.testing.assert_array_equal(a.astype(np.uint64), np.asarray(b).astype(np.uint64))
    np.testing.assert_array_equal(got.extent.vertices, want.extent.vertices)
    np.testing.assert_array_equal(got.extent.faces, want.extent.faces)


def test_mesh_sampled_dataset_matches_jax():
    """The app's textured icosphere (main_nglod.py:80-93) at 1,000 samples, a resample,
    and the untextured dataset with normals."""
    v, f, texv, _ = _mesh()
    kw = dict(vertices=v, faces=f, texv=texv, texf=f.copy(), materials=procedural_texture(),
              face_mats=np.zeros(len(f), np.int32), num_samples=1000, sample_tex=True,
              seed=3)
    want = JMeshSampledSDFDataset(**kw)
    got = MeshSampledSDFDataset(device="cpu", **kw)
    for _ in range(2):
        np.testing.assert_array_equal(np_of(got.coordinates), want.coordinates)
        np.testing.assert_allclose(np_of(got.sdf_data), want.sdf_data, atol=1e-5, rtol=0)
        np.testing.assert_allclose(np_of(got.rgb_data), want.rgb_data, atol=RGB_ATOL, rtol=0)
        got.resample()
        want.resample()
    batch = got[np.arange(10)]
    assert set(batch) == {"coords", "sdf", "rgb"} and tuple(batch.rgb.shape) == (10, 3)
    want = JMeshSampledSDFDataset(vertices=v, faces=f, num_samples=500, get_normals=True)
    got = MeshSampledSDFDataset(vertices=v, faces=f, num_samples=500, get_normals=True,
                                device="cpu")
    np.testing.assert_array_equal(np_of(got.coordinates), want.coordinates)
    np.testing.assert_array_equal(np_of(got.normals_data), want.normals_data)
    np.testing.assert_allclose(np_of(got.sdf_data), want.sdf_data, atol=1e-5, rtol=0)
