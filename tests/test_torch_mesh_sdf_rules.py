"""The rules of K16 and K17 redesigned (``csrc/mesh_sdf.cu``), held on the CPU.

* ``one_pass`` repeats K16's one-pass band rule in torch on the plain version's pair
  values (``closest_point_on_triangle``'s d^2 and each pair's vote): a point keeps its
  running minimum and up to K candidates in ascending triangle order, drops those outside
  the band when the list is full (or, as a check that it is the same list, at every new
  minimum), flags an overflow when none can go, and sums the votes of the candidates
  still in the final band in ascending order; a flagged point sums the votes of every
  triangle in the band in ascending order instead. It is held to ``mesh_sdf_plain`` and
  to JAX's ``compute_sdf`` (the distance within 1e-5, a sign flip only where |d| < 1e-5,
  as tests/test_torch_mesh_sdf.py) on a subdivision-3 icosphere, the hard meshes of that
  file (copied) and a 16-sided bipyramid whose apexes have valence 16, where K = 8
  overflows; and to itself with a list that never overflows, bit for bit.
* The triangle's own terms, made once a triangle as the kernel's ``derive`` makes them,
  give back ``closest_point_on_triangle`` bit for bit when the pair routine uses them.
* Each of the pair routine's six quotients, as the kernel makes it (the correctly rounded
  reciprocal of the divisor, then one fma residual step, emulated exactly with numpy),
  equals IEEE division.
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (caps torch's threads)

from wisp_tpu.ops.mesh.compute_sdf import compute_sdf as jax_compute_sdf

from wisp_tpu_torch.ops.mesh.compute_sdf import (MESH_SDF_CANDIDATES, mesh_sdf_plain,
                                                 triangle_table)
from wisp_tpu_torch.ops.mesh.io import make_box_mesh, make_sphere_mesh
from wisp_tpu_torch.ops.mesh.ops import closest_point_on_triangle, dot3, normalize

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


def bipyramid(sides=16, radius=0.6, height=0.5):
    """A closed bipyramid: a regular ``sides``-gon in z = 0 and two apexes at z = +-height
    of valence ``sides``; 2 * sides outward triangles."""
    ang = 2.0 * np.pi * np.arange(sides) / sides
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros(sides)], -1)
    v = np.concatenate([ring, [[0.0, 0.0, height], [0.0, 0.0, -height]]]).astype(np.float32)
    f = []
    for k in range(sides):
        j = (k + 1) % sides
        f += [[k, j, sides], [j, k, sides + 1]]
    return v, np.asarray(f, np.int32)


def cases():
    """name -> (vertices, faces, points): the icosphere of the NGLOD app with points near
    and far, the queries of tests/core/test_compute_sdf.py with seeded points around each
    hard mesh (as tests/test_torch_mesh_sdf.py hard_cases), and the bipyramid with points
    near each apex, on its axis, at the centre and at random."""
    rng = np.random.default_rng(5)
    sv, sf = normalize(*make_sphere_mesh(1.0, subdivisions=3), "sphere")
    base = sv[rng.integers(0, len(sv), 150)]
    sphere_pts = np.concatenate([base + rng.normal(scale=0.02, size=base.shape),
                                 rng.uniform(-1.0, 1.0, (150, 3))])
    cube_pts = [[0.6, 0.6, 0.6], [0.7, 0.55, 0.55], [-0.6, 0.6, -0.6], [0.55, 0.55, 0.0],
                [0.0, -0.6, 0.6], [0.45, 0.45, 0.45], [0.49, 0.49, 0.0], [0.0, 0.0, 0.0]]
    slab_pts = [[0.0, 0.0, 0.0], [0.5, -0.3, 0.0], [0.0, 0.0, 0.021], [1.001, 0.0, 0.0],
                [0.999, 0.999, 0.0]]
    prism_pts = [[1.05, 1.05, 0.0], [1.0001, 1.0001, 0.0], [0.95, 0.95, 0.0],
                 [1.2, 1.2, 0.0], [1.05, 1.05, 0.49]]
    apexes = np.asarray([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5]])
    bipyramid_pts = np.concatenate([
        [[0.0, 0.0, 0.0], [0.0, 0.0, 0.55], [0.0, 0.0, -0.52], [0.0, 0.0, 0.3]],
        apexes[rng.integers(0, 2, 60)] + rng.normal(scale=0.02, size=(60, 3))])
    out = {"icosphere": (sv, sf, sphere_pts)}
    for name, (v, f), pts, lo, hi in (("cube", make_box_mesh((0.5, 0.5, 0.5)), cube_pts,
                                       -0.8, 0.8),
                                      ("slab", make_box_mesh((1.0, 1.0, 0.02)), slab_pts,
                                       -1.2, 1.2),
                                      ("l_prism", l_prism(), prism_pts, -0.3, 2.3),
                                      ("bipyramid", bipyramid(), bipyramid_pts, -0.8, 0.8)):
        out[name] = (v, f, np.concatenate([pts, rng.uniform(lo, hi, (200, 3))]))
    return {k: (v, f, p.astype(np.float32)) for k, (v, f, p) in out.items()}


CASES = cases()


@functools.lru_cache(maxsize=None)
def pairs(name):
    """(points, table, d2 [P, T], vote [P, T]) of a case: each pair's squared distance and
    its weighted vote alpha_t * dot(p - cp_t, n_t), in the plain version's arithmetic."""
    v, f, pts = CASES[name]
    tris = triangle_table(v, f)
    p = torch.from_numpy(pts)
    va, vb, vc, nrm, ang = (tris[:, k:k + 3] for k in range(0, 15, 3))
    q = p[:, None]
    cp = closest_point_on_triangle(q, va[None], vb[None], vc[None])
    diff = q - cp
    d2 = dot3(diff, diff)
    v0, v1, v2 = (vb - va)[None], (vc - va)[None], cp - va[None]
    d00, d01, d11 = dot3(v0, v0), dot3(v0, v1), dot3(v1, v1)
    d20, d21 = dot3(v2, v0), dot3(v2, v1)
    denom = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
    bv = (d11 * d20 - d01 * d21) / denom
    bw = (d00 * d21 - d01 * d20) / denom
    bu = 1.0 - bv - bw
    eb = 1e-4
    at_a, at_b, at_c = (bv < eb) & (bw < eb), (bu < eb) & (bw < eb), (bu < eb) & (bv < eb)
    on_vertex = at_a | at_b | at_c
    on_edge = ~on_vertex & ((bu < eb) | (bv < eb) | (bw < eb))
    angle = torch.where(at_a, ang[None, :, 0], torch.where(at_b, ang[None, :, 1],
                                                           ang[None, :, 2]))
    pi = torch.full_like(angle, np.pi)
    alpha = torch.where(on_vertex, angle, torch.where(on_edge, pi, 2.0 * pi))
    return p, tris, d2, alpha * dot3(diff, nrm[None])


JAX_TRIANGLES, JAX_POINTS = 32, 264    # the hard meshes' one compiled shape in JAX


@functools.lru_cache(maxsize=None)
def jax_sdf(name):
    """JAX's ``compute_sdf`` of a case. The hard meshes are padded to JAX_TRIANGLES
    triangles (copies of one triangle 1,000 away, never in a band) and JAX_POINTS points
    (sliced off), so that their jitted chunks compile once."""
    v, f, pts = CASES[name]
    n = len(pts)
    if name != "icosphere":
        far = np.asarray([[1e3, 0.0, 0.0], [1e3 + 1.0, 0.0, 0.0], [1e3, 1.0, 0.0]])
        far_face = len(v) + np.arange(3)
        v = np.concatenate([v, far]).astype(np.float32)
        f = np.concatenate([f, np.tile(far_face, (JAX_TRIANGLES - len(f), 1))])
        pts = np.concatenate([pts, np.repeat(pts[:1], JAX_POINTS - n, 0)])
    return np.asarray(jax_compute_sdf(v, f.astype(np.int32), pts))[:n]


def one_pass(d2, vote, k, eager=False):
    """K16's rule on the pair values: (signed distance [P], overflowed [P])."""
    n_pts, n_tris = d2.shape
    rows = torch.arange(n_pts)
    m = torch.full((n_pts,), float("inf"))
    limit = m.clone()
    cand_t = torch.zeros((n_pts, k), dtype=torch.int64)
    cand_d = torch.full((n_pts, k), float("inf"))
    held = torch.zeros((n_pts,), dtype=torch.int64)
    over = torch.zeros((n_pts,), dtype=torch.bool)

    def drop(sel):
        """Keep, in order, the candidates of rows ``sel`` that lie in the band."""
        keep = (cand_d <= limit[:, None]) & (torch.arange(k)[None] < held[:, None])
        order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
        cand_t[sel] = torch.gather(cand_t, 1, order)[sel]
        cand_d[sel] = torch.gather(cand_d, 1, order)[sel]
        held[sel] = keep.sum(dim=1)[sel]

    for t in range(n_tris):
        d = d2[:, t]
        take = d <= limit
        if not bool(take.any()):
            continue
        lower = take & (d < m)
        m = torch.where(lower, d, m)
        limit = m + (1e-8 + 1e-4 * m)
        if eager:
            drop(lower & ~over)
        full = take & ~over & (held == k)
        if not eager and bool(full.any()):
            drop(full)
        over |= full & (held == k)
        ins = take & ~over
        cand_t[rows[ins], held[ins]] = t
        cand_d[rows[ins], held[ins]] = d[ins]
        held[ins] += 1
    s = torch.zeros((n_pts,))
    for c in range(k):
        use = ~over & (c < held) & (cand_d[:, c] <= limit)
        s = torch.where(use, s + vote[rows, cand_t[:, c]], s)
    for t in range(n_tris) if bool(over.any()) else ():
        s = torch.where(over & (d2[:, t] <= limit), s + vote[:, t], s)
    d = torch.sqrt(m)
    return torch.where(s < 0.0, -d, d), over


def assert_sdf_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    flip = (got < 0) != (want < 0)
    assert (np.abs(want[flip]) < SDF_ATOL).all(), (got[flip], want[flip])
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=SDF_ATOL, rtol=0)
    np.testing.assert_allclose(got[~flip], want[~flip], atol=SDF_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_one_pass_band_rule_matches_plain_and_jax(name):
    p, tris, d2, vote = pairs(name)
    got, over = one_pass(d2, vote, MESH_SDF_CANDIDATES)
    want = mesh_sdf_plain(p, tris)
    assert_sdf_close(want.numpy(), jax_sdf(name))
    assert torch.equal(got.abs(), want.abs())          # the same d2min, the same sqrt
    assert_sdf_close(got.numpy(), want.numpy())
    assert_sdf_close(got.numpy(), jax_sdf(name))
    # a list long enough never to overflow gives the same bits: the overflow path sums
    # the same votes in the same order
    wide, wide_over = one_pass(d2, vote, d2.shape[1])
    assert not bool(wide_over.any()) and torch.equal(wide, got)
    # dropping at every new minimum keeps the same list
    eager, eager_over = one_pass(d2, vote, MESH_SDF_CANDIDATES, eager=True)
    assert torch.equal(eager_over, over) and torch.equal(eager, got)
    if name == "bipyramid":
        assert int(over.sum()) > 0
        d2min = d2.amin(dim=1)
        band = (d2 <= (d2min + (1e-8 + 1e-4 * d2min))[:, None]).sum(dim=1)
        assert int(band.max()) > MESH_SDF_CANDIDATES


def derive(tris):
    """The kernel's triangle terms (``derive``), in the plain version's operations."""
    a, b, c = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    ab, bc, ac = b - a, c - b, c - a
    ca = -ac
    n = torch.stack([ab[:, 1] * ac[:, 2] - ab[:, 2] * ac[:, 1],
                     ab[:, 2] * ac[:, 0] - ab[:, 0] * ac[:, 2],
                     ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0]], dim=-1)
    d00, d01, d11 = dot3(ab, ab), dot3(ab, ac), dot3(ac, ac)
    return {"a": a, "b": b, "c": c, "ab": ab, "bc": bc, "ca": ca, "ac": ac, "n": n,
            "dd_ab": torch.clamp(dot3(ab, ab), min=1e-20),
            "dd_bc": torch.clamp(dot3(bc, bc), min=1e-20),
            "dd_ca": torch.clamp(dot3(ca, ca), min=1e-20),
            "nn": torch.clamp(dot3(n, n), min=1e-20), "d00": d00, "d01": d01, "d11": d11,
            "denom": torch.clamp(d00 * d11 - d01 * d01, min=1e-20)}


def hoisted_pair(p, t):
    """The kernel's pair routine on [P, 1, 3] points and [1, T] terms: (cp, d2, and the
    (numerator, divisor) of each of its six quotients). Quotients are IEEE divisions here."""
    quotients = []

    def quot(num, den):
        quotients.append((num, den.expand_as(num)))
        return num / den

    def edge(pe, e0, d, dd):
        s = torch.clamp(quot(dot3(pe, d), dd), 0.0, 1.0)
        return e0 + s[..., None] * d

    a, b, c = t["a"], t["b"], t["c"]
    pa, pb, pc = p - a, p - b, p - c
    cand_ab = edge(pa, a, t["ab"], t["dd_ab"])
    cand_bc = edge(pb, b, t["bc"], t["dd_bc"])
    cand_ca = edge(pc, c, t["ca"], t["dd_ca"])
    dist_plane = quot(dot3(pa, t["n"]), t["nn"])
    proj = p - dist_plane[..., None] * t["n"]
    v2 = proj - a
    d20, d21 = dot3(v2, t["ab"]), dot3(v2, t["ac"])
    v = quot(t["d11"] * d20 - t["d01"] * d21, t["denom"])
    w = quot(t["d00"] * d21 - t["d01"] * d20, t["denom"])
    inside = (v >= 0.0) & (w >= 0.0) & (v + w <= 1.0)

    def d2_to(q):
        e = p - q
        return dot3(e, e)

    best = cand_ab
    best = torch.where((d2_to(cand_bc) < d2_to(best))[..., None], cand_bc, best)
    best = torch.where((d2_to(cand_ca) < d2_to(best))[..., None], cand_ca, best)
    cp = torch.where(inside[..., None], proj, best)
    return cp, d2_to(cp), quotients


@pytest.mark.parametrize("name", list(CASES))
def test_hoisted_terms_give_the_plain_closest_point_bit_for_bit(name):
    p, tris, d2, _ = pairs(name)
    a, b, c = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    assert torch.equal(-(c - a), a - c)                  # edge ca's direction is -ac
    terms = {k: x[None] for k, x in derive(tris).items()}
    cp, got_d2, _ = hoisted_pair(p[:, None], terms)
    want = closest_point_on_triangle(p[:, None], a[None], b[None], c[None])
    assert torch.equal(cp, want)
    assert torch.equal(got_d2, d2)


def fma32(x, y, z):
    """fma(x, y, z) of float32 arrays, rounded once to float32: x * y is exact in float64,
    the sum's rounding error comes from TwoSum, and a float64 sum that lies on a float32
    midpoint is rounded by the sign of that error."""
    prod = x.astype(np.float64) * y.astype(np.float64)
    zz = z.astype(np.float64)
    s = prod + zz
    bb = s - prod
    err = (prod - (s - bb)) + (zz - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r.astype(np.float64), np.inf, -np.inf)
                         .astype(np.float32))
    mid = (r.astype(np.float64) + other.astype(np.float64)) / 2.0
    on_mid = (s == mid) & (err != 0.0)
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(on_mid, np.where(err > 0.0, up, down), r).astype(np.float32)


def markstein(num, den):
    """The kernel's quotient: q = num * rcp(den), then q + fma(-q, den, num) * rcp."""
    rcp = (np.float32(1.0) / den).astype(np.float32)
    q = (num * rcp).astype(np.float32)
    return fma32(fma32(-q, den, num), rcp, q)


def test_fma32_rounds_once():
    # (1 + 2^-23)(1 - 2^-24) + 2^-47 + 2^-60 = 1 + 2^-24 + 2^-60 lies just above the
    # midpoint of 1 and 1 + 2^-23: rounding twice (to float64, then to float32) gives 1,
    # rounding once gives 1 + 2^-23
    x, y = np.float32(1.0 + 2.0 ** -23), np.float32(1.0 - 2.0 ** -24)
    z = np.float32(2.0 ** -47 + 2.0 ** -60)
    assert np.float32(float(x) * float(y) + float(z)) == np.float32(1.0)
    got = fma32(np.asarray([x]), np.asarray([y]), np.asarray([z]))[0]
    assert got == np.float32(1.0 + 2.0 ** -23)


@pytest.mark.parametrize("name", list(CASES))
def test_corrected_reciprocal_quotient_is_ieee_division(name):
    p, tris, _, _ = pairs(name)
    terms = {k: x[None] for k, x in derive(tris).items()}
    _, _, quotients = hoisted_pair(p[:, None], terms)
    for num, den in quotients:
        num, den = num.reshape(-1).numpy(), den.reshape(-1).numpy()
        np.testing.assert_array_equal(markstein(num, den), (num / den).astype(np.float32))
