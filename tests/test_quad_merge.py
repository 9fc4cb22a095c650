"""Parallelogram (quad) cast-merging: scene/compile.py
_merge_parallelograms + the quad-aware dense casters.

The merge is an acceleration-structure rewrite only — a cast prim
flagged quad covers the EXACT union of its two member triangles (same
supporting plane, same edges), so every caster must agree with the
per-triangle scalar oracle on hit/miss, distance, true prim id and the
member-frame barycentrics. No reference analogue (Embree tests raw
triangles, src/intersection.cpp:32)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lajolla_tpu.scene.parser import parse_scene_to_builder
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.ops.intersect import (_brute_force_batched,
                                       _brute_force_scalar,
                                       _occluded_batched, ray_triangle)

from scene_fixtures import SCENES

REF = "/root/reference/scenes"


def _scene(rel):
    root = SCENES if rel.startswith("cbox/") else REF
    return compile_scene(parse_scene_to_builder(f"{root}/{rel}.xml"))


@pytest.fixture(scope="module")
def cbox():
    return _scene("cbox/cbox")


@pytest.mark.parametrize("rel,tris,casts,merged,occluders", [
    ("cbox/cbox", 38, 26, 12, 13),
    ("veach_mi/mi", None, 6, 6, None),   # every plate pair merges
])
def test_pair_counts(rel, tris, casts, merged, occluders):
    """Deterministic merge coverage (a perf proxy: cast prims = dense
    tests per ray). cbox: 38 tris -> 26 cast prims and a 13-prim
    occluder subset."""
    sc = _scene(rel)
    if tris is not None:
        assert sc.meta.num_triangles == tris
    assert sc.cast_src.shape[0] == casts
    assert int((np.asarray(sc.cast_alt) !=
                np.asarray(sc.cast_src)).sum()) == merged
    if occluders is not None:
        assert sc.cast_tri_occ.shape[1] == occluders


def test_merged_pairs_are_parallelograms(cbox):
    """Every merged pair satisfies the canonical-split invariants the
    casters rely on: A = (p0, p1, p2), B = (p2', p1', p3) with matching
    corner POSITIONS (p2' == p2, p1' == p1), p3 == p1 + p2 - p0, and
    both geometric normals aligned with A's."""
    sc = cbox
    src = np.asarray(sc.cast_src)
    altv = np.asarray(sc.cast_alt)
    V = np.asarray(sc.vertices)
    I = np.asarray(sc.indices)
    diag = np.linalg.norm(V.max(0) - V.min(0))
    for a, b in zip(src, altv):
        if a == b:
            continue
        pa = V[I[a]]
        pb = V[I[b]]
        assert np.abs(pb[0] - pa[2]).max() <= 1e-6 * diag
        assert np.abs(pb[1] - pa[1]).max() <= 1e-6 * diag
        assert np.abs(pb[2] - (pa[1] + pa[2] - pa[0])).max() <= 1e-6 * diag
        na = np.cross(pa[1] - pa[0], pa[2] - pa[0])
        nb = np.cross(pb[1] - pb[0], pb[2] - pb[0])
        assert np.dot(na, nb) > 0


def test_no_merge_for_non_parallelograms():
    """A trapezoid quad (non-parallelogram split) must NOT merge."""
    from lajolla_tpu.scene.compile import _merge_parallelograms
    verts = np.array([[0., 0., 0.], [2., 0., 0.], [1.5, 1., 0.],
                      [0.5, 1., 0.]])
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    alt, consumed = _merge_parallelograms(verts, idx, 2)
    assert not consumed.any()
    assert (alt == np.arange(2)).all()
    # and an exact parallelogram DOES
    verts2 = np.array([[0., 0., 0.], [2., 0., 0.], [2., 1., 0.],
                       [0., 1., 0.]])
    idx2 = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    alt2, consumed2 = _merge_parallelograms(verts2, idx2, 2)
    assert consumed2.sum() == 1 and (alt2 != np.arange(2)).sum() == 1


def _bounds(sc):
    V = np.asarray(sc.vertices)
    return V.min(0), V.max(0)


def _random_rays(sc, n, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = _bounds(sc)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d.astype(np.float32))


@pytest.mark.parametrize("rel", ["cbox/cbox", "veach_mi/mi",
                                 "volpath_test/vol_cbox"])
def test_quad_caster_matches_scalar_oracle(rel):
    """Batched quad caster == per-triangle scalar oracle on random
    interior rays: hit set, true prim ids, and the hit POSITION
    reconstructed from the reported member-frame barycentrics."""
    sc = _scene(rel)
    assert sc.meta.has_quads
    o, d = _random_rays(sc, 4096)
    tb, pb, ub, vb = jax.jit(_brute_force_batched)(sc, o, d, 1e-4, jnp.inf)
    ts, ps, us, vs = jax.jit(jax.vmap(
        lambda o, d: _brute_force_scalar(sc, o, d, 1e-4, jnp.inf)))(o, d)
    tb, pb, ts, ps = map(np.asarray, (tb, pb, ts, ps))
    np.testing.assert_array_equal(pb >= 0, ps >= 0)
    m = pb >= 0
    # prim ids must match EXCEPT on coplanar t-ties (box bottoms
    # resting on the floor): both casters report a valid hit at the
    # same distance (up to fp rounding between the cast prim's and
    # the member triangle's frames) and the winner choice is arbitrary
    diff = pb[m] != ps[m]
    rel = np.abs(tb[m][diff] - ts[m][diff]) / np.abs(ts[m][diff])
    assert (rel <= 1e-4).all(), (diff.sum(), rel.max())
    assert diff.mean() < 0.01    # ties are rare
    P0 = np.asarray(sc.tri_p0)
    E1 = np.asarray(sc.tri_e1)
    E2 = np.asarray(sc.tri_e2)
    ub, vb, us, vs = map(np.asarray, (ub, vb, us, vs))
    posb = P0[pb[m]] + ub[m, None] * E1[pb[m]] + vb[m, None] * E2[pb[m]]
    poss = P0[ps[m]] + us[m, None] * E1[ps[m]] + vs[m, None] * E2[ps[m]]
    lo, hi = _bounds(sc)
    diag = float(np.linalg.norm(hi - lo))
    assert np.abs(posb - poss).max() <= 1e-6 * diag


def test_quad_occlusion_matches_per_tri(cbox):
    """Any-hit over the quad cast table == any-hit over raw triangles
    (bounded segments, endpoints on surfaces — the NEE population)."""
    sc = cbox
    rng = np.random.default_rng(9)
    P0 = np.asarray(sc.tri_p0)
    E1 = np.asarray(sc.tri_e1)
    E2 = np.asarray(sc.tri_e2)
    T = P0.shape[0]
    n = 4096

    def pts(seed):
        r = np.random.default_rng(seed)
        ti = r.integers(0, T, size=n)
        u, v = r.random(n), r.random(n)
        fl = u + v > 1
        u = np.where(fl, 1 - u, u)
        v = np.where(fl, 1 - v, v)
        return P0[ti] + u[:, None] * E1[ti] + v[:, None] * E2[ti], ti

    (a, ta), (c, _) = pts(1), pts(2)
    d = c - a
    dist = np.linalg.norm(d, axis=1)
    d = (d / np.maximum(dist[:, None], 1e-20)).astype(np.float32)
    a = a.astype(np.float32)
    tn = (1e-3 * dist).astype(np.float32)
    tf = ((1 - 1e-3) * dist).astype(np.float32)
    occ_q = np.asarray(jax.jit(_occluded_batched)(
        sc, jnp.asarray(a), jnp.asarray(d), jnp.asarray(tn),
        jnp.asarray(tf)))
    # raw-triangle reference via the scalar closest-hit oracle
    ts, ps, _, _ = jax.jit(jax.vmap(
        lambda o, d, tn, tf: _brute_force_scalar(sc, o, d, tn, tf)))(
            jnp.asarray(a), jnp.asarray(d), jnp.asarray(tn),
            jnp.asarray(tf))
    occ_t = np.asarray(ps) >= 0
    # the occluder subset may differ from raw triangles only by
    # envelope prims, which can never block these segments. The one
    # allowed difference is a grazing tie: a segment lying in its start
    # triangle's plane (floor to block bottom) that crosses a coplanar
    # edge of a face standing on that plane, where the merged quad's
    # frame and the member triangle's round the edge barycentric to
    # opposite sides of 0
    bad = np.nonzero(occ_q != occ_t)[0]
    assert len(bad) <= n // 1000, len(bad)
    na = np.cross(E1[ta], E2[ta])
    na /= np.linalg.norm(na, axis=1, keepdims=True)
    off = np.abs(np.sum(na * (c - a), axis=1))
    for k in bad:
        assert off[k] <= 1e-4 * dist[k], (k, off[k] / dist[k])
        t, u, v, _ = map(np.asarray, ray_triangle(
            a[k], d[k], P0, E1, E2, tn[k], tf[k]))
        w = 1.0 - u - v
        inside = ((u >= -1e-5) & (v >= -1e-5) & (w >= -1e-5) &
                  (t > tn[k]) & (t < tf[k]))
        edge = np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(w))
        assert (inside & (edge <= 1e-5)).any(), k
