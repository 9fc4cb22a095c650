"""Dedicated oracle for the convex-envelope occluder subset
(scene/compile.py "occluder subset").

Claim under test: a triangle on the scene's convex envelope can never
intersect a shadow segment whose endpoints both lie on/inside the hull
— so any-hit over the subset must equal any-hit over the FULL triangle
set for every area/sphere-light NEE ray (path_tracing.h:119-131 in the
reference: surface point -> light point). Violations would show as
light leaks through removed walls.

Also gates the exclusions: media scenes (volumetric NEE rays originate
at scatter points outside the hull, vol_path_tracing.h:335-439) and
envmap scenes (shadow rays to infinity) must keep the full set, and
degenerate triangles must be dropped from the subset (they can never
produce a hit: zero normal -> det == 0, guarded out).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from lajolla_tpu.scene.parser import parse_scene
from lajolla_tpu.ops.intersect import _occluded_batched

from scene_fixtures import SCENES

REF = "/root/reference/scenes"


def _occluded_full(scene, o, d, tnear, tfar):
    """Same arithmetic as _occluded_batched, over the FULL cast table."""
    import types as _t
    full = _t.SimpleNamespace(cast_tri_occ=scene.cast_tri,
                              cast_occ_quad=scene.cast_quad)
    return _occluded_batched(full, o, d, tnear, tfar)


def _surface_points(scene, rng, n):
    """Random points on the scene's triangles (and spheres if present):
    exactly the endpoint population of area/sphere-light NEE segments.
    Returns (points, unit normals of the carrying surface)."""
    p0 = np.asarray(scene.tri_p0)
    e1 = np.asarray(scene.tri_e1)
    e2 = np.asarray(scene.tri_e2)
    T = p0.shape[0]
    ti = rng.integers(0, T, size=n)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = p0[ti] + u[:, None] * e1[ti] + v[:, None] * e2[ti]
    nrm = np.cross(e1[ti], e2[ti])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    S = np.asarray(scene.sph_center).shape[0]
    if S and np.asarray(scene.sph_radius).max() > 0:
        m = n // 4
        si = rng.integers(0, S, size=m)
        dirs = rng.normal(size=(m, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        sp = np.asarray(scene.sph_center)[si] + \
            np.asarray(scene.sph_radius)[si][:, None] * dirs
        pts[:m] = sp
        nrm[:m] = dirs
    return pts.astype(np.float32), nrm.astype(np.float32)


def _check_subset_oracle(scene, seed=3, n=4096):
    from lajolla_tpu.dtypes import shadow_eps
    rng = np.random.default_rng(seed)
    a, na = _surface_points(scene, rng, n)
    b, nb = _surface_points(scene, rng, n)
    # exactly the production NEE shadow-ray parameterization
    # (integrators/path.py: tnear = eps_shadow, tfar = (1-eps)*dist):
    # f32 surface points land ulps off their plane, so a smaller tnear
    # would register endpoint self-intersections the estimator never
    # sees (and which the hull subset rightly prunes)
    eps = shadow_eps(scene.meta.scene_radius)
    dist = np.linalg.norm(b - a, axis=1)
    d = (b - a) / np.maximum(dist, 1e-20)[:, None]
    tn = np.full(n, eps, np.float32)
    tf = ((1.0 - eps) * dist).astype(np.float32)
    # drop grazing pairs (ray within ~3 deg of an endpoint's plane):
    # there the FULL set numerically re-hits the endpoint's own
    # supporting plane just past eps_shadow — an artifact occlusion the
    # estimator weights by cos ~ 0, not a real blocker. Everything
    # non-grazing must agree exactly.
    keep = (np.abs(np.einsum('ij,ij->i', d, na)) > 0.05) & \
           (np.abs(np.einsum('ij,ij->i', d, nb)) > 0.05)
    a, d, tn, tf = a[keep], d[keep], tn[keep], tf[keep]
    assert keep.sum() > n // 2
    occ_sub = np.asarray(_occluded_batched(
        scene, jnp.asarray(a), jnp.asarray(d), jnp.asarray(tn),
        jnp.asarray(tf)))
    occ_full = np.asarray(_occluded_full(
        scene, jnp.asarray(a), jnp.asarray(d), jnp.asarray(tn),
        jnp.asarray(tf)))
    np.testing.assert_array_equal(occ_sub, occ_full)


@pytest.mark.parametrize("scene_file,want_smaller", [
    ("cbox/cbox.xml", True),       # walls + block bottoms drop (16 of 38)
    ("veach_mi/mi.xml", False),    # sphere lights extend the hull past
                                   # every plate: nothing drops (still
                                   # exercises the subset code path)
])
def test_occluded_subset_matches_full(scene_file, want_smaller):
    root = SCENES if scene_file.startswith("cbox/") else REF
    scene, _ = parse_scene(f"{root}/{scene_file}")
    T = scene.cast_tri.shape[1]
    T_occ = scene.cast_tri_occ.shape[1]
    if want_smaller:
        assert T_occ < T, "subset not constructed — nothing under test"
    _check_subset_oracle(scene)


def test_media_scene_keeps_full_set():
    """vol_cbox binds a medium to the sensor and as shape exterior:
    its NEE rays start at in-medium scatter points OUTSIDE the hull,
    where envelope walls genuinely occlude. The subset must be the
    identity for any scene with media."""
    scene, _ = parse_scene(f"{REF}/volpath_test/vol_cbox.xml")
    assert scene.meta.num_media > 0
    assert scene.cast_tri_occ.shape == scene.cast_tri.shape


def _hull_scene(rng, n_cloud=40, n_inner=30, degenerate=False):
    """Random convex hull enclosing random interior triangles, built
    through the real SceneBuilder -> compile_scene path."""
    from scipy.spatial import ConvexHull
    from lajolla_tpu.core import transform as xf
    from lajolla_tpu.scene import types as T
    from lajolla_tpu.scene.compile import compile_scene
    from lajolla_tpu.scene.parser import (CameraB, LightB, MaterialB,
                                          MeshB, SceneBuilder, ShapeB,
                                          TexDesc)
    from lajolla_tpu.scene.texture import TexturePool
    from lajolla_tpu.scene.types import RenderOptions

    cloud = rng.normal(size=(n_cloud, 3))
    hull = ConvexHull(cloud)
    pos = [cloud[hull.vertices]]
    remap = {v: i for i, v in enumerate(hull.vertices)}
    idx = [np.array([[remap[a], remap[b], remap[c]]
                     for a, b, c in hull.simplices], np.int32)]
    base = pos[0].shape[0]
    # interior triangles: strictly inside the hull (shrunk toward the
    # cloud centroid)
    c = cloud.mean(axis=0)
    inner = c + 0.4 * rng.normal(size=(n_inner, 3, 3)) * 0.5
    inner = c + (inner - c) * 0.5
    pos.append(inner.reshape(-1, 3))
    idx.append(np.arange(3 * n_inner, dtype=np.int32).reshape(-1, 3) + base)
    if degenerate:
        base2 = base + 3 * n_inner
        p = c + 0.1 * rng.normal(size=3)
        pos.append(np.stack([p, p, p]))  # zero-area triangle
        idx.append(np.array([[base2, base2 + 1, base2 + 2]], np.int32))
    positions = np.concatenate(pos).astype(np.float64)
    indices = np.concatenate(idx)

    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 8], [0, 0, 0], [0, 1, 0]), fov=45.0, width=16, height=16),
        options=RenderOptions(), texture_pool=TexturePool())
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    b.texdescs.append(TexDesc(kind=T.TEX_CONSTANT, const=(0.5, 0.5, 0.5)))
    m.tex[T.P_BASE_COLOR] = 0
    b.materials.append(m)
    b.shapes.append(ShapeB(type=T.SHAPE_MESH,
                           mesh=MeshB(positions=positions, indices=indices),
                           material_id=0, area_light_id=0))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=0,
                           intensity=(1.0, 1.0, 1.0)))
    return compile_scene(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_hull_subset(seed):
    rng = np.random.default_rng(seed)
    scene = _hull_scene(rng)
    T = scene.cast_tri.shape[1]
    T_occ = scene.cast_tri_occ.shape[1]
    # every hull face must have been dropped (they ARE the envelope)
    assert T_occ < T
    _check_subset_oracle(scene, seed=seed + 100, n=2048)


def test_degenerate_tris_excluded():
    """A zero-area triangle can never register a hit (det == 0 is
    guarded out), so the subset must drop it — and occlusion results
    must still match the full set."""
    rng = np.random.default_rng(7)
    scene_d = _hull_scene(rng, degenerate=True)
    rng = np.random.default_rng(7)
    scene_n = _hull_scene(rng, degenerate=False)
    Td = scene_d.cast_tri_occ.shape[1]
    Tn = scene_n.cast_tri_occ.shape[1]
    assert Td == Tn, "degenerate tri must not enter the occluder subset"
    _check_subset_oracle(scene_d, seed=11, n=2048)
