"""Dense brute-force casters against the scalar Moller-Trumbore oracle
(ops/intersect.py _brute_force_scalar) on the in-repo cbox: closest hit,
any hit over the occluder subset, the quad-merge remap, ragged ray
counts, misses and the tnear/tfar window. Each closest-hit case runs for
the fused XLA caster and for the Pallas/Triton kernel in interpret mode
(32 rays per program, so that ragged ray counts cross several
programs); any hit has the one XLA caster on every backend."""

import dataclasses

import jax
import numpy as np
import pytest

from lajolla_tpu.ops.intersect import (_brute_force_batched,
                                       _brute_force_scalar,
                                       _occluded_batched)
from lajolla_tpu.ops.intersect_pallas import _intersect
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.scene.parser import parse_scene_to_builder
from lajolla_tpu.testing import caster_parity_rays, occluder_triangles
from scene_fixtures import CBOX

IMPLS = {
    "xla": _brute_force_batched,
    "triton": lambda s, o, d, a, b: _intersect(s, o, d, a, b, block_r=32,
                                               interpret=True),
}


@pytest.fixture(scope="module")
def cbox():
    b = parse_scene_to_builder(CBOX)
    b.camera.width = b.camera.height = 16
    scene = compile_scene(b)
    return scene, caster_parity_rays(scene, b.options, seed=1)


def _oracle(scene, o, d, tn, tf):
    out = jax.vmap(_brute_force_scalar, (None, 0, 0, 0, 0))(
        scene, o, d, tn, tf)
    return tuple(np.asarray(x) for x in out)


def _closest(impl, scene, o, d, tn, tf):
    return tuple(np.asarray(x) for x in IMPLS[impl](scene, o, d, tn, tf))


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_closest_hit_matches_oracle(impl, cbox):
    scene, (closest, _) = cbox
    t0, p0, u0, v0 = _oracle(scene, *closest)
    t, p, u, v = _closest(impl, scene, *closest)
    np.testing.assert_array_equal(p, p0)
    hit = p0 >= 0
    assert hit.mean() > 0.5
    np.testing.assert_allclose(t[hit], t0[hit], rtol=1e-5)
    np.testing.assert_allclose(u[hit], u0[hit], atol=1e-5)
    np.testing.assert_allclose(v[hit], v0[hit], atol=1e-5)
    assert np.isinf(t[~hit]).all()


@pytest.mark.parametrize("rays", ["shadow", "closest"])
def test_any_hit_matches_oracle(rays, cbox):
    """Any hit over the occluder subset, for shadow segments (camera hit
    -> light point) and for the unbounded camera and bounce rays; the
    oracle tests the triangles behind the occluder subset."""
    scene, (closest, shadow) = cbox
    o, d, tn, tf = shadow if rays == "shadow" else closest
    ids = occluder_triangles(scene)
    sub = dataclasses.replace(scene, tri_p0=scene.tri_p0[ids],
                              tri_e1=scene.tri_e1[ids],
                              tri_e2=scene.tri_e2[ids])
    want = _oracle(sub, o, d, tn, tf)[1] >= 0
    got = np.asarray(_occluded_batched(scene, o, d, tn, tf))
    assert 0.02 < want.mean() < 0.98
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_quad_back_half_remaps_to_partner(impl, cbox):
    """Rays aimed at the u + v > 1 half of every merged quad must report
    the partner triangle and its own barycentrics."""
    scene, _ = cbox
    src = np.asarray(scene.cast_src)
    alt = np.asarray(scene.cast_alt)
    partners = alt[alt != src]
    assert partners.size == 12
    p0 = np.asarray(scene.tri_p0)[partners]
    e1 = np.asarray(scene.tri_e1)[partners]
    e2 = np.asarray(scene.tri_e2)[partners]
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    target = p0 + 0.3 * e1 + 0.3 * e2
    o = (target + 5.0 * n).astype(np.float32)
    d = (-n).astype(np.float32)
    tn = np.zeros(len(o), np.float32)
    tf = np.full(len(o), np.inf, np.float32)
    t, p, u, v = _closest(impl, scene, o, d, tn, tf)
    np.testing.assert_array_equal(p, partners)
    np.testing.assert_allclose(t, 5.0, rtol=1e-5)
    np.testing.assert_allclose(u, 0.3, atol=1e-5)
    np.testing.assert_allclose(v, 0.3, atol=1e-5)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("n", [1, 45, 161])
def test_ragged_ray_counts(impl, n, cbox):
    """Ray counts that are not a multiple of the kernel's block."""
    scene, (closest, shadow) = cbox
    sel = tuple(x[:n] for x in closest)
    t0, p0, _, _ = _oracle(scene, *sel)
    t, p, _, _ = _closest(impl, scene, *sel)
    assert t.shape == (n,) and p.shape == (n,)
    np.testing.assert_array_equal(p, p0)
    occ = np.asarray(_occluded_batched(scene, *(x[:n] for x in shadow)))
    assert occ.shape == (n,) and occ.dtype == np.bool_


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_misses(impl, cbox):
    """Rays leaving through the open front of the box, and rays whose
    window is empty, hit nothing."""
    scene, _ = cbox
    o = np.tile(np.float32([278.0, 273.0, -100.0]), (4, 1))
    d = np.float32([[0, 0, -1], [0.1, 0, -0.995], [0, 1, 0], [1, 0, 0]])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.float32([0, 0, 0, 0])
    tf = np.float32([np.inf, np.inf, 0.0, 0.0])
    t, p, u, v = _closest(impl, scene, o, d, tn, tf)
    np.testing.assert_array_equal(p, -1)
    assert np.isinf(t).all()
    np.testing.assert_array_equal(u, 0.0)
    assert not np.asarray(_occluded_batched(scene, o, d, tn, tf)).any()


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_tnear_tfar_window(impl, cbox):
    """A ray from the camera through the short block: the window decides
    whether the block's near face, its far face, or nothing is hit."""
    scene, _ = cbox
    o = np.float32([[185.0, 80.0, -800.0]] * 3)
    d = np.float32([[0.0, 0.0, 1.0]] * 3)
    full = np.float32([0.0]), np.float32([np.inf])
    t_face = _closest(impl, scene, o[:1], d[:1], *full)[0][0]
    assert np.isfinite(t_face)
    tn = np.float32([0.0, t_face + 1.0, 0.0])
    tf = np.float32([np.inf, np.inf, t_face - 1.0])
    t, p, _, _ = _closest(impl, scene, o, d, tn, tf)
    t0, p0, _, _ = _oracle(scene, o, d, tn, tf)
    np.testing.assert_array_equal(p, p0)
    assert p[0] >= 0 and p[1] >= 0 and p[1] != p[0] and p[2] == -1
    assert t[1] > t_face + 1.0
    np.testing.assert_allclose(t[:2], t0[:2], rtol=1e-5)
    occ = np.asarray(_occluded_batched(scene, o, d, tn, tf))
    np.testing.assert_array_equal(occ, [True, True, False])


def test_wavefront_step_dots_are_highest_precision(cbox):
    """Every dot_general in one cbox wavefront step asks for HIGHEST
    operand precision, so a GPU never runs the renderer's float32
    contractions in TF32."""
    from lajolla_tpu.integrators.path import _render_block_sc
    from lajolla_tpu.scene.types import RenderOptions
    scene, _ = cbox
    opts = RenderOptions(integrator='path', samples_per_pixel=1)
    hlo = _render_block_sc.lower(scene, opts, 0, 0, 1).as_text(
        dialect="hlo")
    dots = [ln for ln in hlo.splitlines() if " dot(" in ln]
    bad = [ln for ln in dots if "operand_precision={highest,highest}"
           not in ln]
    assert not bad, bad[:3]
