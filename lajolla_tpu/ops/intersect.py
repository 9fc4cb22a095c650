"""Ray-primitive intersection (device side).

Replaces the Embree calls behind intersect()/occluded()
(src/intersection.cpp:7-85). All functions are written per-ray
(scalar-style) and vmapped into the wavefront by callers; custom vmap
rules hand the batched rays to dense casters that XLA fuses into SoA
vector code.

Conventions (matching Embree's, so downstream shading math carries over):
hit point = (1-u-v)*v0 + u*v1 + v*v2; triangles tested with
Moller-Trumbore; spheres with the numerically-stable quadratic
(src/shapes/sphere.inl:15-38).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lajolla_tpu.core.math import cross, dot

INF = np.float32(np.inf)


def ray_triangle(o, d, p0, e1, e2, tnear, tfar):
    """Moller-Trumbore. Returns (t, u, v, hit) — scalars (or batched over
    triangle arrays if p0/e1/e2 carry a leading axis)."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    # No backface culling (Embree default). Guard near-zero determinant.
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) &
           (u + v <= 1.0) & (t > tnear) & (t < tfar))
    return t, u, v, hit


def ray_sphere(o, d, center, radius, tnear, tfar):
    """Numerically-stable sphere quadratic; returns (t, hit) for the
    nearest root in (tnear, tfar)."""
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * jnp.where(b >= 0.0, b + sqrt_disc, b - sqrt_disc)
    safe = lambda num, den: jnp.where(jnp.abs(den) > 1e-30, num / jnp.where(
        jnp.abs(den) > 1e-30, den, 1.0), INF)
    t0 = safe(q, a)
    t1 = safe(c, q)
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    t = jnp.where((tlo > tnear) & (tlo < tfar), tlo,
                  jnp.where((thi > tnear) & (thi < tfar), thi, INF))
    hit = valid & (t < INF)
    return jnp.where(hit, t, INF), hit


# ---------------------------------------------------------------------------
# Brute-force intersectors (small scenes; also the BVH reference oracle)
# ---------------------------------------------------------------------------

def _brute_force_scalar(scene, o, d, tnear, tfar):
    """Closest hit over ALL triangles (vectorized over the T axis).
    Returns (t, prim_id, u, v). prim_id = -1 on miss."""
    t, u, v, hit = ray_triangle(o[None, :], d[None, :],
                                scene.tri_p0, scene.tri_e1, scene.tri_e2,
                                tnear, tfar)
    t = jnp.where(hit, t, INF)
    i = jnp.argmin(t)
    t_best = t[i]
    miss = t_best == INF
    return (jnp.where(miss, INF, t_best),
            jnp.where(miss, -1, i).astype(jnp.int32),
            u[i], v[i])


def _cast_setup(tab, o, d):
    """Moller-Trumbore of N rays against every cast prim, evaluated as
    (N, 1) x (1, T) broadcasts so XLA fuses it with the acceptance test
    and the reduction that follow: no (N, T) intermediate reaches device
    memory. Same arithmetic as ray_triangle, the scalar oracle's test.
    tab: (9, T) rows [p0 | e1 | e2]; o, d: (N, 3). Returns (t, u, v, ok),
    each (N, T)."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (tab[k][None, :]
                                                    for k in range(9))
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0 / det, 0.0)
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return t, u, v, ok


def _cast_hit(t, u, v, ok, quad, tnear, tfar):
    """Acceptance test; quad-flagged cast prims accept the whole
    parallelogram max(u, v) <= 1."""
    col = lambda x: x[:, None] if jnp.ndim(x) == 1 else x
    lim = jnp.where(quad[None, :] > 0, 1.0 - jnp.maximum(u, v),
                    1.0 - u - v)
    return (ok & (u >= 0.0) & (v >= 0.0) & (lim >= 0.0) &
            (t > col(tnear)) & (t < col(tfar)))


def _closest(a, b):
    """Variadic-reduce combiner: the (t, index) lexicographic minimum,
    carrying its u and v — argmin semantics (first index on ties)."""
    ta, ia, ua, va = a
    tb, ib, ub, vb = b
    take_b = (tb < ta) | ((tb == ta) & (ib < ia))
    return (jnp.where(take_b, tb, ta), jnp.where(take_b, ib, ia),
            jnp.where(take_b, ub, ua), jnp.where(take_b, vb, va))


def resolve_cast_hit(scene, o, d, t, ci, u, v):
    """Cast-prim hit -> true triangle hit. A quad cast hit with
    u + v > 1 lies in the partner triangle; its (t, u, v) are recomputed
    in the partner's own frame (one row gather per ray), so every hit is
    reported in the frame the scalar oracle uses. ci = -1 marks a miss."""
    c = jnp.maximum(ci, 0)
    back = (scene.cast_quad[c] > 0) & (u + v > 1.0)
    prim = jnp.where(back, scene.cast_alt[c], scene.cast_src[c])
    tb, ub, vb, _ = ray_triangle(o, d, scene.tri_p0[prim],
                                 scene.tri_e1[prim], scene.tri_e2[prim],
                                 -INF, INF)
    miss = ci < 0
    return (jnp.where(miss, INF, jnp.where(back, tb, t)),
            jnp.where(miss, -1, prim).astype(jnp.int32),
            jnp.where(miss, 0.0, jnp.where(back, ub, u)),
            jnp.where(miss, 0.0, jnp.where(back, vb, v)))


def _brute_force_batched(scene, o, d, tnear, tfar):
    """Closest hit of N rays against the quad-merged CAST table
    (scene/compile.py _merge_parallelograms), exact fp32. o, d: (N, 3);
    tnear/tfar: (N,). Set-up, acceptance and the arg-min run as one
    fused pass; the arg-min is a single variadic reduce over
    (t, index, u, v). Returns (t, prim, u, v) in TRUE triangle ids.

    The closest-hit caster on the CPU; the GPU runs the Triton kernel of
    ops/intersect_pallas.py instead."""
    t, u, v, ok = _cast_setup(scene.cast_tri, o, d)
    hit = _cast_hit(t, u, v, ok, scene.cast_quad, tnear, tfar)
    t = jnp.where(hit, t, INF)
    idx = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
    t_best, i, ub, vb = jax.lax.reduce(
        (t, idx, u, v),
        (INF, jnp.int32(jnp.iinfo(jnp.int32).max), jnp.float32(0.0),
         jnp.float32(0.0)),
        _closest, (1,))
    ci = jnp.where(t_best == INF, -1, i)
    return resolve_cast_hit(scene, o, d, t_best, ci, ub, vb)


def _occluded_batched(scene, o, d, tnear, tfar):
    """Any-hit over the OCCLUDER SUBSET (convex-envelope tris can never
    block a shadow segment; scene/compile.py cast_tri_occ). The any-hit
    caster on every backend: on the GPU it rendered faster end to end
    than a Triton any-hit kernel (PERF.md)."""
    t, u, v, ok = _cast_setup(scene.cast_tri_occ, o, d)
    return _cast_hit(t, u, v, ok, scene.cast_occ_quad, tnear,
                     tfar).any(axis=1)


@jax.custom_batching.custom_vmap
def brute_force_triangles(scene, o, d, tnear, tfar):
    return _brute_force_scalar(scene, o, d, tnear, tfar)


def _bcast_ray_args(axis_size, in_batched, o, d, tnear, tfar):
    _, o_b, d_b, tn_b, tf_b = in_batched
    if not o_b:
        o = jnp.broadcast_to(o, (axis_size, 3))
    if not d_b:
        d = jnp.broadcast_to(d, (axis_size, 3))
    if not tn_b:
        tnear = jnp.broadcast_to(jnp.asarray(tnear, jnp.float32),
                                 (axis_size,))
    if not tf_b:
        tfar = jnp.broadcast_to(jnp.asarray(tfar, jnp.float32),
                                (axis_size,))
    return o, d, tnear, tfar


@brute_force_triangles.def_vmap
def _brute_force_vmap_rule(axis_size, in_batched, scene, o, d, tnear, tfar):
    o, d, tnear, tfar = _bcast_ray_args(axis_size, in_batched, o, d,
                                        tnear, tfar)
    if scene.meta.use_binned:
        from lajolla_tpu.ops.intersect_binned import intersect_binned
        out = intersect_binned(scene, o, d, tnear, tfar)
    elif jax.default_backend() == 'gpu':
        from lajolla_tpu.ops.intersect_pallas import intersect_brute_triton
        out = intersect_brute_triton(scene, o, d, tnear, tfar)
    else:
        out = _brute_force_batched(scene, o, d, tnear, tfar)
    return out, (True, True, True, True)


@jax.custom_batching.custom_vmap
def occluded_brute(scene, o, d, tnear, tfar):
    """Any-hit over all triangles (scalar form)."""
    t, prim, _, _ = _brute_force_scalar(scene, o, d, tnear, tfar)
    return prim >= 0


@occluded_brute.def_vmap
def _occluded_vmap_rule(axis_size, in_batched, scene, o, d, tnear, tfar):
    o, d, tnear, tfar = _bcast_ray_args(axis_size, in_batched, o, d,
                                        tnear, tfar)
    if scene.meta.use_binned:
        from lajolla_tpu.ops.intersect_binned import occluded_binned
        out = occluded_binned(scene, o, d, tnear, tfar)
    else:
        out = _occluded_batched(scene, o, d, tnear, tfar)
    return out, True


def brute_force_spheres(scene, o, d, tnear, tfar):
    """Closest hit over all spheres. Returns (t, sphere_idx)."""
    t, hit = ray_sphere(o[None, :], d[None, :],
                        scene.sph_center, scene.sph_radius, tnear, tfar)
    t = jnp.where(hit, t, INF)
    i = jnp.argmin(t)
    t_best = t[i]
    miss = t_best == INF
    return jnp.where(miss, INF, t_best), jnp.where(miss, -1, i).astype(jnp.int32)
