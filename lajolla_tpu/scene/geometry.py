"""Device-side scene intersection producing full hit records.

The equivalent of intersect()/occluded() + compute_shading_info
(src/intersection.cpp:7-85, shapes/triangle_mesh.inl:65-157,
shapes/sphere.inl:235-260): BVH or brute-force over triangles, brute
force over the (always few) spheres, then pure-gather shading info.
All functions are per-ray; callers vmap.
"""

from typing import NamedTuple

import jax.numpy as jnp

from lajolla_tpu.core.math import (coordinate_system, cross, dot, length,
                                   normalize)
from lajolla_tpu.ops.bvh import bvh_traverse, bvh_occluded
from lajolla_tpu.ops.intersect import (INF, brute_force_spheres,
                                       brute_force_triangles, occluded_brute)

TWO_PI = 6.283185307179586
PI = 3.141592653589793


class Hit(NamedTuple):
    """PathVertex analogue (reference intersection.h:21-37)."""
    valid: jnp.ndarray        # bool
    t: jnp.ndarray            # distance
    position: jnp.ndarray     # (3,)
    geometry_normal: jnp.ndarray  # (3,) flipped toward shading normal
    frame: jnp.ndarray        # (3,3) rows = (tangent, bitangent, shading_n)
    uv: jnp.ndarray           # (2,) texture uv
    st: jnp.ndarray           # (2,) native param (barycentric / sphere angles)
    mean_curvature: jnp.ndarray
    inv_uv_size: jnp.ndarray  # max(|dpdu|, |dpdv|)
    footprint: jnp.ndarray    # uv_screen_size = ray_radius / inv_uv_size
    shape_id: jnp.ndarray
    prim_id: jnp.ndarray
    material_id: jnp.ndarray
    light_id: jnp.ndarray
    interior_med: jnp.ndarray
    exterior_med: jnp.ndarray


def intersect_triangles(scene, o, d, tnear, tfar):
    # brute_force_triangles is a custom_vmap op whose batched rule picks
    # the caster: binned two-level (big scenes), the Pallas/Triton dense
    # kernel (small scenes on the GPU), or the fused XLA dense caster
    # (small scenes elsewhere). The per-lane BVH traversal remains
    # available as an oracle.
    if scene.meta.use_bvh and not scene.meta.use_binned:
        return bvh_traverse(scene, o, d, tnear, tfar)
    return brute_force_triangles(scene, o, d, tnear, tfar)


def cast_scene(scene, o, d, tnear, tfar):
    """Raw closest-hit cast → (t, prim, bu, bv, take_sph). The compact,
    cacheable part of intersect_scene: the wavefront phase machine
    (integrators/volpath.py) casts once at bounce start, carries this
    tuple through the free-flight phases, and rebuilds the full record
    with hit_from_cast only at the vertex."""
    t_tri, prim, bu, bv = intersect_triangles(scene, o, d, tnear, tfar)
    if scene.meta.num_spheres > 0:
        t_sph, sph = brute_force_spheres(scene, o, d, tnear, tfar)
    else:
        t_sph, sph = INF, jnp.int32(-1)
    take_sph = t_sph < t_tri
    t = jnp.where(take_sph, t_sph, t_tri)
    prim = jnp.where(take_sph, sph, prim)
    return t, prim, bu, bv, take_sph


def intersect_scene(scene, o, d, tnear, tfar, ray_radius=0.0, ray_spread=0.0,
                    need_aux=False):
    """Closest hit over triangles + spheres → Hit record. ray_radius/
    ray_spread are the scalar ray-differential state (ray.h:27-33); the
    hit's texture footprint is (radius + spread·t) / |dp/duv|."""
    raw = cast_scene(scene, o, d, tnear, tfar)
    return hit_from_cast(scene, o, d, raw, ray_radius, ray_spread,
                         need_aux)


def hit_from_cast(scene, o, d, raw, ray_radius=0.0, ray_spread=0.0,
                  need_aux=False):
    """Build the full Hit record from a cast_scene tuple.

    Static gating (the wavefront cost lever): uv interpolation, the
    dp/duv Jacobian, curvature and footprint math are only emitted when
    the scene statically needs them (textures present) or `need_aux`
    (debug integrators) — for texture-free scenes like cbox the hit
    record is just position/normal/frame/ids."""
    need_uv = need_aux or scene.meta.needs_uv
    need_diff = need_aux or scene.meta.needs_ray_diff
    t, prim, bu, bv, take_sph = raw
    sph = prim
    valid = t < INF
    prim_c = jnp.maximum(prim, 0)

    # --- triangle record: ONE wide-row fetch (scene/soa.py) -----------------
    from lajolla_tpu.scene.soa import fetch_tri, fetch_shape
    tri = fetch_tri(scene, prim_c)
    p0, p1, p2 = tri.p0, tri.p0 + tri.e1, tri.p0 + tri.e2
    ng_tri = normalize(cross(tri.e1, tri.e2))

    # --- sphere branch --------------------------------------------------------
    sph_c = jnp.where(take_sph, prim_c, 0) \
        if scene.meta.num_spheres > 0 else jnp.int32(0)
    center = scene.sph_center[sph_c]
    radius = scene.sph_radius[sph_c]
    pos = o + t * d
    ng_sph = normalize(pos - center)
    # spherical st (sphere.inl:88-95), y-up
    cart = (pos - center) / jnp.maximum(radius, 1e-20)
    elevation = jnp.arccos(jnp.clip(cart[1], -1.0, 1.0))
    azimuth = jnp.arctan2(cart[2], cart[0])
    st_sph = jnp.stack([azimuth / TWO_PI, elevation / PI])

    shape_id = jnp.where(take_sph,
                         scene.sph_shape[sph_c] if scene.meta.num_spheres > 0
                         else jnp.int32(-1),
                         tri.shape_id)
    shape_id = jnp.where(valid, shape_id, -1)
    shape_c = jnp.maximum(shape_id, 0)
    shape = fetch_shape(scene, shape_c)

    st = jnp.where(take_sph, st_sph, jnp.stack([bu, bv]))
    geometry_normal = jnp.where(take_sph, ng_sph, ng_tri)

    # --- shading normal (triangle: vertex-normal interp,
    # triangle_mesh.inl:125-137) ----------------------------------------------
    w = 1.0 - st[0] - st[1]
    has_n = shape.has_normals > 0
    n0, n1, n2 = tri.n0, tri.n1, tri.n2
    sn_interp = normalize(w * n0 + st[0] * n1 + st[1] * n2)
    sn_tri = jnp.where(has_n, sn_interp, ng_tri)
    sn = jnp.where(take_sph, ng_sph, sn_tri)

    need_tangent = need_uv or scene.meta.needs_tangent
    if need_uv:
        # uv interpolation (triangle_mesh.inl:67-83)
        has_uvs = shape.has_uvs > 0
        uv0 = jnp.where(has_uvs, tri.uv0, jnp.array([0.0, 0.0]))
        uv1 = jnp.where(has_uvs, tri.uv1, jnp.array([1.0, 0.0]))
        uv2 = jnp.where(has_uvs, tri.uv2, jnp.array([1.0, 1.0]))
        uv_tri = w * uv0 + st[0] * uv1 + st[1] * uv2
    else:
        uv0 = uv1 = uv2 = None
        uv_tri = st

    if need_tangent:
        # dp/duv from the uv Jacobian (triangle_mesh.inl:84-120)
        if uv0 is None:
            uv0 = jnp.array([0.0, 0.0])
            uv1 = jnp.array([1.0, 0.0])
            uv2 = jnp.array([1.0, 1.0])
        duvds = uv2 - uv0
        duvdt = uv2 - uv1
        det = duvds[0] * duvdt[1] - duvdt[0] * duvds[1]
        inv_det = jnp.where(jnp.abs(det) > 1e-8,
                            1.0 / jnp.where(det == 0, 1.0, det), 0.0)
        dsdu = duvdt[1] * inv_det
        dtdu = -duvds[1] * inv_det
        dsdv = duvdt[0] * inv_det
        dtdv = -duvds[0] * inv_det
        dpds = p2 - p0
        dpdt = p2 - p1
        dpdu = dpds * dsdu + dpdt * dtdu
        dpdv = dpds * dsdv + dpdt * dtdv
        degen = jnp.abs(det) <= 1e-8
        t0_cs, t1_cs = coordinate_system(ng_tri)
        dpdu = jnp.where(degen, t0_cs, dpdu)
        dpdv = jnp.where(degen, t1_cs, dpdv)
        tangent_tri = normalize(dpdu - sn_tri * dot(sn_tri, dpdu))
        bitangent_tri = normalize(cross(sn_tri, tangent_tri))
    else:
        tangent_tri, bitangent_tri = coordinate_system(sn_tri)

    if need_diff and need_tangent:
        dnds = n2 - n0
        dndt = n2 - n1
        dndu = dnds * dsdu + dndt * dtdu
        dndv = dnds * dsdv + dndt * dtdv
        curv_tri = jnp.where(
            has_n,
            (dot(dndu, tangent_tri) + dot(dndv, bitangent_tri)) / 2.0, 0.0)
        inv_uv_tri = jnp.maximum(length(dpdu), length(dpdv))
    else:
        curv_tri = jnp.float32(0.0)
        inv_uv_tri = jnp.float32(1.0)

    if scene.meta.num_spheres > 0:
        # sphere shading frame (sphere.inl:235-260; st treated as angles,
        # replicating the reference verbatim)
        su, sv = st[0], st[1]
        dpdu_s = jnp.stack([-radius * jnp.sin(su) * jnp.sin(sv),
                            radius * jnp.cos(su) * jnp.sin(sv),
                            jnp.zeros_like(su)])
        dpdv_s = jnp.stack([radius * jnp.cos(su) * jnp.cos(sv),
                            radius * jnp.sin(su) * jnp.cos(sv),
                            -radius * jnp.sin(sv)])
        tangent_s = normalize(dpdu_s - ng_sph * dot(ng_sph, dpdu_s))
        bitangent_s = normalize(cross(ng_sph, tangent_s))
        curv_sph = 1.0 / jnp.maximum(radius, 1e-20)
        inv_uv_sph = (length(dpdu_s) + length(dpdv_s)) / 2.0
        uv = jnp.where(take_sph, st, uv_tri)
        tangent = jnp.where(take_sph, tangent_s, tangent_tri)
        bitangent = jnp.where(take_sph, bitangent_s, bitangent_tri)
        mean_curvature = jnp.where(take_sph, curv_sph, curv_tri)
        inv_uv_size = jnp.where(take_sph, inv_uv_sph, inv_uv_tri)
    else:
        uv = uv_tri
        tangent = tangent_tri
        bitangent = bitangent_tri
        mean_curvature = curv_tri
        inv_uv_size = inv_uv_tri

    # flip geometry normal toward shading normal (intersection.cpp:59-62)
    geometry_normal = jnp.where(dot(geometry_normal, sn) < 0,
                                -geometry_normal, geometry_normal)

    frame = jnp.stack([tangent, bitangent, sn], axis=-2)
    return Hit(
        valid=valid,
        t=t,
        position=pos,
        geometry_normal=geometry_normal,
        frame=frame,
        uv=uv,
        st=st,
        mean_curvature=mean_curvature,
        inv_uv_size=inv_uv_size,
        footprint=(ray_radius + ray_spread * t) / jnp.maximum(inv_uv_size,
                                                              1e-20),
        shape_id=shape_id,
        prim_id=jnp.where(valid, prim, -1),
        material_id=jnp.where(valid, shape.material_id, -1),
        light_id=jnp.where(valid, shape.light_id, -1),
        interior_med=jnp.where(valid, shape.interior_med, -1),
        exterior_med=jnp.where(valid, shape.exterior_med, -1),
    )


def occluded(scene, o, d, tnear, tfar):
    """Shadow-ray test (intersection.cpp:67-85)."""
    if scene.meta.use_bvh and not scene.meta.use_binned:
        occ = bvh_occluded(scene, o, d, tnear, tfar)
    else:
        occ = occluded_brute(scene, o, d, tnear, tfar)
    if scene.meta.num_spheres > 0:
        t_sph, sph = brute_force_spheres(scene, o, d, tnear, tfar)
        occ = occ | (sph >= 0)
    return occ
