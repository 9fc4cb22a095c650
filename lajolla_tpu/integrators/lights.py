"""Light sampling / pdf / emission (device side, per-ray; callers vmap).

Replaces the Light variant ops (light.h:38-70,
lights/diffuse_area_light.inl, lights/envmap.inl) and the shape point
sampling they delegate to (shapes/triangle_mesh.inl:24-63,
shapes/sphere.inl:156-230).
"""

from typing import NamedTuple

import jax.numpy as jnp

from lajolla_tpu.core.distribution import sample_alias, sample_cdf
from lajolla_tpu.core.math import (cross, dot, distance_squared, make_frame,
                                   normalize, to_world)
from lajolla_tpu.core.transform import xform_vector
from lajolla_tpu.scene.soa import (fetch_light, fetch_row, fetch_shape,
                                   fetch_tri)
from lajolla_tpu.scene.texeval import lookup_trilinear, image_mip_level
from lajolla_tpu.scene.types import LIGHT_ENVMAP, SHAPE_SPHERE

PI = 3.141592653589793
TWO_PI = 6.283185307179586
INV_PI = 1.0 / PI
INV_TWO_PI = 1.0 / TWO_PI


class LightPoint(NamedTuple):
    position: jnp.ndarray  # (3,)
    normal: jnp.ndarray    # (3,); for envmap: direction pointing outwards
                           # from the light (light.h:40-44)


def sample_light(scene, u):
    """Power-weighted light pick (scene.cpp:48-52, scene.h:85-88)."""
    return sample_cdf(scene.light_cdf, u).astype(jnp.int32)


def light_pmf(scene, light_id):
    return fetch_row(scene.light_pmf, jnp.maximum(light_id, 0))


def _sample_point_on_mesh(scene, shape, uv, w):
    """Area-weighted triangle pick via the per-shape alias table (ONE
    row gather; replaces the log2(T)-gather staircase-CDF search) +
    sqrt-uv barycentric point (triangle_mesh.inl:24-38). uv[0] doubles
    as the accept/alias coin and is remapped back to U[0,1)."""
    c = jnp.maximum(shape.prim_count, 1)
    f = w * c.astype(jnp.float32)
    j = shape.prim_start + jnp.clip(f.astype(jnp.int32), 0, c - 1)
    row = scene.tri_alias[jnp.maximum(j, 0)]
    q = row[0]
    take = uv[0] < q
    tri_id = jnp.where(take, j, row[1].astype(jnp.int32))
    u0 = jnp.where(take, uv[0] / jnp.maximum(q, 1e-12),
                   (uv[0] - q) / jnp.maximum(1.0 - q, 1e-12))
    tri = fetch_tri(scene, tri_id)
    v0, e1, e2 = tri.p0, tri.e1, tri.e2
    a = jnp.sqrt(jnp.clip(u0, 0.0, 1.0))
    b1 = 1.0 - a
    b2 = a * uv[1]
    return LightPoint(position=v0 + e1 * b1 + e2 * b2,
                      normal=normalize(cross(e1, e2)))


def _sample_point_on_sphere(scene, shape_id, ref_point, uv, sph_idx):
    """Cone sampling toward the sphere w/ inside-uniform fallback
    (sphere.inl:156-204)."""
    center = scene.sph_center[sph_idx]
    r = scene.sph_radius[sph_idx]
    d2 = distance_squared(ref_point, center)
    inside = d2 < r * r

    # inside: uniform sphere
    z = 1.0 - 2.0 * uv[0]
    r_ = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * uv[1]
    off_in = jnp.stack([r_ * jnp.cos(phi), r_ * jnp.sin(phi), z])

    # outside: cone
    dir_to_center = normalize(center - ref_point)
    fr = make_frame(dir_to_center)
    sin_el_max_sq = r * r / jnp.maximum(d2, 1e-20)
    cos_el_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_el_max_sq))
    cos_el = (1.0 - uv[0]) + uv[0] * cos_el_max
    sin_el = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_el * cos_el))
    azimuth = uv[1] * TWO_PI
    dc = jnp.sqrt(d2)
    ds = dc * cos_el - jnp.sqrt(jnp.maximum(
        0.0, r * r - dc * dc * sin_el * sin_el))
    cos_alpha = (dc * dc + r * r - ds * ds) / jnp.maximum(2.0 * dc * r, 1e-20)
    sin_alpha = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_alpha * cos_alpha))
    n_out = -to_world(fr, jnp.stack([sin_alpha * jnp.cos(azimuth),
                                     sin_alpha * jnp.sin(azimuth),
                                     cos_alpha]))
    n = jnp.where(inside, off_in, n_out)
    return LightPoint(position=r * n + center, normal=n)


def _pdf_point_on_sphere(scene, sph_idx, point, ref_point):
    """sphere.inl:210-230 (solid-angle cone pdf → area measure)."""
    center = scene.sph_center[sph_idx]
    r = scene.sph_radius[sph_idx]
    d2 = distance_squared(ref_point, center)
    inside = d2 < r * r
    uniform_pdf = 1.0 / (4.0 * PI * r * r)
    sin_el_max_sq = r * r / jnp.maximum(d2, 1e-20)
    cos_el_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_el_max_sq))
    pdf_solid = 1.0 / jnp.maximum(TWO_PI * (1.0 - cos_el_max), 1e-20)
    dirv = normalize(point.position - ref_point)
    pdf_area = pdf_solid * jnp.abs(dot(point.normal, dirv)) / \
        jnp.maximum(distance_squared(ref_point, point.position), 1e-20)
    return jnp.where(inside, uniform_pdf, pdf_area)


def _envmap_uv_from_dir(scene, world_dir):
    """Direction (scene→envmap) → uv (envmap.inl:27-34)."""
    local_dir = xform_vector(scene.env_to_local, world_dir)
    u = jnp.arctan2(local_dir[0], -local_dir[2]) * INV_TWO_PI
    u = jnp.where(u < 0, u + 1.0, u)
    v = jnp.arccos(jnp.clip(local_dir[1], -1.0, 1.0)) * INV_PI
    return jnp.stack([u, v]), local_dir


def sample_point_on_light(scene, light_id, ref_point, uv, w):
    """light.h:47-56. For envmap the returned normal stores -world_dir."""
    light_id = jnp.maximum(light_id, 0)
    light = fetch_light(scene, light_id)
    shape_c = jnp.maximum(light.shape_id, 0)
    shape = fetch_shape(scene, shape_c)

    # area light on mesh or sphere
    is_sphere = shape.type == SHAPE_SPHERE
    if scene.meta.num_spheres > 0:
        sph_idx = jnp.maximum(shape.prim_start, 0)
        p_sph = _sample_point_on_sphere(scene, shape_c, ref_point, uv, sph_idx)
    mesh_valid = scene.meta.num_triangles > 0
    if mesh_valid:
        p_mesh = _sample_point_on_mesh(scene, shape, uv, w)
    if scene.meta.num_spheres > 0 and mesh_valid:
        p_area = LightPoint(
            position=jnp.where(is_sphere, p_sph.position, p_mesh.position),
            normal=jnp.where(is_sphere, p_sph.normal, p_mesh.normal))
    elif scene.meta.num_spheres > 0:
        p_area = p_sph
    else:
        p_area = p_mesh

    if not scene.meta.has_envmap:
        return p_area

    # envmap (envmap.inl:7-20) — O(1) alias draw over the H*W luminance
    # cells (ONE row gather; the CDF search gathered a whole W-wide
    # conditional row per lane). Same distribution as the reference's
    # binary search; env_pdf_uv is sampler-independent.
    h, wdt = scene.meta.env_res
    cell, du, dv = sample_alias(scene.env_alias, uv[0], uv[1])
    ue = (cell % wdt + du) / wdt
    ve = (cell // wdt + dv) / h
    azimuth = ue * TWO_PI
    elevation = ve * PI
    local_dir = jnp.stack([jnp.sin(azimuth) * jnp.sin(elevation),
                           jnp.cos(elevation),
                           -jnp.cos(azimuth) * jnp.sin(elevation)])
    world_dir = xform_vector(scene.env_to_world, local_dir)
    p_env = LightPoint(position=jnp.zeros(3), normal=-world_dir)

    is_env = light.type == LIGHT_ENVMAP
    return LightPoint(position=jnp.where(is_env, p_env.position,
                                         p_area.position),
                      normal=jnp.where(is_env, p_env.normal, p_area.normal))


def pdf_point_on_light(scene, light_id, point, ref_point):
    """light.h:59-63: area measure for area lights, solid-angle pdf with
    the envmap Jacobian 1/(2π² sinθ) for envmaps (envmap.inl:22-42)."""
    light_id = jnp.maximum(light_id, 0)
    light = fetch_light(scene, light_id)
    shape_c = jnp.maximum(light.shape_id, 0)
    shape = fetch_shape(scene, shape_c)

    is_sphere = shape.type == SHAPE_SPHERE
    pdf_mesh = 1.0 / jnp.maximum(shape.area, 1e-20)
    if scene.meta.num_spheres > 0:
        sph_idx = jnp.maximum(shape.prim_start, 0)
        pdf_sph = _pdf_point_on_sphere(scene, sph_idx, point, ref_point)
        pdf_area = jnp.where(is_sphere, pdf_sph, pdf_mesh)
    else:
        pdf_area = pdf_mesh

    if not scene.meta.has_envmap:
        return pdf_area

    world_dir = -point.normal
    uve, local_dir = _envmap_uv_from_dir(scene, world_dir)
    h, wdt = scene.meta.env_res
    x = jnp.clip((uve[0] * wdt).astype(jnp.int32), 0, wdt - 1)
    y = jnp.clip((uve[1] * h).astype(jnp.int32), 0, h - 1)
    pdf_uv = scene.env_pdf_uv[y, x]
    cos_el = local_dir[1]
    sin_el = jnp.sqrt(jnp.clip(1.0 - cos_el * cos_el, 0.0, 1.0))
    pdf_env = jnp.where(sin_el <= 0, 0.0,
                        pdf_uv / jnp.maximum(2.0 * PI * PI * sin_el, 1e-20))

    is_env = light.type == LIGHT_ENVMAP
    return jnp.where(is_env, pdf_env, pdf_area)


def emission_area(scene, light_id, point_normal, view_dir):
    """DiffuseAreaLight one-sided emission (diffuse_area_light.inl:15-20)."""
    light_id = jnp.maximum(light_id, 0)
    intensity = fetch_light(scene, light_id).intensity
    return jnp.where(dot(point_normal, view_dir) <= 0,
                     jnp.zeros(3), intensity)


def emission_envmap(scene, emit_dir, view_footprint):
    """Envmap radiance along emit_dir = direction from scene toward the
    envmap (envmap.inl:44-73). The footprint formula is replicated
    verbatim — including its min() with the negative dv/dwy, which pins
    the lookup to mip level 0 exactly like the reference build does."""
    if not scene.meta.has_envmap:
        return jnp.zeros(3)
    uve, w = _envmap_uv_from_dir(scene, emit_dir)
    denom = jnp.maximum(w[0] * w[0] + w[2] * w[2], 1e-20)
    dudwx = -w[2] / denom
    dudwz = w[0] / denom
    dvdwy = -1.0 / jnp.sqrt(jnp.maximum(1.0 - w[1] * w[1], 1e-20))
    footprint = jnp.minimum(jnp.sqrt(dudwx * dudwx + dudwz * dudwz), dvdwy)

    # envmap texture is an image texture with uvscale 1
    img_id = jnp.int32(scene.meta.env_image_id)
    level = image_mip_level(scene, img_id, jnp.array([1.0, 1.0]), footprint)
    val = lookup_trilinear(scene, img_id, uve[0], uve[1], level)
    return val * scene.env_scale


