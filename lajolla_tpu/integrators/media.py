"""Participating media + phase functions (device side; scalar per-lane).

Replaces the Medium/PhaseFunction variant ops (medium.h:22-27,
media/homogeneous.inl, media/heterogeneous.inl, phase_function.cpp,
phase_functions/{isotropic,henyeygreenstein}.inl) and grid-volume
trilinear lookup (volume.h:45-95, :114-144).
"""

import jax.numpy as jnp

from lajolla_tpu.core.math import dot, make_frame, normalize, to_world
from lajolla_tpu.scene.types import (MED_HETEROGENEOUS, MED_HOMOGENEOUS,
                                     PHASE_HG, PHASE_ISOTROPIC, VOL_GRID)

PI = 3.141592653589793
TWO_PI = 6.283185307179586
INV_4PI = 1.0 / (4.0 * PI)


# ---------------------------------------------------------------------------
# Volume lookup
# ---------------------------------------------------------------------------

# wide medium row column offsets (scene.med_tab, built in compile.py)
MT_TYPE, MT_PHASE, MT_G, MT_DVOL, MT_AVOL = 0, 1, 2, 3, 4
MT_SA, MT_SS, MT_MAXVAL = 5, 8, 11
MT_SRES, MT_SOFF = 14, 17
MT_DLOOK, MT_ALOOK = 18, 32      # 14-float volume-lookup sub-rows
# volume-lookup sub-row offsets: [kind, const3, pmin3, pmax3, res3, off]
VL_KIND, VL_CONST, VL_PMIN, VL_PMAX, VL_RES, VL_OFF = 0, 1, 4, 7, 10, 13


def lookup_volume_vrow(scene, vrow, p):
    """Trilinear grid / constant volume lookup → (3,) from a 14-float
    volume sub-row (no table gathers; volume.h:40-81 semantics, scale
    pre-multiplied at compile)."""
    kind = vrow[VL_KIND]
    const = vrow[VL_CONST:VL_CONST + 3]
    if not scene.meta.has_grid_volumes:
        return const

    pmin = vrow[VL_PMIN:VL_PMIN + 3]
    pmax = vrow[VL_PMAX:VL_PMAX + 3]
    res = vrow[VL_RES:VL_RES + 3].astype(jnp.int32)
    off = vrow[VL_OFF].astype(jnp.int32)
    pn = (p - pmin) / jnp.maximum(pmax - pmin, 1e-20)
    inside = jnp.all((pn >= 0.0) & (pn <= 1.0))
    rx, ry, rz = res[0], res[1], res[2]
    fx = pn[0] * (rx - 1).astype(jnp.float32)
    fy = pn[1] * (ry - 1).astype(jnp.float32)
    fz = pn[2] * (rz - 1).astype(jnp.float32)
    x0 = jnp.clip(fx.astype(jnp.int32), 0, rx - 1)
    y0 = jnp.clip(fy.astype(jnp.int32), 0, ry - 1)
    z0 = jnp.clip(fz.astype(jnp.int32), 0, rz - 1)
    dx = fx - x0
    dy = fy - y0
    dz = fz - z0

    # ONE octo-packed row gather (compile.py): node (z0,y0,x0) carries
    # all 8 edge-clamped cell-corner values
    c = scene.volume_data[off + (z0 * ry + y0) * rx + x0]   # (24,)
    wx1, wy1, wz1 = dx, dy, dz
    wx0, wy0, wz0 = 1.0 - dx, 1.0 - dy, 1.0 - dz
    val = (c[0:3] * (wx0 * wy0 * wz0) + c[3:6] * (wx1 * wy0 * wz0) +
           c[6:9] * (wx0 * wy1 * wz0) + c[9:12] * (wx1 * wy1 * wz0) +
           c[12:15] * (wx0 * wy0 * wz1) + c[15:18] * (wx1 * wy0 * wz1) +
           c[18:21] * (wx0 * wy1 * wz1) + c[21:24] * (wx1 * wy1 * wz1))
    grid_val = jnp.where(inside, val, 0.0)
    return jnp.where(kind == VOL_GRID, grid_val, const)


def _vrow_from_tables(scene, vol_id):
    """Assemble a 14-float volume sub-row with narrow table gathers —
    for callers outside the hot loops (tests, aux integrators)."""
    vol_id = jnp.maximum(vol_id, 0)
    return jnp.concatenate([
        scene.vol_kind[vol_id][None].astype(jnp.float32),
        scene.vol_const[vol_id],
        scene.vol_pmin[vol_id],
        scene.vol_pmax[vol_id],
        scene.vol_res[vol_id].astype(jnp.float32),
        scene.vol_offset[vol_id][None].astype(jnp.float32),
    ])


def lookup_volume(scene, vol_id, p):
    """Trilinear grid / constant volume lookup by volume id → (3,)."""
    return lookup_volume_vrow(scene, _vrow_from_tables(scene, vol_id), p)


def volume_aabb_hit_vrow(vrow, o, d, tfar):
    """Slab test against the grid bbox (volume.h:114-144); constant
    volumes always 'hit'."""
    kind = vrow[VL_KIND]
    pmin = vrow[VL_PMIN:VL_PMIN + 3]
    pmax = vrow[VL_PMAX:VL_PMAX + 3]
    safe_d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    tn = (pmin - o) / safe_d
    tf = (pmax - o) / safe_d
    t0 = jnp.max(jnp.minimum(tn, tf))
    t1 = jnp.min(jnp.maximum(tn, tf))
    t0 = jnp.maximum(t0, 0.0)
    t1 = jnp.minimum(t1, tfar)
    return jnp.where(kind == VOL_GRID, t0 <= t1, True)


def volume_aabb_hit(scene, vol_id, o, d, tfar):
    return volume_aabb_hit_vrow(_vrow_from_tables(scene, vol_id), o, d,
                                tfar)


# ---------------------------------------------------------------------------
# Medium properties (medium.h:25-27)
#
# All property reads go through ONE wide-row fetch (scene.med_tab,
# compile.py) instead of one narrow per-lane gather per property.
# ---------------------------------------------------------------------------

def med_row(scene, med_id):
    """(46,) wide medium property row; med_id < 0 reads row 0 (callers
    mask vacuum lanes themselves, as with the old accessors)."""
    from lajolla_tpu.scene.soa import fetch_row
    return fetch_row(scene.med_tab, jnp.maximum(med_id, 0))


def get_majorant(scene, med_id, o, d, tfar, row=None):
    row = med_row(scene, med_id) if row is None else row
    hom = row[MT_SA:MT_SA + 3] + row[MT_SS:MT_SS + 3]
    if MED_HETEROGENEOUS not in scene.meta.med_types_present:
        return hom
    hit = volume_aabb_hit_vrow(row[MT_DLOOK:MT_DLOOK + 14], o, d, tfar)
    het = jnp.where(hit, row[MT_MAXVAL:MT_MAXVAL + 3], jnp.zeros(3))
    return jnp.where(row[MT_TYPE] == MED_HOMOGENEOUS, hom, het)


def get_sigma_s(scene, med_id, p, row=None):
    row = med_row(scene, med_id) if row is None else row
    hom = row[MT_SS:MT_SS + 3]
    if MED_HETEROGENEOUS not in scene.meta.med_types_present:
        return hom
    density = lookup_volume_vrow(scene, row[MT_DLOOK:MT_DLOOK + 14], p)
    albedo = lookup_volume_vrow(scene, row[MT_ALOOK:MT_ALOOK + 14], p)
    return jnp.where(row[MT_TYPE] == MED_HOMOGENEOUS, hom,
                     density * albedo)


def get_sigma_a(scene, med_id, p, row=None):
    row = med_row(scene, med_id) if row is None else row
    hom = row[MT_SA:MT_SA + 3]
    if MED_HETEROGENEOUS not in scene.meta.med_types_present:
        return hom
    density = lookup_volume_vrow(scene, row[MT_DLOOK:MT_DLOOK + 14], p)
    albedo = lookup_volume_vrow(scene, row[MT_ALOOK:MT_ALOOK + 14], p)
    return jnp.where(row[MT_TYPE] == MED_HOMOGENEOUS, hom,
                     density * (1.0 - albedo))


# ---------------------------------------------------------------------------
# Phase functions (phase_functions/*.inl)
# ---------------------------------------------------------------------------

def _hg(g, cos_theta):
    return INV_4PI * (1.0 - g * g) / jnp.maximum(
        (1.0 + g * g + 2.0 * g * cos_theta) ** 1.5, 1e-20)


def phase_eval(scene, med_id, dir_in, dir_out, row=None):
    """→ (3,) (constant across channels, like the reference)."""
    row = med_row(scene, med_id) if row is None else row
    typ, g = row[1], row[2]
    hg = _hg(g, dot(dir_in, dir_out))
    val = jnp.where(typ == PHASE_ISOTROPIC, INV_4PI, hg)
    return jnp.full(3, 1.0) * val


def phase_pdf(scene, med_id, dir_in, dir_out, row=None):
    row = med_row(scene, med_id) if row is None else row
    typ, g = row[1], row[2]
    hg = _hg(g, dot(dir_in, dir_out))
    return jnp.where(typ == PHASE_ISOTROPIC, INV_4PI, hg)


def phase_sample(scene, med_id, dir_in, u, row=None):
    """HG inverse-CDF with uniform-sphere fallback for |g|<1e-3
    (henyeygreenstein.inl:26-46); isotropic = uniform sphere."""
    row = med_row(scene, med_id) if row is None else row
    typ, g = row[1], row[2]

    z = 1.0 - 2.0 * u[0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * u[1]
    uniform = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z])

    g_safe = jnp.where(jnp.abs(g) < 1e-3, 1.0, g)
    tmp = (g_safe * g_safe - 1.0) / (2.0 * u[0] * g_safe - (g_safe + 1.0))
    cos_el = (tmp * tmp - (1.0 + g_safe * g_safe)) / (2.0 * g_safe)
    sin_el = jnp.sqrt(jnp.maximum(1.0 - cos_el * cos_el, 0.0))
    azimuth = TWO_PI * u[1]
    fr = make_frame(dir_in)
    hg_dir = to_world(fr, jnp.stack([sin_el * jnp.cos(azimuth),
                                     sin_el * jnp.sin(azimuth), cos_el]))
    use_uniform = (typ == PHASE_ISOTROPIC) | (jnp.abs(g) < 1e-3)
    return jnp.where(use_uniform, uniform, hg_dir)


def update_medium(hit, d, medium):
    """Medium transition across an interface (vol_path_tracing.h:149-163)."""
    differs = hit.interior_med != hit.exterior_med
    new_med = jnp.where(dot(d, hit.geometry_normal) > 0,
                        hit.exterior_med, hit.interior_med)
    return jnp.where(differs, new_med, medium)
