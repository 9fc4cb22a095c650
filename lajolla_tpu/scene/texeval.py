"""Device-side texture evaluation (constant / image-mipmap / checkerboard).

Replaces eval(texture, uv, footprint, pool) (src/texture.h:108-154) and
the mipmap lookups (src/mipmap.h:52-88). Image lookups are trilinear:
two bilinear taps on adjacent mip levels, each tap = ONE wide gather into
the quad-packed texdata array (scene/texture.py). Per-ray scalar style; callers vmap.
"""

import jax.numpy as jnp

from lajolla_tpu.scene.soa import fetch_row, fetch_tex
from lajolla_tpu.scene.types import TEX_CONSTANT, TEX_IMAGE, TEX_CHECKERBOARD

def _mip_row(scene, img_id):
    """(25,) wide mip-metadata row [off x8 | w x8 | h x8 | nlev] — one
    row fetch replaces ~9 narrow per-lane gathers per texture eval
    (offsets are exact in f32 up to 16.7M quad rows)."""
    return fetch_row(scene.mip_tab, jnp.maximum(img_id, 0))


def _lvl(row, base, level):
    """row[base + level]."""
    return row[base + level]


def _bilinear(scene, mrow, level, u, v):
    off = _lvl(mrow, 0, level).astype(jnp.int32)
    w = _lvl(mrow, 8, level).astype(jnp.int32)
    h = _lvl(mrow, 16, level).astype(jnp.int32)
    x = u * w - 0.5
    y = v * h - 0.5
    xf = jnp.floor(x).astype(jnp.int32)
    yf = jnp.floor(y).astype(jnp.int32)
    uo = x - xf
    vo = y - yf
    x0 = jnp.mod(xf, w)
    y0 = jnp.mod(yf, h)
    c = scene.texdata[off + y0 * w + x0]       # quad-packed (12,)
    t00, t10, t01, t11 = c[0:3], c[3:6], c[6:9], c[9:12]
    return (t00 * (1 - uo) * (1 - vo) + t01 * (1 - uo) * vo +
            t10 * uo * (1 - vo) + t11 * uo * vo)


def lookup_trilinear(scene, img_id, u, v, level, mrow=None):
    """Trilinear mipmap lookup with fractional level (mipmap.h:76-88)."""
    mrow = _mip_row(scene, img_id) if mrow is None else mrow
    nlev = mrow[24].astype(jnp.int32)
    level = jnp.clip(level, 0.0, (nlev - 1).astype(jnp.float32))
    fl = jnp.floor(level).astype(jnp.int32)
    cl = jnp.minimum(fl + 1, nlev - 1)
    t = level - fl
    lo = _bilinear(scene, mrow, fl, u, v)
    hi = _bilinear(scene, mrow, cl, u, v)
    return lo * (1 - t) + hi * t


def image_mip_level(scene, img_id, uvscale, footprint, mrow=None):
    """log2 footprint → fractional mip level (texture.h:127-134)."""
    mrow = _mip_row(scene, img_id) if mrow is None else mrow
    scaled = (jnp.maximum(mrow[8], mrow[16]) *
              jnp.maximum(uvscale[0], uvscale[1]) * footprint)
    return jnp.log2(jnp.maximum(scaled, 1e-8))


def eval_texture(scene, tex_id, uv, footprint):
    """Evaluate texture descriptor tex_id at uv → (3,) RGB. Scalar params
    read channel 0. footprint ≈ du/dx for mip selection."""
    tex = fetch_tex(scene, tex_id)
    kind = tex.kind
    out = tex.const
    local_uv = jnp.mod(uv * tex.uvscale + tex.uvoffset, 1.0)

    if TEX_CHECKERBOARD in scene.meta.texture_types_present:
        xi = 2 * jnp.mod((local_uv[0] * 2).astype(jnp.int32), 2) - 1
        yi = 2 * jnp.mod((local_uv[1] * 2).astype(jnp.int32), 2) - 1
        checker = jnp.where(xi * yi == 1, tex.const, tex.color1)
        out = jnp.where(kind == TEX_CHECKERBOARD, checker, out)

    if scene.meta.has_image_textures:
        img_id = tex.image_id
        mrow = _mip_row(scene, img_id)
        level = image_mip_level(scene, img_id, tex.uvscale, footprint,
                                mrow=mrow)
        img_val = lookup_trilinear(scene, img_id, local_uv[0], local_uv[1],
                                   level, mrow=mrow)
        out = jnp.where(kind == TEX_IMAGE, img_val, out)

    return out


def eval_texture_scalar(scene, tex_id, uv, footprint):
    return eval_texture(scene, tex_id, uv, footprint)[0]
