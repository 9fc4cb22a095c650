"""Material (BSDF) dispatch.

The reference's `Material = std::variant<...9 types...>` with std::visit
(material.h:102-110, material.cpp:90-123) becomes: integer tags +
`lax.switch` over ONLY the material types present in the scene (a static
set recorded by the compiler), vmapped branch-free. With a single type
present (e.g. cbox = all Lambertian) the switch disappears entirely.

API (per-ray scalar style; callers vmap):
    eval(scene, mat_id, dir_in, dir_out, hit)       -> f (3,) [BSDF x cos]
    pdf(scene, mat_id, dir_in, dir_out, hit)        -> scalar
    sample(scene, mat_id, dir_in, hit, u2, w)       -> SampleRec
All take `adjoint` (TransportDirection, material.h:114-117) as a static
Python bool — radiance transport by default.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lajolla_tpu.scene import types as T


class SampleRec(NamedTuple):
    dir_out: jnp.ndarray   # (3,)
    eta: jnp.ndarray       # 0 = reflection, else relative IOR
    roughness: jnp.ndarray
    valid: jnp.ndarray     # bool


def flip_frame_if_needed(frame, dir_in):
    """Flip the shading frame when inconsistent with dir_in (the
    black-fringe guard used by every BSDF, e.g. lambertian.inl:10-13)."""
    flip = jnp.sum(frame[2] * dir_in) < 0
    return jnp.where(flip, -frame, frame)


def _modules():
    from lajolla_tpu.materials import (lambertian, roughplastic,
                                       roughdielectric, disney_diffuse,
                                       disney_metal, disney_glass,
                                       disney_clearcoat, disney_sheen,
                                       disney_bsdf)
    return {
        T.MAT_LAMBERTIAN: lambertian,
        T.MAT_ROUGH_PLASTIC: roughplastic,
        T.MAT_ROUGH_DIELECTRIC: roughdielectric,
        T.MAT_DISNEY_DIFFUSE: disney_diffuse,
        T.MAT_DISNEY_METAL: disney_metal,
        T.MAT_DISNEY_GLASS: disney_glass,
        T.MAT_DISNEY_CLEARCOAT: disney_clearcoat,
        T.MAT_DISNEY_SHEEN: disney_sheen,
        T.MAT_DISNEY_BSDF: disney_bsdf,
    }


def _dispatch(scene, mat_id, method, args, adjoint):
    """`adjoint` (TransportDirection) is a static Python bool and is bound
    by closure — never passed through switch operands (a traced bool would
    break static branches inside the BSDFs)."""
    mods = _modules()
    present = scene.meta.mat_types_present or (T.MAT_LAMBERTIAN,)
    mat_id_c = jnp.maximum(mat_id, 0)
    if len(present) == 1:
        return getattr(mods[present[0]], method)(scene, mat_id_c, *args,
                                                 adjoint)
    table = np.zeros(T.NUM_MAT_TYPES, np.int32)
    for i, t in enumerate(present):
        table[t] = i
    from lajolla_tpu.scene.soa import fetch_row
    mat_type = fetch_row(scene.mat_tab, mat_id_c)[0].astype(jnp.int32)
    branch = jnp.asarray(table)[mat_type]
    return jax.lax.switch(
        branch,
        [(lambda m: (lambda *a: getattr(m, method)(*a, adjoint)))(mods[t])
         for t in present],
        scene, mat_id_c, *args)


def eval_bsdf(scene, mat_id, dir_in, dir_out, hit, adjoint=False):
    """BSDF x |cos| (material.h:126-131). Returns (3,)."""
    return _dispatch(scene, mat_id, 'eval', (dir_in, dir_out, hit), adjoint)


def pdf_bsdf(scene, mat_id, dir_in, dir_out, hit, adjoint=False):
    """Solid-angle pdf of sample_bsdf (material.h:161-166)."""
    return _dispatch(scene, mat_id, 'pdf', (dir_in, dir_out, hit), adjoint)


def sample_bsdf(scene, mat_id, dir_in, hit, u2, w, adjoint=False):
    """Importance sample dir_out (material.h:133-154)."""
    return _dispatch(scene, mat_id, 'sample', (dir_in, hit, u2, w), adjoint)
