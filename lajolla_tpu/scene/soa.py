"""Wide-row scene record fetchers.

The scene compiler denormalizes the hot per-hit lookups into merged
wide-row tables (tri_shade, shape_tab, light_tab, mat_tab, tex_tab) so
each shading step does ONE row fetch per record type instead of a dozen
narrow gathers. These helpers fetch a row and name its columns. Scalar-style (callers vmap); exact fp32.

Integer ids are stored as float32 in these tables — all ids are far
below 2^24 so the encoding is exact.
"""

from typing import NamedTuple

import jax.numpy as jnp


def fetch_row(table, idx):
    """table[idx] along axis 0, as one gather. An id outside the table
    (-1 marks "none") reads a row of zeros instead of wrapping."""
    return table.at[idx].get(mode='fill', fill_value=0,
                             wrap_negative_indices=False)



class TriShade(NamedTuple):
    p0: jnp.ndarray
    e1: jnp.ndarray
    e2: jnp.ndarray
    n0: jnp.ndarray
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    shape_id: jnp.ndarray  # int32


TRI_SHADE_DIM = 25  # 3*3 pos + 3*3 normals + 3*2 uv + shape_id


def fetch_tri(scene, prim):
    row = fetch_row(scene.tri_shade, prim)
    return TriShade(
        p0=row[0:3], e1=row[3:6], e2=row[6:9],
        n0=row[9:12], n1=row[12:15], n2=row[15:18],
        uv0=row[18:20], uv1=row[20:22], uv2=row[22:24],
        shape_id=row[24].astype(jnp.int32))


class ShapeRec(NamedTuple):
    material_id: jnp.ndarray
    light_id: jnp.ndarray
    interior_med: jnp.ndarray
    exterior_med: jnp.ndarray
    type: jnp.ndarray
    prim_start: jnp.ndarray
    prim_count: jnp.ndarray
    has_normals: jnp.ndarray
    has_uvs: jnp.ndarray
    area: jnp.ndarray


SHAPE_TAB_DIM = 9


def fetch_shape(scene, shape_id):
    row = fetch_row(scene.shape_tab, shape_id)
    i = lambda c: row[c].astype(jnp.int32)
    return ShapeRec(material_id=i(0), light_id=i(1), interior_med=i(2),
                    exterior_med=i(3), type=i(4), prim_start=i(5),
                    prim_count=i(9), has_normals=i(6), has_uvs=i(7),
                    area=row[8])


class LightRec(NamedTuple):
    type: jnp.ndarray
    shape_id: jnp.ndarray   # image id for envmap rows
    intensity: jnp.ndarray  # (3,)
    pmf: jnp.ndarray


LIGHT_TAB_DIM = 6


def fetch_light(scene, light_id):
    row = fetch_row(scene.light_tab, light_id)
    return LightRec(type=row[0].astype(jnp.int32),
                    shape_id=row[1].astype(jnp.int32),
                    intensity=row[2:5], pmf=row[5])


class MatRec(NamedTuple):
    type: jnp.ndarray
    eta: jnp.ndarray
    tex: jnp.ndarray  # (NUM_PARAM_SLOTS,) int32 texture descriptor ids


MAT_TAB_DIM = 15  # type, eta, 13 slots


def fetch_mat(scene, mat_id):
    row = fetch_row(scene.mat_tab, mat_id)
    return MatRec(type=row[0].astype(jnp.int32), eta=row[1],
                  tex=row[2:15].astype(jnp.int32))


class TexRec(NamedTuple):
    kind: jnp.ndarray
    image_id: jnp.ndarray
    const: jnp.ndarray     # (3,)
    color1: jnp.ndarray    # (3,)
    uvscale: jnp.ndarray   # (2,)
    uvoffset: jnp.ndarray  # (2,)


TEX_TAB_DIM = 12


def fetch_tex(scene, tex_id):
    row = fetch_row(scene.tex_tab, jnp.maximum(tex_id, 0))
    return TexRec(kind=row[0].astype(jnp.int32),
                  image_id=row[1].astype(jnp.int32),
                  const=row[2:5], color1=row[5:8],
                  uvscale=row[8:10], uvoffset=row[10:12])
