"""Scene compiler: host SceneBuilder → flat device arrays (the Scene pytree).

This is the analogue of the reference Scene constructor (scene.cpp:4-52):
BVH build, per-shape sampling distributions, the power-weighted light pick
distribution, and scene bounds — except everything lands in SoA device
arrays instead of Embree state and std::vectors.
"""

import numpy as np
import jax.numpy as jnp

from lajolla_tpu.core import transform as xf
from lajolla_tpu.core.distribution import (build_alias, build_cdf_1d,
                                            build_segmented_cdf, build_cdf_2d)
from lajolla_tpu.ops.bvh import build_bvh
from lajolla_tpu.scene import types as T
from lajolla_tpu.scene.types import Scene, SceneMeta

# Below this many triangles the dense brute-force casters serve the
# scene; at or above it the binned two-level caster does. The value is
# not yet measured on the GPU (ROADMAP Design 2 keeps it as an A/B item).
BVH_MIN_TRIS = 192

# Supervoxel majorant cells cover ~this many fine voxels per axis: the
# optimum balances DDA crossing count against majorant tightness
# (counted on hetvol: mean delta-tracking rounds at 8 are ~25% below 4;
# 16 is within noise of 8).
SVOX_DIVISOR = 8


def fov_to_fov_x(fov, fov_axis, width, height):
    """fovAxis → fovX conversion (parse_scene.cpp:536-549), applied at
    compile time so film-size overrides re-derive the framing exactly
    like a reference re-parse would."""
    if (fov_axis == 'y' or (fov_axis == 'smaller' and height < width) or
            (fov_axis == 'larger' and width < height)):
        aspect = width / height
        fov = np.degrees(2 * np.arctan(np.tan(np.radians(fov) / 2) * aspect))
    elif fov_axis == 'diagonal':
        aspect = width / height
        diagonal = 2 * np.tan(np.radians(fov) / 2)
        w = diagonal / np.sqrt(1 + 1 / (aspect * aspect))
        fov = np.degrees(2 * np.arctan(w / 2))
    return float(fov)


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _i32(x):
    return jnp.asarray(np.asarray(x, np.int32))


def _merge_parallelograms(vertices, indices, num_tris):
    """Detect triangle pairs tiling an exact parallelogram and reorder
    them in place to the canonical quad split: A = (p0, p1, p2) with the
    shared edge as (p1, p2), B = (p2, p1, p3), p3 = p1 + p2 - p0.

    Returns (alt, consumed): alt[i] = partner id for a rep triangle
    (== i when unpaired), consumed[i] = True for triangles absorbed as
    a rep's B half. Pairing requires a shared vertex-index edge, same
    winding orientation, and |p3_predicted - p3_stored| <= 1e-9 x the
    mesh bounding-box diagonal (f64 — true authored parallelograms
    match to ~1e-12 relative; anything else differs by orders more)."""
    alt = np.arange(max(num_tris, 1), dtype=np.int32)
    consumed = np.zeros(max(num_tris, 1), bool)
    # only the dense brute-family casters consume the cast tables, and
    # they only serve small scenes (use_binned scenes go through the
    # binned caster) — skip the host-side edge walk for big meshes
    if num_tris < 2 or num_tris > 4096:
        return alt, consumed
    P = vertices
    p0 = P[indices[:, 0]]
    n = np.cross(P[indices[:, 1]] - p0, P[indices[:, 2]] - p0)
    area2 = np.linalg.norm(n, axis=1)
    ext = P[indices.reshape(-1)]
    tol = 1e-9 * max(float(np.linalg.norm(ext.max(0) - ext.min(0))), 1e-9)
    # canonical POSITION ids for edge matching: loaders duplicate
    # vertices when per-face normals/uvs differ (.serialized, OBJ with
    # split attributes), which would hide every shared edge from an
    # index-based match. Exact f64 byte equality only.
    pos_id = {}
    canon = np.empty(P.shape[0], np.int64)
    for vi in range(P.shape[0]):
        canon[vi] = pos_id.setdefault(P[vi].tobytes(), vi)
    from collections import defaultdict
    edges = defaultdict(list)
    for t in range(num_tris):
        i0, i1, i2 = (int(canon[indices[t, 0]]), int(canon[indices[t, 1]]),
                      int(canon[indices[t, 2]]))
        for k, (a, c) in enumerate(((i1, i2), (i2, i0), (i0, i1))):
            edges[(min(a, c), max(a, c))].append((t, k))
    for lst in edges.values():
        if len(lst) != 2:
            continue
        (ta, ka), (tb, kb) = lst
        if consumed[ta] or consumed[tb] or alt[ta] != ta or alt[tb] != tb:
            continue
        if area2[ta] <= 0.0 or area2[tb] <= 0.0:
            continue
        if np.dot(n[ta], n[tb]) <= 0.0:
            continue
        ia, ib = indices[ta], indices[tb]
        a0 = int(ia[ka])
        d1, d2 = int(ia[(ka + 1) % 3]), int(ia[(ka + 2) % 3])
        b3 = int(ib[kb])
        if np.abs(P[d1] + P[d2] - P[a0] - P[b3]).max() > tol:
            continue
        # B keeps its OWN vertex indices (its normals/uvs) at the
        # shared corners, matched to A's diagonal by canonical position
        bb1, bb2 = int(ib[(kb + 1) % 3]), int(ib[(kb + 2) % 3])
        if canon[bb1] == canon[d1]:
            b_d1, b_d2 = bb1, bb2
        else:
            b_d1, b_d2 = bb2, bb1
        if canon[b_d1] != canon[d1] or canon[b_d2] != canon[d2]:
            continue
        indices[ta] = (a0, d1, d2)       # cyclic rotation: parity kept
        indices[tb] = (b_d2, b_d1, b3)   # normal = +n_A = B's own normal
        alt[ta] = tb
        consumed[tb] = True
    return alt, consumed


def compile_scene(b):
    # ------------------------------------------------------------------ geometry
    verts, norms, uvs, tris, tri_shape = [], [], [], [], []
    shape_rows = []
    v_off = 0
    t_off = 0
    spheres = []
    for sid, s in enumerate(b.shapes):
        if s.type == T.SHAPE_MESH:
            m = s.mesh
            nv = m.positions.shape[0]
            nt = m.indices.shape[0]
            verts.append(m.positions)
            has_n = m.normals is not None
            has_uv = m.uvs is not None
            norms.append(m.normals if has_n else np.zeros((nv, 3)))
            uvs.append(m.uvs if has_uv else np.zeros((nv, 2)))
            tris.append(m.indices + v_off)
            tri_shape.append(np.full(nt, sid, np.int32))
            shape_rows.append(dict(type=T.SHAPE_MESH, prim_start=t_off,
                                   prim_count=nt, has_normals=int(has_n),
                                   has_uvs=int(has_uv), sid=sid))
            v_off += nv
            t_off += nt
        else:
            shape_rows.append(dict(type=T.SHAPE_SPHERE,
                                   prim_start=len(spheres), prim_count=1,
                                   has_normals=1, has_uvs=1, sid=sid))
            spheres.append((np.asarray(s.center, np.float64), s.radius))

    if verts:
        vertices = np.concatenate(verts).astype(np.float64)
        normals = np.concatenate(norms).astype(np.float64)
        uv_arr = np.concatenate(uvs).astype(np.float64)
        indices = np.concatenate(tris).astype(np.int32)
        tri_shape = np.concatenate(tri_shape).astype(np.int32)
    else:
        vertices = np.zeros((1, 3))
        normals = np.zeros((1, 3))
        uv_arr = np.zeros((1, 2))
        indices = np.zeros((1, 3), np.int32)
        tri_shape = np.full(1, -1, np.int32)

    num_tris = indices.shape[0] if verts else 0

    # ------------------------------------------- quad (parallelogram) merging
    # Triangle pairs that tile an exact parallelogram become ONE cast
    # primitive for the dense casters: rep triangle A is rotated to
    # (p0 off-diagonal | p1, p2 diagonal), partner B is reordered to
    # (p2, p1, p3) with p3 = p1 + p2 - p0. A's Moller-Trumbore test then
    # covers the whole parallelogram with acceptance max(u, v) <= 1, and
    # a hit with u + v > 1 lies in B (ops/intersect.py resolve_cast_hit).
    # Halves dense tri-tests on quad-built meshes (cbox walls/boxes,
    # veach plates). Reorders are parity-preserving (A: cyclic rotation;
    # B: checked same-normal), so geometric normals, one-sided emission
    # and area sampling are untouched — only the (u, v) parameterization
    # rotates, consistently with the reported barycentrics. No reference
    # analogue (Embree tests raw triangles, src/intersection.cpp:32).
    quad_alt, quad_consumed = _merge_parallelograms(vertices, indices,
                                                    num_tris)
    cast_src = np.nonzero(~quad_consumed)[0].astype(np.int32)
    if cast_src.size == 0:
        cast_src = np.zeros(1, np.int32)
    cast_alt = quad_alt[cast_src].astype(np.int32)

    p0 = vertices[indices[:, 0]]
    e1 = vertices[indices[:, 1]] - p0
    e2 = vertices[indices[:, 2]] - p0
    tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    if not verts:
        tri_area = np.zeros(1)

    if spheres:
        sph_center = np.stack([c for c, _ in spheres])
        sph_radius = np.array([r for _, r in spheres], np.float64)
        sph_shape = np.array([r['sid'] for r in shape_rows
                              if r['type'] == T.SHAPE_SPHERE], np.int32)
    else:
        sph_center = np.zeros((1, 3))
        sph_radius = np.zeros(1)
        sph_shape = np.full(1, -1, np.int32)

    # ------------------------------------------------------------------ shapes
    ns = max(len(b.shapes), 1)
    shape_material = np.full(ns, -1, np.int32)
    shape_light = np.full(ns, -1, np.int32)
    shape_int_med = np.full(ns, -1, np.int32)
    shape_ext_med = np.full(ns, -1, np.int32)
    shape_type = np.zeros(ns, np.int32)
    shape_prim_start = np.zeros(ns, np.int32)
    shape_prim_count = np.zeros(ns, np.int32)
    shape_area = np.zeros(ns)
    shape_has_n = np.zeros(ns, np.int32)
    shape_has_uv = np.zeros(ns, np.int32)
    for row, s in zip(shape_rows, b.shapes):
        sid = row['sid']
        shape_material[sid] = s.material_id
        shape_light[sid] = s.area_light_id
        shape_int_med[sid] = s.interior_medium_id
        shape_ext_med[sid] = s.exterior_medium_id
        shape_type[sid] = row['type']
        shape_prim_start[sid] = row['prim_start']
        shape_prim_count[sid] = row['prim_count']
        shape_has_n[sid] = row['has_normals']
        shape_has_uv[sid] = row['has_uvs']
        if row['type'] == T.SHAPE_MESH:
            shape_area[sid] = tri_area[row['prim_start']:
                                       row['prim_start'] + row['prim_count']].sum()
        else:
            shape_area[sid] = 4.0 * np.pi * b.shapes[sid].radius ** 2

    # per-shape triangle-area staircase CDF (triangle_mesh.inl:48-63)
    mesh_rows = [r for r in shape_rows if r['type'] == T.SHAPE_MESH]
    if mesh_rows and num_tris > 0:
        _, tri_stair = build_segmented_cdf(
            tri_area,
            [shape_prim_start[r['sid']] for r in mesh_rows],
            [shape_prim_count[r['sid']] for r in mesh_rows])
        # staircase segments must be keyed by SHAPE id for device sampling:
        # rebuild with shape-id offsets
        tri_stair = np.zeros(num_tris)
        # per-shape alias tables in the same flat layout (device sampling
        # is one row gather instead of a log2(T)-gather binary search;
        # aliases are globalized by the segment offset)
        # Global tri ids ride in f32 alias columns: exact below 2^24.
        assert num_tris < (1 << 24), \
            f"{num_tris} triangles: f32 tri ids would lose precision"
        tri_alias = np.zeros((num_tris, 2), np.float32)
        for r in mesh_rows:
            s0, c = shape_prim_start[r['sid']], shape_prim_count[r['sid']]
            _, cdf = build_cdf_1d(tri_area[s0:s0 + c])
            tri_stair[s0:s0 + c] = r['sid'] + cdf
            al = build_alias(tri_area[s0:s0 + c])
            al[:, 1] += s0
            tri_alias[s0:s0 + c] = al
    else:
        tri_stair = np.zeros(max(num_tris, 1))
        tri_alias = np.zeros((max(num_tris, 1), 2), np.float32)

    # ------------------------------------------- cast tables (dense casters)
    # Moller-Trumbore rows [p0 | e1 | e2] of each cast prim's rep
    # triangle, one prim per column. A cast prim with cast_alt !=
    # cast_src accepts max(u, v) <= 1 (the full parallelogram) and remaps
    # u + v > 1 hits to the partner triangle. Degenerate triangles have
    # det = 0 and never hit.
    cast_tri = np.concatenate([p0, e1, e2], axis=1)[cast_src].T.astype(
        np.float32)
    cast_quad = (cast_alt != cast_src).astype(np.float32)

    # ------------------------------------------------------------------ bounds
    pts = [vertices] if verts else []
    for c, r in spheres:
        pts.append(c[None, :] - r)
        pts.append(c[None, :] + r)
    if pts:
        allp = np.concatenate(pts)
        lb, ub = allp.min(0), allp.max(0)
    else:
        lb = ub = np.zeros(3)
    center = 0.5 * (lb + ub)
    radius = float(np.linalg.norm(ub - center))  # scene.cpp:30-34

    # ------------------------------------------------------------------ BVH
    use_bvh = num_tris >= BVH_MIN_TRIS
    if use_bvh:
        tri_lo = np.minimum(np.minimum(p0, p0 + e1), p0 + e2)
        tri_hi = np.maximum(np.maximum(p0, p0 + e1), p0 + e2)
        bvh = build_bvh(tri_lo.astype(np.float32), tri_hi.astype(np.float32))
    else:
        bvh = dict(lo=np.zeros((1, 3), np.float32),
                   hi=np.zeros((1, 3), np.float32),
                   first=np.zeros(1, np.int32), count=np.zeros(1, np.int32),
                   skip=np.ones(1, np.int32),
                   prim=np.arange(max(num_tris, 1), dtype=np.int32),
                   n_nodes=1)

    # binned two-level intersector (big scenes)
    use_binned = use_bvh
    if use_binned:
        from lajolla_tpu.ops.intersect_binned import build_clusters
        cl = build_clusters(bvh, p0.astype(np.float32),
                            e1.astype(np.float32), e2.astype(np.float32),
                            max_tris=128)
    else:
        cl = dict(cl_lo=np.zeros((1, 3), np.float32),
                  cl_hi=np.zeros((1, 3), np.float32),
                  cl_A=np.zeros((1, 3, 3), np.float32),
                  cl_b=np.zeros((1, 3), np.float32),
                  cl_prim=np.full((1, 1), -1, np.int32))

    # merged BVH tables: ONE wide gather per node visit / leaf triangle
    nb = bvh['lo'].shape[0]
    bvh_node = np.zeros((nb, 9), np.float32)
    bvh_node[:, 0:3] = bvh['lo']
    bvh_node[:, 3:6] = bvh['hi']
    bvh_node[:, 6] = bvh['first']
    bvh_node[:, 7] = bvh['count']
    bvh_node[:, 8] = bvh['skip']
    perm = bvh['prim']
    ntl = max(len(perm), 1)
    bvh_leaf_tri = np.zeros((ntl, 10), np.float32)
    if num_tris > 0 and len(perm) > 0:
        bvh_leaf_tri[:, 0:3] = p0[perm]
        bvh_leaf_tri[:, 3:6] = e1[perm]
        bvh_leaf_tri[:, 6:9] = e2[perm]
        bvh_leaf_tri[:, 9] = perm

    # ------------------------------------------------------------------ materials
    nm = max(len(b.materials), 1)
    mat_type = np.zeros(nm, np.int32)
    mat_tex = np.zeros((nm, T.NUM_PARAM_SLOTS), np.int32)
    mat_eta = np.full(nm, 1.5)
    for i, m in enumerate(b.materials):
        mat_type[i] = m.type
        for slot, td in m.tex.items():
            mat_tex[i, slot] = td
        mat_eta[i] = m.eta

    # ------------------------------------------------------------------ textures
    nt = max(len(b.texdescs), 1)
    tex_kind = np.zeros(nt, np.int32)
    tex_const = np.zeros((nt, 3))
    tex_color1 = np.zeros((nt, 3))
    tex_image = np.zeros(nt, np.int32)
    tex_uvscale = np.ones((nt, 2))
    tex_uvoffset = np.zeros((nt, 2))
    for i, td in enumerate(b.texdescs):
        tex_kind[i] = td.kind
        tex_const[i] = td.const
        tex_color1[i] = td.color1
        tex_image[i] = td.image_id
        tex_uvscale[i] = (td.uscale, td.vscale)
        tex_uvoffset[i] = (td.uoffset, td.voffset)
    texdata, mip_offset, mip_w, mip_h, mip_levels = b.texture_pool.pack()
    mip_tab = np.concatenate([mip_offset, mip_w, mip_h,
                              mip_levels[:, None]], axis=1).astype(
                                  np.float32)

    # ------------------------------------------------------------------ lights
    nl = max(len(b.lights), 1)
    light_type = np.zeros(nl, np.int32)
    light_shape = np.full(nl, -1, np.int32)
    light_intensity = np.zeros((nl, 3))
    env_to_world = np.eye(4)
    env_to_local = np.eye(4)
    env_scale = 1.0
    env_h = env_w = 0
    env_cond_cdf = np.zeros((1, 1))
    env_marg_cdf = np.ones(1)
    env_pdf_uv = np.zeros((1, 1))
    env_alias = np.zeros((1, 2), np.float32)
    env_total = 0.0

    env_image_id = -1
    for i, l in enumerate(b.lights):
        light_type[i] = l.type
        light_shape[i] = l.shape_id
        light_intensity[i] = l.intensity
        if l.type == T.LIGHT_ENVMAP:
            env_image_id = l.image_id
            env_to_world = np.asarray(l.to_world, np.float64)
            env_to_local = np.linalg.inv(env_to_world)
            env_scale = l.scale
            img = b.texture_pool.pyramids[l.image_id][0]  # level 0
            h, w = img.shape[:2]
            env_h, env_w = h, w
            lum = (img[:, :, 0] * 0.212671 + img[:, :, 1] * 0.715160 +
                   img[:, :, 2] * 0.072169)
            sin_elev = np.sin(np.pi * (np.arange(h) + 0.5) / h)
            f = lum.astype(np.float64) * sin_elev[:, None]
            d2 = build_cdf_2d(f)
            env_cond_cdf = d2['cond_cdf']
            env_marg_cdf = d2['marg_cdf']
            env_pdf_uv = d2['cond_pmf'] * d2['marg_pmf'][:, None] * w * h
            env_total = float(f.sum())
            env_alias = build_alias(f.ravel())

    # power-weighted light pick CDF (scene.cpp:46-52)
    powers = np.zeros(nl)
    for i, l in enumerate(b.lights):
        if l.type == T.LIGHT_AREA:
            lum = (l.intensity[0] * 0.212671 + l.intensity[1] * 0.715160 +
                   l.intensity[2] * 0.072169)
            powers[i] = lum * shape_area[l.shape_id] * np.pi
        else:  # envmap (envmap.inl:1-5)
            powers[i] = (np.pi * radius * radius * env_total /
                         max(env_w * env_h, 1))
    light_pmf, light_cdf = build_cdf_1d(powers) if len(b.lights) else \
        (np.ones(1), np.ones(1))

    # ------------------------------------------------------------------ media
    nmed = max(len(b.media), 1)
    med_type = np.zeros(nmed, np.int32)
    med_sigma_a = np.zeros((nmed, 3))
    med_sigma_s = np.zeros((nmed, 3))
    med_phase = np.zeros(nmed, np.int32)
    med_g = np.zeros(nmed)
    med_albedo_vol = np.zeros(nmed, np.int32)
    med_density_vol = np.zeros(nmed, np.int32)
    for i, m in enumerate(b.media):
        med_type[i] = m.type
        med_sigma_a[i] = m.sigma_a
        med_sigma_s[i] = m.sigma_s
        med_phase[i] = m.phase_type
        med_g[i] = m.g
        med_albedo_vol[i] = m.albedo_vol
        med_density_vol[i] = m.density_vol

    # one wide row per medium (scene/soa.py pattern): the volpath inner
    # loops read medium properties per lane per iteration, and one row
    # fetch replaces ~13 narrow gathers per bounce.
    # layout: [type, phase, g, dvol, avol, sa3, ss3, maxval3, pad2]

    def _super_majorants(g, gres):
        """Conservative per-supervoxel majorants for a (Z,Y,X,3) grid.

        Supervoxel (i,j,k) of an (gx,gy,gz) partition of the volume's
        [pmin,pmax] box must bound the trilinear-interpolated density
        anywhere inside it (plus a one-node margin for the DDA's boundary
        nudges), i.e. the max over fine nodes with index in
        [floor(lo)-1, floor(hi)+2] per axis. Replaces the single global
        majorant the reference uses (media/heterogeneous.inl:3-11) — any
        local bound >= sigma_t keeps delta tracking unbiased, and a tight
        one cuts the lockstep null-collision rounds ~100x on hetvol.

        Also returns the matching per-supervoxel MINORANT (min over the
        same node window) — a conservative control sigma_c <= sigma_t
        everywhere in the cell, used by volpath's residual ratio
        tracking: exp(-sigma_c * dt) is factored out analytically and
        tracking runs at the residual rate (majorant - control), cutting
        null-collision rounds on smooth/dense regions. sigma_c = 0
        wherever the majorant is 0, so empty-space skips are unchanged."""
        gx, gy, gz = gres
        out_hi = g
        out_lo = g
        for axis, gdim in ((2, gx), (1, gy), (0, gz)):
            n_nodes = out_hi.shape[axis]
            chunks_hi, chunks_lo = [], []
            for i in range(gdim):
                lo = int(np.floor(i * (n_nodes - 1) / gdim)) - 1
                hi = int(np.floor((i + 1) * (n_nodes - 1) / gdim)) + 2
                lo, hi = max(lo, 0), min(hi, n_nodes - 1)
                sl = [slice(None)] * out_hi.ndim
                sl[axis] = slice(lo, hi + 1)
                chunks_hi.append(
                    out_hi[tuple(sl)].max(axis=axis, keepdims=True))
                chunks_lo.append(
                    out_lo[tuple(sl)].min(axis=axis, keepdims=True))
            out_hi = np.concatenate(chunks_hi, axis=axis)
            out_lo = np.concatenate(chunks_lo, axis=axis)
        return out_hi, out_lo  # each (gz, gy, gx, 3)

    def _empty_skip(sv):
        """Chebyshev distance-to-occupied over the supervoxel grid.
        A cell with skip = s > 0 has NO nonzero-majorant supervoxel
        within L-inf distance s-1, so a free flight sitting in it may
        advance to the exit of its cell box expanded by s-1 cells per
        axis as ONE zero-majorant segment (volpath._majorant_segment)
        instead of one DDA step per empty cell. 0 on occupied cells.
        Compile-time empty-space skipping; no reference equivalent
        (the reference tracks under one global majorant,
        media/heterogeneous.inl:3-11)."""
        occ = sv.max(axis=-1) > 0
        gz, gy, gx = occ.shape
        big = 10 ** 6
        dist = np.where(occ, 0, big).astype(np.int64)
        for _ in range(max(gz, gy, gx)):
            p = np.pad(dist, 1, constant_values=big)
            m = dist
            for dz in range(3):
                for dy in range(3):
                    for dx in range(3):
                        m = np.minimum(m, p[dz:dz + gz, dy:dy + gy,
                                            dx:dx + gx] + 1)
            m = np.where(occ, 0, m)
            if (m == dist).all():
                break
            dist = m
        return np.minimum(dist, 255).astype(np.float32)

    def _svox_gres(shape_zyx, div):
        """Supervoxel grid resolution for a (z, y, x) density grid at
        `div` cells per supervoxel."""
        z, y, x = shape_zyx
        return tuple(int(np.clip((r - 1 + div - 1) // div, 1, 32))
                     for r in (x, y, z))

    nv = max(len(b.volumes), 1)
    vol_kind = np.zeros(nv, np.int32)
    vol_const = np.zeros((nv, 3))
    vol_offset = np.zeros(nv, np.int32)
    vol_res = np.ones((nv, 3), np.int32)
    vol_pmin = np.zeros((nv, 3))
    vol_pmax = np.ones((nv, 3))
    vol_maxval = np.zeros((nv, 3))
    vol_scale = np.ones(nv)
    svox_offset = np.zeros(nv, np.int32)
    svox_res = np.ones((nv, 3), np.int32)
    vchunks = []
    schunks = []
    voff = 0
    soff = 0
    for i, v in enumerate(b.volumes):
        vol_kind[i] = v.kind
        vol_const[i] = np.asarray(v.const) * v.scale
        vol_scale[i] = v.scale
        if v.kind == T.VOL_GRID:
            g = v.grid  # (Z,Y,X,3)
            z, y, x = g.shape[:3]
            vol_offset[i] = voff
            vol_res[i] = (x, y, z)
            vol_pmin[i] = v.pmin
            vol_pmax[i] = v.pmax
            vol_maxval[i] = g.reshape(-1, 3).max(0) * v.scale
            # octo-packed rows: node (z,y,x) carries all 8 corners of its
            # cell (edge-clamped), so one trilinear lookup is ONE wide
            # gather instead of 8 narrow ones (the grid-media inner-loop
            # hot spot; ~10 ns/lane/gather regardless of row width).
            # 8x memory — hetvol-class grids are ~10 MB, so ~80 MB.
            gs = g * v.scale
            xi = np.minimum(np.arange(x) + 1, x - 1)
            yi = np.minimum(np.arange(y) + 1, y - 1)
            zi = np.minimum(np.arange(z) + 1, z - 1)
            oct_ = np.concatenate([
                gs,                      # c000
                gs[:, :, xi],            # c001 (x+1)
                gs[:, yi, :],            # c010 (y+1)
                gs[:, yi][:, :, xi],     # c011
                gs[zi],                  # c100 (z+1)
                gs[zi][:, :, xi],        # c101
                gs[zi][:, yi, :],        # c110
                gs[zi][:, yi][:, :, xi]  # c111
            ], axis=-1)
            vchunks.append(oct_.reshape(-1, 24))
            voff += x * y * z
            gres = _svox_gres(g.shape[:3], SVOX_DIVISOR)
            sv, sv_lo = _super_majorants(g, gres)
            sv = sv * v.scale
            sv_lo = sv_lo * v.scale
            svox_offset[i] = soff
            svox_res[i] = gres
            skip = _empty_skip(sv)
            # row: majorant rgb | empty-skip | control (minorant) rgb |
            # pad — one 8-wide row per supervoxel so the tracking loop's
            # single gather also carries the residual-tracking control
            schunks.append(np.concatenate(
                [sv.reshape(-1, 3), skip.reshape(-1, 1),
                 sv_lo.reshape(-1, 3),
                 np.zeros((sv_lo.reshape(-1, 3).shape[0], 1))], axis=-1))
            soff += gres[0] * gres[1] * gres[2]
        else:
            vol_maxval[i] = vol_const[i]
    volume_data = (np.concatenate(vchunks) if vchunks
                   else np.zeros((1, 24))).astype(np.float32)
    svox_data = (np.concatenate(schunks) if schunks
                 else np.zeros((1, 8))).astype(np.float32)

    # layout documented in media.py (MT_*/VL_* constants)
    med_tab = np.zeros((nmed, 46), np.float32)
    med_tab[:, 0] = med_type
    med_tab[:, 1] = med_phase
    med_tab[:, 2] = med_g
    med_tab[:, 3] = med_density_vol
    med_tab[:, 4] = med_albedo_vol
    med_tab[:, 5:8] = med_sigma_a
    med_tab[:, 8:11] = med_sigma_s
    dv = np.maximum(med_density_vol, 0)
    av = np.maximum(med_albedo_vol, 0)
    med_tab[:, 11:14] = vol_maxval[dv]
    med_tab[:, 14:17] = svox_res[dv]
    med_tab[:, 17] = svox_offset[dv]
    for c0, vi in ((18, dv), (32, av)):
        med_tab[:, c0] = vol_kind[vi]
        med_tab[:, c0 + 1:c0 + 4] = vol_const[vi]
        med_tab[:, c0 + 4:c0 + 7] = vol_pmin[vi]
        med_tab[:, c0 + 7:c0 + 10] = vol_pmax[vi]
        med_tab[:, c0 + 10:c0 + 13] = vol_res[vi]
        med_tab[:, c0 + 13] = vol_offset[vi]

    # --------------------------------------------------- merged wide-row tables
    # (scene/soa.py): one row fetch per record instead of many narrow
    # gathers — the wavefront hot-loop access pattern.
    nt_pad = max(num_tris, 1)
    tri_shade = np.zeros((nt_pad, 25), np.float32)
    if num_tris > 0:
        tri_shade[:, 0:3] = p0
        tri_shade[:, 3:6] = e1
        tri_shade[:, 6:9] = e2
        tri_shade[:, 9:12] = normals[indices[:, 0]]
        tri_shade[:, 12:15] = normals[indices[:, 1]]
        tri_shade[:, 15:18] = normals[indices[:, 2]]
        tri_shade[:, 18:20] = uv_arr[indices[:, 0]]
        tri_shade[:, 20:22] = uv_arr[indices[:, 1]]
        tri_shade[:, 22:24] = uv_arr[indices[:, 2]]
        tri_shade[:, 24] = tri_shape

    shape_tab = np.zeros((ns, 10), np.float32)
    shape_tab[:, 0] = shape_material
    shape_tab[:, 1] = shape_light
    shape_tab[:, 2] = shape_int_med
    shape_tab[:, 3] = shape_ext_med
    shape_tab[:, 4] = shape_type
    shape_tab[:, 5] = shape_prim_start
    shape_tab[:, 6] = shape_has_n
    shape_tab[:, 7] = shape_has_uv
    shape_tab[:, 8] = shape_area
    shape_tab[:, 9] = shape_prim_count

    light_tab = np.zeros((nl, 6), np.float32)
    light_tab[:, 0] = light_type
    light_tab[:, 1] = light_shape
    light_tab[:, 2:5] = light_intensity
    light_tab[:, 5] = light_pmf

    mat_tab = np.zeros((nm, 15), np.float32)
    mat_tab[:, 0] = mat_type
    mat_tab[:, 1] = mat_eta
    mat_tab[:, 2:15] = mat_tex

    tex_tab = np.zeros((nt, 12), np.float32)
    tex_tab[:, 0] = tex_kind
    tex_tab[:, 1] = tex_image
    tex_tab[:, 2:5] = tex_const
    tex_tab[:, 5:8] = tex_color1
    tex_tab[:, 8:10] = tex_uvscale
    tex_tab[:, 10:12] = tex_uvoffset

    # ------------------------------------------------------ occluder subset
    # A triangle on the scene's convex envelope — ALL geometry on one side
    # of its plane — can never intersect a shadow segment whose endpoints
    # both lie on/inside the hull, which is every area/sphere-light NEE
    # ray (path_tracing.h:119-131: surface point → light point). Envmap
    # shadow rays extend to infinity, so envmap scenes keep the full set.
    # Media scenes also
    # keep the full set: volumetric NEE rays originate at scatter points
    # that can lie OUTSIDE the geometry hull (e.g. camera-in-medium
    # vol_cbox), where envelope walls genuinely occlude
    # (vol_path_tracing.h:335-439). cbox: the room walls and the block
    # bottoms (16 of 38 tris) drop out of every occlusion cast.
    cast_occ_quad = cast_quad
    if 0 < num_tris <= 4096 and not (b.envmap_light_id >= 0) \
            and not b.media:
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=1)
        ok_n = ln > 1e-18
        nrm = np.where(ok_n[:, None],
                       nrm / np.maximum(ln, 1e-18)[:, None], 0.0)
        dpl = np.einsum('td,td->t', nrm, p0)
        tv = np.concatenate([p0, p0 + e1, p0 + e2], axis=0)
        sdist = tv @ nrm.T - dpl[None, :]             # (3T, T)
        smax = sdist.max(axis=0)
        smin = sdist.min(axis=0)
        if spheres:
            sc = sph_center @ nrm.T - dpl[None, :]    # (S, T)
            smax = np.maximum(smax, (sc + sph_radius[:, None]).max(axis=0))
            smin = np.minimum(smin, (sc - sph_radius[:, None]).min(axis=0))
        eps_h = 1e-4 * float(radius)
        hull = ok_n & ((smax <= eps_h) | (smin >= -eps_h))
        # degenerate tris never hit anything either
        occ = ~hull & ok_n
        # cast space: a quad prim occludes if EITHER member does (the
        # envelope argument applies per member triangle)
        occ_c = occ[cast_src] | occ[cast_alt]
        if occ_c.any():
            cast_tri_occ = cast_tri[:, occ_c]
            cast_occ_quad = cast_quad[occ_c]
        else:
            cast_tri_occ = np.zeros((9, 1), np.float32)
            cast_occ_quad = np.zeros(1, np.float32)
    else:
        cast_tri_occ = cast_tri

    # ------------------------------------------------------------------ camera
    cam = b.camera
    aspect = cam.width / cam.height
    fov_x = fov_to_fov_x(cam.fov, getattr(cam, 'fov_axis', 'x'),
                         cam.width, cam.height)
    cam_to_sample = (xf.scale([-0.5, -0.5 * aspect, 1.0]) @
                     xf.translate([-1.0, -1.0 / aspect, 0.0]) @
                     xf.perspective(fov_x))  # camera.cpp:16-21
    sample_to_cam = np.linalg.inv(cam_to_sample)
    cam_to_world = np.asarray(cam.to_world, np.float64)
    world_to_cam = np.linalg.inv(cam_to_world)

    # ------------------------------------------------------------------ meta
    mat_types_present = tuple(sorted(set(int(t) for t in mat_type[:max(len(b.materials), 0)]))) \
        if b.materials else ()
    phase_present = tuple(sorted(set(int(p) for p in med_phase[:len(b.media)]))) \
        if b.media else ()
    med_present = tuple(sorted(set(int(t) for t in med_type[:len(b.media)]))) \
        if b.media else ()
    tex_present = tuple(sorted(set(int(k) for k in tex_kind[:len(b.texdescs)]))) \
        if b.texdescs else (T.TEX_CONSTANT,)

    meta = SceneMeta(
        num_shapes=len(b.shapes),
        num_triangles=num_tris,
        num_spheres=len(spheres),
        num_materials=len(b.materials),
        num_lights=len(b.lights),
        num_media=len(b.media),
        num_textures=len(b.texdescs),
        num_images=len(b.texture_pool.pyramids),
        mat_types_present=mat_types_present,
        phase_types_present=phase_present,
        med_types_present=med_present,
        has_envmap=b.envmap_light_id >= 0,
        envmap_light_id=b.envmap_light_id,
        env_image_id=env_image_id,
        env_res=(env_h, env_w),
        width=cam.width,
        height=cam.height,
        camera_medium_id=cam.medium_id,
        scene_radius=radius,
        use_bvh=use_bvh,
        bvh_depth=int(bvh['n_nodes']),
        use_binned=use_binned,
        has_image_textures=any(td.kind == T.TEX_IMAGE for td in b.texdescs),
        texture_types_present=tex_present,
        needs_uv=any(td.kind != T.TEX_CONSTANT for td in b.texdescs),
        needs_ray_diff=any(td.kind == T.TEX_IMAGE for td in b.texdescs),
        needs_tangent=any(m.type in (T.MAT_DISNEY_METAL, T.MAT_DISNEY_GLASS,
                                     T.MAT_DISNEY_BSDF)
                          for m in b.materials),
        has_grid_volumes=any(v.kind == T.VOL_GRID for v in b.volumes),
        has_quads=bool((cast_alt != cast_src).any()),
        # control == sigma_t for homogeneous media (exact analytic NEE
        # transmittance); for grids only worth the hot-loop exps when the
        # supervoxel minorants are nontrivial (hetvol's wispy cloud has
        # ~0 minima everywhere, so it compiles the plain form)
        svox_ctrl=bool(
            T.MED_HOMOGENEOUS in med_present or
            (T.MED_HETEROGENEOUS in med_present and
             svox_data[:, 4:7].max() > 1e-4 * max(svox_data[:, :3].max(),
                                                  1e-20))),
    )

    return Scene(
        vertices=_f32(vertices), normals=_f32(normals), uvs=_f32(uv_arr),
        indices=_i32(indices), tri_shape=_i32(tri_shape),
        tri_p0=_f32(p0), tri_e1=_f32(e1), tri_e2=_f32(e2),
        cast_tri=_f32(cast_tri), cast_tri_occ=_f32(cast_tri_occ),
        cast_src=_i32(cast_src), cast_alt=_i32(cast_alt),
        cast_quad=_f32(cast_quad), cast_occ_quad=_f32(cast_occ_quad),
        sph_center=_f32(sph_center), sph_radius=_f32(sph_radius),
        sph_shape=_i32(sph_shape),
        bvh_lo=_f32(bvh['lo']), bvh_hi=_f32(bvh['hi']),
        bvh_first=_i32(bvh['first']), bvh_count=_i32(bvh['count']),
        bvh_skip=_i32(bvh['skip']), bvh_prim=_i32(bvh['prim']),
        bvh_node=_f32(bvh_node), bvh_leaf_tri=_f32(bvh_leaf_tri),
        cl_lo=_f32(cl['cl_lo']), cl_hi=_f32(cl['cl_hi']),
        cl_A=_f32(cl['cl_A']), cl_b=_f32(cl['cl_b']),
        cl_prim=_i32(cl['cl_prim']),
        shape_material_id=_i32(shape_material), shape_light_id=_i32(shape_light),
        shape_interior_med=_i32(shape_int_med),
        shape_exterior_med=_i32(shape_ext_med),
        shape_type=_i32(shape_type), shape_prim_start=_i32(shape_prim_start),
        shape_prim_count=_i32(shape_prim_count), shape_area=_f32(shape_area),
        shape_has_normals=_i32(shape_has_n), shape_has_uvs=_i32(shape_has_uv),
        tri_stair_cdf=_f32(tri_stair), tri_area=_f32(tri_area),
        tri_alias=_f32(tri_alias),
        mat_type=_i32(mat_type), mat_tex=_i32(mat_tex), mat_eta=_f32(mat_eta),
        tex_kind=_i32(tex_kind), tex_const=_f32(tex_const),
        tex_color1=_f32(tex_color1), tex_image=_i32(tex_image),
        tex_uvscale=_f32(tex_uvscale), tex_uvoffset=_f32(tex_uvoffset),
        texdata=_f32(texdata), mip_tab=_f32(mip_tab),
        mip_offset=_i32(mip_offset),
        mip_w=_i32(mip_w), mip_h=_i32(mip_h), mip_levels=_i32(mip_levels),
        light_type=_i32(light_type), light_shape=_i32(light_shape),
        light_intensity=_f32(light_intensity), light_cdf=_f32(light_cdf),
        light_pmf=_f32(light_pmf),
        env_to_world=_f32(env_to_world), env_to_local=_f32(env_to_local),
        env_scale=_f32(env_scale), env_cond_cdf=_f32(env_cond_cdf),
        env_marg_cdf=_f32(env_marg_cdf), env_pdf_uv=_f32(env_pdf_uv),
        env_alias=_f32(env_alias),
        med_type=_i32(med_type), med_sigma_a=_f32(med_sigma_a),
        med_sigma_s=_f32(med_sigma_s), med_phase_type=_i32(med_phase),
        med_g=_f32(med_g), med_albedo_vol=_i32(med_albedo_vol),
        med_density_vol=_i32(med_density_vol),
        vol_kind=_i32(vol_kind), vol_const=_f32(vol_const),
        vol_offset=_i32(vol_offset), vol_res=_i32(vol_res),
        vol_pmin=_f32(vol_pmin), vol_pmax=_f32(vol_pmax),
        vol_maxval=_f32(vol_maxval), volume_data=_f32(volume_data),
        svox_offset=_i32(svox_offset), svox_res=_i32(svox_res),
        svox_data=_f32(svox_data),
        med_tab=_f32(med_tab),
        tri_shade=_f32(tri_shade), shape_tab=_f32(shape_tab),
        light_tab=_f32(light_tab), mat_tab=_f32(mat_tab),
        tex_tab=_f32(tex_tab),
        cam_to_world=_f32(cam_to_world), world_to_cam=_f32(world_to_cam),
        sample_to_cam=_f32(sample_to_cam), cam_to_sample=_f32(cam_to_sample),
        meta=meta,
    )
