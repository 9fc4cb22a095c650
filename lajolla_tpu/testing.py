"""Programmatic scene construction helpers (testing + benchmarks) — the
analogue of the reference in-memory
Scene fixture in tests/intersection.cpp:9-27)."""

import numpy as np

from lajolla_tpu.scene import types as T
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.scene.parser import (CameraB, LightB, MaterialB, MeshB,
                                      SceneBuilder, ShapeB, TexDesc)
from lajolla_tpu.scene.texture import TexturePool
from lajolla_tpu.scene.types import RenderOptions


MATERIAL_XML_TYPES = {
    'diffuse': T.MAT_LAMBERTIAN,
    'roughplastic': T.MAT_ROUGH_PLASTIC,
    'roughdielectric': T.MAT_ROUGH_DIELECTRIC,
    'disneydiffuse': T.MAT_DISNEY_DIFFUSE,
    'disneymetal': T.MAT_DISNEY_METAL,
    'disneyglass': T.MAT_DISNEY_GLASS,
    'disneyclearcoat': T.MAT_DISNEY_CLEARCOAT,
    'disneysheen': T.MAT_DISNEY_SHEEN,
    'disneybsdf': T.MAT_DISNEY_BSDF,
}


def quad_mesh(z=0.0, half=1.0):
    return MeshB(
        positions=np.array([[-half, -half, z], [half, -half, z],
                            [half, half, z], [-half, half, z]], np.float64),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.array([[0, 0, 1]] * 4, np.float64),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64))


def make_furnace_scene(albedo=0.6, res=24, env_radiance=1.0):
    """Convex Lambertian sphere in a uniform environment light: every
    sphere pixel must converge to albedo * env_radiance (no
    self-interreflection on a convex body) — a quantitative end-to-end
    gate on envmap emission/sampling, MIS weighting and BSDF sampling."""
    import numpy as np
    from lajolla_tpu.core import transform as xf
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 4], [0, 0, 0], [0, 1, 0]), fov=30.0, width=res, height=res),
        options=RenderOptions(), texture_pool=TexturePool())
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    b.texdescs.append(TexDesc(kind=T.TEX_CONSTANT,
                              const=(albedo, albedo, albedo)))
    m.tex[T.P_BASE_COLOR] = 0
    b.materials.append(m)
    b.shapes.append(ShapeB(type=T.SHAPE_SPHERE, center=(0.0, 0.0, 0.0),
                           radius=1.0, material_id=0))
    img_id = b.texture_pool.insert(
        "__envmap_texture__",
        np.full((16, 32, 3), env_radiance, np.float32))
    b.envmap_light_id = 0
    b.lights.append(LightB(type=T.LIGHT_ENVMAP, image_id=img_id,
                           to_world=xf.identity(), scale=1.0))
    return compile_scene(b)


def make_volume_scene(sigma_a=(0.05,) * 3, sigma_s=(0.3,) * 3, g=0.0,
                      res=24, radiance=2.0):
    """Emissive sphere inside a homogeneous scattering medium filling the
    camera's space — exercises free-flight sampling, volumetric NEE and
    phase sampling on a small fixture."""
    import numpy as np
    from lajolla_tpu.core import transform as xf
    from lajolla_tpu.scene.parser import MediumB
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 6], [0, 0, 0], [0, 1, 0]), fov=40.0, width=res, height=res,
        medium_id=0),
        options=RenderOptions(integrator='volpath'),
        texture_pool=TexturePool())
    b.media.append(MediumB(type=T.MED_HOMOGENEOUS, sigma_a=sigma_a,
                           sigma_s=sigma_s, phase_type=T.PHASE_HG if g else
                           T.PHASE_ISOTROPIC, g=g))
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    b.texdescs.append(TexDesc(kind=T.TEX_CONSTANT, const=(0.0, 0.0, 0.0)))
    m.tex[T.P_BASE_COLOR] = 0
    b.materials.append(m)
    b.shapes.append(ShapeB(type=T.SHAPE_SPHERE, center=(0.0, 0.0, 0.0),
                           radius=1.0, material_id=0, area_light_id=0,
                           exterior_medium_id=0))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=0,
                           intensity=(radiance,) * 3))
    return compile_scene(b)


def make_white_box_scene(albedo=0.9, emission=0.3, res=8):
    """Camera inside a closed emissive diffuse cube: every wall both
    emits Le and reflects with albedo rho, so the uniform equilibrium
    radiance is analytic, L = Le / (1 - rho) — a worst-case DEEP-path
    fixture (RR-survival ~ rho per bounce, mean path length 1/(1-rho))
    that gates the MAX_BOUNCES_CAP truncation bias (see docs/PARITY.md
    'Path length is capped')."""
    from lajolla_tpu.core import transform as xf
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 0], [0, 0, 1], [0, 1, 0]), fov=45.0, width=res, height=res),
        options=RenderOptions(max_depth=-1), texture_pool=TexturePool())
    m = MaterialB(type=T.MAT_LAMBERTIAN)
    b.texdescs.append(TexDesc(kind=T.TEX_CONSTANT, const=(albedo,) * 3))
    m.tex[T.P_BASE_COLOR] = 0
    b.materials.append(m)
    # 12 triangles wound so geometric normals face INWARD (one-sided
    # area emission toward the camera, diffuse_area_light.inl:15-20).
    # Each face owns its 4 vertices + explicit flat normals: shared
    # corners would get angle-weighted SMOOTH normals (diagonals), which
    # breaks the analytic equilibrium.
    pos, nrm, idx = [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            quad = []
            for (su, sv) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[axis] = sign
                p[u_ax] = su
                p[v_ax] = sv
                quad.append(p)
            n_in = np.zeros(3)
            n_in[axis] = -sign                 # inward
            fn = np.cross(quad[1] - quad[0], quad[2] - quad[0])
            if np.dot(fn, n_in) < 0:
                quad = quad[::-1]
            base = len(pos)
            pos.extend(quad)
            nrm.extend([n_in] * 4)
            idx.append([base, base + 1, base + 2])
            idx.append([base, base + 2, base + 3])
    mesh = MeshB(positions=np.array(pos, np.float64),
                 indices=np.array(idx, np.int32),
                 normals=np.array(nrm, np.float64))
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, mesh=mesh, material_id=0,
                           area_light_id=0))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=0,
                           intensity=(emission,) * 3))
    return compile_scene(b)


def make_single_material_scene(mat_xml_type, params=None, eta=1.5):
    """One quad with the given material, a white area light quad above,
    camera looking down."""
    from lajolla_tpu.core import transform as xf
    b = SceneBuilder(camera=CameraB(to_world=xf.look_at(
        [0, 0, 3], [0, 0, 0], [0, 1, 0]), fov=45.0, width=32, height=32),
        options=RenderOptions(), texture_pool=TexturePool())

    m = MaterialB(type=MATERIAL_XML_TYPES[mat_xml_type], eta=eta)
    params = dict(params or {})

    def const_tex(v):
        v = np.broadcast_to(np.asarray(v, np.float64), (3,))
        b.texdescs.append(TexDesc(kind=T.TEX_CONSTANT, const=tuple(v)))
        return len(b.texdescs) - 1

    defaults = {
        T.P_BASE_COLOR: (0.5, 0.5, 0.5), T.P_AUX_COLOR: (1.0, 1.0, 1.0),
        T.P_ROUGHNESS: 0.25, T.P_SUBSURFACE: 0.0, T.P_METALLIC: 0.0,
        T.P_SPECULAR: 0.5, T.P_SPECULAR_TINT: 0.0, T.P_ANISOTROPIC: 0.0,
        T.P_SHEEN: 0.0, T.P_SHEEN_TINT: 0.5, T.P_CLEARCOAT: 0.0,
        T.P_CLEARCOAT_GLOSS: 1.0, T.P_SPEC_TRANS: 0.0,
    }
    defaults.update(params)
    for slot, v in defaults.items():
        m.tex[slot] = const_tex(v)
    b.materials.append(m)

    b.shapes.append(ShapeB(type=T.SHAPE_MESH, mesh=quad_mesh(0.0),
                           material_id=0))
    # area light
    light_mesh = quad_mesh(2.0)
    b.shapes.append(ShapeB(type=T.SHAPE_MESH, mesh=light_mesh,
                           material_id=0, area_light_id=0))
    b.lights.append(LightB(type=T.LIGHT_AREA, shape_id=1,
                           intensity=(5.0, 5.0, 5.0)))
    return compile_scene(b)


def caster_parity_rays(scene, options, seed=0):
    """The dense casters' parity workload on a film-sized ray batch, with
    the distances a real wavefront step casts. Returns two ray sets, each
    (o, d, tnear, tfar) with o, d (N, 3) and tnear, tfar (N,) float32:

      closest: one camera ray per pixel plus one cosine-distributed
               bounce from each camera hit (2 * W * H rays);
      shadow:  one segment per pixel from the camera hit to a uniform
               point on an emitting triangle, windowed like the path
               integrator's NEE (W * H rays).

    Camera hits come from the scalar Moller-Trumbore oracle; camera
    misses get an empty window (tfar = 0)."""
    import jax
    import jax.numpy as jnp
    from lajolla_tpu.dtypes import intersection_eps, shadow_eps
    from lajolla_tpu.integrators.path import _primary_hash
    from lajolla_tpu.ops.intersect import _brute_force_scalar

    n = scene.meta.width * scene.meta.height
    item = jnp.arange(n, dtype=jnp.int32)
    _, o, d = _primary_hash(scene, options, item, jnp.uint32(seed))
    eps = intersection_eps(scene.meta.scene_radius)
    tn = jnp.full(n, eps, jnp.float32)
    tf = jnp.full(n, jnp.inf, jnp.float32)
    t, prim, _, _ = jax.vmap(_brute_force_scalar, (None, 0, 0, 0, 0))(
        scene, o, d, tn, tf)
    hit = prim >= 0
    p = o + jnp.where(hit, t, 0.0)[:, None] * d
    pc = jnp.maximum(prim, 0)
    ng = jnp.cross(scene.tri_e1[pc], scene.tri_e2[pc])
    ng = ng / jnp.linalg.norm(ng, axis=1, keepdims=True)
    ng = jnp.where(jnp.sum(ng * d, axis=1, keepdims=True) > 0, -ng, ng)
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    r = jnp.sqrt(jax.random.uniform(k1, (n,)))
    phi = 2.0 * jnp.pi * jax.random.uniform(k2, (n,))
    a = jnp.where(jnp.abs(ng[:, 0:1]) > 0.9, jnp.array([0.0, 1.0, 0.0]),
                  jnp.array([1.0, 0.0, 0.0]))
    s = jnp.cross(ng, a)
    s = s / jnp.linalg.norm(s, axis=1, keepdims=True)
    tt = jnp.cross(ng, s)
    db = ((r * jnp.cos(phi))[:, None] * s + (r * jnp.sin(phi))[:, None] * tt
          + jnp.sqrt(jnp.maximum(1.0 - r * r, 0.0))[:, None] * ng)
    tfb = jnp.where(hit, jnp.inf, 0.0).astype(jnp.float32)
    closest = (jnp.concatenate([o, p]).astype(jnp.float32),
               jnp.concatenate([d, db]).astype(jnp.float32),
               jnp.concatenate([tn, tn]), jnp.concatenate([tf, tfb]))

    emit = np.nonzero(np.asarray(scene.shape_light_id)[
        np.asarray(scene.tri_shape)] >= 0)[0]
    area = np.asarray(scene.tri_area)[emit]
    li = jnp.asarray(emit)[jax.random.choice(
        k3, emit.size, (n,), p=jnp.asarray(area / area.sum()))]
    b1 = jnp.sqrt(jax.random.uniform(k4, (n,)))
    b2 = jax.random.uniform(k5, (n,))
    q = (scene.tri_p0[li] + ((1.0 - b2) * b1)[:, None] * scene.tri_e1[li]
         + (b2 * b1)[:, None] * scene.tri_e2[li])
    ds = q - p
    dist = jnp.linalg.norm(ds, axis=1)
    eps_s = shadow_eps(scene.meta.scene_radius)
    shadow = (p.astype(jnp.float32),
              (ds / jnp.maximum(dist, 1e-20)[:, None]).astype(jnp.float32),
              jnp.full(n, eps_s, jnp.float32),
              jnp.where(hit, (1.0 - eps_s) * dist, 0.0).astype(jnp.float32))
    return closest, shadow


def occluder_triangles(scene):
    """Triangle ids behind the occluder subset (both members of each
    quad cast prim in cast_tri_occ): what the scalar oracle must test to
    answer the same any-hit question as the dense occlusion caster."""
    full = np.asarray(scene.cast_tri).T
    occ = np.asarray(scene.cast_tri_occ).T
    src, alt = np.asarray(scene.cast_src), np.asarray(scene.cast_alt)
    ids = set()
    for row in occ:
        c = np.nonzero((full == row).all(axis=1))[0]
        if c.size:
            ids.update((int(src[c[0]]), int(alt[c[0]])))
    return np.asarray(sorted(ids), np.int32)
