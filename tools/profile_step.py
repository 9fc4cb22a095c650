"""Per-step anatomy of the general wavefront queue: time the full
vmapped _advance_lane step (casts + shading + NEE) vs the casters alone,
with evolving state for a realistic bounce mix. Prints one JSON line.

usage: python tools/profile_step.py SCENE.xml [lanes] [steps]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def main():
    path = sys.argv[1]
    lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
    steps = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    import jax
    from lajolla_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from lajolla_tpu.scene.parser import parse_scene
    import lajolla_tpu.integrators.path as P

    scene, options = parse_scene(path)
    w, h = scene.meta.width, scene.meta.height
    n_q = -(-(w * h) // lanes) * lanes
    su = P._pcg_hash(jnp.uint32(7) ^ jnp.uint32(0x9E3779B9))
    item0 = jnp.arange(lanes, dtype=jnp.int32)
    _pix, org0, d0 = jax.jit(
        lambda: P._primary_hash(scene, options, item0, su, n_q))()
    z = jnp.zeros(lanes, jnp.float32)
    state = (item0, jnp.full(lanes, 2, jnp.int32), org0, d0,
             jnp.full(lanes, 0.25 / max(w, h), jnp.float32), z,
             jnp.ones((lanes, 3), jnp.float32),
             jnp.zeros((lanes, 3), jnp.float32),
             jnp.ones(lanes, jnp.float32), z, org0,
             jnp.zeros(lanes, jnp.bool_))
    kidx = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9) +
            jnp.uint32(0x9E3779B9))[None, :]

    dev = jax.devices()[0]
    out = {"scene": os.path.basename(path), "lanes": lanes, "steps": steps,
           "device": {"platform": dev.platform, "kind": dev.device_kind}}

    def time_loop(name, body_fn, init):
        f = jax.jit(lambda c: jax.lax.fori_loop(0, steps, body_fn, c))
        r = jax.tree_util.tree_map(np.asarray, f(init))   # compile+warm
        ts = []
        for _ in range(3):
            t0 = time.time()
            r = jax.tree_util.tree_map(np.asarray, f(init))
            ts.append(time.time() - t0)
        out[name] = {"ms_per_step": round(min(ts) * 1e3 / steps, 3)}
        return r

    # full advance step (casts + shading + NEE + regen-style masking)
    def adv_body(i, st):
        hb = P._pcg_hash(st[0].astype(jnp.uint32) ^
                         P._pcg_hash(st[1].astype(jnp.uint32) ^ su))
        uN = P._hash_u01(P._pcg_hash(hb[:, None] + kidx))
        nst, died = jax.vmap(
            lambda u, *s: P._advance_lane(scene, options, s, u))(uN, *st)
        # keep lanes alive so the mix stays realistic: dead lanes
        # restart at their origin (same shapes, no host regen)
        done = nst[-1] | died
        nst = nst[:-1] + (jnp.where(done, False, done),)
        return nst
    time_loop("advance_full", adv_body, state)

    # casters alone on the same evolving-o/d population
    from lajolla_tpu.scene.geometry import cast_scene, occluded

    def cast_body(i, c):
        o, d = c
        t, prim, u, v, sph = jax.vmap(
            lambda oo, dd: cast_scene(scene, oo, dd, 1e-3, jnp.inf))(o, d)
        tt = jnp.where(jnp.isfinite(t), t, 1.0)
        occ = jax.vmap(
            lambda oo, dd, far: occluded(scene, oo, dd, 1e-3, far))(
            o, d, tt * 0.999)
        o2 = o + 0.999 * tt[:, None] * d
        d2 = jnp.where((prim % 2 == 0)[:, None], d, -d)
        return (jnp.where(occ[:, None], o, o2), d2)
    time_loop("cast_closest_plus_anyhit", cast_body, (org0, d0))

    print(json.dumps(out))


if __name__ == "__main__":
    main()
