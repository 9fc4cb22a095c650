"""Per-component device timing for the volumetric event machine: where
one outer event-machine step spends its time. Components, each timed
inside a jitted fori_loop with a value dependence so XLA cannot hoist or
DCE:

  cast     vmapped cast_scene (brute tri + sphere for hetvol's 14 tris)
  sigmas   vmapped _sigmas: ONE octo-row density gather + albedo const
  svox     vmapped _majorant_segment: supervoxel DDA step
  ff       vmapped _ff_steps: K_FF tracking micro-steps (svox + sigmas
           + masked pdf algebra per micro-step)
  step     one full outer advance: _render_volpath_block wall / iters

usage: python tools/profile_hetvol.py SCENE.xml [lanes]
(a volpath scene such as hetvol or vol_cbox; default 16384 lanes).
Prints one JSON line.
"""
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 30


def main():
    path = sys.argv[1]
    lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
    import jax
    from lajolla_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from lajolla_tpu.scene.parser import parse_scene
    import lajolla_tpu.integrators.volpath as vp
    from lajolla_tpu.integrators.media import med_row
    from lajolla_tpu.scene.geometry import cast_scene

    scene, options = parse_scene(path)
    dev = jax.devices()[0]
    out = {"scene": os.path.basename(path), "lanes": lanes,
           "knobs": {"K_FF": vp.K_FF},
           "device": {"platform": dev.platform, "kind": dev.device_kind}}

    # primary rays + in-grid sample points
    item = jnp.arange(lanes, dtype=jnp.int32)
    su = jnp.uint32(1234)
    _, o0, d0 = jax.jit(lambda: vp._primary_hash(scene, options, item,
                                                 su))()
    pmin = np.asarray(scene.vol_pmin[0] if scene.meta.has_grid_volumes
                      else np.zeros(3))
    pmax = np.asarray(scene.vol_pmax[0] if scene.meta.has_grid_volumes
                      else np.ones(3))
    rng = np.random.default_rng(0)
    p0 = jnp.asarray(pmin + rng.random((lanes, 3)) * (pmax - pmin),
                     jnp.float32)

    def timeit(name, fn, *args):
        f = jax.jit(fn)
        r = np.asarray(f(*args))          # compile + warm
        ts = []
        for _ in range(3):
            t0 = time.time()
            r = np.asarray(f(*args))
            ts.append(time.time() - t0)
        ms = min(ts) * 1e3 / STEPS
        out[name] = {"ms_per_call": round(ms, 4),
                     "ns_per_lane": round(ms * 1e6 / lanes, 2)}
        return r

    mrow = jax.jit(lambda: med_row(scene, jnp.int32(0)))().reshape(-1)

    # --- density lookup (_sigmas: octo gather + albedo) ---------------
    def sig_loop(p):
        def body(_, p):
            s, a = jax.vmap(lambda q: vp._sigmas(scene, mrow, q))(p)
            return p + jnp.minimum(s[:, :1] + a[:, :1], 0.0) * 1e-9
        return jax.lax.fori_loop(0, STEPS, body, p).sum()
    timeit("sigmas", sig_loop, p0)

    # --- supervoxel DDA majorant segment ------------------------------
    def svox_loop(p):
        def body(_, c):
            p, t = c
            maj, ctrl, t_end = jax.vmap(
                lambda q, tt: vp._majorant_segment(scene, mrow, q, d0[0],
                                                   tt, jnp.inf))(
                p, t)
            return (p + jnp.minimum(maj[:, :1], 0.0) * 1e-9,
                    jnp.minimum(t_end * 1e-9, 0.0))
        p, t = jax.lax.fori_loop(0, STEPS, body,
                                 (p, jnp.zeros(lanes)))
        return p.sum() + t.sum()
    timeit("svox", svox_loop, p0)

    # --- scene cast ---------------------------------------------------
    def cast_loop(o):
        def body(_, o):
            t, prim, u, v, sph = jax.vmap(
                lambda oo, dd: cast_scene(scene, oo, dd, 1e-4,
                                          jnp.inf))(o, d0)
            tt = jnp.where(jnp.isfinite(t), t, 0.0)
            return o + jnp.minimum(tt, 0.0)[:, None] * 1e-9
        return jax.lax.fori_loop(0, STEPS, body, o).sum()
    timeit("cast", cast_loop, o0)

    # --- K_FF free-flight micro-steps ---------------------------------
    def ff_loop(o):
        hs = jnp.full(lanes, jnp.uint32(777))
        wsc = jnp.ones(lanes, bool)
        go = jnp.ones(lanes, bool)
        ones3 = jnp.ones((lanes, 3))

        def body(_, o):
            fst = (jnp.zeros(lanes), jnp.zeros(lanes, jnp.int32),
                   ones3, ones3, ones3,
                   jnp.zeros(lanes, bool), jnp.zeros(lanes, bool))
            r = jax.vmap(lambda oo, dd, h, ws, g, *st: vp._ff_steps(
                scene, options, mrow, h, oo, dd, jnp.inf, ws, g, st),
                in_axes=(0, 0, 0, 0, 0) + (0,) * 7)(
                o, d0, hs, wsc, go, *fst)
            return o + jnp.minimum(r[0], 0.0)[:, None] * 1e-9
        return jax.lax.fori_loop(0, STEPS, body, o).sum()
    timeit("ff_kff", ff_loop, o0)

    # --- full outer step ---------------------------------------------
    f = functools.partial(vp._render_volpath_block, scene, options,
                          0, 0, 1, lanes=lanes, count=lanes)
    film, st, iters = f()
    np.asarray(film)
    ts = []
    for _ in range(2):
        t0 = time.time()
        film, st, iters = f()
        np.asarray(film)
        ts.append(time.time() - t0)
    iters = int(iters)
    out["outer_step"] = {"iters": iters,
                         "wall_s": round(min(ts), 3),
                         "ms_per_iter": round(min(ts) * 1e3 / iters, 2)}
    out["mpaths_one_path_per_lane"] = round(lanes / min(ts) / 1e6, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
