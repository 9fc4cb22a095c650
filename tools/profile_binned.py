"""Where does a bounce go on a large (binned-caster) scene such as
matpreview or sponza? Times, on the device JAX runs on:
  - intersect_binned / occluded_binned on coherent and incoherent rays
  - one full wavefront advance step (cast + shade glue)

Usage: python tools/profile_binned.py SCENE.xml [lanes]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from lajolla_tpu.ops.intersect_binned import (intersect_binned,
                                              occluded_binned)
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.scene.parser import parse_scene_to_builder
from lajolla_tpu.utils.cache import enable_compile_cache


def timeit(fn, *args, n=5):
    fn(*args)  # compile
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    path = sys.argv[1]
    lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
    enable_compile_cache()
    b = parse_scene_to_builder(path)
    scene = compile_scene(b)
    opts = b.options
    m = scene.meta
    K, C = scene.cl_prim.shape
    dev = jax.devices()[0]
    print(f"{os.path.basename(path)}: {m.num_triangles} tris, K={K} "
          f"clusters x C={C}, use_binned={m.use_binned}, film "
          f"{m.width}x{m.height}, lanes={lanes}, device {dev.platform} "
          f"{dev.device_kind}")

    # representative rays: primary rays from the camera (coherent-ish),
    # and a hash-scrambled copy (incoherent, like bounce 3+)
    from lajolla_tpu.integrators.path import _primary_hash
    item = jnp.arange(lanes, dtype=jnp.int32)
    _, org, d = _primary_hash(scene, opts, item, jnp.uint32(7))
    perm = np.random.default_rng(0).permutation(lanes)
    org_i = org[perm] + 0.0
    rng = np.random.default_rng(1)
    d_i = jnp.asarray(rng.normal(size=(lanes, 3)), jnp.float32)
    d_i = d_i / jnp.linalg.norm(d_i, axis=1, keepdims=True)
    tn = jnp.zeros(lanes) + 1e-3
    tf = jnp.full(lanes, jnp.inf)

    cast = jax.jit(lambda o, dd: intersect_binned(scene, o, dd, tn, tf))
    occ = jax.jit(lambda o, dd: occluded_binned(scene, o, dd, tn, tf))
    for label, fn, o_, d_ in [
            ("cast coherent", cast, org, d),
            ("cast incoherent", cast, org_i, d_i),
            ("occl coherent", occ, org, d)]:
        t = timeit(fn, o_, d_)
        print(f"{label}: {t * 1e3:.2f} ms ({lanes / t / 1e6:.2f} Mrays/s)")

    # one full advance step
    from lajolla_tpu.integrators.path import _advance_lane, _pcg_hash, \
        _hash_u01, _GOLD
    su = jnp.uint32(7)
    kidx = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(_GOLD) +
            jnp.uint32(_GOLD))[None, :]

    def step(org, d):
        z = jnp.zeros(lanes, jnp.float32)
        st = (item, jnp.full(lanes, 2, jnp.int32), org, d,
              jnp.full(lanes, 1e-3, jnp.float32), z,
              jnp.ones((lanes, 3), jnp.float32),
              jnp.zeros((lanes, 3), jnp.float32),
              jnp.ones(lanes, jnp.float32), z, org,
              jnp.zeros(lanes, jnp.bool_))
        hb = _pcg_hash(item.astype(jnp.uint32) ^ _pcg_hash(su))
        uN = _hash_u01(_pcg_hash(hb[:, None] + kidx))
        nst, died = jax.vmap(
            lambda u, *s: _advance_lane(scene, opts, s, u))(uN, *st)
        return nst[6], died

    t = timeit(jax.jit(step), org, d)
    print(f"full advance step: {t * 1e3:.2f} ms "
          f"({lanes / t / 1e6:.3f} Mpaths-steps/s)")


if __name__ == "__main__":
    main()
