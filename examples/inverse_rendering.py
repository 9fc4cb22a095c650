"""Inverse rendering example: recover scene parameters from an image.

Runs two small optimizations on scenes of the reference corpus (CPU or
GPU):
  1. cbox: recover the red wall's diffuse reflectance from a target
     render (surface path tracing, reverse-mode gradients).
  2. volpath_test2: recover the medium's absorption scale (volumetric
     single scattering). Skipped when volpath_test is not under --scenes
     (only cbox ships with the repository).

Usage:
    python examples/inverse_rendering.py [--scenes SCENES_DIR]

See integrators/diffpath.py for the estimator details (detached
sampling; fixed-depth scan) and tests/test_diffpath.py for the gates
this example mirrors.
"""
import argparse
import dataclasses
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from lajolla_tpu.scene.parser import parse_scene_to_builder
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.integrators.diffpath import render_diff, render_volpath_diff
from lajolla_tpu.integrators.media import MT_SA


def _load(path, res):
    b = parse_scene_to_builder(path)
    b.camera.width = res
    b.camera.height = res
    return compile_scene(b), b.options


def recover_albedo(scenes):
    scene, opts = _load(f"{scenes}/cbox/cbox.xml", 24)
    opts = dataclasses.replace(opts, max_depth=4)
    tab = np.asarray(scene.tex_tab)
    tid = int(np.nonzero(tab[:, 2] > 3.0 * tab[:, 3] + 1e-3)[0][0])
    kd_true = jnp.asarray(scene.tex_tab[tid, 2:5])
    print(f"[albedo] true red-wall kd = {np.asarray(kd_true)}")

    def render(kd):
        s = dataclasses.replace(scene,
                                tex_tab=scene.tex_tab.at[tid, 2:5].set(kd))
        return render_diff(s, opts, seed=9, spp=4, depth=4)

    target = render(kd_true)

    @jax.jit
    def step(kd, ost):
        loss, g = jax.value_and_grad(
            lambda kd: jnp.mean((render(kd) - target) ** 2))(kd)
        upd, ost = tx.update(g, ost)
        return jnp.clip(kd + upd, 0.0, 1.0), ost, loss

    kd = jnp.full(3, 0.5, jnp.float32)
    tx = optax.adam(0.1)
    ost = tx.init(kd)
    for i in range(40):
        kd, ost, loss = step(kd, ost)
        if i % 10 == 0:
            print(f"[albedo] step {i:3d} loss {float(loss):.3e} "
                  f"kd {np.asarray(kd).round(3)}")
    print(f"[albedo] recovered {np.asarray(kd).round(4)} "
          f"(true {np.asarray(kd_true).round(4)})")


def recover_sigma(scenes):
    scene, opts = _load(f"{scenes}/volpath_test/volpath_test2.xml", 24)

    def render(s):
        med = scene.med_tab.at[:, MT_SA:MT_SA + 6].mul(s)
        return render_volpath_diff(
            dataclasses.replace(scene, med_tab=med), opts, seed=5, spp=16)

    target = render(jnp.float32(1.0))

    @jax.jit
    def step(s, ost):
        loss, g = jax.value_and_grad(
            lambda s: jnp.mean((render(s) - target) ** 2))(s)
        upd, ost = tx.update(g, ost)
        return jnp.clip(s + upd, 0.05, 3.0), ost, loss

    s = jnp.float32(0.4)
    tx = optax.adam(0.05)
    ost = tx.init(s)
    for i in range(80):
        s, ost, loss = step(s, ost)
        if i % 20 == 0:
            print(f"[sigma]  step {i:3d} loss {float(loss):.3e} "
                  f"scale {float(s):.4f}")
    print(f"[sigma]  recovered absorption scale {float(s):.4f} (true 1.0)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scenes"))
    args = ap.parse_args()
    recover_albedo(args.scenes)
    if os.path.isfile(f"{args.scenes}/volpath_test/volpath_test2.xml"):
        recover_sigma(args.scenes)
    else:
        print("[sigma]  skipped: volpath_test not under --scenes")
