"""Aux-integrator parity pins against the REFERENCE renderer.

The reference's depth/shadingNormal/meanCurvature/rayDifferential/
mipmapLevel integrators (render.cpp:12-69) are deterministic — pixel
center rays, one intersection — so near-pixel-exact comparison against
the shim-built `tools/ref_baseline/lajolla_ref` output pins the whole
camera → intersection → shading-info geometry chain exactly: fov /
fovAxis conversion, lookat chain, watertight hits, barycentric uv
interpolation, vertex-normal interpolation, dn/du curvature, mipmap
footprint math.

Goldens in tests/golden_ref/aux_*.npz come from tools/ref_renders.py
(stage `aux`), rendered at 64x64 with fp32 PFM output.
"""

import dataclasses
import os

import numpy as np
import pytest

from lajolla_tpu.render import render
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.scene.parser import parse_scene_to_builder

from scene_fixtures import SCENES

REF = "/root/reference/scenes"
GOLD = os.path.join(os.path.dirname(__file__), "golden_ref")

# (scene, xml, integrator, rel tolerance, min fraction of pixels within)
# depth/shadingNormal/mipmapLevel agree to fp32 noise; meanCurvature's
# dn/du chain amplifies fp32 rounding at silhouette pixels (measured
# p99 ~1.8% on matpreview's serialized mesh), hence the looser gate.
CASES = [
    ("cbox", "cbox/cbox.xml", "depth", 2e-3, 0.999),
    ("cbox", "cbox/cbox.xml", "shadingNormal", 2e-3, 0.999),
    ("cbox", "cbox/cbox.xml", "meanCurvature", 2e-2, 0.999),
    ("cbox", "cbox/cbox.xml", "rayDifferential", 2e-3, 0.999),
    ("cbox", "cbox/cbox.xml", "mipmapLevel", 2e-3, 0.999),
    ("matpreview", "matpreview/matpreview.xml", "depth", 2e-3, 0.999),
    ("matpreview", "matpreview/matpreview.xml", "shadingNormal",
     2e-3, 0.999),
    ("matpreview", "matpreview/matpreview.xml", "meanCurvature",
     2e-2, 0.97),
    ("sponza", "sponza/sponza.xml", "depth", 2e-3, 0.999),
    ("sponza", "sponza/sponza.xml", "shadingNormal", 2e-3, 0.999),
    ("sponza", "sponza/sponza.xml", "rayDifferential", 2e-3, 0.999),
    ("sponza", "sponza/sponza.xml", "mipmapLevel", 2e-3, 0.999),
]

_scene_cache = {}


def _load(xml):
    if xml not in _scene_cache:
        root = SCENES if xml.startswith("cbox/") else REF
        b = parse_scene_to_builder(f"{root}/{xml}")
        b.camera.width = b.camera.height = 64
        _scene_cache[xml] = (compile_scene(b), b.options)
    return _scene_cache[xml]


@pytest.mark.parametrize("name,xml,integ,tol,minfrac",
                         CASES, ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_aux_parity(name, xml, integ, tol, minfrac):
    path = os.path.join(GOLD, f"aux_{name}_{integ}.npz")
    if not os.path.exists(path):
        pytest.skip(f"no reference golden (run tools/ref_renders.py aux)")
    ref = np.load(path)["img"]
    scene, opts = _load(xml)
    ours = np.asarray(render(scene,
                             dataclasses.replace(opts, integrator=integ)))
    assert ours.shape == ref.shape
    # relative to the image's own scale: channels like meanCurvature
    # hover near zero, where per-pixel relative error is meaningless
    scale = np.abs(ref).max() + 1e-9
    ad = np.abs(ours - ref) / scale
    frac = float((ad <= tol).mean())
    assert frac >= minfrac, \
        (f"{name}/{integ}: only {frac:.4f} of pixels within {tol} "
         f"(need {minfrac}); max rel err {ad.max():.4g}")
