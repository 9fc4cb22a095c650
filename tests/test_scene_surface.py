"""Full scene-surface gates vs REFERENCE-rendered goldens (CPU-only).

The golden gates (test_golden.py) cover the six benchmark scenes plus
disney_bsdf; this file gates the rest of the reference scene corpus
against ground truth rendered by the shim-built reference binary itself
(tools/ref_renders.py -> tests/golden_ref/<name>.npz, 32x32 at
512-2048 spp), so a parser / compiler / estimator regression on any
shipped scene class fails the suite instead of only failing a user.

Scene classes gated here and nowhere else:
  - pixel_filter_test: tent + gaussian reconstruction filters in a real
    render (filter warps are unit-tested in test_filters.py only)
  - simple_sphere: sphere-geometry-only scene
  - volpath_test1: vol_path_version 1 single-chunk end-to-end
  - volpath_test6: the final volpath engine on the version-6 scene
  - hetvol_colored: per-channel (colored) grid majorants
  - vol_cbox_teapot: mesh-bounded interior medium via the binned caster

Metric: 8x8-box-downsampled relative RMSE (test_golden.rel_rmse).
Thresholds sit ~1.6x the measured seed-{2,7} max at gate spp
(/root/work/surface_gate_cal.py): pixel_filter 0.032, simple_sphere
0.019, volpath1 0.023, volpath6 0.026, teapot 0.037. hetvol_colored is
heavy-tailed (single seeds 0.16-0.32 at 64 spp; the 512-spp golden's
own noise floors the metric ~0.08), so it gates on the 2-seed average
plus a film-mean ratio (ours converges to 0.0401 vs ref 0.0398 at
128 total spp).
"""
import dataclasses
import os

import numpy as np
import pytest

from test_golden import rel_rmse

REF = '/root/reference/scenes'
GOLD = os.path.join(os.path.dirname(__file__), 'golden_ref')


# golden name -> (scene rel path, gate spp, d8 rel-RMSE threshold)
GATES = [
    ('pixel_filter', 'pixel_filter_test/pixel_filter_test', 16, 0.05),
    ('simple_sphere', 'disney_bsdf_test/simple_sphere', 16, 0.035),
    ('volpath1', 'volpath_test/volpath_test1', 16, 0.04),
    ('volpath6', 'volpath_test/volpath_test6', 16, 0.045),
    ('vol_cbox_teapot', 'volpath_test/vol_cbox_teapot', 32, 0.06),
]


def _render(rel, spp, seed):
    from lajolla_tpu.scene.parser import parse_scene_to_builder
    from lajolla_tpu.scene.compile import compile_scene
    from lajolla_tpu.render import render

    b = parse_scene_to_builder(f'{REF}/{rel}.xml')
    b.camera.width = 32
    b.camera.height = 32
    scene = compile_scene(b)
    opts = dataclasses.replace(b.options, samples_per_pixel=spp)
    return np.asarray(render(scene, opts, seed=seed))


@pytest.mark.parametrize('name,rel,spp,thresh', GATES,
                         ids=[g[0] for g in GATES])
def test_scene_matches_reference(name, rel, spp, thresh):
    ref = np.load(os.path.join(GOLD, f'{name}.npz'))['img']
    img = _render(rel, spp, seed=2)
    assert np.isfinite(img).all()
    err = rel_rmse(img, ref)
    assert err < thresh, (name, float(err))


def test_hetvol_colored_matches_reference():
    ref = np.load(os.path.join(GOLD, 'hetvol_colored.npz'))['img']
    imgs = [_render('volpath_test/hetvol_colored', 64, seed=s)
            for s in (2, 7)]
    avg = np.mean(imgs, axis=0)
    assert np.isfinite(avg).all()
    err = rel_rmse(avg, ref)
    assert err < 0.30, float(err)
    ratio = float(avg.mean()) / float(ref.mean())
    assert abs(ratio - 1.0) < 0.08, ratio
