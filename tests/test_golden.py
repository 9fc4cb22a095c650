"""Golden-image gates against the REFERENCE renderer's output.

tests/golden_ref/<name>.npz are rendered by the shim-built reference
binary (tools/ref_renders.py, stage `goldens`) at the gate resolution
with high spp — so these are CORRECTNESS gates against the CPU
reference, not self-referential regression pins: a replicated-but-wrong
quirk fails here.

The metric is 4x4-box-downsampled relative RMSE (averages ~4x of the
Monte-Carlo noise while keeping region-level structure, so it measures
estimator bias, not per-pixel noise). Thresholds are set ~1.5-2x above
the measured error of a validated render at the test spp (the residual
is MC noise of OUR render at test_spp + the reference golden's own
noise); the measured values are recorded in docs/VALIDATION.md.

Plus quick film-mean brightness pins for the three cheapest scenes.
"""

import dataclasses
import os

import numpy as np
import pytest

from lajolla_tpu.render import render
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.scene.parser import parse_scene_to_builder

from scene_fixtures import CBOX

REF = "/root/reference/scenes"
GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden_ref")


def load_lowres(path, res=64):
    b = parse_scene_to_builder(path)
    b.camera.width = res
    b.camera.height = res
    return compile_scene(b), b.options


def test_cbox_brightness():
    scene, opts = load_lowres(CBOX, 64)
    opts = dataclasses.replace(opts, samples_per_pixel=16)
    img = render(scene, opts)
    assert np.isfinite(img).all()
    # reference 64x64 @4096spp film mean: 0.1379 (tests/golden_ref)
    assert img.mean() == pytest.approx(0.138, rel=0.12)
    # red wall on the left, green wall on the right
    left = img[24:40, 2:8]
    right = img[24:40, -8:-2]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()


def test_veach_brightness():
    scene, opts = load_lowres(f"{REF}/veach_mi/mi.xml", 64)
    opts = dataclasses.replace(opts, samples_per_pixel=16)
    img = render(scene, opts)
    assert np.isfinite(img).all()
    # reference 64x64 @4096spp film mean: 0.3390 (tests/golden_ref)
    assert img.mean() == pytest.approx(0.339, rel=0.15)


def test_volpath_cbox_brightness():
    scene, opts = load_lowres(f"{REF}/volpath_test/vol_cbox.xml", 48)
    opts = dataclasses.replace(opts, samples_per_pixel=8)
    img = render(scene, opts)
    assert np.isfinite(img).all()
    # reference 48x48 @2048spp film mean: 0.3439 (tests/golden_ref)
    assert img.mean() == pytest.approx(0.344, rel=0.2)


# ---------------------------------------------------------------------------
# Image gates vs reference renders
# ---------------------------------------------------------------------------

# name -> (scene path, test spp, rel-RMSE threshold, gate seeds)
# Metric (round 4): 8x8-box-downsampled relative RMSE — averaging 4x
# more MC samples per region than the old 4x4 metric halves the noise
# floor for FREE (wall time unchanged), while smooth estimator bias
# (wrong lobe weight, wrong transmittance, the r3 bf16-einsum +4%)
# survives any downsampling. Measured ours-vs-golden d8 error at gate
# spp across seeds {2,7} (r4, /root/work/golden_noise.log): cbox
# 0.023-0.027, disney 0.022-0.024, veach 0.061-0.092, vol_cbox
# 0.060-0.093, matpreview 0.053-0.069, sponza 0.054-0.061, hetvol
# 0.103-0.118 (hetvol gates on the 2-seed average -> noise/sqrt(2)).
# Thresholds sit ~1.6x the measured max — every scene now gates at
# <= 0.15 (the r3 4x4 gates ran 0.24-0.37 on the heavy scenes);
# tests/test_northstar.py carries the tight GPU-side gates.
GOLD_SCENES = {
    "cbox": (CBOX, 64, 0.045, (2,)),
    "veach_mi": (f"{REF}/veach_mi/mi.xml", 64, 0.15, (2,)),
    "vol_cbox": (f"{REF}/volpath_test/vol_cbox.xml", 32, 0.15, (2,)),
    "hetvol": (f"{REF}/volpath_test/hetvol.xml", 32, 0.14, (2, 7)),
    "matpreview": (f"{REF}/matpreview/matpreview.xml", 32, 0.11, (2,)),
    "disney_bsdf": (f"{REF}/disney_bsdf_test/disney_bsdf.xml", 64, 0.05,
                    (2,)),
    "sponza": (f"{REF}/sponza/sponza.xml", 32, 0.10, (2,)),
}


def _downk(img, k=8):
    h, w, c = img.shape
    return img[:h - h % k, :w - w % k].reshape(
        h // k, k, w // k, k, c).mean(axis=(1, 3))


def rel_rmse(a, b, k=8):
    """k x k-downsampled relative RMSE with a luminance floor."""
    a, b = _downk(a, k), _downk(b, k)
    eps = 0.1 * float(b.mean()) + 1e-6
    return float(np.sqrt(np.mean((a - b) ** 2 / (b ** 2 + eps ** 2))))


@pytest.mark.parametrize("name", sorted(GOLD_SCENES))
def test_golden_image_gate(name):
    path = os.path.join(GOLD_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"no reference golden for {name} "
                    "(run tools/ref_renders.py goldens)")
    g = np.load(path)
    scene_path, test_spp, thresh, seeds = GOLD_SCENES[name]
    scene, opts = load_lowres(scene_path, int(g["res"]))
    opts = dataclasses.replace(opts, samples_per_pixel=test_spp)
    imgs = [np.asarray(render(scene, opts, seed=s)) for s in seeds]
    img = np.mean(imgs, axis=0)
    assert np.isfinite(img).all()
    err = rel_rmse(img, g["img"])
    assert err <= thresh, \
        f"{name}: rel-RMSE vs reference {err:.4f} > {thresh:.4f}"
