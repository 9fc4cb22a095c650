"""The north-star correctness gate (BASELINE.json): cbox 512x512 @
256 spp, per-pixel RMSE < 1% vs the CPU reference.

The reference image (tests/golden_ref/cbox_full.npz) is the shim-built
reference binary's own render of the exact workload (the cbox scene
patched to 256 spp; rendered by tools/ref_renders.py stage `northstar`;
scenes/cbox is the same visible geometry, pinned by the aux goldens). The metric is RMSE relative to
the reference's RMS magnitude (lajolla_tpu.tools.rel_rmse — the "<1%
RMSE" formulation).

Both images carry MC noise. Measured decomposition (docs/VALIDATION.md):
two independent 256-spp renders of OUR engine differ by 1.90% rel-RMSE
(pure noise; one render's noise is 1.34%), ours-vs-reference measures
1.94%, so estimator bias is ~sqrt(1.94^2 - 1.90^2) ~= 0.4% — film means
agree to 0.01%. The 256-spp gate therefore sits just above its noise
floor at 2.2%; the < 1% bias claim is gated by the 4096-spp comparison
below, whose noise floor (~0.67%) is actually below 1%.

GPU-only (marker `chip`): the full-res renders take seconds on the
card but hours on the CPU test mesh.
"""

import dataclasses
import os

import numpy as np
import pytest

from scene_fixtures import CBOX

from lajolla_tpu.render import render
from lajolla_tpu.scene.compile import compile_scene
from lajolla_tpu.scene.parser import parse_scene_to_builder
from lajolla_tpu.tools import rel_rmse

GOLD = os.path.join(os.path.dirname(__file__), "golden_ref",
                    "cbox_full.npz")


@pytest.mark.chip
def test_cbox_northstar_rmse(gpu):
    g = np.load(GOLD)
    ref = g["img"]
    assert ref.shape == (512, 512, 3)
    b = parse_scene_to_builder(CBOX)
    scene = compile_scene(b)
    opts = dataclasses.replace(b.options, samples_per_pixel=256)
    img = np.asarray(render(scene, opts, seed=3))
    assert np.isfinite(img).all()
    err = rel_rmse(img, ref)
    print(f"cbox 512x512 @256spp rel-RMSE vs reference: {100 * err:.3f}%")
    assert err < 0.022, \
        f"north-star gate: rel-RMSE {100 * err:.3f}% >= 2.2% " \
        "(256-spp noise floor is 1.9%)"


@pytest.mark.chip
def test_cbox_bias_below_1pct(gpu):
    """The < 1% RMSE claim at a spp where the comparison's noise floor
    (~0.67%) is below 1%: ours @4096spp vs reference @4096spp."""
    path = os.path.join(os.path.dirname(__file__), "golden_ref",
                        "cbox_full_hispp.npz")
    if not os.path.exists(path):
        pytest.skip("no 4096-spp reference render "
                    "(tools/ref_renders.py + /tmp/ref_hispp)")
    g = np.load(path)
    ref = g["img"]
    b = parse_scene_to_builder(CBOX)
    scene = compile_scene(b)
    opts = dataclasses.replace(b.options, samples_per_pixel=4096)
    img = np.asarray(render(scene, opts, seed=5))
    err = rel_rmse(img, ref)
    print(f"cbox 512x512 @4096spp rel-RMSE vs reference: "
          f"{100 * err:.3f}%")
    assert err < 0.01, f"bias gate: rel-RMSE {100 * err:.3f}% >= 1%"


@pytest.mark.chip
def test_matpreview_glass_bias(gpu):
    """Near-specular glass-chain bias gate at 64x64, where the error at
    96 spp is ~0.06 noise: a depth-compounding estimator bias of ~2x the
    noise floor fails. This exact comparison once caught DEFAULT-precision
    frame-transform einsums running at reduced precision on an
    accelerator (0.21 here against 0.06 for the CPU render of the same
    program) — device numerics need a device-side gate."""
    path = os.path.join(os.path.dirname(__file__), "golden_ref",
                        "matpreview.npz")
    if not os.path.exists(path):
        pytest.skip("no matpreview reference golden")
    g = np.load(path)
    b = parse_scene_to_builder(
        "/root/reference/scenes/matpreview/matpreview.xml")
    b.camera.width = b.camera.height = int(g["res"])
    scene = compile_scene(b)
    opts = dataclasses.replace(b.options, samples_per_pixel=96)
    img = np.asarray(render(scene, opts, seed=2))
    # 4x4-downsampled metric (test_golden.rel_rmse), which the quoted
    # noise/bias calibration numbers were measured with
    from test_golden import rel_rmse as rel_rmse_d4
    err = rel_rmse_d4(img, g["img"])
    print(f"matpreview 64x64 @96spp rel-RMSE vs reference: {err:.4f}")
    assert err < 0.13, f"glass bias gate: rel-RMSE {err:.4f} >= 0.13"


@pytest.mark.chip
@pytest.mark.parametrize("name,scene_path,spp", [
    ("hetvol", "/root/reference/scenes/volpath_test/hetvol.xml", 512),
    ("sponza", "/root/reference/scenes/sponza/sponza.xml", 512),
])
def test_hispp_bias_gate(name, scene_path, spp, gpu):
    """Self-calibrating bias gates for the two hardest scenes: their low-spp golden gates are noise-calibrated
    (thresholds 0.10-0.14), so a smooth few-percent estimator bias
    would pass them. Here the reference golden is rendered at 4096 spp
    (tools/ref_renders.py stage `hispp`), we render the same square
    crop twice with independent seeds, and require

        rel_rmse(ours, ref) < max(1.5 * rel_rmse(ours_a, ours_b), 0.01)

    i.e. the ours-vs-reference discrepancy must be explained by our own
    noise floor (+50% for the reference's residual noise) or be below
    the 1%-class the north-star metric uses. A depth- or
    tracking-compounding bias >~ the per-render noise fails."""
    path = os.path.join(os.path.dirname(__file__), "golden_ref",
                        f"{name}_hispp.npz")
    if not os.path.exists(path):
        pytest.skip(f"no {name} high-spp golden "
                    "(run tools/ref_renders.py hispp)")
    g = np.load(path)
    ref = g["img"]
    res = int(g["res"])
    b = parse_scene_to_builder(scene_path)
    b.camera.width = b.camera.height = res
    scene = compile_scene(b)
    opts = dataclasses.replace(b.options, samples_per_pixel=spp)
    img_a = np.asarray(render(scene, opts, seed=7))
    img_b = np.asarray(render(scene, opts, seed=8))
    assert np.isfinite(img_a).all() and np.isfinite(img_b).all()
    from test_golden import rel_rmse as rel_rmse_d8
    err_self = rel_rmse_d8(img_a, img_b)
    err_ref = rel_rmse_d8(img_a, ref)
    print(f"{name} {res}x{res} @{spp}spp: ours-vs-ref {err_ref:.4f}, "
          f"ours-vs-ours {err_self:.4f}")
    assert err_ref < max(1.5 * err_self, 0.01), \
        f"bias gate: {err_ref:.4f} vs noise floor {err_self:.4f}"
