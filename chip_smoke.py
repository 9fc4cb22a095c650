"""Bring-up check of the renderer on one NVIDIA GPU.

    python chip_smoke.py          # one card: casters, then the CLI render
    python chip_smoke.py --four   # four cards: the sharded render only

One card:
  1. device line, and the card's name and power limit from nvidia-smi;
  2. dense casters on the cbox tables at the cbox lane count, against
     the scalar Moller-Trumbore oracle: closest hit by the Pallas/Triton
     kernel the renderer casts with on the GPU (timed beside the vmapped
     oracle, the plain version XLA compiles) and by the CPU's fused XLA
     caster (parity only); any hit by the fused XLA caster (timed);
  3. cbox 512x512 at 256 spp through `lajolla_tpu.cli.main`, after a
     16-spp call that compiles the same block shape, checked against the
     reference renderer's image tests/golden_ref/cbox_full.npz.
With --four, only the sample-parallel render over a ('samples',) mesh of
four cards and the single-card render it is compared with.

Every line but the last is a report. The last line is one JSON object
that names the device; it is printed only when every phase passed. The
script exits non-zero when JAX finds no GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "scenes", "cbox", "cbox.xml")
GOLDEN = os.path.join(REPO, "tests", "golden_ref", "cbox_full.npz")
OUT = os.path.join(REPO, "chiprun_out")
SEED = 3            # the seed of tests/test_northstar.py's gate
SPP = 256
WARM_SPP = 16       # == integrators/path.py SPP_BLOCK: same block shape
GATE_RMSE = 0.022   # tests/test_northstar.py: 256-spp noise floor 1.9%
GATE_MEAN = 0.01
GATE_SHARDED = 1e-3
MIN_AGREE = 0.9999
T_REL = 1e-5


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def card():
    """Name and power limit as nvidia-smi reports them (no JAX here)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cast_ms(cast, scene, rays, k=8, reps=5):
    """Milliseconds per cast: k casts of the same batch run in one jitted
    lax.map, so the per-call dispatch of the scene pytree is amortized;
    timed with block_until_ready after a warm-up call."""
    import jax
    import jax.numpy as jnp
    stacked = tuple(jnp.stack([x] * k) for x in rays)
    run = jax.jit(lambda s, *r: jax.lax.map(lambda x: cast(s, *x), r))
    jax.block_until_ready(run(scene, *stacked))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run(scene, *stacked)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / (reps * k) * 1e3


def caster_phase():
    """Caster parity against the scalar oracle, and time per cast."""
    import dataclasses

    import jax
    import numpy as np
    from lajolla_tpu.ops.intersect import (_brute_force_batched,
                                           _brute_force_scalar,
                                           _occluded_batched)
    from lajolla_tpu.ops.intersect_pallas import intersect_brute_triton
    from lajolla_tpu.scene.parser import parse_scene
    from lajolla_tpu.testing import caster_parity_rays, occluder_triangles

    scene, options = parse_scene(SCENE)
    n = scene.meta.width * scene.meta.height
    closest, shadow = caster_parity_rays(scene, options, seed=0)
    oracle = jax.jit(jax.vmap(_brute_force_scalar, (None, 0, 0, 0, 0)))
    t0, p0, _, _ = (np.asarray(x) for x in oracle(scene, *closest))
    ids = occluder_triangles(scene)
    occ_scene = dataclasses.replace(scene, tri_p0=scene.tri_p0[ids],
                                    tri_e1=scene.tri_e1[ids],
                                    tri_e2=scene.tri_e2[ids])
    _, ps, _, _ = oracle(occ_scene, *shadow)
    occ0 = np.asarray(ps) >= 0
    print(f"casters: cbox cast table {scene.cast_tri.shape[1]} prims, "
          f"occluder subset {scene.cast_tri_occ.shape[1]}; "
          f"{2 * n} closest-hit rays (camera + bounce), {n} shadow rays; "
          f"camera hits {float((p0[:n] >= 0).mean()):.4f}, "
          f"occluded {float(occ0.mean()):.4f}")

    cam = tuple(x[:n] for x in closest)
    bounce = tuple(x[n:] for x in closest)
    print(f"  plain (vmapped scalar oracle): closest "
          f"{cast_ms(oracle, scene, cam):.4f} ms/cast (camera) "
          f"{cast_ms(oracle, scene, bounce):.4f} ms/cast (bounce)")
    # the Triton kernel casts closest hits on the GPU; the fused XLA
    # caster is the CPU's, checked here for parity only
    for name, fn in (("triton", intersect_brute_triton),
                     ("xla (CPU path)", _brute_force_batched)):
        t, p, _, _ = (np.asarray(x) for x in jax.jit(fn)(scene, *closest))
        agree = float((p == p0).mean())
        both = (p >= 0) & (p0 >= 0)
        rel = np.abs(t[both] - t0[both]) / np.maximum(np.abs(t0[both]),
                                                      1e-30)
        line = (f"  {name}: prim agree {agree:.6f}, t rel max "
                f"{float(rel.max()):.3e}")
        if fn is intersect_brute_triton:
            line += (f"; closest {cast_ms(fn, scene, cam):.4f} ms/cast "
                     f"(camera) {cast_ms(fn, scene, bounce):.4f} ms/cast "
                     f"(bounce), N={n}")
        print(line)
        check(agree >= MIN_AGREE, f"{name}: prim agreement {agree}")
        check(float(rel.max()) <= T_REL, f"{name}: t rel {rel.max()}")
    occ_agree = float((np.asarray(jax.jit(_occluded_batched)(
        scene, *shadow)) == occ0).mean())
    print(f"  any-hit (fused XLA, every backend): agree {occ_agree:.6f}; "
          f"{cast_ms(_occluded_batched, scene, shadow):.4f} ms/cast, N={n}")
    check(occ_agree >= MIN_AGREE, f"any-hit agreement {occ_agree}")


def render_phase(card_line):
    """cbox 512x512 @ 256 spp through the CLI, checked against the
    reference renderer's image."""
    import jax
    import numpy as np
    from lajolla_tpu.cli import main as cli_main
    from lajolla_tpu.io.image import imread3
    from lajolla_tpu.tools import rel_rmse

    os.makedirs(OUT, exist_ok=True)
    warm_out = os.path.join(OUT, "cbox_warm.pfm")
    out = os.path.join(OUT, "cbox_256spp.pfm")
    t0 = time.perf_counter()
    check(cli_main([SCENE, "--spp", str(WARM_SPP), "--seed", str(SEED),
                    "-o", warm_out]) == 0, "warm-up CLI call failed")
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(cli_main([SCENE, "--spp", str(SPP), "--seed", str(SEED),
                    "-o", out]) == 0, "CLI render failed")
    render_s = time.perf_counter() - t0
    img = imread3(out)
    ref = np.load(GOLDEN)["img"]
    check(img.shape == ref.shape, f"image shape {img.shape}")
    err = rel_rmse(img, ref)
    mean, ref_mean = float(img.mean()), float(ref.mean())
    stats = jax.devices()[0].memory_stats() or {}
    paths = img.shape[0] * img.shape[1] * SPP
    print(f"render: cbox {img.shape[1]}x{img.shape[0]} @ {SPP} spp via "
          f"lajolla_tpu.cli.main, seed {SEED}")
    print(f"  warm-up ({WARM_SPP} spp, compiles the block) {warm_s:.3f} s; "
          f"compile ~{warm_s - render_s * WARM_SPP / SPP:.3f} s")
    print(f"  render {render_s:.3f} s = {paths / render_s / 1e6:.3f} "
          f"Mpaths/s on {card_line}")
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    print(f"  rel-RMSE vs reference {100 * err:.3f}% (gate "
          f"{100 * GATE_RMSE:.1f}%); film mean {mean:.6f} vs reference "
          f"{ref_mean:.6f} ({100 * (mean / ref_mean - 1):+.3f}%)")
    check(bool(np.isfinite(img).all()), "non-finite pixels")
    check(err < GATE_RMSE, f"rel-RMSE {err}")
    check(abs(mean / ref_mean - 1) < GATE_MEAN, f"film mean {mean}")


def four_card_phase(card_line):
    """Sample-parallel render over four cards against one card."""
    import dataclasses

    import jax
    import numpy as np
    from lajolla_tpu.parallel.mesh import default_mesh, render_path_sharded
    from lajolla_tpu.render import render
    from lajolla_tpu.scene.parser import parse_scene
    from lajolla_tpu.tools import rel_rmse

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    scene, options = parse_scene(SCENE)
    mesh = default_mesh()

    def sharded(spp):
        o = dataclasses.replace(options, samples_per_pixel=spp)
        return np.asarray(render_path_sharded(scene, o, seed=SEED,
                                              mesh=mesh))

    def single(spp):
        o = dataclasses.replace(options, samples_per_pixel=spp)
        return render(scene, o, seed=SEED)

    t0 = time.perf_counter()
    sharded(SPP)
    warm_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    img4 = sharded(SPP)
    t_sharded = time.perf_counter() - t0
    t0 = time.perf_counter()
    single(WARM_SPP)
    warm_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    img1 = single(SPP)
    t_single = time.perf_counter() - t0
    ref = np.load(GOLDEN)["img"]
    diff = rel_rmse(img4, img1)
    err = rel_rmse(img4, ref)
    mean, ref_mean = float(img4.mean()), float(ref.mean())
    paths = img4.shape[0] * img4.shape[1] * SPP
    print(f"four cards: cbox {img4.shape[1]}x{img4.shape[0]} @ {SPP} spp "
          f"({SPP // 4} per card) "
          f"over a ('samples',) mesh of {mesh.devices.size}, seed {SEED}")
    print(f"  sharded {t_sharded:.3f} s ({paths / t_sharded / 1e6:.3f} "
          f"Mpaths/s; first call with compile {warm_sharded:.3f} s); "
          f"single card {t_single:.3f} s ({paths / t_single / 1e6:.3f} "
          f"Mpaths/s; {WARM_SPP}-spp warm-up {warm_single:.3f} s); "
          f"cards: {card_line}")
    print(f"  sharded vs single-card rel-RMSE {diff:.3e} (gate "
          f"{GATE_SHARDED:.0e}); vs reference {100 * err:.3f}%; film "
          f"mean {mean:.6f} vs reference {ref_mean:.6f}")
    check(bool(np.isfinite(img4).all()), "non-finite pixels")
    check(diff < GATE_SHARDED, f"sharded vs single rel-RMSE {diff}")
    check(err < GATE_RMSE, f"rel-RMSE {err}")
    check(abs(mean / ref_mean - 1) < GATE_MEAN, f"film mean {mean}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded render")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax
    from lajolla_tpu.utils.cache import enable_compile_cache

    devs = jax.devices()
    dev = devs[0]
    print(f"device: platform {dev.platform}, kind {dev.device_kind}, "
          f"count {len(devs)}")
    if dev.platform != "gpu":
        print("chip_smoke: no GPU found", file=sys.stderr)
        return 2
    enable_compile_cache()
    card_line = card()
    print(f"card: {card_line}")
    try:
        if args.four:
            four_card_phase(card_line)
        else:
            caster_phase()
            render_phase(card_line)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
