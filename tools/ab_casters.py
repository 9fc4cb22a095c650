"""End-to-end A/B of the dense closest-hit casters on the GPU: the cbox
render (512x512 at 256 spp, seed 3, through render()) with the Triton
kernel and with the fused XLA caster, run interleaved in one process so
that both see the same card and clocks.

    python tools/ab_casters.py [rounds]

The "xla" variant replaces the Triton entry point that the vmap rule of
ops/intersect.py imports at trace time with the fused XLA caster; the
jit caches are cleared between variants, and each variant renders 16 spp
first so that its compile falls outside the timed window. Rounds run the
variants forward, then backward (A B B A ...). Prints one line per run
and the median of each variant, with the card's name and power limit.
"""
import dataclasses
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SCENE = os.path.join(REPO, "scenes", "cbox", "cbox.xml")
SPP = 256
WARM_SPP = 16
SEED = 3


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    import jax
    from lajolla_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import lajolla_tpu.ops.intersect as I
    import lajolla_tpu.ops.intersect_pallas as K
    from lajolla_tpu.render import render
    from lajolla_tpu.scene.parser import parse_scene

    if jax.devices()[0].platform != "gpu":
        sys.exit("ab_casters: no GPU found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    variants = {"triton": K.intersect_brute_triton,
                "xla": I._brute_force_batched}

    scene, options = parse_scene(SCENE)
    paths = scene.meta.width * scene.meta.height * SPP
    times = {v: [] for v in variants}
    names = list(variants)
    for r in range(rounds):
        for v in (names if r % 2 == 0 else names[::-1]):
            K.intersect_brute_triton = variants[v]
            jax.clear_caches()
            render(scene, dataclasses.replace(options,
                                              samples_per_pixel=WARM_SPP),
                   seed=SEED)
            t0 = time.perf_counter()
            img = render(scene, dataclasses.replace(
                options, samples_per_pixel=SPP), seed=SEED)
            s = time.perf_counter() - t0
            times[v].append(s)
            print(f"round {r} {v}: {s:.4f} s = {paths / s / 1e6:.2f} "
                  f"Mpaths/s, film mean {float(img.mean()):.6f}",
                  flush=True)
    K.intersect_brute_triton = variants["triton"]
    for v, ts in times.items():
        m = statistics.median(ts)
        print(f"{v}: median {m:.4f} s = {paths / m / 1e6:.2f} Mpaths/s "
              f"(runs {', '.join(f'{t:.4f}' for t in ts)}) on {card}")


if __name__ == "__main__":
    main()
