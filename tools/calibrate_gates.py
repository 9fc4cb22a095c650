"""Measure current-engine rel-RMSE against the reference goldens
(tests/golden_ref) at the gate test spp — the numbers the thresholds in
tests/test_golden.py are calibrated from (~1.5-2x measured).

Run on the GPU:  python tools/calibrate_gates.py [scene ...]
"""

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))   # test_golden's imports

from lajolla_tpu.render import render                         # noqa: E402
from lajolla_tpu.scene.compile import compile_scene           # noqa: E402
from lajolla_tpu.scene.parser import parse_scene_to_builder   # noqa: E402
from tests.test_golden import (GOLD_DIR, GOLD_SCENES,         # noqa: E402
                               load_lowres, rel_rmse)


def main():
    only = set(sys.argv[1:])
    for name in sorted(GOLD_SCENES):
        if only and name not in only:
            continue
        path = os.path.join(GOLD_DIR, f"{name}.npz")
        if not os.path.exists(path):
            print(f"[{name}] no reference golden, skip")
            continue
        g = np.load(path)
        scene_path, test_spp, thresh = GOLD_SCENES[name]
        scene, opts = load_lowres(scene_path, int(g["res"]))
        for seed in (2, 7):
            img = np.asarray(render(scene, dataclasses.replace(
                opts, samples_per_pixel=test_spp), seed=seed))
            err = rel_rmse(img, g["img"])
            print(f"[{name}] seed {seed} @{test_spp}spp: rel-RMSE "
                  f"{err:.4f} (gate {thresh}) mean {img.mean():.4f} "
                  f"vs ref {g['img'].mean():.4f}", flush=True)


if __name__ == "__main__":
    main()
