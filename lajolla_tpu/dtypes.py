"""Global numeric policy.

The reference renderer computes in fp64 throughout (src/lajolla.h:23).
Accelerators compute fp32 far faster than fp64, so the
whole device-side pipeline runs fp32 with numerically-stable primitives
(stable quadratics, offset-from-surface epsilons scaled by scene extent)
and the statistical RMSE gate verifies the result.
"""

import numpy as np
import jax.numpy as jnp

Real = jnp.float32
NpReal = np.float32
Int = jnp.int32

# Matches the reference epsilon policy (src/scene.h:99-105): epsilons are
# proportional to the scene bounding-sphere radius, capped at 0.01.
# fp32 needs a larger relative floor than the reference's fp64 1e-5.
INTERSECT_EPS_SCALE = 1e-4
SHADOW_EPS_SCALE = 1e-4
EPS_CAP = 0.01


def intersection_eps(scene_radius: float) -> float:
    return float(min(INTERSECT_EPS_SCALE * scene_radius, EPS_CAP))


def shadow_eps(scene_radius: float) -> float:
    return float(min(SHADOW_EPS_SCALE * scene_radius, EPS_CAP))
