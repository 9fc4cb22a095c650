"""Deterministic performance-proxy gates.

Device times come only from the GPU, but the ALGORITHMIC quantities
behind the throughput are exact and CPU-testable, because all RNG is
counter-hashed (no device dependence):

  * wavefront occupancy: lane-steps per path after tail compaction
    (path.QUEUE_STATS from _render_block_drained);
  * volumetric tracking cost: delta-tracking rounds per free flight
    under the supervoxel majorants (volpath._free_flight `rounds`).

Each pin is the measured value at gate time +10% headroom: a change
that silently regresses any of these fails here on the CPU. When a
deliberate optimization IMPROVES a metric, re-pin it (tighten) in the
same commit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lajolla_tpu.scene.parser import parse_scene_to_builder
from lajolla_tpu.scene.compile import compile_scene

from scene_fixtures import CBOX

REF = "/root/reference/scenes"


def _lowres(path, w, h):
    b = parse_scene_to_builder(path)
    b.camera.width = w
    b.camera.height = h
    return compile_scene(b), b.options


@pytest.fixture(scope="module")
def matpreview():
    return _lowres(f"{REF}/matpreview/matpreview.xml", 48, 36)


def test_queue_lane_steps_cbox():
    """cbox 64x64 @4spp through the drained wavefront with the cascade
    drain: 7.906 lane-steps/path measured r4 (8.375 with the r3
    fixed-width drain; true mean path length ~3.5)."""
    import lajolla_tpu.integrators.path as P
    scene, opts = _lowres(CBOX, 64, 64)
    opts = dataclasses.replace(opts, samples_per_pixel=4)
    P._render_block_drained(scene, opts, 0, 0, 4, 64 * 64)
    s = dict(P.QUEUE_STATS)
    assert s["lane_steps_per_path"] <= 7.91 * 1.10, s


def test_queue_lane_steps_veach():
    """veach_mi (depth-2 MIS scene): 2.0 lane-steps/path
    measured r4 at 64x48 @4spp — the queue is already optimal here
    (every lane dies at the depth limit); guards against regressions
    that keep dead lanes resident."""
    import lajolla_tpu.integrators.path as P
    scene, opts = _lowres(f"{REF}/veach_mi/mi.xml", 64, 48)
    opts = dataclasses.replace(opts, samples_per_pixel=4)
    P._render_block_drained(scene, opts, 0, 0, 4, 64 * 48)
    s = dict(P.QUEUE_STATS)
    assert s["lane_steps_per_path"] <= 2.0 * 1.10, s


def test_volpath_queue_lane_steps_vol_cbox():
    """vol_cbox through the volpath wavefront + cascade drain: 8.83
    lane-steps/path measured r4 at 48x48 @2spp (homogeneous medium,
    closed-form free flight — one event per bounce)."""
    import lajolla_tpu.integrators.volpath as V
    scene, opts = _lowres(f"{REF}/volpath_test/vol_cbox.xml", 48, 48)
    opts = dataclasses.replace(opts, samples_per_pixel=2)
    V._render_volpath_block_drained(scene, opts, 0, 0, 2, 48 * 48)
    s = dict(V.QUEUE_STATS)
    assert s["lane_steps_per_path"] <= 8.84 * 1.10, s


def test_queue_lane_steps_matpreview(matpreview):
    """Binned-scene queue occupancy (the matpreview class): 7.96 lane-steps/path measured r4 at 48x36 @1spp
    with the cascade drain (10.0 with the r3 fixed-width drain)."""
    import lajolla_tpu.integrators.path as P
    scene, opts = matpreview
    opts = dataclasses.replace(opts, samples_per_pixel=1)
    P._render_block_drained(scene, opts, 0, 0, 1, 48 * 36)
    s = dict(P.QUEUE_STATS)
    assert s["lane_steps_per_path"] <= 7.97 * 1.10, s


def test_hetvol_null_collision_rounds():
    """Delta-tracking rounds per free flight on hetvol rays inside the
    grid medium, under the supervoxel majorants: measured r4 mean 11.0,
    then 9.62 with the empty-skip channel (compile.py _empty_skip),
    max 31 (global-majorant tracking measured ~20x more in round 2 —
    this pin protects that win). Lockstep cost of the vmapped loop is
    the batch MAX, so both moments are gated."""
    import lajolla_tpu.integrators.path as P
    import lajolla_tpu.integrators.volpath as V
    from lajolla_tpu.ops.intersect import brute_force_triangles
    scene, opts = _lowres(f"{REF}/volpath_test/hetvol.xml", 48, 36)
    n = 48 * 36
    item = jnp.arange(n, dtype=jnp.int32)
    _pix, o, d = P._primary_hash(scene, opts, item, jnp.uint32(0))
    cast = jax.jit(jax.vmap(
        lambda o, d: brute_force_triangles(scene, o, d, 1e-3, jnp.inf)))
    t, prim, _u, _v = cast(o, d)
    shape = scene.tri_shape[jnp.maximum(prim, 0)]
    med = jnp.where(prim >= 0, scene.shape_interior_med[shape], -1)
    o2 = o + d * (t[:, None] + 1e-3)
    t2, prim2, _, _ = cast(o2, d)
    th = jnp.where(prim2 >= 0, t2, jnp.float32(np.inf))
    hs = V._pcg_hash(item.astype(jnp.uint32) ^ jnp.uint32(77))
    inside = np.asarray(med) >= 0
    assert inside.sum() > 1000
    ff = jax.jit(jax.vmap(
        lambda hs, o, d, th, m: V._free_flight(
            scene, opts, hs, o, d, m, th, with_scatter=True)))
    *_rest, sc, _at, rounds = ff(hs[inside], o2[inside], d[inside],
                                 th[inside], med[inside])
    r = np.asarray(rounds)
    assert r.mean() <= 9.62 * 1.10, (r.mean(), r.max())
    assert r.max() <= 31 * 1.3, (r.mean(), r.max())
    assert float(np.asarray(sc).mean()) > 0.05   # sanity: flights scatter
