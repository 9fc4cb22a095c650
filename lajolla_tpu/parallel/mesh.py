"""Multi-device rendering: sample-axis data parallelism over a device mesh.

The reference's entire distribution story is a work-stealing thread pool
over 16x16 film tiles (src/parallel.cpp, render.cpp:75-99). The
equivalent here (SURVEY §2.7): ONE SPMD program — `shard_map` over a 1-D
`('samples',)` `jax.sharding.Mesh`, sharding the *sample* axis (each
device renders the full image with a disjoint slice of the per-pixel
sample indices; the counter-hash RNG keys each path on (seed, item,
bounce), so the union of the slices is exactly the single-device
render's work), scene arrays replicated (read-only), film reduced with a
single `psum` (an NCCL all-reduce on GPUs, which reach each other all to
all). Multi-host = the same program over a bigger mesh; no new code path.

Pixel-axis sharding would equally work; sample-axis keeps every device's
control flow identical (no tile shape remainders) and needs zero scene
re-layout.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from lajolla_tpu.scene.types import RenderOptions


def default_mesh(devices=None):
    devices = devices if devices is not None else jax.devices()
    import numpy as np
    return Mesh(np.asarray(devices), ('samples',))


@partial(jax.jit, static_argnames=('options', 'mesh', 'spp_per_chip'))
def _render_sharded_jit(scene, options, seed, mesh, spp_per_chip):
    from lajolla_tpu.integrators.path import _render_block

    def per_chip(scene):
        chip = jax.lax.axis_index('samples')
        s0 = chip.astype(jnp.int32) * spp_per_chip
        img = _render_block(scene, options, seed, s0, spp_per_chip)
        return jax.lax.psum(img, 'samples')

    fn = jax.shard_map(per_chip, mesh=mesh,
                       in_specs=(P(),), out_specs=P(),
                       check_vma=False)
    return fn(scene)


def render_path_sharded(scene, options, seed=0, mesh=None):
    """Distributed path render. spp is split evenly across the mesh
    (rounded up)."""
    mesh = mesh or default_mesh()
    n = mesh.devices.size
    spp_per_chip = -(-options.samples_per_pixel // n)
    total = spp_per_chip * n
    img = _render_sharded_jit(scene, options, seed, mesh, spp_per_chip)
    return img / total


@partial(jax.jit, static_argnames=('options', 'mesh', 'spp_per_chip'))
def _render_volpath_sharded_jit(scene, options, seed, mesh, spp_per_chip):
    from lajolla_tpu.integrators.volpath import _render_volpath_block

    def per_chip(scene):
        chip = jax.lax.axis_index('samples')
        s0 = chip.astype(jnp.int32) * spp_per_chip
        film, _, _ = _render_volpath_block(scene, options, seed, s0,
                                           spp_per_chip)
        return jax.lax.psum(film, 'samples')

    fn = jax.shard_map(per_chip, mesh=mesh,
                       in_specs=(P(),), out_specs=P(),
                       check_vma=False)
    return fn(scene)


def render_volpath_sharded(scene, options, seed=0, mesh=None):
    """Distributed volumetric path render — identical sample-axis DP
    (the volpath engines are lane-pool loops over (pixel, sample) items,
    so sharding the sample index range needs no new machinery)."""
    mesh = mesh or default_mesh()
    n = mesh.devices.size
    spp_per_chip = -(-options.samples_per_pixel // n)
    total = spp_per_chip * n
    film = _render_volpath_sharded_jit(scene, options, seed, mesh,
                                       spp_per_chip)
    h, w = scene.meta.height, scene.meta.width
    return (film / total).reshape(h, w, 3)


@partial(jax.jit, static_argnames=('options', 'mesh', 'spp_per_chip'))
def _render_volpath_simple_sharded_jit(scene, options, seed, mesh,
                                       spp_per_chip):
    from lajolla_tpu.integrators.volpath import _render_volpath_simple_block

    def per_chip(scene):
        chip = jax.lax.axis_index('samples')
        s0 = chip.astype(jnp.int32) * spp_per_chip
        film = _render_volpath_simple_block(scene, options, seed, s0,
                                            spp_per_chip)
        return jax.lax.psum(film, 'samples')

    fn = jax.shard_map(per_chip, mesh=mesh,
                       in_specs=(P(),), out_specs=P(),
                       check_vma=False)
    return fn(scene)


def render_volpath_simple_sharded(scene, options, seed=0, mesh=None):
    """Distributed volpath v1/v2 (the single-bounce pedagogical
    integrators, vol_path_tracing.h:6-147) — same sample-axis DP as the
    final integrator."""
    mesh = mesh or default_mesh()
    n = mesh.devices.size
    spp_per_chip = -(-options.samples_per_pixel // n)
    total = spp_per_chip * n
    film = _render_volpath_simple_sharded_jit(scene, options, seed, mesh,
                                              spp_per_chip)
    h, w = scene.meta.height, scene.meta.width
    return (film / total).reshape(h, w, 3)


@partial(jax.jit, static_argnames=('options', 'mesh', 'rows_per_chip'))
def _render_aux_sharded_jit(scene, options, mesh, rows_per_chip):
    from lajolla_tpu.integrators.aux import _pixel

    w = scene.meta.width

    def per_chip(scene):
        chip = jax.lax.axis_index('samples')
        y0 = chip.astype(jnp.int32) * rows_per_chip
        xs = jnp.arange(w, dtype=jnp.int32)
        ys = jnp.arange(rows_per_chip, dtype=jnp.int32) + y0
        px, py = jnp.meshgrid(xs, ys)                     # (rows_pc, w)
        f = lambda x, y: _pixel(scene, options, x, y, options.integrator)
        return jax.vmap(jax.vmap(f))(px, py)

    fn = jax.shard_map(per_chip, mesh=mesh,
                       in_specs=(P(),), out_specs=P('samples'),
                       check_vma=False)
    return fn(scene)


def render_aux_sharded(scene, options, mesh=None):
    """Distributed aux integrators. Aux renders are deterministic
    (one pixel-center ray each, render.cpp:12-69), so the sample axis
    is empty — shard the pixel ROWS instead; chips past the last row
    compute discarded padding rows."""
    mesh = mesh or default_mesh()
    n = mesh.devices.size
    h = scene.meta.height
    rows_per_chip = -(-h // n)
    img = _render_aux_sharded_jit(scene, options, mesh, rows_per_chip)
    return img[:h]


@partial(jax.jit, static_argnames=('options', 'mesh', 'spp_per_chip',
                                   'depth'))
def _render_diff_sharded_jit(scene, options, seed, mesh, spp_per_chip,
                             depth):
    from lajolla_tpu.integrators.diffpath import render_diff

    def per_chip(scene):
        chip = jax.lax.axis_index('samples')
        img = render_diff(scene, options, seed, spp=spp_per_chip,
                          depth=depth, s0=chip * spp_per_chip)
        return jax.lax.pmean(img, 'samples')

    fn = jax.shard_map(per_chip, mesh=mesh,
                       in_specs=(P(),), out_specs=P(),
                       check_vma=False)
    return fn(scene)


def render_diff_sharded(scene, options, seed=0, mesh=None, depth=6):
    """Distributed DIFFERENTIABLE render (integrators/diffpath.py) —
    sample-axis data parallelism like render_path_sharded, and
    `jax.grad` flows straight through the shard_map + pmean: the film
    gradient wrt replicated scene parameters is all-reduced over the mesh
    by the transpose automatically. Per-chip sample indices reproduce the
    single-chip RNG streams exactly (render_diff's s0), so the sharded
    primal AND gradients match a single-device render at equal total
    spp (tests/test_diffpath.py::test_sharded_gradients_match)."""
    mesh = mesh or default_mesh()
    n = mesh.devices.size
    spp_per_chip = -(-options.samples_per_pixel // n)
    return _render_diff_sharded_jit(scene, options, seed, mesh,
                                    spp_per_chip, depth)


_AUX = ('depth', 'shadingNormal', 'meanCurvature', 'rayDifferential',
        'mipmapLevel')


def render_sharded(scene, options, seed=0, mesh=None):
    """Integrator-dispatching distributed render: the full main.cpp
    integrator surface over a mesh (the reference parallelizes every
    integrator through the same tile pool, render.cpp:71-149)."""
    if options.integrator in _AUX:
        return render_aux_sharded(scene, options, mesh)
    if options.integrator == 'volpath':
        if options.vol_path_version in (1, 2):
            return render_volpath_simple_sharded(scene, options, seed,
                                                 mesh)
        return render_volpath_sharded(scene, options, seed, mesh)
    if options.integrator != 'path':
        raise ValueError(f"unknown integrator: {options.integrator}")
    return render_path_sharded(scene, options, seed, mesh)
