"""Dense closest-hit caster as a Pallas kernel through Triton.

One program casts a block of BLOCK_R rays against the whole quad-merged
cast table (scene/compile.py cast_tri: at most BVH_MIN_TRIS - 1 prims).
The table is walked in CHUNK-prim steps held in registers, and each
program keeps a running (t, index, u, v) minimum per ray, so only the
rays go in and only the per-ray result comes out. The arithmetic is the
Moller-Trumbore test of ops/intersect.py _cast_setup, in fp32.

The renderer's closest-hit casts take this kernel on the GPU
(ops/intersect.py vmap rule); on the CPU they take the fused XLA caster
of ops/intersect.py. Any-hit casts take the fused XLA caster everywhere:
it rendered faster end to end than a Triton any-hit kernel (PERF.md).
The kernel is tested in interpret mode on the CPU against the scalar
oracle (tests/test_casters.py). The block sizes are the fastest of those
timed on an H100 (PERF.md).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

INF = float('inf')
# rays per program, prims per loop step, warps per program: the fastest
# of (128, 16, 4), (256, 16, 4) and (128, 32, 8) timed on an H100
# (PERF.md, PR 1)
BLOCK_R = 128
CHUNK = 16
NUM_WARPS = 4


def _kernel(*refs, n_chunks, chunk):
    ray_refs, tab_refs, out_refs = refs[:8], refs[8:18], refs[18:]
    ox, oy, oz, dx, dy, dz, tn, tf = (r[...][:, None] for r in ray_refs)
    nr = ox.shape[0]

    def body(c, carry):
        sl = pl.ds(c * chunk, chunk)
        (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z,
         quad) = (r[sl][None, :] for r in tab_refs)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = jnp.abs(det) > 1e-12
        inv_det = jnp.where(ok, 1.0 / det, 0.0)
        tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        lim = jnp.where(quad > 0, 1.0 - jnp.maximum(u, v), 1.0 - u - v)
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (lim >= 0.0) & (t > tn) &
               (t < tf))
        tb, ib, ub, vb = carry
        t = jnp.where(hit, t, INF)
        tmin = jnp.min(t, axis=1)
        j = jnp.argmin(t, axis=1).astype(jnp.int32)
        sel = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == j[:, None]
        uc = jnp.sum(jnp.where(sel, u, 0.0), axis=1)
        vc = jnp.sum(jnp.where(sel, v, 0.0), axis=1)
        better = tmin < tb
        return (jnp.where(better, tmin, tb),
                jnp.where(better, j + c * chunk, ib),
                jnp.where(better, uc, ub), jnp.where(better, vc, vb))

    init = (jnp.full((nr,), INF, jnp.float32), jnp.full((nr,), -1, jnp.int32),
            jnp.zeros((nr,), jnp.float32), jnp.zeros((nr,), jnp.float32))
    for ref, val in zip(out_refs, jax.lax.fori_loop(0, n_chunks, body, init)):
        ref[...] = val


@functools.partial(jax.jit, static_argnames=('block_r', 'interpret'))
def _cast(tab, quad, o, d, tnear, tfar, *, block_r, interpret):
    n = o.shape[0]
    npad = -(-n // block_r) * block_r
    T = tab.shape[1]
    tpad = -(-T // CHUNK) * CHUNK
    # padded rays get an empty (0, 0) window; padded prims have det = 0
    rays = [jnp.pad(x, (0, npad - n)) for x in
            (*o.T, *d.T, jnp.broadcast_to(tnear, (n,)),
             jnp.broadcast_to(tfar, (n,)))]
    rows = [jnp.pad(x, (0, tpad - T)) for x in (*tab, quad)]
    ray_spec = pl.BlockSpec((block_r,), lambda i: (i,))
    tab_spec = pl.BlockSpec((tpad,), lambda i: (0,))
    out_shape = [jax.ShapeDtypeStruct((npad,), dt) for dt in
                 (jnp.float32, jnp.int32, jnp.float32, jnp.float32)]
    outs = pl.pallas_call(
        functools.partial(_kernel, n_chunks=tpad // CHUNK, chunk=CHUNK),
        out_shape=out_shape,
        grid=(npad // block_r,),
        in_specs=[ray_spec] * 8 + [tab_spec] * 10,
        out_specs=[ray_spec] * len(out_shape),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        backend="triton",
        name='cast_closest',
    )(*rays, *rows)
    return [x[:n] for x in outs]


def _intersect(scene, o, d, tnear, tfar, *, block_r, interpret):
    from lajolla_tpu.ops.intersect import resolve_cast_hit
    t, ci, u, v = _cast(scene.cast_tri, scene.cast_quad, o, d,
                        jnp.asarray(tnear, jnp.float32),
                        jnp.asarray(tfar, jnp.float32), block_r=block_r,
                        interpret=interpret)
    return resolve_cast_hit(scene, o, d, t, ci, u, v)


def intersect_brute_triton(scene, o, d, tnear, tfar):
    """Closest hit of N rays, o, d: (N, 3); tnear/tfar: (N,) or scalar.
    Returns (t, prim, u, v), each (N,), prim in TRUE triangle ids."""
    return _intersect(scene, o, d, tnear, tfar, block_r=BLOCK_R,
                      interpret=False)
