"""Differentiable path tracing (beyond the reference).

The reference is a forward C++ renderer; gradients are out of its
scope. Here the wavefront design pays off: the scalar advance step
(`path._advance_lane`) is a pure JAX function, so a fixed-depth
`lax.scan` over it yields a renderer that reverse-mode differentiates
end-to-end with `jax.grad` — scene parameters (albedos, roughness,
light intensity, textures) get exact detached-estimator gradients with
no extra code per material.

Estimator = the production wavefront estimator with two deviations,
both standard for differentiable rendering:

  1. Fixed bounce budget (`depth` scan steps, no persistent queue):
     reverse-mode AD cannot transpose `lax.while_loop`, and a scan
     keeps the saved-primal memory proportional to depth. Paths still
     die by Russian roulette; survivors at the budget are truncated
     exactly like a `max_depth = depth` forward render.
  2. Detached sampling (`_advance_lane(detach=True)`): geometry,
     sampled directions, sampling pdfs, MIS weights and RR are wrapped
     in stop_gradient; BSDF evaluations and emission stay attached.
     Unbiased for eval-side parameters (see _advance_lane docstring);
     parameters that move visibility discontinuities (vertex
     positions) get the usual interior-term-only gradient.

Primal values are IDENTICAL to a `_render_block_sc` render with the
same seed and `max_depth` (same counter-hash RNG stream keyed on
(seed, item, nv) — gated by tests/test_diffpath.py), so everything the
forward suite validates transfers.

Typical use (recover a material parameter from a target image):

    def loss(kd):
        s = scene.replace(tex_data=pack(kd))
        img = render_diff(s, options, spp=4, depth=4)
        return jnp.mean((img - target) ** 2)
    g = jax.grad(loss)(kd0)

Gradient-robustness notes (hard-won; see also core/math.safe_sqrt and
the _ct_barrier primitive below):
  - every sqrt-at-clip site uses safe_sqrt (exact primal, clamped
    derivative) so masked lanes cannot emit inf partials;
  - finished lanes are parked on a benign unit ray and a per-step
    cotangent barrier zeroes any residual non-finite lane cotangent;
  - reverse mode is exact on diffuse-dominated scenes (gated:
    gradient == finite differences on cbox). On microfacet-heavy
    scenes XLA's optimizer (any --xla_backend_optimization_level >= 1)
    can still leak a masked dead-lane inf partial into the fused
    cotangent reduction (level 0 and the un-jitted transpose are
    finite and agree with forward mode) — use `grad_fwd` for
    few-parameter optimization there, or optax.zero_nans.
"""

from functools import partial

import jax
import jax.numpy as jnp

from lajolla_tpu.integrators.path import (_GOLD, _advance_lane, _hash_u01,
                                          _pcg_hash, _primary_hash)


# --- cotangent-sanitizing barrier -----------------------------------------
#
# Identity in the primal AND in forward mode (jvp passes tangents
# through), but its TRANSPOSE zeroes non-finite cotangents. Parked
# (finished) lanes re-run the advance step each iteration; their zero
# cotangents crossing inf partials produce per-lane NaN cotangents in
# the state chain (0 * inf). Un-jitted these die at the parking
# select's transpose, but under whole-program XLA the fused
# select/accumulate graph lets them leak into the parameter cotangent
# reduction. Sanitizing at each scan-step boundary reproduces the
# un-jitted semantics exactly: a finished lane contributes zero
# gradient, as it contributes zero radiance. Implemented as a first-
# class primitive (not custom_vjp) so forward-mode AD (grad_fwd) still
# works through it.

from jax.extend import core as _jex_core
from jax.interpreters import ad as _ad, batching as _batching, \
    mlir as _mlir

_ctb_p = _jex_core.Primitive('lajolla_ct_sanitize_barrier')


def _ct_barrier(x):
    return _ctb_p.bind(x)


_ctb_p.def_impl(lambda x: x)
_ctb_p.def_abstract_eval(lambda x: x)
_mlir.register_lowering(
    _ctb_p, _mlir.lower_fun(lambda x: x, multiple_results=False))
_ad.defjvp(_ctb_p, lambda t, x: _ctb_p.bind(t))


def _ctb_transpose(ct, x):
    ct = jax.lax.optimization_barrier(ct)
    ct = jnp.where(jnp.isfinite(ct), ct, 0.0)
    return (jax.lax.optimization_barrier(ct),)


_ad.primitive_transposes[_ctb_p] = _ctb_transpose
_batching.defvectorized(_ctb_p)


def _barrier_state(st):
    return tuple(_ct_barrier(x) if x.dtype == jnp.float32 else x
                 for x in st)


@partial(jax.jit, static_argnames=('options', 'spp', 'depth'))
def render_diff(scene, options, seed=0, spp=4, depth=6, s0=0):
    """Differentiable render: (h, w, 3) film MEAN over `spp` samples
    with a fixed `depth`-bounce budget. Differentiable wrt any float
    leaf of `scene` that parameterizes shading or emission. `s0` offsets
    the sample indices (work items s0*n ..) so a mesh of chips can split
    the sample axis while reproducing the exact single-chip RNG streams
    (parallel/mesh.py render_diff_sharded)."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    lanes = n * spp
    su = jnp.uint32(seed)
    kidx = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(_GOLD) +
            jnp.uint32(_GOLD))[None, :]                    # (1, 8)

    item0 = jnp.arange(lanes, dtype=jnp.int32) + \
        jnp.asarray(s0, jnp.int32) * n                     # item % n = pixel
    _pix, org0, d0 = _primary_hash(scene, options, item0, su)
    z = jnp.zeros(lanes, jnp.float32)
    st = (item0, jnp.full(lanes, 2, jnp.int32), org0, d0,
          jnp.full(lanes, 0.25 / max(w, h), jnp.float32), z,
          jnp.ones((lanes, 3), jnp.float32),
          jnp.zeros((lanes, 3), jnp.float32),
          jnp.ones(lanes, jnp.float32), z, org0,
          jnp.zeros(lanes, jnp.bool_))

    def body(carry, _):
        st, Lf = carry
        hb = _pcg_hash(st[0].astype(jnp.uint32) ^
                       _pcg_hash(st[1].astype(jnp.uint32) ^ su))
        uN = _hash_u01(_pcg_hash(hb[:, None] + kidx))      # (lanes, 8)
        nst, died = jax.vmap(
            lambda u, *s: _advance_lane(scene, options, s, u,
                                        detach=True))(uN, *st)
        # latch radiance at death (no regeneration: one path per lane)
        Lf = jnp.where(died[:, None], nst[7], Lf)
        done = nst[11] | died
        # Park finished lanes on a BENIGN unit ray (origin 0, dir +z,
        # T = L = 0) every step. A dead lane that kept marching would
        # step from degenerate state (zero sampled directions, inf miss
        # positions); its values are masked out forward, but any
        # inf/NaN partial those ops produce (e.g. the GGX cos^4
        # division in rough materials at wo = 0) poisons the scan
        # transpose through the zero-cotangent lanes and NaNs the
        # WHOLE film gradient. The benign ray keeps every subsequent
        # advance finite with finite partials; its (T = 0)-weighted
        # contributions are exact zeros.
        db = done[:, None]
        unitz = jnp.zeros((lanes, 3), jnp.float32).at[:, 2].set(1.0)
        nst = (nst[0], nst[1],
               jnp.where(db, 0.0, nst[2]),            # org
               jnp.where(db, unitz, nst[3]),          # dir
               jnp.where(done, 0.0, nst[4]),          # spread
               jnp.where(done, 0.0, nst[5]),          # radius
               jnp.where(db, 0.0, nst[6]),            # T
               jnp.where(db, 0.0, nst[7]),            # L
               jnp.where(done, 1.0, nst[8]),          # eta_scale
               jnp.where(done, 1.0, nst[9]),          # dir_pdf
               jnp.where(db, 0.0, nst[10]),           # prev_pos
               done)
        return (_barrier_state(nst), _ct_barrier(Lf)), None

    (st, Lf), _ = jax.lax.scan(body, (st, jnp.zeros((lanes, 3))),
                               None, length=depth)
    # budget-truncated survivors contribute their accumulated radiance
    Lf = jnp.where(st[11][:, None], Lf, st[7])
    # whole-sample NaN/Inf exclusion (render.cpp:140-143 parity)
    Lf = jnp.where(jnp.all(jnp.isfinite(Lf), axis=-1)[:, None], Lf, 0.0)
    return Lf.reshape(spp, n, 3).sum(0).reshape(h, w, 3) / spp


def grad_fwd(loss_fn, params):
    """FORWARD-mode gradient of a scalar render loss wrt a small
    parameter pytree (one jvp per scalar parameter).

    Exact and overflow-robust where reverse mode can fail: on scenes
    with microfacet materials, XLA's optimizer (any
    --xla_backend_optimization_level >= 1; level 0 and the un-jitted
    transpose are finite and agree with forward mode) rewrites the
    fused transpose so that masked dead-lane inf partials leak NaN
    into the parameter cotangent reduction. Forward mode never forms
    those cotangent products, so it is immune. Cost scales with the
    number of parameters — use for few-parameter recovery (albedos,
    roughness, sigma) and reverse mode (`jax.grad`) for large texture
    tables on diffuse-dominated scenes."""
    import numpy as np

    leaves, treedef = jax.tree_util.tree_flatten(params)
    sizes = [int(np.prod(l.shape)) if hasattr(l, 'shape') else 1
             for l in leaves]
    grads = []
    for i, leaf in enumerate(leaves):
        flat = jnp.ravel(jnp.asarray(leaf, jnp.float32))
        g = jnp.zeros_like(flat)
        for k in range(sizes[i]):
            seed_leaves = [jnp.zeros_like(jnp.asarray(l, jnp.float32))
                           for l in leaves]
            seed_leaves[i] = jnp.reshape(
                jnp.zeros_like(flat).at[k].set(1.0), jnp.shape(leaf))
            tangent = jax.tree_util.tree_unflatten(treedef, seed_leaves)
            _, dv = jax.jvp(loss_fn, (params,), (tangent,))
            g = g.at[k].set(dv)
        grads.append(jnp.reshape(g, jnp.shape(leaf)))
    return jax.tree_util.tree_unflatten(treedef, grads)


@partial(jax.jit, static_argnames=('options', 'spp'))
def render_volpath_diff(scene, options, seed=0, spp=4):
    """Differentiable VOLUMETRIC render for the loop-free single-
    scattering estimators (vol_path_version 1/2): (h, w, 3) film mean,
    differentiable wrt medium (σ_a, σ_s), phase and emission parameters
    of the scene pytree. Version 1 is closed-form (nothing is sampled
    from the differentiated parameters — plain AD is exact); version 2
    runs `volpath2_trace_one(detach=True)` (detached free-flight
    sampling; see its docstring). Mirrors the production
    `_render_volpath_simple_block` RNG exactly (threefry fold_in per
    (pixel, sample)), so primals match the forward driver bit-for-bit
    modulo XLA fusion."""
    from functools import partial as _p

    from lajolla_tpu.integrators.volpath import (volpath1_trace_one,
                                                 volpath2_trace_one)
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    root = jax.random.PRNGKey(seed)
    pix = jnp.arange(n, dtype=jnp.uint32)
    px = (pix % w).astype(jnp.int32)
    py = (pix // w).astype(jnp.int32)
    pixel_keys = jax.vmap(jax.random.fold_in, (None, 0))(root, pix)
    tracer = volpath1_trace_one if options.vol_path_version == 1 \
        else _p(volpath2_trace_one, detach=True)
    trace = jax.vmap(tracer, in_axes=(None, None, 0, 0, 0))

    def body(img, i):
        keys = jax.vmap(jax.random.fold_in, (0, None))(
            pixel_keys, i.astype(jnp.uint32))
        L = trace(scene, options, px, py, keys)
        L = jnp.where(jnp.isfinite(L), L, 0.0)
        return img + L, None

    img, _ = jax.lax.scan(body, jnp.zeros((n, 3), jnp.float32),
                          jnp.arange(spp))
    return (img / spp).reshape(h, w, 3)
