"""Unidirectional surface path tracer — persistent-wavefront engine.

Faithful re-derivation of the reference integrator (src/path_tracing.h):
NEE with power-heuristic (k=2) MIS against BSDF sampling, solid-angle →
area measure conversion through the geometry term, Mitsuba/pbrt-style
Russian roulette with eta_scale tracking, filter importance sampling.

Accelerator structure ("persistent threads" wavefront):
a fixed pool of lanes processes a queue of (pixel, sample) work items.
Each `lax.while_loop` iteration advances EVERY lane by one path vertex —
one closest-hit cast + one shadow cast, lockstep — and lanes whose path
terminates (miss / depth / RR / invalid sample) scatter their radiance
into the film and immediately regenerate from the next work item. This
keeps occupancy ~100%, so total iterations ≈ spp × E[path length]
instead of spp × max path length (Mitsuba-style RR keeps per-bounce
survival ≈ albedo, so the max over a 262k-lane batch otherwise runs to
the bounce cap every pass).

The MIS for BSDF-samples-hit-light is restructured to a cached-pdf form
(store the bounce's solid-angle pdf + previous vertex position, weight at
the NEXT hit) — the same reformulation the reference's volumetric
integrator uses (vol_path_tracing.h:516-532 nee_p_cache/dir_pdf). The
Russian-roulette division lands on the full continuation throughput
(pbrt-style) rather than reference's emission-exclusive placement; both
are unbiased estimators of the same integral.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lajolla_tpu.core.math import distance_squared, dot, normalize
from lajolla_tpu.dtypes import intersection_eps, shadow_eps
from lajolla_tpu.integrators.lights import (emission_area, emission_envmap,
                                            light_pmf, pdf_point_on_light,
                                            sample_light,
                                            sample_point_on_light, LightPoint)
from lajolla_tpu.materials import eval_bsdf, pdf_bsdf, sample_bsdf
from lajolla_tpu.scene.camera import sample_primary
from lajolla_tpu.scene.geometry import intersect_scene, occluded
from lajolla_tpu.scene.types import LIGHT_ENVMAP

INF = np.float32(np.inf)
MAX_BOUNCES_CAP = 64  # absolute safety cap on path length (RR terminates
                      # far earlier; bias at this cap is ~0.75^59)


def _ray_diff_reflect(spread, radius, mean_curvature, roughness):
    """ray.h:45-51."""
    spec = spread + 2.0 * mean_curvature * radius
    return jnp.maximum(spec * (1.0 - roughness) + 0.2 * roughness, 0.0)


def _ray_diff_refract(spread, radius, mean_curvature, eta, roughness):
    """ray.h:54-66."""
    spec = (spread + 2.0 * mean_curvature * radius) / eta
    return jnp.maximum(spec * (1.0 - roughness) + 0.2 * roughness, 0.0)


def _advance_lane(scene, options, st, u, detach=False):
    """One path-vertex step for a single lane (scalar; vmapped).

    st: (item, nv, org, d, spread, radius, T, L, eta_scale,
         dir_pdf, prev_pos, done); u: the lane's 8 uniforms for this
    vertex (drawn by the driver from the counter-hash stream).
    Returns (new_state_tuple, died) where died marks a path completing
    THIS step (radiance ready to splat).

    detach=True enables the DETACHED-sampling gradient mode used by
    integrators/diffpath.py (reverse-mode AD through the estimator):
    geometry (rays, hit records), sampled directions, sampling pdfs,
    MIS weights and the RR probability are wrapped in stop_gradient,
    while BSDF *evaluations* and emission stay attached. Detaching the
    pdfs in denominators is what makes the gradient estimator unbiased
    for eval-side parameters: E[∂θ f(x;θ)/p_detached(x)] = ∂θ ∫f
    (attaching p would add the spurious -∫ f ∂θ p / p term); detaching
    the sample x itself drops only the reparameterization term that
    moves discontinuities (Mitsuba's 'detached' estimator). No effect
    on the primal values, so detach=False paths are untouched."""
    sg = jax.lax.stop_gradient if detach else (lambda x: x)
    (item, nv, org, d, spread, radius, T, L, eta_scale,
     dir_pdf, prev_pos, done) = st
    org, d, prev_pos = sg(org), sg(d), sg(prev_pos)
    spread, radius = sg(spread), sg(radius)
    dir_pdf = sg(dir_pdf)
    eps_shadow = shadow_eps(scene.meta.scene_radius)
    eps_isect = intersection_eps(scene.meta.scene_radius)
    max_depth = options.max_depth

    hit = intersect_scene(scene, org, d, eps_isect, INF, radius, spread)
    if detach:
        # Detached + SANITIZED: miss records carry t = INF and
        # position = o + INF*d. Forward, every use is masked out; in
        # reverse mode the masked branch's inf/NaN partials multiply the
        # zero cotangent into NaN (0*inf), which the film-gradient
        # reduction then spreads to every parameter. Zeroing non-finite
        # fields is invisible to the primal and keeps the transpose
        # finite.
        hit = jax.tree_util.tree_map(
            lambda x: jnp.where(jnp.isfinite(x), x, 0.0)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
            jax.tree_util.tree_map(sg, hit))
    radius = radius + spread * jnp.where(hit.valid, hit.t, 0.0)
    from_camera = nv == 2

    # ---- emission at this vertex (path_tracing.h:58-61 / :264-302) --------
    hit_light = hit.valid & (hit.light_id >= 0)
    Le = emission_area(scene, hit.light_id, hit.geometry_normal, -d)
    G2 = jnp.abs(dot(d, hit.geometry_normal)) / \
        jnp.maximum(distance_squared(hit.position, prev_pos), 1e-20)
    p2 = dir_pdf * G2
    lp2 = LightPoint(position=hit.position, normal=hit.geometry_normal)
    p1 = sg(light_pmf(scene, hit.light_id) *
            pdf_point_on_light(scene, hit.light_id, lp2, prev_pos))
    if detach:
        # f32 overflow hygiene for AD: pdf*geometry products can exceed
        # 3.4e38 on near-degenerate lanes; forward, w = inf/inf = NaN
        # samples are dropped by the film's isfinite filter, but the
        # NaN poisons every cotangent in the scan transpose. Clamping
        # at 1e18 keeps those (discarded-anyway) values finite and is
        # exact for every non-pathological lane.
        p1, p2 = jnp.minimum(p1, 1e18), jnp.minimum(p2, 1e18)
    w2 = jnp.where(from_camera, 1.0,
                   (p2 * p2) / jnp.maximum(p1 * p1 + p2 * p2, 1e-30))
    L = L + jnp.where(hit_light, T * Le * w2, 0.0)

    if scene.meta.has_envmap:
        Lenv = emission_envmap(scene, d, spread)
        env_id = scene.meta.envmap_light_id
        lpe = LightPoint(position=jnp.zeros(3), normal=-d)
        p1e = sg(light_pmf(scene, env_id) *
                 pdf_point_on_light(scene, jnp.int32(env_id), lpe,
                                    prev_pos))
        p2e = dir_pdf  # solid-angle measure; G = 1 for envmaps
        if detach:
            p1e, p2e = jnp.minimum(p1e, 1e18), jnp.minimum(p2e, 1e18)
        w2e = jnp.where(from_camera, 1.0,
                        (p2e * p2e) / jnp.maximum(p1e * p1e + p2e * p2e,
                                                  1e-30))
        L = L + jnp.where(~hit.valid, T * Lenv * w2e, 0.0)

    # path continues only if we hit a non-light-limit vertex
    depth_stop = jnp.where(max_depth == -1,
                           nv >= 2 + MAX_BOUNCES_CAP,
                           nv > max_depth)
    alive = hit.valid & ~depth_stop

    dir_view = -d
    mat_id = hit.material_id

    # ---- NEE (path_tracing.h:98-207) --------------------------------------
    light_id = sample_light(scene, u[2])
    lp = sample_point_on_light(scene, light_id, hit.position, u[0:2], u[3])
    if detach:
        lp = jax.tree_util.tree_map(sg, lp)
    is_env = (scene.light_type[light_id] == LIGHT_ENVMAP) \
        if scene.meta.has_envmap else jnp.bool_(False)
    dir_light_area = normalize(lp.position - hit.position)
    dir_light = jnp.where(is_env, -lp.normal, dir_light_area)
    if detach:
        # degenerate shadow directions (coincident points -> normalize
        # returns 0) are masked by nee_ok, but evaluating a microfacet
        # BSDF at wo = 0 has inf partials that NaN the transpose even
        # under a zero cotangent; substitute a benign direction
        dl_ok = jnp.sum(dir_light * dir_light) > 0.5
        dir_light = jnp.where(dl_ok, dir_light, hit.frame[2])
    dist2 = distance_squared(lp.position, hit.position)
    tfar = jnp.where(is_env, INF, (1.0 - eps_shadow) * jnp.sqrt(dist2))
    occ = occluded(scene, hit.position, dir_light, eps_shadow, tfar)
    G_area = jnp.maximum(-dot(dir_light, lp.normal), 0.0) / \
        jnp.maximum(dist2, 1e-20)
    G = jnp.where(occ, 0.0, jnp.where(is_env, 1.0, G_area))
    if detach:
        # a substituted (originally degenerate) shadow direction must
        # stay masked: the original G was exactly 0 there
        G = jnp.where(dl_ok, G, 0.0)
    p1n = sg(light_pmf(scene, light_id) *
             pdf_point_on_light(scene, light_id, lp, hit.position))
    nee_ok = alive & (G > 0) & (p1n > 0)
    f_nee = eval_bsdf(scene, mat_id, dir_view, dir_light, hit)
    L_nee = jnp.where(is_env,
                      emission_envmap(scene, dir_light, 0.0),
                      emission_area(scene, light_id, lp.normal, -dir_light))
    p2n = sg(pdf_bsdf(scene, mat_id, dir_view, dir_light, hit)) * G
    if detach:
        p1n, p2n = jnp.minimum(p1n, 1e18), jnp.minimum(p2n, 1e18)
    w1 = (p1n * p1n) / jnp.maximum(p1n * p1n + p2n * p2n, 1e-30)
    # nee_ok-gated denominator: identical where the term is used
    # (nee_ok implies p1n > 0); masked lanes divide by 1 instead of
    # 1e-30 so their (discarded) values stay finite — required for a
    # finite reverse-mode transpose in detach mode
    C1 = G * f_nee * L_nee / jnp.where(nee_ok,
                                       jnp.maximum(p1n, 1e-30), 1.0)
    L = L + jnp.where(nee_ok, T * C1 * w1, 0.0)

    # ---- BSDF sampling + RR (path_tracing.h:210-322) ----------------------
    rec = sample_bsdf(scene, mat_id, dir_view, hit, u[4:6], u[6])
    if detach:
        rec = jax.tree_util.tree_map(sg, rec)
        # invalid samples can return a zero/non-finite dir_out; the lane
        # is masked (alive &= rec.valid) but the eval/pdf at a
        # degenerate wo has inf partials — NaN through the transpose
        do = jnp.where(jnp.isfinite(rec.dir_out), rec.dir_out, 0.0)
        d_ok = jnp.sum(do * do) > 0.5
        rec = rec._replace(dir_out=jnp.where(d_ok, do, hit.frame[2]))
    f2 = eval_bsdf(scene, mat_id, dir_view, rec.dir_out, hit)
    p2s = sg(pdf_bsdf(scene, mat_id, dir_view, rec.dir_out, hit))
    alive = alive & rec.valid & (p2s > 0)

    do_rr = (nv - 1) >= options.rr_depth
    rr_prob = sg(jnp.where(do_rr,
                           jnp.minimum(jnp.max(T / eta_scale), 0.95), 1.0))
    alive = alive & (u[7] <= rr_prob)

    is_refract = rec.eta != 0.0
    new_spread = jnp.where(
        is_refract,
        _ray_diff_refract(spread, radius, hit.mean_curvature,
                          jnp.maximum(rec.eta, 1e-6), rec.roughness),
        _ray_diff_reflect(spread, radius, hit.mean_curvature, rec.roughness))
    new_eta_scale = jnp.where(is_refract,
                              eta_scale / jnp.maximum(rec.eta * rec.eta,
                                                      1e-12),
                              eta_scale)
    # dead lanes carry T = 0 (their state is never read by the film —
    # the queue regenerates them, the drain latched L at death — but a
    # garbage 1/1e-30-scaled T would compound to inf in diffpath's
    # fixed-depth scan and NaN its transpose)
    new_T = jnp.where(alive, T * f2 / jnp.maximum(p2s * rr_prob, 1e-30),
                      0.0)
    if detach:
        # overflow hygiene (see the p1/p2 clamp above): a fireball
        # lane's T must not reach inf — inf*0 NaNs the transpose
        new_T = jnp.minimum(new_T, 1e18)

    died = ~done & ~alive

    nst = (item, nv + 1, hit.position, rec.dir_out, new_spread, radius,
           new_T, L, new_eta_scale, p2s, hit.position, done)
    return nst, died


def _dense_film_add(film, pixel, contrib, n, lanes):
    """film[pixel] += contrib ((N,3), zeros for non-finished lanes).

    The queue stride makes a scatter-add avoidable: work items advance
    by `lanes`, so item ≡ lane (mod lanes). When lanes divides n each
    lane only ever touches pixel lane + k·lanes — K dense masked adds;
    when n divides lanes, pixel = lane mod n — one reshaped dense add.
    Scatter remains only for the irregular case. Dense adds against the
    scatter on the GPU: not measured."""
    if n % lanes == 0:
        K = n // lanes
        k_lane = pixel // lanes                            # (N,)
        kio = jnp.arange(K, dtype=jnp.int32)[:, None]
        mask = (kio == k_lane[None, :]).astype(jnp.float32)
        adds = mask[:, :, None] * contrib[None, :, :]      # (K, N, 3)
        return film + adds.reshape(n, 3)
    if lanes % n == 0:
        return film + contrib.reshape(lanes // n, n, 3).sum(0)
    return film.at[pixel].add(contrib)


# Counter-based hash RNG for the wavefront drivers. Per-lane threefry
# chains are ~10x the ALU work of a hash; instead every uniform derives
# from (seed, work item, bounce, dim) with the pcg_hash mixer (Jarzynski &
# Olano, "Hash Functions for GPU Rendering") — the same role PCG32 plays
# in the reference (pcg.h:21-41): statistically solid white noise, not
# cryptographic. Deterministic and placement-independent, so checkpoint
# resume and multi-chip sharding behave exactly like the threefry path.

def _pcg_hash(v):
    v = v * jnp.uint32(747796405) + jnp.uint32(2891336453)
    w = ((v >> ((v >> jnp.uint32(28)) + jnp.uint32(4))) ^ v) \
        * jnp.uint32(277803737)
    return (w >> jnp.uint32(22)) ^ w


_GOLD = 0x9E3779B9  # 2^32 / golden ratio: decorrelates dimension streams


def _hash_u01(x):
    return (x >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0)


def _primary_hash(scene, options, item, seed_u32, nq=None):
    """Camera ray for work item `item` with hash-derived uniforms
    (vectorized over item; semantics of _primary_ray otherwise).
    `nq` >= n is the padded queue stride (see _render_block): items with
    pixel >= n are dummy lanes whose radiance is discarded."""
    w = scene.meta.width
    n = nq or (w * scene.meta.height)
    pixel = (item % n).astype(jnp.uint32)
    px = (pixel % w).astype(jnp.float32)
    py = (pixel // w).astype(jnp.float32)
    hp = _pcg_hash(item.astype(jnp.uint32) ^
                   _pcg_hash(seed_u32 ^ jnp.uint32(0xCAFEF00D)))
    u_pix = jnp.stack(
        [_hash_u01(_pcg_hash(hp + jnp.uint32(_GOLD))),
         _hash_u01(_pcg_hash(hp + jnp.uint32(2 * _GOLD & 0xFFFFFFFF)))],
        axis=-1)
    org, d = jax.vmap(sample_primary, in_axes=(None, None, 0, 0, 0))(
        scene, options, px, py, u_pix)
    return pixel.astype(jnp.int32), org, d


@partial(jax.jit, static_argnames=('options', 'nspp', 'lanes',
                                   'early_exit'))
def _render_block_sc(scene, options, seed, s0, nspp, lanes=None,
                     early_exit=False):
    """Render nspp samples/pixel (sample indices s0..s0+nspp) of the full
    film via the persistent-wavefront queue. Returns (film_sum (n_q, 3),
    final state, loop iterations — a deterministic occupancy proxy,
    see tests/test_perf_proxies.py). `lanes` < n*nspp shrinks the worker
    pool (shorter
    device launches for heavy scenes) — the queue semantics are
    unchanged.

    early_exit=True stops the loop once live lanes fall to
    lanes // DRAIN_DIV (which can only happen after the work queue is
    exhausted — until then dead lanes regenerate immediately). The
    caller compacts the survivors into a DRAIN_DIV-times smaller pool
    and finishes them with _drain_block: the last ~40%% of iterations
    on a binned scene run at <25%% occupancy but near-full step cost
    (the per-step sort / cull-list glue is shape-bound, not
    occupancy-bound)."""
    w = scene.meta.width
    h = scene.meta.height
    n = w * h
    lanes = lanes or n
    su = jnp.uint32(seed)
    kidx = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(_GOLD) +
            jnp.uint32(_GOLD))[None, :]                    # (1, 8)

    # Padded queue stride: items advance by `lanes`, so keeping
    # n_q ≡ 0 (mod lanes) makes item ≡ lane (mod lanes) — the invariant
    # the dense film add needs. Lanes whose pixel lands in [n, n_q)
    # trace a dummy path whose radiance is discarded (≤ lanes/n waste,
    # ~3% for matpreview; the scatter-add fallback this replaces cost
    # ~50% of a binned-scene step).
    n_q = -(-n // lanes) * lanes
    item0 = jnp.arange(lanes, dtype=jnp.int32) + s0 * n_q
    pixel0, org0, d0 = _primary_hash(scene, options, item0, su, n_q)

    z = jnp.zeros(lanes, jnp.float32)
    state = (
        item0, jnp.full(lanes, 2, jnp.int32), org0, d0,
        jnp.full(lanes, 0.25 / max(w, h), jnp.float32), z,
        jnp.ones((lanes, 3), jnp.float32), jnp.zeros((lanes, 3), jnp.float32),
        jnp.ones(lanes, jnp.float32), z, org0,
        jnp.zeros(lanes, jnp.bool_),
    )
    film0 = jnp.zeros((n_q, 3), jnp.float32)
    end = (s0 + nspp) * n_q

    def cond(carry):
        st, film, _it = carry
        if early_exit:
            # keep going while any lane still has queued work (a lane
            # that dies with next_item < end regenerates, which the
            # drain loop does not do) or while survivors outnumber the
            # drain pool
            has_queue = jnp.any(st[0] + lanes < end)
            return has_queue | (jnp.sum(~st[11]) > (lanes // DRAIN_DIV))
        return ~jnp.all(st[11])

    def body(carry):
        st, film, it = carry
        hb = _pcg_hash(st[0].astype(jnp.uint32) ^
                       _pcg_hash(st[1].astype(jnp.uint32) ^ su))
        uN = _hash_u01(_pcg_hash(hb[:, None] + kidx))     # (N, 8)
        nst, died = jax.vmap(
            lambda u, *s: _advance_lane(scene, options, s, u))(uN, *st)
        (item, nv, org, d, spread, radius, T, L, eta_scale,
         dir_pdf, prev_pos, done) = nst

        # splat finished paths; whole-sample NaN/Inf exclusion like the
        # reference's film accumulation (render.cpp:140-143)
        pixel = (item % n_q).astype(jnp.int32)
        fin = jnp.all(jnp.isfinite(L), axis=-1)
        film = _dense_film_add(film, pixel,
                               jnp.where((died & fin)[:, None], L, 0.0),
                               n_q, lanes)

        # regenerate from the queue
        next_item = item + lanes
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)

        _rp, rorg, rd = _primary_hash(scene, options, next_item, su, n_q)
        sel = lambda a, b: jnp.where(regen, a, b)
        selv = lambda a, b: jnp.where(regen[:, None], a, b)
        state_new = (
            sel(next_item, item),
            sel(jnp.full_like(nv, 2), nv),
            selv(rorg, org),
            selv(rd, d),
            sel(jnp.full_like(spread, 0.25 / max(w, h)), spread),
            sel(jnp.zeros_like(radius), radius),
            selv(jnp.ones_like(T), T),
            selv(jnp.zeros_like(L), L),
            sel(jnp.ones_like(eta_scale), eta_scale),
            sel(jnp.zeros_like(dir_pdf), dir_pdf),
            selv(rorg, prev_pos),
            done,
        )
        return (state_new, film, it + 1)

    (st, film, iters) = jax.lax.while_loop(
        cond, body, (state, film0, jnp.int32(0)))
    return film, st, iters


def _render_block(scene, options, seed, s0, nspp, lanes=None):
    """Full render to an (h, w, 3) film sum through the general wavefront
    queue `_render_block_sc`."""
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    film, _, _ = _render_block_sc(scene, options, seed, s0, nspp, lanes)
    return film[:n].reshape(h, w, 3)


DRAIN_DIV = 4


@partial(jax.jit, static_argnames=('options', 'early_exit'))
def _drain_block(scene, options, seed, st, early_exit=False):
    """Finish the compacted survivors of an early-exited
    _render_block_sc. Drained lanes never regenerate, so each lane's
    radiance lands on one fixed pixel: no per-step film splat — latch L
    at death and return (state, L_final, iterations) for ONE host-side
    scatter. Estimator-identical to the in-loop path: the RNG stream is
    keyed on (seed, item, nv) only, independent of lane position or pool
    width. early_exit=True stops once live lanes fall to width/DRAIN_DIV
    so the host can re-compact (the drain CASCADE: path-length tails are
    long, and a single fixed-width drain runs its last ~100 iterations
    at a few percent occupancy — see _drain_cascade)."""
    su = jnp.uint32(seed)
    kidx = (jnp.arange(8, dtype=jnp.uint32) * jnp.uint32(_GOLD) +
            jnp.uint32(_GOLD))[None, :]
    L_final = jnp.zeros_like(st[7])
    width = st[0].shape[0]

    def cond(carry):
        st, _, _it = carry
        live = jnp.sum(~st[11])
        if early_exit:
            return live > (width // DRAIN_DIV)
        return live > 0

    def body(carry):
        st, Lf, it = carry
        hb = _pcg_hash(st[0].astype(jnp.uint32) ^
                       _pcg_hash(st[1].astype(jnp.uint32) ^ su))
        uN = _hash_u01(_pcg_hash(hb[:, None] + kidx))
        nst, died = jax.vmap(
            lambda u, *s: _advance_lane(scene, options, s, u))(uN, *st)
        fin = jnp.all(jnp.isfinite(nst[7]), axis=-1)
        Lf = jnp.where((died & fin)[:, None], nst[7], Lf)
        nst = nst[:11] + (nst[11] | died,)
        return (nst, Lf, it + 1)

    st, L_final, iters = jax.lax.while_loop(
        cond, body, (st, L_final, jnp.int32(0)))
    return st, L_final, iters


def _compact_state(st, done_idx, width):
    """Gather live lanes of a host-side state tuple into a width-lane
    pool (padding lanes are marked done and never advance)."""
    import numpy as np
    done = np.asarray(st[done_idx])
    alive = np.nonzero(~done)[0]
    idx = np.zeros(width, np.int64)
    idx[:len(alive)] = alive
    stc = [np.asarray(x)[idx] for x in st]
    stc[done_idx] = np.ones(width, bool)
    stc[done_idx][:len(alive)] = False
    return tuple(jnp.asarray(x) for x in stc)


def _drain_cascade(scene, options, seed, st, film, n_q, drain_fn,
                   done_idx, min_width=256):
    """Host loop: repeatedly compact survivors into a pool sized to
    them (next power of two, >= min_width) and drain with early exit,
    re-compacting every time live lanes fall another DRAIN_DIV-fold.
    Path-length tails are heavy (hetvol: a single fixed-width drain
    measured 130 iterations for a 7-iteration main loop), so keeping
    the pool matched to the survivor count makes the tail cost
    geometric instead of max-path-length x fixed width. Splats each
    level's latched radiance into `film` (numpy, in place); returns
    total drain lane-steps for QUEUE_STATS."""
    import numpy as np
    lane_steps = 0
    while True:
        done = np.asarray(st[done_idx])
        alive = int((~done).sum())
        if alive == 0:
            return lane_steps
        # power-of-FOUR width ladder (matches DRAIN_DIV): a pool ladder
        # of lanes/4, lanes/16, ... bounds the number of distinct drain
        # shapes (= device compilations) to ~3 per scene while still
        # shrinking the pool geometrically with the survivor tail
        width = min_width
        while width < alive:   # integer ladder: exact (a float
            width *= 4         # log/ceil overshoot here would make the
                               # early-exit drain a no-op -> host spin)
        stc = _compact_state(st, done_idx, width)
        st, Lf, iters = drain_fn(scene, options, seed, stc,
                                 early_exit=width > min_width)
        lane_steps += int(iters) * width
        pix = np.asarray(st[0]).astype(np.int64) % n_q
        np.add.at(film, pix, np.asarray(Lf))


QUEUE_STATS = {}   # last _render_block_drained occupancy telemetry
                   # (deterministic given (scene, seed): counter-hash
                   # RNG; pinned by tests/test_perf_proxies.py)


def _render_block_drained(scene, options, seed, s0, nspp, lanes):
    """Host driver for one queue block with tail compaction: run the
    wavefront at full width until survivors fit in a DRAIN_DIV-smaller
    pool, then finish them there. Returns the (n_q, 3) film-sum ndarray."""
    import numpy as np
    n = scene.meta.width * scene.meta.height
    n_q = -(-n // lanes) * lanes
    film, st, iters_main = _render_block_sc(scene, options, seed, s0,
                                            nspp, lanes, early_exit=True)
    film = np.array(film)   # writable copy (np.asarray of a jax array
                            # is a read-only view)
    drain_steps = _drain_cascade(scene, options, seed, st, film, n_q,
                                 _drain_block, done_idx=11)
    paths = n_q * nspp
    QUEUE_STATS.update(
        iters_main=int(iters_main), drain_lane_steps=drain_steps,
        lanes=lanes, paths=paths,
        lane_steps_per_path=(int(iters_main) * lanes + drain_steps)
        / paths)
    return film


def render_path(scene, options, seed=0, checkpoint=None, progress=False):
    """Block-accumulating driver. `checkpoint` (optional path) persists
    (film sum, samples done, seed) after every block so an interrupted
    render resumes exactly — possible because RNG is counter-based per
    (pixel, sample) work item (no stream state to save). The reference
    has no checkpointing (SURVEY §5); it falls out of the design here."""
    import numpy as np
    from lajolla_tpu.utils.checkpoint import load_film, save_film
    from lajolla_tpu.utils.progress import ProgressReporter

    spp = options.samples_per_pixel
    # the block programs never read the total spp (each block gets its
    # own nspp): key them without it, so renders that differ only in spp
    # share one compiled block
    options = dataclasses.replace(options, samples_per_pixel=0)
    n = scene.meta.width * scene.meta.height
    if scene.meta.use_binned:
        # heavy intersector → short launches: a small lane pool and
        # 1 spp per launch. Pool widths and block size are not yet
        # measured on the GPU (ROADMAP Design 3 keeps them as A/B items).
        spp_block = 1
        lanes = min(n, 8192 if scene.meta.num_triangles < (1 << 17)
                    else 16384)
    else:
        spp_block, lanes = SPP_BLOCK, n

    img, s0 = None, 0
    if checkpoint:
        img, s0 = load_film(checkpoint, seed,
                            (scene.meta.height, scene.meta.width, 3))
    rep = ProgressReporter(spp, enabled=progress)
    rep.done = s0
    h, w = scene.meta.height, scene.meta.width
    while s0 < spp:
        ns = min(spp_block, spp - s0)
        if scene.meta.use_binned:
            # tail compaction: the drain phase of a binned-scene launch
            # is ~40% of its iterations at <25% occupancy
            block = _render_block_drained(scene, options, seed, s0, ns,
                                          lanes)[:n].reshape(h, w, 3)
        else:
            block = np.asarray(_render_block(scene, options, seed, s0,
                                             ns, lanes))
        img = block if img is None else img + block
        s0 += ns
        rep.update(ns)
        if checkpoint:
            save_film(checkpoint, seed, img, s0)
    rep.finish()
    return img / spp


SPP_BLOCK = 16
