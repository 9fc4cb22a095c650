"""Volumetric path tracer (null-scattering / delta tracking with MIS).

Faithful re-derivation of the reference's final volumetric integrator
(vol_path_tracing.h:503-869) and its NEE helper (:299-495), plus the
pedagogical versions 1 and 2 (:6-147); versions 3-5 delegate to the
final integrator exactly like the fork does (:880,:1052,:1297).

Wavefront structure (round 2 — same persistent-queue design as the
surface engine, integrators/path.py): a fixed lane pool processes
(pixel, sample) work items; each outer `lax.while_loop` iteration
advances every lane by ONE path bounce, and lanes whose path terminates
splat and immediately regenerate from the queue, so total iterations ≈
spp × E[path length] instead of spp × MAX_BOUNCES_CAP. The inner
stochastic loops — null collisions and shadow-ray segments — remain
bounded nested `lax.while_loop`s inside the bounce step. All randomness
comes from the (seed, item, bounce, salt, dim) pcg-hash counter stream
(path.py), replacing per-lane threefry chains (~10x the ALU work).

Deliberately replicated fork quirks (for output parity):
  * escaping into vacuum discards ALL accumulated radiance
    (vol_path_tracing.h:634-641 returns zero);
  * the surface-bounce branch does not refresh dir_pdf /
    multi_trans_pdf for the next emissive-hit MIS (:785-848).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lajolla_tpu.core.math import (distance, distance_squared, dot,
                                   normalize)
from lajolla_tpu.dtypes import intersection_eps, shadow_eps
from lajolla_tpu.integrators.lights import (LightPoint, emission_area,
                                            light_pmf, pdf_point_on_light,
                                            sample_light,
                                            sample_point_on_light)
from lajolla_tpu.integrators.media import (get_majorant, get_sigma_a,
                                           get_sigma_s, phase_eval,
                                           phase_pdf, phase_sample,
                                           update_medium)
from lajolla_tpu.integrators.path import (_GOLD, _dense_film_add,
                                          _hash_u01, _pcg_hash,
                                          _primary_hash,
                                          _ray_diff_reflect,
                                          _ray_diff_refract)
from lajolla_tpu.materials import eval_bsdf, pdf_bsdf, sample_bsdf
from lajolla_tpu.scene.camera import sample_primary
from lajolla_tpu.scene.geometry import intersect_scene

INF = np.float32(np.inf)
MAX_BOUNCES_CAP = 64
MAX_SHADOW_SEGMENTS = 16  # index-matching interfaces along one shadow ray

# Draw-site salts for the counter-hash stream: each random-consuming site
# inside one (item, bounce) cell gets its own sub-stream.
_S_FF = 0x111AA111       # main free-flight
_S_NEE = 0x222BB222      # NEE light pick + point sample
_S_NEE_SEG = 0x333CC333  # per-shadow-segment free flight
_S_PHASE = 0x444DD444
_S_BSDF = 0x555EE555
_S_RR = 0x666FF666


def _avg(s):
    return jnp.mean(s)


def _u(hs, dim):
    """dim-th U[0,1) of the sub-stream rooted at uint32 hs."""
    return _hash_u01(_pcg_hash(hs + jnp.uint32(dim * _GOLD & 0xFFFFFFFF)))


def _uit(hs, it, k):
    """k-th uniform of (traced) inner-loop iteration it."""
    hsi = _pcg_hash(hs ^ _pcg_hash(it.astype(jnp.uint32) +
                                   jnp.uint32(0x9E377969)))
    return _u(hsi, k + 1)


def _uniforms(key, n):
    key, sub = jax.random.split(key)
    return key, jax.random.uniform(sub, (n,))


def _sigmas(scene, row, p):
    """sigma_s and sigma_a from ONE density + ONE albedo lookup (the
    separate get_sigma_s/get_sigma_a calls would do the grid trilinear
    twice each — this is the inner-loop hot spot for grid media). `row`
    is the prefetched wide medium row (media.med_row) so the inner loop
    does no medium-table gathers at all."""
    from lajolla_tpu.integrators.media import (MT_ALOOK, MT_DLOOK, MT_SA,
                                               MT_SS, MT_TYPE,
                                               lookup_volume_vrow)
    from lajolla_tpu.scene.types import MED_HETEROGENEOUS, MED_HOMOGENEOUS
    hom_s = row[MT_SS:MT_SS + 3]
    hom_a = row[MT_SA:MT_SA + 3]
    if MED_HETEROGENEOUS not in scene.meta.med_types_present:
        return hom_s, hom_a
    density = lookup_volume_vrow(scene, row[MT_DLOOK:MT_DLOOK + 14], p)
    albedo = lookup_volume_vrow(scene, row[MT_ALOOK:MT_ALOOK + 14], p)
    het_s = density * albedo
    het_a = density * (1.0 - albedo)
    is_hom = row[MT_TYPE] == MED_HOMOGENEOUS
    return (jnp.where(is_hom, hom_s, het_s),
            jnp.where(is_hom, hom_a, het_a))


# ---------------------------------------------------------------------------
# Free-flight (null-scattering) sampling through a medium segment
# (vol_path_tracing.h:554-629 main form; :355-410 NEE form)
# ---------------------------------------------------------------------------

def _majorant_segment(scene, row, org, d, t_cur, t_hit):
    """Piecewise-constant majorant along the ray: the (3,) majorant that
    bounds sigma_t over [t_cur, t_end), a (3,) CONTROL sigma_c <= sigma_t
    over the same span, and t_end itself. `row` is the prefetched wide
    medium row (media.med_row).

    The control enables residual ratio tracking (Novak et al. 2014):
    exp(-sigma_c * dt) is exact per segment, so tracking only has to
    estimate the residual exp(-int(sigma_t - sigma_c)) under the
    residual majorant (majorant - control) — fewer tentative collisions
    wherever the density is locally smooth or dense. Homogeneous media
    get control == majorant == sigma_t (zero residual: transmittance is
    closed-form in one segment). The reference has no analogue — it
    delta-tracks under one global majorant with zero control
    (media/heterogeneous.inl:3-11, vol_path_tracing.h:384-404).

    Heterogeneous grid media: a DDA step over the compile-time
    supervoxel majorant/minorant grid (scene.svox_*, scene/compile.py
    _super_majorants) — outside the grid bbox majorant and control are 0
    (density lookups are 0 there, volume.h:45-52), inside they are the
    current supervoxel's bounds and t_end its exit distance."""
    from lajolla_tpu.integrators.media import (MT_DLOOK, MT_SA, MT_SOFF,
                                               MT_SRES, MT_SS, MT_TYPE,
                                               VL_PMIN, VL_PMAX)
    from lajolla_tpu.scene.types import MED_HETEROGENEOUS
    hom = row[MT_SA:MT_SA + 3] + row[MT_SS:MT_SS + 3]
    if MED_HETEROGENEOUS not in scene.meta.med_types_present:
        return hom, hom, t_hit

    pmin = row[MT_DLOOK + VL_PMIN:MT_DLOOK + VL_PMIN + 3]
    pmax = row[MT_DLOOK + VL_PMAX:MT_DLOOK + VL_PMAX + 3]
    sres = row[MT_SRES:MT_SRES + 3].astype(jnp.int32)      # (3,) i32
    sresf = row[MT_SRES:MT_SRES + 3]
    safe_d = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    tn = (pmin - org) / safe_d
    tf = (pmax - org) / safe_d
    t0 = jnp.maximum(jnp.max(jnp.minimum(tn, tf)), 0.0)
    t1 = jnp.min(jnp.maximum(tn, tf))

    # current supervoxel (nudged off the entry boundary)
    span = jnp.maximum(t1 - t0, 1e-20)
    tq = t_cur + 1e-5 * span
    pn = (org + d * tq - pmin) / jnp.maximum(pmax - pmin, 1e-20)
    cell = jnp.clip((pn * sresf).astype(jnp.int32), 0, sres - 1)
    clo = pmin + cell.astype(jnp.float32) / sresf * (pmax - pmin)
    chi = pmin + (cell + 1).astype(jnp.float32) / sresf * (pmax - pmin)
    gx, gy = sres[0], sres[1]
    idx = row[MT_SOFF].astype(jnp.int32) + \
        (cell[2] * gy + cell[1]) * gx + cell[0]
    # (8,): majorant rgb | empty-skip | control rgb | pad. This gather
    # runs once per tracking iteration per lane — the event machine's
    # hottest lookup.
    from lajolla_tpu.scene.soa import fetch_row
    rowd = fetch_row(scene.svox_data, idx)
    maj_cell = rowd[:3]
    ctrl_cell = rowd[4:7]
    # empty-space skip (compile.py _empty_skip): a zero-majorant cell
    # with skip = s has no occupied supervoxel within L-inf distance
    # s-1, so the zero segment extends to the exit of the cell box
    # expanded by s-1 cells — one DDA step per empty RUN, not per cell.
    # Free: the skip rides the same wide-row gather as the majorant.
    ex = jnp.maximum(rowd[3] - 1.0, 0.0) / sresf * (pmax - pmin)
    tcn = (clo - ex - org) / safe_d
    tcf = (chi + ex - org) / safe_d
    t_exit = jnp.min(jnp.maximum(tcn, tcf))

    before = t_cur < t0
    after = t_cur >= t1
    outside = before | after | (t0 > t1)
    maj_het = jnp.where(outside, jnp.zeros(3), maj_cell)
    ctrl_het = jnp.where(outside, jnp.zeros(3), ctrl_cell)
    # inside the box: guarantee forward progress for boundary-sitting
    # lanes (tq's nudge stays within the supervoxel build's one-node
    # conservative margin, scene/compile.py _super_majorants)
    t_end_het = jnp.where(before & (t0 <= t1), t0,
                          jnp.where(after | (t0 > t1), INF,
                                    jnp.maximum(t_exit, tq)))

    is_het = row[MT_TYPE] == MED_HETEROGENEOUS
    maj = jnp.where(is_het, maj_het, hom)
    ctrl = jnp.where(is_het, ctrl_het, hom)
    t_end = jnp.where(is_het, jnp.minimum(t_end_het, t_hit), t_hit)
    return maj, ctrl, t_end


def _free_flight(scene, options, hs, org, d, med_id, t_hit,
                 with_scatter, row=None):
    """Delta-tracking along [0, t_hit). hs: uint32 sub-stream root.
    `row`: prefetched wide medium row (media.med_row) — passed by the
    hot callers so the loop body does no medium-table gathers.
    Returns (transmittance, trans_dir_pdf, trans_nee_pdf, scatter,
    accum_t, rounds). with_scatter=False gives the ratio-tracking NEE
    variant (no real/null decision; transmittance picks up sigma_n).
    `rounds` is the number of tracking iterations taken — a
    deterministic perf proxy pinned by tests/test_perf_proxies.py
    (lockstep cost of the vmapped loop = batch max of rounds).

    The loop walks piecewise-constant majorant segments
    (_majorant_segment): one iteration either processes a tentative
    collision inside the current segment (real/null decision against the
    LOCAL majorant — unbiased for any local bound >= sigma_t) or skips
    deterministically to the segment end, multiplying all three products
    by exp(-majorant * dt) exactly like the reference's
    reached-the-surface branch (vol_path_tracing.h:607-612)."""
    from lajolla_tpu.integrators.media import med_row
    if row is None:
        row = med_row(scene, med_id)
    majorant0 = get_majorant(scene, med_id, org, d, t_hit, row=row)
    channel = jnp.clip((_u(hs, 0) * 3).astype(jnp.int32), 0, 2)
    maj0_ch = majorant0[channel]

    def cond(st):
        (accum_t, it, trans, tdp, tnp, scatter, done) = st
        return ~done & (maj0_ch > 0) & (it < options.max_null_collisions)

    def body(st):
        (accum_t, it, trans, tdp, tnp, scatter, done) = st
        majorant, control, t_end = _majorant_segment(scene, row, org, d,
                                                     accum_t, t_hit)
        # residual ratio tracking: the NEE process samples tentative
        # collisions at the RESIDUAL rate (majorant - control); the
        # analytic control factor exp(-control * advance) folds into
        # trans/tdp exactly because att keeps the FULL majorant rate
        # (exp(-m*t) == exp(-c*t) * exp(-(m-c)*t)), while tnp — the NEE
        # process's own density — switches to the residual rate. The
        # distance-sampling (with_scatter) process itself is unchanged.
        # meta.svox_ctrl == False means every control is 0 — the plain
        # tracking loop compiles with no extra exps (resid == majorant).
        use_res = scene.meta.svox_ctrl
        resid = jnp.maximum(majorant - control, 0.0) if use_res \
            else majorant
        maj_ch = majorant[channel]
        rate_ch = maj_ch if with_scatter else resid[channel]
        max_maj = jnp.maximum(jnp.max(majorant), 1e-20)
        max_den = max_maj if with_scatter else \
            jnp.maximum(jnp.max(resid), 1e-20)
        u = jnp.stack([_uit(hs, it, 0), _uit(hs, it, 1)])
        t = jnp.where(rate_ch > 0,
                      -jnp.log(jnp.maximum(1.0 - u[0], 1e-20)) /
                      jnp.maximum(rate_ch, 1e-20), INF)
        dt = t_end - accum_t
        t_next = jnp.minimum(accum_t + t, t_end)
        in_flight = t < dt
        hit_end = ~in_flight & (t_end >= t_hit)

        p = org + d * t_next
        sigma_s, sigma_a = _sigmas(scene, row, p)
        sigma_t = sigma_s + sigma_a
        sigma_n = majorant * (1.0 - sigma_t / jnp.maximum(majorant, 1e-20))
        real_prob = sigma_t / jnp.maximum(majorant, 1e-20)
        # clamp inf distances (majorant-0 segments / unbounded media):
        # 0 * inf would be NaN where exp(-0 * dt) must be 1
        att = jnp.exp(-majorant * jnp.minimum(t, 1e30))
        att_dt = jnp.exp(-majorant * jnp.minimum(dt, 1e30))
        att_r = jnp.exp(-resid * jnp.minimum(t, 1e30)) if use_res else att
        att_r_dt = jnp.exp(-resid * jnp.minimum(dt, 1e30)) if use_res \
            else att_dt

        if with_scatter:
            is_real = u[1] < real_prob[channel]
            trans_n = jnp.where(
                in_flight,
                jnp.where(is_real, trans * att / max_maj,
                          trans * att * sigma_n / max_maj),
                trans * att_dt)
            tdp_n = jnp.where(
                in_flight,
                jnp.where(is_real,
                          tdp * att * majorant * real_prob / max_maj,
                          tdp * att * majorant * (1.0 - real_prob) /
                          max_maj),
                tdp * att_dt)
            # tnp evaluates the residual NEE process's density at this
            # chain's vertices (per-chain normalization shared with
            # trans/tdp so it cancels in the MIS ratios)
            tnp_n = jnp.where(
                in_flight,
                jnp.where(is_real, tnp,
                          tnp * att_r * resid / max_maj),
                tnp * att_r_dt)
            scatter_n = scatter | (in_flight & is_real)
            done_n = done | hit_end | (in_flight & is_real)
        else:
            # NEE residual ratio tracking (reference form: :384-404 with
            # control 0): per vertex trans picks up exactly
            # exp(-c*t) * exp(-resid*t) * sigma_n == att * sigma_n, and
            # the escape factor exp(-c*dt) * exp(-resid*dt) == att_dt —
            # identical expressions to plain ratio tracking, at the
            # residual vertex rate and normalization
            trans_n = jnp.where(in_flight,
                                trans * att * sigma_n / max_den,
                                trans * att_dt)
            tnp_n = jnp.where(in_flight,
                              tnp * att_r * resid / max_den,
                              tnp * att_r_dt)
            tdp_n = jnp.where(in_flight,
                              tdp * att * majorant * (1.0 - real_prob) /
                              max_den,
                              tdp * att_dt)
            scatter_n = scatter
            done_n = done | hit_end | (jnp.max(trans_n) <= 0)

        return (t_next, it + 1, trans_n, tdp_n, tnp_n, scatter_n,
                done_n)

    ones = jnp.ones(3)
    init = (jnp.float32(0.0), jnp.int32(0), ones, ones, ones,
            jnp.bool_(False), jnp.bool_(False))
    from lajolla_tpu.scene.types import MED_HETEROGENEOUS
    if MED_HETEROGENEOUS not in scene.meta.med_types_present:
        # homogeneous media: majorant == sigma_t, so real_prob == 1 and
        # the very first iteration terminates (real collision or reached
        # t_hit; the NEE variant dies on sigma_n == 0 or reaches t_hit)
        # — ONE unrolled body call, no lockstep while_loop at all
        init = jax.lax.cond(maj0_ch > 0, body, lambda st: st, init)
        (accum_t, _it, trans, tdp, tnp, scatter, _done) = init
        return trans, tdp, tnp, scatter, accum_t, _it
    (accum_t, _it, trans, tdp, tnp, scatter, _done) = \
        jax.lax.while_loop(cond, body, init)
    return trans, tdp, tnp, scatter, accum_t, _it


# ---------------------------------------------------------------------------
# The phase machine (round 2).
#
# The reference integrator (vol_path_tracing.h:503-869) is three nested
# stochastic loops: bounces x null-collisions x shadow-ray segments
# (each segment with its own null-collision loop). vmapped
# `lax.while_loop`s run those loops in LOCKSTEP: every nesting level
# costs the batch MAX of its iteration count (measured on hetvol: the
# free-flight loop has mean 2 iterations but max ~91 -> ~45x wasted
# work; the shadow chain adds another x16). The vector-machine shape is ONE
# flat loop over *events*: each outer iteration advances every lane by
# one bounded event — a main-ray cast, K null-collision steps, a vertex,
# a shadow-segment cast, or K shadow null-collision steps — so total
# iterations track the MEAN number of events per path, not the product
# of per-loop maxima. Physics, MIS caches and RNG streams are identical
# to the nested form (same per-(item,bounce) counter-hash cells).
# ---------------------------------------------------------------------------

PH_CAST = 0    # cast main ray, init free flight, step it
PH_FF = 1      # continue main free flight
PH_SHC = 3     # cast next shadow segment, init+step its free flight
PH_SHF = 4     # continue shadow-segment free flight
K_FF = 8       # free-flight steps per outer iteration (p90 of hetvol)


def _ff_steps(scene, options, row, hs, org, d, t_hit, wsc, go, fst):
    """K_FF bounded delta/ratio-tracking steps (the body of _free_flight
    with per-lane `wsc` = with_scatter and carried state). fst =
    (ff_t, it, trans, tdp, tnp, scatter, done)."""
    channel = jnp.clip((_u(hs, 0) * 3).astype(jnp.int32), 0, 2)

    def step(_, st):
        (accum_t, it, trans, tdp, tnp, scatter, dn) = st
        live = go & ~dn & (it < options.max_null_collisions)
        majorant, control, t_end = _majorant_segment(scene, row, org, d,
                                                     accum_t, t_hit)
        # residual ratio tracking (see _free_flight.body): NEE lanes
        # (~wsc) sample at the residual rate with the control folded in
        # analytically; tnp evaluates the residual NEE density on both
        # lane kinds. Per-lane chain normalization: max_maj for scatter
        # chains, max residual for NEE chains. meta.svox_ctrl == False
        # compiles the plain zero-control loop (resid == majorant).
        use_res = scene.meta.svox_ctrl
        resid = jnp.maximum(majorant - control, 0.0) if use_res \
            else majorant
        maj_ch = majorant[channel]
        rate_ch = jnp.where(wsc, maj_ch, resid[channel])
        max_maj = jnp.maximum(jnp.max(majorant), 1e-20)
        max_den = jnp.where(wsc, max_maj,
                            jnp.maximum(jnp.max(resid), 1e-20))
        u = jnp.stack([_uit(hs, it, 0), _uit(hs, it, 1)])
        t = jnp.where(rate_ch > 0,
                      -jnp.log(jnp.maximum(1.0 - u[0], 1e-20)) /
                      jnp.maximum(rate_ch, 1e-20), INF)
        dt = t_end - accum_t
        t_next = jnp.minimum(accum_t + t, t_end)
        in_flight = t < dt
        hit_end = ~in_flight & (t_end >= t_hit)

        p = org + d * t_next
        sigma_s, sigma_a = _sigmas(scene, row, p)
        sigma_t = sigma_s + sigma_a
        sigma_n = majorant * (1.0 - sigma_t / jnp.maximum(majorant, 1e-20))
        real_prob = sigma_t / jnp.maximum(majorant, 1e-20)
        att = jnp.exp(-majorant * jnp.minimum(t, 1e30))
        att_dt = jnp.exp(-majorant * jnp.minimum(dt, 1e30))
        att_r = jnp.exp(-resid * jnp.minimum(t, 1e30)) if use_res else att
        att_r_dt = jnp.exp(-resid * jnp.minimum(dt, 1e30)) if use_res \
            else att_dt

        is_real = wsc & (u[1] < real_prob[channel])
        trans_n = jnp.where(
            in_flight,
            jnp.where(is_real, trans * att / max_den,
                      trans * att * sigma_n / max_den),
            trans * att_dt)
        tdp_n = jnp.where(
            in_flight,
            jnp.where(is_real,
                      tdp * att * majorant * real_prob / max_den,
                      tdp * att * majorant * (1.0 - real_prob) / max_den),
            tdp * att_dt)
        tnp_n = jnp.where(
            in_flight,
            jnp.where(is_real, tnp, tnp * att_r * resid / max_den),
            tnp * att_r_dt)
        scatter_n = scatter | (in_flight & is_real)
        dn_n = dn | hit_end | (in_flight & is_real) | \
            (~wsc & (jnp.max(trans_n) <= 0)) | \
            (it + 1 >= options.max_null_collisions)

        sel = lambda a, b: jnp.where(live, a, b)
        sel3 = sel
        return (sel(t_next, accum_t), sel(it + 1, it),
                sel3(trans_n, trans), sel3(tdp_n, tdp), sel3(tnp_n, tnp),
                sel(scatter_n, scatter), sel(dn_n, dn))

    return jax.lax.fori_loop(0, K_FF, step, fst)


# ---------------------------------------------------------------------------
# The final integrator as a flat event machine
# (vol_path_tracing.h:503-869 main loop; :299-495 NEE)
# ---------------------------------------------------------------------------

def _advance_event(scene, options, st, su):
    """Advance one lane by one greedy event step. Each outer iteration
    performs AT MOST one scene cast per lane — the main ray for lanes
    starting a bounce, or the next shadow segment for lanes walking an
    NEE chain — then K bounded free-flight steps, and, for lanes whose
    main free flight finished THIS iteration, the full vertex
    (emission MIS, NEE setup, continuation sampling, RR) immediately: a
    bounce is 2 iterations in the common case (main cast+ff+vertex;
    shadow cast+walk+completion). Returns (new_state, died).

    The vertex step is a verbatim port of the reference bounce body
    (vol_path_tracing.h:503-869); NEE (:299-495) is split into a
    vertex-time factor (f*Le*jac + base pdfs, cached in cb/pdfb/pdfd/
    tsc) and the shadow-walk products (sh_T/sh_pn/sh_pd), combined at
    chain completion — algebraically identical to the nested form."""
    (item, org, d, medium, T, L, bounces, dir_pdf, nee_p, mtp,
     eta_scale, spread, radius, ph,
     mc_t, mc_prim, mc_u, mc_v, mc_sph,
     ff_hs, ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn,
     sh_p, sh_dir, sh_med, sh_seg, sh_T, sh_pn, sh_pd, lp_pos,
     nb_hs, cb, pdfb, pdfd, tsc,
     sg_t, sg_valid, sg_opaque, sg_dblock, sg_mednext,
     v_alive, done) = st
    from lajolla_tpu.integrators.media import med_row
    from lajolla_tpu.scene.geometry import cast_scene, hit_from_cast
    eps_i = intersection_eps(scene.meta.scene_radius)
    eps_s = shadow_eps(scene.meta.scene_radius)
    max_depth = options.max_depth
    ones = jnp.ones(3)
    zeros = jnp.zeros(3)
    alive_l = ~done

    in_cast = alive_l & (ph == PH_CAST)
    in_ff = alive_l & (ph == PH_FF)
    in_shc = alive_l & (ph == PH_SHC)
    in_shf = alive_l & (ph == PH_SHF)
    is_sh = in_shc | in_shf

    hb = _pcg_hash(item.astype(jnp.uint32) ^
                   _pcg_hash(bounces.astype(jnp.uint32) ^ su))
    mrow = med_row(scene, medium)
    in_medium = medium >= 0

    # ---- unified raw cast: main ray (PH_CAST) or shadow segment (PH_SHC)
    dist_l = distance(sh_p, lp_pos)
    cast_o = jnp.where(in_shc, sh_p, org)
    cast_d = jnp.where(in_shc, sh_dir, d)
    cast_near = jnp.where(in_shc, eps_s, eps_i)
    cast_far = jnp.where(in_shc, (1.0 - eps_s) * dist_l, INF)
    rt, rprim, rbu, rbv, rsph = cast_scene(scene, cast_o, cast_d,
                                           cast_near, cast_far)
    mc_t = jnp.where(in_cast, rt, mc_t)
    mc_prim = jnp.where(in_cast, rprim, mc_prim)
    mc_u = jnp.where(in_cast, rbu, mc_u)
    mc_v = jnp.where(in_cast, rbv, mc_v)
    mc_sph = jnp.where(in_cast, rsph, mc_sph)

    # ---- ONE record build: shadow-cast lanes from the fresh raw tuple,
    # everyone else from the cached main cast (== fresh for PH_CAST)
    b_raw = (jnp.where(in_shc, rt, mc_t),
             jnp.where(in_shc, rprim, mc_prim),
             jnp.where(in_shc, rbu, mc_u),
             jnp.where(in_shc, rbv, mc_v),
             jnp.where(in_shc, rsph, mc_sph))
    b_o = jnp.where(in_shc, cast_o, org)
    b_d = jnp.where(in_shc, cast_d, d)
    hit = hit_from_cast(scene, b_o, b_d, b_raw, radius, spread)

    # ---- main free-flight init (PH_CAST) --------------------------------
    hs_ff0 = _pcg_hash(hb + jnp.uint32(_S_FF))
    t_hit_new = jnp.where(rt < INF, rt, INF)
    maj0 = get_majorant(scene, medium, org, d, t_hit_new, row=mrow)
    ch0 = jnp.clip((_u(hs_ff0, 0) * 3).astype(jnp.int32), 0, 2)
    ff_trivial = (medium < 0) | (maj0[ch0] <= 0) | \
        (scene.meta.num_media == 0)

    # ---- shadow-segment setup (PH_SHC) ----------------------------------
    sg_valid_n = rt < INF
    seg_next_t = jnp.where(sg_valid_n, distance(sh_p, hit.position),
                           dist_l)
    sg_opaque_n = sg_valid_n & (hit.material_id >= 0)
    # bounces was already incremented at the vertex -> pre-vertex value
    # is bounces-1 (reference depth check, :437-446)
    sg_dblock_n = sg_valid_n & (max_depth != -1) & \
        (bounces - 1 + sh_seg + 1 >= max_depth)
    sg_mednext_n = update_medium(hit, sh_dir, sh_med)
    sg_t = jnp.where(in_shc, seg_next_t, sg_t)
    sg_valid = jnp.where(in_shc, sg_valid_n, sg_valid)
    sg_opaque = jnp.where(in_shc, sg_opaque_n, sg_opaque)
    sg_dblock = jnp.where(in_shc, sg_dblock_n, sg_dblock)
    sg_mednext = jnp.where(in_shc, sg_mednext_n, sg_mednext)
    hseg = _pcg_hash(nb_hs ^ _pcg_hash(
        sh_seg.astype(jnp.uint32) + jnp.uint32(_S_NEE_SEG)))
    srow = med_row(scene, sh_med)
    smaj0 = get_majorant(scene, sh_med, sh_p, sh_dir, seg_next_t, row=srow)
    sch0 = jnp.clip((_u(hseg, 0) * 3).astype(jnp.int32), 0, 2)
    sff_trivial = (sh_med < 0) | (smaj0[sch0] <= 0) | \
        (scene.meta.num_media == 0)

    # reset ff state on entry (the slots are shared: the main products
    # are consumed at the vertex before any shadow segment uses them)
    entry = in_cast | in_shc
    ff_hs = jnp.where(in_cast, hs_ff0, jnp.where(in_shc, hseg, ff_hs))
    ff_t = jnp.where(entry, 0.0, ff_t)
    ff_it = jnp.where(entry, 0, ff_it)
    ff_tr = jnp.where(entry, ones, ff_tr)
    ff_dp = jnp.where(entry, ones, ff_dp)
    ff_np = jnp.where(entry, ones, ff_np)
    ff_sc = jnp.where(entry, False, ff_sc)
    ff_dn = jnp.where(in_cast, ff_trivial,
                      jnp.where(in_shc, sff_trivial, ff_dn))

    # ---- K bounded free-flight steps (all four phases) ------------------
    f_row = jnp.where(is_sh, srow, mrow)
    f_org = jnp.where(is_sh, sh_p, org)
    f_dir = jnp.where(is_sh, sh_dir, d)
    f_thit = jnp.where(is_sh, sg_t, jnp.where(mc_t < INF, mc_t, INF))
    go = in_cast | in_ff | is_sh
    wsc = ~is_sh & in_medium
    (ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn) = _ff_steps(
        scene, options, f_row, ff_hs, f_org, f_dir, f_thit, wsc, go,
        (ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn))

    ph = jnp.where((in_cast | in_ff) & ~ff_dn, PH_FF, ph)
    seg_ff_done = is_sh & ff_dn
    ph = jnp.where(is_sh & ~ff_dn, PH_SHF, ph)

    # ---- shadow-segment wrap-up -----------------------------------------
    has_med_seg = sh_med >= 0
    sh_T = jnp.where(seg_ff_done & has_med_seg, sh_T * ff_tr, sh_T)
    sh_pn = jnp.where(seg_ff_done & has_med_seg, sh_pn * ff_np, sh_pn)
    sh_pd = jnp.where(seg_ff_done & has_med_seg, sh_pd * ff_dp, sh_pd)
    blocked = sg_opaque | sg_dblock
    cont_chain = seg_ff_done & sg_valid & ~blocked & \
        (sh_seg + 1 < MAX_SHADOW_SEGMENTS)
    sh_med = jnp.where(cont_chain, sg_mednext, sh_med)
    sh_p = jnp.where(cont_chain, sh_p + sg_t * sh_dir, sh_p)
    sh_seg = jnp.where(seg_ff_done, sh_seg + 1, sh_seg)
    ph = jnp.where(cont_chain, PH_SHC, ph)
    chain_done = seg_ff_done & ~cont_chain

    # ---- NEE completion (chain_done) ------------------------------------
    ok = ~blocked & (jnp.max(sh_T) > 0)
    pdf_nee = pdfb * sh_pn
    contrib = sh_T * cb / jnp.maximum(_avg(pdf_nee), 1e-30)
    pdf_dir3 = pdfd * sh_pd
    wmis = (pdf_nee * pdf_nee) / jnp.maximum(
        pdf_nee * pdf_nee + pdf_dir3 * pdf_dir3, 1e-30)
    nee_out = jnp.where(ok, contrib * wmis, zeros)
    L = L + jnp.where(chain_done, tsc * nee_out, 0.0)
    nee_p = jnp.where(chain_done & (jnp.max(nee_out) > 0), org, nee_p)
    cont_ok = v_alive & (bounces < MAX_BOUNCES_CAP)
    died_c = chain_done & ~cont_ok
    ph = jnp.where(chain_done & cont_ok, PH_CAST, ph)

    # ---- VERTEX: runs the same iteration the main free flight ends ------
    # (verbatim port of the reference bounce body)
    vready = (in_cast | in_ff) & ff_dn
    active = vready
    trans = jnp.where(in_medium, ff_tr, ones)
    tdp = jnp.where(in_medium, ff_dp, ones)
    tnp = jnp.where(in_medium, ff_np, ones)
    scatter = ff_sc & in_medium
    mtp_v = jnp.where(in_medium, mtp * tdp, mtp)
    scatter_pos = org + d * ff_t
    hit_valid = mc_t < INF

    # vacuum miss: the fork discards the path entirely (:634-641)
    vacuum_miss = ~in_medium & ~hit_valid
    L = jnp.where(active & vacuum_miss, 0.0, L)
    active = active & ~vacuum_miss

    new_org = jnp.where(scatter, scatter_pos,
                        jnp.where(hit_valid, hit.position, org))
    T_v = T * trans / jnp.maximum(_avg(tdp), 1e-30)
    t_adv = jnp.where(scatter, ff_t, jnp.where(hit_valid, hit.t, 0.0))
    radius_v = radius + spread * t_adv

    # emission (:652-711)
    hit_light = active & ~scatter & hit_valid & (hit.light_id >= 0)
    Le = emission_area(scene, hit.light_id, hit.geometry_normal, -d)
    lp2 = LightPoint(position=hit.position, normal=hit.geometry_normal)
    pdf_nee_l = light_pmf(scene, hit.light_id) * \
        pdf_point_on_light(scene, hit.light_id, lp2, nee_p) * tnp
    jac_l = jnp.maximum(-dot(-d, hit.geometry_normal), 0.0) / \
        jnp.maximum(distance_squared(nee_p, hit.position), 1e-20)
    pdf_phase_l = dir_pdf * mtp_v * jac_l
    w_l = (pdf_phase_l * pdf_phase_l) / jnp.maximum(
        pdf_phase_l * pdf_phase_l + pdf_nee_l * pdf_nee_l, 1e-30)
    first = bounces == 0
    L = L + jnp.where(hit_light,
                      T_v * Le * jnp.where(first, ones, w_l), 0.0)
    active = active & ~(hit_light & first)  # :668 returns at bounce 0

    # index-matching pass-through (:716-726)
    pass_through = active & ~scatter & hit_valid & (hit.material_id < 0)
    medium_pt = update_medium(hit, d, medium)

    # depth limit (:731-733)
    depth_stop = (max_depth != -1) & (bounces >= max_depth - 1)
    active_work = active & ~pass_through & ~depth_stop
    active = active & ~(depth_stop & ~pass_through)
    active = active & (scatter | hit_valid)

    # scatter in medium (:737-784)
    do_scatter = active_work & scatter & in_medium
    sigma_s = get_sigma_s(scene, medium, new_org, row=mrow)
    hph = _pcg_hash(hb + jnp.uint32(_S_PHASE))
    u_ph = jnp.stack([_u(hph, 0), _u(hph, 1)])
    next_dir = phase_sample(scene, medium, -d, u_ph, row=mrow)
    ph_pdf = phase_pdf(scene, medium, -d, next_dir, row=mrow)
    ph_f = phase_eval(scene, medium, -d, next_dir, row=mrow)
    T_scatter = T_v * (ph_f / jnp.maximum(ph_pdf, 1e-30)) * sigma_s

    # surface interaction (:786-848)
    do_surface = active_work & ~scatter & hit_valid
    hbs = _pcg_hash(hb + jnp.uint32(_S_BSDF))
    u_b = jnp.stack([_u(hbs, 0), _u(hbs, 1), _u(hbs, 2)])
    rec = sample_bsdf(scene, hit.material_id, -d, hit, u_b[0:2], u_b[2])
    f_b = eval_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    pdf_b = pdf_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    bsdf_ok = rec.valid & (pdf_b > 0)
    active = active & ~(do_surface & ~bsdf_ok)
    is_refract = rec.eta != 0.0
    eta_v = jnp.where(do_surface & is_refract,
                      eta_scale / jnp.maximum(rec.eta * rec.eta, 1e-12),
                      eta_scale)
    medium_sf = jnp.where(is_refract,
                          update_medium(hit, rec.dir_out, medium), medium)
    T_surface = T_v * f_b / jnp.maximum(pdf_b, 1e-30)
    new_spread = jnp.where(
        is_refract,
        _ray_diff_refract(spread, radius_v, hit.mean_curvature,
                          jnp.maximum(rec.eta, 1e-6), rec.roughness),
        _ray_diff_reflect(spread, radius_v, hit.mean_curvature,
                          rec.roughness))
    spread_v = jnp.where(do_surface, new_spread, spread)

    # NEE setup (vertex-time half of vol_path_tracing.h:299-495): light
    # pick + point + the direction-independent factors; the shadow walk
    # accumulates the transmittance/pdf products event by event
    with_nee = do_scatter | do_surface
    hb_eff = jnp.where(do_surface, _pcg_hash(hb + jnp.uint32(7)), hb)
    nb_hs_v = _pcg_hash(hb_eff + jnp.uint32(_S_NEE))
    u_n = jnp.stack([_u(nb_hs_v, 0), _u(nb_hs_v, 1), _u(nb_hs_v, 2),
                     _u(nb_hs_v, 3)])
    light_id = sample_light(scene, u_n[2])
    lp = sample_point_on_light(scene, light_id, new_org, u_n[0:2], u_n[3])
    dir_l_v = normalize(lp.position - new_org)
    Le_n = emission_area(scene, light_id, lp.normal, -dir_l_v)
    jac_n = jnp.maximum(-dot(dir_l_v, lp.normal), 0.0) / \
        jnp.maximum(distance_squared(new_org, lp.position), 1e-20)
    pdfb_v = light_pmf(scene, light_id) * \
        pdf_point_on_light(scene, light_id, lp, new_org)
    f_ph = phase_eval(scene, medium, -d, dir_l_v, row=mrow)
    pdf_ph = phase_pdf(scene, medium, -d, dir_l_v, row=mrow)
    f_bs = eval_bsdf(scene, hit.material_id, -d, dir_l_v, hit)
    pdf_bs = pdf_bsdf(scene, hit.material_id, -d, dir_l_v, hit)
    cb_v = jnp.where(do_surface,
                     jnp.where(pdf_bs > 0, f_bs, zeros),
                     f_ph) * Le_n * jac_n
    pdfd_v = jnp.where(do_surface, pdf_bs, pdf_ph) * jac_n
    tsc_v = jnp.where(do_scatter, T_v * sigma_s, T_v)

    # merge continuation — applied NOW; the chain carries only v_alive
    d_next = jnp.where(do_scatter, next_dir,
                       jnp.where(do_surface, rec.dir_out, d))
    T_n = jnp.where(do_scatter, T_scatter,
                    jnp.where(do_surface, T_surface, T_v))
    medium_n = jnp.where(pass_through, medium_pt,
                         jnp.where(do_surface, medium_sf, medium))
    dir_pdf_n = jnp.where(do_scatter, ph_pdf, dir_pdf)
    mtp_n = jnp.where(do_scatter, ones, mtp_v)

    # russian roulette (:851-862)
    do_rr = (bounces >= options.rr_depth) & active & ~pass_through
    rr_prob = jnp.where(do_rr,
                        jnp.minimum(jnp.max(T_n / eta_v), 0.95), 1.0)
    u_rr = _u(_pcg_hash(hb + jnp.uint32(_S_RR)), 0)
    active = active & ~(do_rr & (u_rr > rr_prob))
    T_n = jnp.where(do_rr, T_n / jnp.maximum(rr_prob, 1e-20), T_n)

    # ---- apply vertex results -------------------------------------------
    v = vready
    med_vertex = medium              # the chain walks the VERTEX medium
    org = jnp.where(v, new_org, org)
    d = jnp.where(v, d_next, d)
    T = jnp.where(v, T_n, T)
    medium = jnp.where(v, medium_n, medium)
    bounces = jnp.where(v, bounces + 1, bounces)
    dir_pdf = jnp.where(v, dir_pdf_n, dir_pdf)
    mtp = jnp.where(v, mtp_n, mtp)
    eta_scale = jnp.where(v, eta_v, eta_scale)
    spread = jnp.where(v, spread_v, spread)
    radius = jnp.where(v, radius_v, radius)
    v_alive = jnp.where(v, active, v_alive)

    # shadow chain init / direct continuation
    start_chain = v & with_nee
    sh_p = jnp.where(start_chain, new_org, sh_p)
    sh_dir = jnp.where(start_chain, dir_l_v, sh_dir)
    sh_med = jnp.where(start_chain, med_vertex, sh_med)
    sh_seg = jnp.where(start_chain, 0, sh_seg)
    sh_T = jnp.where(start_chain, ones, sh_T)
    sh_pn = jnp.where(start_chain, ones, sh_pn)
    sh_pd = jnp.where(start_chain, ones, sh_pd)
    lp_pos = jnp.where(start_chain, lp.position, lp_pos)
    nb_hs = jnp.where(start_chain, nb_hs_v, nb_hs)
    cb = jnp.where(start_chain, cb_v, cb)
    pdfb = jnp.where(start_chain, pdfb_v, pdfb)
    pdfd = jnp.where(start_chain, pdfd_v, pdfd)
    tsc = jnp.where(start_chain, tsc_v, tsc)
    ph = jnp.where(start_chain, PH_SHC, ph)

    cont_now = v & ~with_nee & active        # pass-through only
    ph = jnp.where(cont_now, PH_CAST, ph)
    died_v = v & ~with_nee & ~active

    died = (died_v | died_c) & ~done
    nst = (item, org, d, medium, T, L, bounces, dir_pdf, nee_p, mtp,
           eta_scale, spread, radius, ph,
           mc_t, mc_prim, mc_u, mc_v, mc_sph,
           ff_hs, ff_t, ff_it, ff_tr, ff_dp, ff_np, ff_sc, ff_dn,
           sh_p, sh_dir, sh_med, sh_seg, sh_T, sh_pn, sh_pd, lp_pos,
           nb_hs, cb, pdfb, pdfd, tsc,
           sg_t, sg_valid, sg_opaque, sg_dblock, sg_mednext,
           v_alive, done)
    return nst, died


# ---------------------------------------------------------------------------
# Nested-loop advance (used for scenes with ONLY homogeneous media,
# where the closed-form free flight makes the classic one-bounce-per-
# iteration wavefront cheaper than the event machine: each bounce pays
# one vertex body instead of ~3 predicated ones. Grid-media scenes
# dispatch to _advance_event — their free-flight lockstep tails
# (mean 2 / max ~91 iterations) dominate the nested form.)
# ---------------------------------------------------------------------------

def _vol_nee(scene, options, hb, p, med_id, bounces, dir_view, is_surface,
             hit, row=None):
    from lajolla_tpu.integrators.media import med_row
    if row is None:
        row = med_row(scene, med_id)
    eps_shadow = shadow_eps(scene.meta.scene_radius)
    hs = _pcg_hash(hb + jnp.uint32(_S_NEE))
    u = jnp.stack([_u(hs, 0), _u(hs, 1), _u(hs, 2), _u(hs, 3)])
    light_id = sample_light(scene, u[2])
    lp = sample_point_on_light(scene, light_id, p, u[0:2], u[3])
    dir_light = normalize(lp.position - p)
    p_prime = lp.position
    p_origin = p

    ones = jnp.ones(3)

    def seg_cond(st):
        (p, med, sb, Tl, pn, pd, done, blocked) = st
        return ~done & ~blocked & (sb < MAX_SHADOW_SEGMENTS)

    def seg_body(st):
        (p, med, sb, Tl, pn, pd, done, blocked) = st
        tmax = (1.0 - eps_shadow) * distance(p, p_prime)
        shadow_hit = intersect_scene(scene, p, dir_light, eps_shadow, tmax)
        next_t = jnp.where(shadow_hit.valid,
                           distance(p, shadow_hit.position),
                           distance(p, p_prime))
        if scene.meta.num_media > 0:
            has_med = med >= 0
            hseg = _pcg_hash(hs ^ _pcg_hash(
                sb.astype(jnp.uint32) + jnp.uint32(_S_NEE_SEG)))
            row_seg = med_row(scene, med)
            trans, tdp, tnp, _sc, _at, _rounds = _free_flight(
                scene, options, hseg, p, dir_light, med, next_t,
                with_scatter=False, row=row_seg)
            Tl = jnp.where(has_med, Tl * trans, Tl)
            pn = jnp.where(has_med, pn * tnp, pn)
            pd = jnp.where(has_med, pd * tdp, pd)

        opaque = shadow_hit.valid & (shadow_hit.material_id >= 0)
        depth_block = shadow_hit.valid & (options.max_depth != -1) & \
            (bounces + sb + 1 >= options.max_depth)
        blocked = blocked | opaque | depth_block
        done = done | ~shadow_hit.valid
        med = jnp.where(shadow_hit.valid & ~blocked,
                        update_medium(shadow_hit, dir_light, med), med)
        p = jnp.where(shadow_hit.valid & ~blocked,
                      p + next_t * dir_light, p)
        return (p, med, sb + 1, Tl, pn, pd, done, blocked)

    init = (p, med_id, jnp.int32(0), ones, ones, ones,
            jnp.bool_(False), jnp.bool_(False))
    (_p, _med, _sb, Tl, p_nee, p_dir_t, done, blocked) = \
        jax.lax.while_loop(seg_cond, seg_body, init)

    ok = ~blocked & (jnp.max(Tl) > 0)

    Le = emission_area(scene, light_id, lp.normal, -dir_light)
    jac = jnp.maximum(-dot(dir_light, lp.normal), 0.0) / \
        jnp.maximum(distance_squared(p_origin, p_prime), 1e-20)
    pdf_nee = light_pmf(scene, light_id) * \
        pdf_point_on_light(scene, light_id, lp, p_origin) * p_nee

    # is_surface is a TRACED per-lane bool: the caller evaluates NEE
    # once per bounce with the shared shadow walk (the dominant cost)
    # and selects the bsdf/phase factors per lane
    mat_id = hit.material_id
    f_b = eval_bsdf(scene, mat_id, dir_view, dir_light, hit)
    pdf_b = pdf_bsdf(scene, mat_id, dir_view, dir_light, hit)
    f_p = phase_eval(scene, med_id, dir_view, dir_light, row=row)
    pdf_p = phase_pdf(scene, med_id, dir_view, dir_light, row=row)
    ok = ok & (~is_surface | (pdf_b > 0))
    f = jnp.where(is_surface, f_b, f_p)
    pdf_dir = jnp.where(is_surface, pdf_b, pdf_p) * jac * p_dir_t

    contrib = Tl * f * Le * jac / jnp.maximum(_avg(pdf_nee), 1e-30)
    w = (pdf_nee * pdf_nee) / jnp.maximum(
        pdf_nee * pdf_nee + pdf_dir * pdf_dir, 1e-30)
    return jnp.where(ok, contrib * w, jnp.zeros(3))


def _advance_vol_lane(scene, options, st, su):
    """ONE bounce of the final integrator for a single lane (vmapped by
    the wavefront driver). st = (item, org, d, medium, T, L, bounces,
    dir_pdf, nee_p, multi_trans_pdf, eta_scale, spread, radius, done).
    Returns (new_state, died) where died marks the path completing THIS
    step. spread/radius are the scalar ray-differential state threaded
    through surface bounces like the surface engine (path.py:49-58;
    reference passes ray_diff through vol_path_tracing.h:543) so textured
    surfaces inside media select mips."""
    (item, org, d, medium, T, L, bounces, dir_pdf, nee_p,
     multi_trans_pdf, eta_scale, spread, radius, done) = st
    eps_isect = intersection_eps(scene.meta.scene_radius)
    max_depth = options.max_depth
    ones = jnp.ones(3)
    active = ~done
    hb = _pcg_hash(item.astype(jnp.uint32) ^
                   _pcg_hash(bounces.astype(jnp.uint32) ^ su))

    hit = intersect_scene(scene, org, d, eps_isect, INF, radius, spread)
    t_hit = jnp.where(hit.valid, hit.t, INF)

    from lajolla_tpu.integrators.media import med_row
    mrow = med_row(scene, medium)   # ONE wide fetch per bounce
    in_medium = medium >= 0
    if scene.meta.num_media > 0:
        trans, tdp, tnp, scatter, accum_t, _rounds = _free_flight(
            scene, options, _pcg_hash(hb + jnp.uint32(_S_FF)), org, d,
            medium, t_hit, with_scatter=True, row=mrow)
        trans = jnp.where(in_medium, trans, ones)
        tdp = jnp.where(in_medium, tdp, ones)
        tnp = jnp.where(in_medium, tnp, ones)
        scatter = scatter & in_medium
        multi_trans_pdf = jnp.where(in_medium, multi_trans_pdf * tdp,
                                    multi_trans_pdf)
        scatter_pos = org + d * accum_t
    else:
        trans = tdp = tnp = ones
        scatter = jnp.bool_(False)
        scatter_pos = org
        accum_t = jnp.float32(0.0)

    # vacuum miss: the fork discards the path entirely (:634-641)
    vacuum_miss = ~in_medium & ~hit.valid
    L = jnp.where(active & vacuum_miss, 0.0, L)
    active = active & ~vacuum_miss

    new_org = jnp.where(scatter, scatter_pos,
                        jnp.where(hit.valid, hit.position, org))
    T = T * trans / jnp.maximum(_avg(tdp), 1e-30)
    # footprint grows with distance traveled (path.py:77)
    t_adv = jnp.where(scatter, accum_t, jnp.where(hit.valid, hit.t, 0.0))
    radius = radius + spread * t_adv

    # ---- emission (:652-711) -------------------------------------------
    hit_light = active & ~scatter & hit.valid & (hit.light_id >= 0)
    Le = emission_area(scene, hit.light_id, hit.geometry_normal, -d)
    lp2 = LightPoint(position=hit.position, normal=hit.geometry_normal)
    pdf_nee_l = light_pmf(scene, hit.light_id) * \
        pdf_point_on_light(scene, hit.light_id, lp2, nee_p) * tnp
    jac = jnp.maximum(-dot(-d, hit.geometry_normal), 0.0) / \
        jnp.maximum(distance_squared(nee_p, hit.position), 1e-20)
    pdf_phase_l = dir_pdf * multi_trans_pdf * jac
    w_l = (pdf_phase_l * pdf_phase_l) / jnp.maximum(
        pdf_phase_l * pdf_phase_l + pdf_nee_l * pdf_nee_l, 1e-30)
    first = bounces == 0
    L = L + jnp.where(hit_light,
                      T * Le * jnp.where(first, ones, w_l), 0.0)
    active = active & ~(hit_light & first)  # :668 returns at bounce 0

    # ---- index-matching pass-through (:716-726) ------------------------
    pass_through = active & ~scatter & hit.valid & (hit.material_id < 0)
    medium_pt = update_medium(hit, d, medium)

    # ---- depth limit (:731-733) ----------------------------------------
    depth_stop = (max_depth != -1) & (bounces >= max_depth - 1)
    active_work = active & ~pass_through & ~depth_stop
    active = active & ~(depth_stop & ~pass_through)
    # non-surface non-scatter non-passthrough lanes terminate (miss into
    # a medium boundary / escaped rays already handled above)
    active = active & (scatter | hit.valid)

    # ---- scatter in medium (:737-784) ----------------------------------
    do_scatter = active_work & scatter & in_medium
    do_surface = active_work & ~scatter & hit.valid
    sigma_s = get_sigma_s(scene, medium, new_org, row=mrow)
    # ONE merged NEE per bounce: the shadow walk (the dominant cost) is
    # shared; per-lane is_surface selects bsdf vs phase factors inside
    hb_eff = jnp.where(do_surface, _pcg_hash(hb + jnp.uint32(7)), hb)
    nee_m = _vol_nee(scene, options, hb_eff, new_org, medium, bounces,
                     -d, do_surface, hit, row=mrow)
    nee_s = nee_b = nee_m
    L = L + jnp.where(do_scatter, T * sigma_s * nee_m,
                      jnp.where(do_surface, T * nee_m, 0.0))
    hph = _pcg_hash(hb + jnp.uint32(_S_PHASE))
    u_ph = jnp.stack([_u(hph, 0), _u(hph, 1)])
    next_dir = phase_sample(scene, medium, -d, u_ph, row=mrow)
    ph_pdf = phase_pdf(scene, medium, -d, next_dir, row=mrow)
    ph_f = phase_eval(scene, medium, -d, next_dir, row=mrow)
    T_scatter = T * (ph_f / jnp.maximum(ph_pdf, 1e-30)) * sigma_s

    # ---- surface interaction (:786-848) --------------------------------
    hbs = _pcg_hash(hb + jnp.uint32(_S_BSDF))
    u_b = jnp.stack([_u(hbs, 0), _u(hbs, 1), _u(hbs, 2)])
    rec = sample_bsdf(scene, hit.material_id, -d, hit, u_b[0:2], u_b[2])
    f = eval_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    pdf_b = pdf_bsdf(scene, hit.material_id, -d, rec.dir_out, hit)
    bsdf_ok = rec.valid & (pdf_b > 0)
    active = active & ~(do_surface & ~bsdf_ok)
    is_refract = rec.eta != 0.0
    eta_scale = jnp.where(do_surface & is_refract,
                          eta_scale / jnp.maximum(rec.eta * rec.eta,
                                                  1e-12), eta_scale)
    medium_sf = jnp.where(is_refract,
                          update_medium(hit, rec.dir_out, medium),
                          medium)
    T_surface = T * f / jnp.maximum(pdf_b, 1e-30)
    new_spread = jnp.where(
        is_refract,
        _ray_diff_refract(spread, radius, hit.mean_curvature,
                          jnp.maximum(rec.eta, 1e-6), rec.roughness),
        _ray_diff_reflect(spread, radius, hit.mean_curvature,
                          rec.roughness))
    spread = jnp.where(do_surface, new_spread, spread)

    # nee cache update (:755-760, :806-810)
    nee_valid = (do_scatter & (jnp.max(nee_s) > 0)) | \
        (do_surface & (jnp.max(nee_b) > 0))
    nee_p = jnp.where(nee_valid, new_org, nee_p)

    # ---- merge branch results ------------------------------------------
    d_next = jnp.where(do_scatter, next_dir,
                       jnp.where(do_surface, rec.dir_out, d))
    T = jnp.where(do_scatter, T_scatter,
                  jnp.where(do_surface, T_surface, T))
    medium = jnp.where(pass_through, medium_pt,
                       jnp.where(do_surface, medium_sf, medium))
    dir_pdf = jnp.where(do_scatter, ph_pdf, dir_pdf)
    multi_trans_pdf = jnp.where(do_scatter, ones, multi_trans_pdf)

    # ---- russian roulette (:851-862) -----------------------------------
    do_rr = (bounces >= options.rr_depth) & active & ~pass_through
    rr_prob = jnp.where(do_rr,
                        jnp.minimum(jnp.max(T / eta_scale), 0.95), 1.0)
    u_rr = _u(_pcg_hash(hb + jnp.uint32(_S_RR)), 0)
    active = active & ~(do_rr & (u_rr > rr_prob))
    T = jnp.where(do_rr, T / jnp.maximum(rr_prob, 1e-20), T)

    active = active & (bounces + 1 < MAX_BOUNCES_CAP)
    died = ~done & ~active
    nst = (item, new_org, d_next, medium, T, L, bounces + 1, dir_pdf,
           nee_p, multi_trans_pdf, eta_scale, spread, radius, done)
    return nst, died

# ---------------------------------------------------------------------------
# Pedagogical versions 1 & 2 (vol_path_tracing.h:6-147)
# ---------------------------------------------------------------------------

def volpath1_trace_one(scene, options, px, py, key):
    """Absorption only, single homogeneous exterior volume (:6-41)."""
    key, sub = jax.random.split(key)
    u_pix = jax.random.uniform(sub, (2,))
    org, d = sample_primary(scene, options, px.astype(jnp.float32),
                            py.astype(jnp.float32), u_pix)
    hit = intersect_scene(scene, org, d, 0.0, INF)
    has_med = hit.valid & (hit.exterior_med >= 0)
    sigma_a = get_sigma_a(scene, hit.exterior_med, hit.position)
    # miss lanes carry position = inf; the result is masked by has_med,
    # but exp(-σ·inf) would NaN the σ-cotangent under jax.grad
    # (diffpath.render_volpath_diff) — 0 is primal-equivalent
    t_hit = jnp.where(hit.valid, distance(hit.position, org), 0.0)
    transmittance = jnp.exp(-sigma_a * t_hit)
    Le = jnp.where(hit.light_id >= 0,
                   emission_area(scene, hit.light_id, hit.geometry_normal,
                                 -d), jnp.zeros(3))
    return jnp.where(has_med, transmittance * Le, jnp.zeros(3))


def volpath2_trace_one(scene, options, px, py, key, detach=False):
    """Single monochromatic homogeneous volume, single scattering (:46-147).

    detach=True is the volumetric detached-gradient mode (see
    path._advance_lane): the sampled free-flight distance, the sampling
    pdfs and all geometry are stop-gradiented while the transmittance /
    scattering / phase / emission factors stay attached — unbiased
    gradients wrt medium (σ_a, σ_s), phase and emission parameters
    (∂θ E = E[∂θ f / p_detached] since p carries no θ after detach).
    Primal-neutral; used by integrators/diffpath.render_volpath_diff."""
    sg = jax.lax.stop_gradient if detach else (lambda x: x)
    eps_shadow = shadow_eps(scene.meta.scene_radius)
    key, sub = jax.random.split(key)
    u_pix = jax.random.uniform(sub, (2,))
    org, d = sample_primary(scene, options, px.astype(jnp.float32),
                            py.astype(jnp.float32), u_pix)
    hit = intersect_scene(scene, org, d, 0.0, INF)
    medium = jnp.where(hit.valid, hit.exterior_med,
                       jnp.int32(scene.meta.camera_medium_id))
    t_hit = jnp.where(hit.valid, sg(distance(hit.position, org)), INF)

    sigma_s = get_sigma_s(scene, medium, sg(hit.position))
    sigma_a = get_sigma_a(scene, medium, sg(hit.position))
    sigma_t = sigma_s + sigma_a

    key, u = _uniforms(key, 5)
    t = sg(-jnp.log(jnp.maximum(1.0 - u[0], 1e-20)) /
           jnp.maximum(sigma_t[0], 1e-20))

    # scatter before surface
    trans_pdf_s = sg(jnp.exp(-sigma_t * t) * sigma_t)
    transmittance_s = jnp.exp(-sigma_t * t)
    p = sg(org + t * d)
    light_id = sample_light(scene, u[3])
    lp = sample_point_on_light(scene, light_id, p, u[1:3], u[4])
    if detach:
        lp = jax.tree_util.tree_map(sg, lp)
    dir_light = normalize(lp.position - p)
    rho = phase_eval(scene, medium, -d, dir_light)
    Le = emission_area(scene, light_id, lp.normal, -dir_light)
    dist_l = distance(p, lp.position)
    exp_term = jnp.exp(-sigma_t * dist_l)
    from lajolla_tpu.scene.geometry import occluded
    occ = occluded(scene, p, dir_light, eps_shadow,
                   (1.0 - eps_shadow) * dist_l)
    jac = jnp.abs(dot(dir_light, lp.normal)) / \
        jnp.maximum(distance_squared(p, lp.position), 1e-20) * \
        jnp.where(occ, 0.0, 1.0)
    L_s1 = rho * Le * exp_term * jac
    L_s1_pdf = sg(light_pmf(scene, light_id) *
                  pdf_point_on_light(scene, light_id, lp, p))
    scatter_contrib = (transmittance_s / trans_pdf_s) * sigma_s * \
        (L_s1 / jnp.maximum(L_s1_pdf, 1e-30))

    # reach the surface. In detach mode a miss (t_hit = INF) must not
    # reach exp(-σ·INF): forward it's the masked branch, but the
    # σ-cotangent would be -INF·exp(-INF) = NaN (see _advance_lane's
    # sanitize note); the selected branch is identical.
    t_hit_e = jnp.where(jnp.isfinite(t_hit), t_hit, 0.0) \
        if detach else t_hit
    trans_pdf_h = sg(jnp.exp(-sigma_t * t_hit_e))
    transmittance_h = jnp.exp(-sigma_t * t_hit_e)
    Le_h = jnp.where(hit.valid & (hit.light_id >= 0),
                     emission_area(scene, hit.light_id,
                                   hit.geometry_normal, -d), jnp.zeros(3))
    surf_contrib = transmittance_h / jnp.maximum(trans_pdf_h, 1e-30) * Le_h

    return jnp.where(t < t_hit, scatter_contrib, surf_contrib)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('options', 'nspp', 'lanes', 'count',
                                   'early_exit'))
def _render_volpath_block(scene, options, seed, s0, nspp, lanes=None,
                          i0=0, count=None, early_exit=False):
    """Persistent-wavefront queue over (pixel, sample) work items for the
    final integrator. Two statically-selected lane-advance engines:

    * grid-media scenes -> the flat EVENT machine (_advance_event): one
      cast + K bounded free-flight steps per iteration, so the lockstep
      cost tracks mean events per path instead of the product of
      per-loop maxima (hetvol: 2.7x the nested form);
    * homogeneous-only scenes -> the classic one-bounce-per-iteration
      advance (_advance_vol_lane) with the closed-form single-step free
      flight — fewer (predicated) vertex-body evaluations per path.

    Finished paths splat into the film (dense, queue-stride — see
    path.py _dense_film_add) and regenerate immediately. Returns the
    film SUM over work items [s0*n + i0, s0*n + i0 + count) — `count`
    < n*nspp bounds the device-launch duration for heavy scenes; the
    driver accumulates chunks."""
    w = scene.meta.width
    h = scene.meta.height
    n = w * h
    lanes = lanes or n
    count = count if count is not None else n * nspp
    su = _pcg_hash(jnp.uint32(seed) ^ jnp.uint32(0x701A77E5))
    use_machine = scene.meta.has_grid_volumes

    item0 = jnp.arange(lanes, dtype=jnp.int32) + s0 * n + i0
    _pix, org0, d0 = _primary_hash(scene, options, item0, su)
    ones = jnp.ones((lanes, 3), jnp.float32)
    z3 = jnp.zeros((lanes, 3), jnp.float32)
    z1 = jnp.zeros(lanes, jnp.float32)
    zi = jnp.zeros(lanes, jnp.int32)
    zb = jnp.zeros(lanes, jnp.bool_)
    zu = jnp.zeros(lanes, jnp.uint32)
    spread0 = jnp.full(lanes, 0.25 / max(w, h), jnp.float32)

    def fresh(item, org, dd):
        """Per-lane state for newly-(re)generated items."""
        path_st = (item, org, dd,
                   jnp.full(lanes, scene.meta.camera_medium_id, jnp.int32),
                   ones, z3, zi, z1, org, ones,
                   jnp.ones(lanes, jnp.float32), spread0, z1)
        if not use_machine:
            return path_st + (zb,)
        return path_st + (
            jnp.full(lanes, PH_CAST, jnp.int32),
            jnp.full(lanes, jnp.inf, jnp.float32), zi, z1, z1, zb,
            zu, z1, zi, ones, ones, ones, zb, zb,
            org, dd, zi, zi, ones, ones, ones, org,
            zu, z3, z1, z1, ones,
            z1, zb, zb, zb, zi,
            zb, zb)

    state = fresh(item0, org0, d0)
    film0 = jnp.zeros((n, 3), jnp.float32)
    end = s0 * n + i0 + count
    advance = _advance_event if use_machine else _advance_vol_lane

    def cond(carry):
        st, film, _it = carry
        if early_exit:
            # see path.py _render_block_sc: stop once the queue is fully
            # consumed and survivors fit the DRAIN_DIV-smaller pool
            has_queue = jnp.any(st[0] + lanes < end)
            return has_queue | (jnp.sum(~st[-1]) > (lanes // VOL_DRAIN_DIV))
        return ~jnp.all(st[-1])

    def body(carry):
        st, film, it = carry
        nst, died = jax.vmap(
            lambda *s: advance(scene, options, s, su))(*st)
        item = nst[0]
        L = nst[5]
        done = nst[-1]

        # whole-sample NaN exclusion at the splat, as in the reference
        # film loop (render.cpp:140-143)
        pixel = (item % n).astype(jnp.int32)
        fin = jnp.all(jnp.isfinite(L), axis=-1)
        contrib = jnp.where((died & fin)[:, None], L, 0.0)
        film = _dense_film_add(film, pixel, contrib, n, lanes)

        next_item = item + lanes
        has_more = next_item < end
        regen = died & has_more
        done = done | (died & ~has_more)

        _rp, rorg, rd = _primary_hash(scene, options, next_item, su)
        fr = fresh(next_item, rorg, rd)
        state_new = []
        for i, (f_i, cur) in enumerate(zip(fr, nst)):
            if i == len(fr) - 1:            # done flag
                state_new.append(done)
            elif cur.ndim == 2:
                state_new.append(jnp.where(regen[:, None], f_i, cur))
            else:
                state_new.append(jnp.where(regen, f_i, cur))
        return (tuple(state_new), film, it + 1)

    (st, film, iters) = jax.lax.while_loop(
        cond, body, (state, film0, jnp.int32(0)))
    return film, st, iters


VOL_DRAIN_DIV = 4


@partial(jax.jit, static_argnames=('options', 'early_exit'))
def _drain_volpath_block(scene, options, seed, st, early_exit=False):
    """Finish the compacted survivors of an early-exited
    _render_volpath_block: no regeneration, so each lane's radiance
    latches at death and lands in ONE host-side scatter (see path.py
    _drain_block / _drain_cascade — volumetric path-length tails are
    the heaviest in the suite, hetvol measured 130 fixed-width drain
    iterations for a 7-iteration main loop before the cascade)."""
    su = _pcg_hash(jnp.uint32(seed) ^ jnp.uint32(0x701A77E5))
    use_machine = scene.meta.has_grid_volumes
    advance = _advance_event if use_machine else _advance_vol_lane
    L_final = jnp.zeros_like(st[5])
    width = st[0].shape[0]

    def cond(carry):
        st, _, _it = carry
        live = jnp.sum(~st[-1])
        if early_exit:
            return live > (width // VOL_DRAIN_DIV)
        return live > 0

    def body(carry):
        st, Lf, it = carry
        nst, died = jax.vmap(
            lambda *s: advance(scene, options, s, su))(*st)
        L = nst[5]
        fin = jnp.all(jnp.isfinite(L), axis=-1)
        Lf = jnp.where((died & fin)[:, None], L, Lf)
        nst = nst[:-1] + (nst[-1] | died,)
        return (nst, Lf, it + 1)

    st, L_final, iters = jax.lax.while_loop(
        cond, body, (st, L_final, jnp.int32(0)))
    return st, L_final, iters


QUEUE_STATS = {}   # last _render_volpath_block_drained occupancy
                   # telemetry (deterministic given (scene, seed);
                   # pinned by tests/test_perf_proxies.py)


def _render_volpath_block_drained(scene, options, seed, s0, nspp, lanes,
                                  i0=0, count=None):
    """Host wrapper: full-width wavefront until survivors fit a
    VOL_DRAIN_DIV-smaller pool, then drain them there. Returns the
    (n, 3) film-sum ndarray."""
    import numpy as np
    n = scene.meta.width * scene.meta.height
    film, st, iters_main = _render_volpath_block(
        scene, options, seed, s0, nspp, lanes, i0, count, early_exit=True)
    from lajolla_tpu.integrators.path import _drain_cascade
    film = np.array(film)
    drain_steps = _drain_cascade(scene, options, seed, st, film, n,
                                 _drain_volpath_block,
                                 done_idx=len(st) - 1)
    work = count if count is not None else n * nspp
    QUEUE_STATS.update(
        iters_main=int(iters_main), drain_lane_steps=drain_steps,
        lanes=lanes, paths=work,
        lane_steps_per_path=(int(iters_main) * lanes + drain_steps)
        / work)
    return film


@partial(jax.jit, static_argnames=('options', 'nspp', 'tile'))
def _render_volpath_simple_block(scene, options, seed, s0, nspp, p0=0,
                                 tile=None):
    """Per-pixel driver for the single-bounce pedagogical versions 1-2."""
    w = scene.meta.width
    h = scene.meta.height
    n = w * h
    tile = tile or n
    root = jax.random.PRNGKey(seed)
    pix = (jnp.arange(tile, dtype=jnp.uint32) +
           jnp.uint32(0) + jnp.asarray(p0, jnp.uint32))
    px = (pix % w).astype(jnp.int32)
    py = (pix // w).astype(jnp.int32)
    pixel_keys = jax.vmap(jax.random.fold_in, (None, 0))(root, pix)
    tracer = {1: volpath1_trace_one, 2: volpath2_trace_one}[
        options.vol_path_version]
    trace = jax.vmap(tracer, in_axes=(None, None, 0, 0, 0))

    def one_spp(i, img):
        keys = jax.vmap(jax.random.fold_in, (0, None))(
            pixel_keys, (s0 + i).astype(jnp.uint32))
        L = trace(scene, options, px, py, keys)
        L = jnp.where(jnp.isfinite(L), L, 0.0)
        return img + L

    return jax.lax.fori_loop(0, nspp, one_spp,
                             jnp.zeros((tile, 3), jnp.float32))


# Lane pools and launch sizes: not yet measured on the GPU (ROADMAP
# Design 3 keeps them as A/B items). Grid-media scenes run long lockstep
# null-collision loops, so they take a smaller pool and shorter launches.
VOL_SPP_BLOCK = 4
VOL_LANES = 131072
GRID_LANES = 16384


def render_volpath(scene, options, seed=0, checkpoint=None, progress=False):
    import numpy as np
    from lajolla_tpu.utils.checkpoint import load_film, save_film
    from lajolla_tpu.utils.progress import ProgressReporter
    w = scene.meta.width
    h = scene.meta.height
    n = w * h
    spp = options.samples_per_pixel
    # blocks never read the total spp: one compiled block for every spp
    options = dataclasses.replace(options, samples_per_pixel=0)
    simple = options.vol_path_version in (1, 2)
    # heterogeneous media run long null-collision chains → shorter
    # launches (the lockstep inner loop can run hundreds of iterations)
    lanes = min(GRID_LANES if scene.meta.has_grid_volumes else VOL_LANES, n)
    spp_block = 1 if scene.meta.has_grid_volumes else VOL_SPP_BLOCK

    img, spp_done = None, 0
    if checkpoint:
        img, spp_done = load_film(checkpoint, seed, (n, 3))
    if img is None:
        img = np.zeros((n, 3), np.float32)
    rep = ProgressReporter(spp, label="volpath", enabled=progress)
    rep.done = spp_done
    s0 = spp_done
    # grid-media paths run long lockstep null-collision loops; bound each
    # device launch by chunking the work-item range
    chunk = 2 * lanes if scene.meta.has_grid_volumes else None
    while s0 < spp:
        ns = min(spp_block, spp - s0)
        if simple:
            block = _render_volpath_simple_block(scene, options, seed, s0,
                                                 ns, 0, n)
            img += np.asarray(block)
        elif chunk is None:
            img += _render_volpath_block_drained(scene, options, seed,
                                                 s0, ns, lanes)
        else:
            i0 = 0
            while i0 < n * ns:
                c = min(chunk, n * ns - i0)
                img += _render_volpath_block_drained(
                    scene, options, seed, s0, ns, lanes, i0, c)
                i0 += c
        s0 += ns
        rep.update(ns)
        if checkpoint:
            save_film(checkpoint, seed, img, s0)
    rep.finish()
    return (img / spp).reshape(h, w, 3)
