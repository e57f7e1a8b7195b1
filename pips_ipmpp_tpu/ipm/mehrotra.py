"""Mehrotra predictor-corrector with Gondzio multiple centrality correctors.

Backend-generic, fully jittable: one call = one IPM iteration (factorize +
predictor solve + corrector solve + Gondzio loop + step).  This is a
jittable reimplementation of the reference's InteriorPointMethod
(Core/InteriorPointMethod/InteriorPointMethod.cpp): the predictor/corrector
logic at :68-178, the Gondzio loop at :236-358, the primal vs primal-dual
step rules (InteriorPointMethodType.hpp), and the fraction-to-boundary and
step-length heuristics at :696-816 — expressed as fused jnp ops and
`lax.while_loop` (no data-dependent Python control flow, per XLA semantics).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

from pips_ipmpp_tpu.core.lp import _register
from pips_ipmpp_tpu.core.options import Options, StepMode
from pips_ipmpp_tpu.ipm import formulation as F


@_register
@dataclass
class StepStats:
    mu: Any
    sigma: Any
    alpha_primal: Any
    alpha_dual: Any
    n_gondzio: Any
    factor_ok: Any


def _bicg_tol(opts: Options, iteration):
    """Iteration-adaptive outer-BiCGStab tolerance (reference
    set_BiCGStab_tolerance, InteriorPointMethod.cpp:655-669): loose early
    (1e-8), tightening to 1e-10 as the IPM converges."""
    if not opts.dynamic_bicg_tol or iteration is None:
        return opts.outer_bicg_tol
    return jnp.where(iteration <= 3, 1e-8,
                     jnp.where(iteration <= 7, 1e-9, opts.outer_bicg_tol))


def _solve_dir(be, it, res, comp, Ominv, fac, opts: Options,
               want_stats: bool = False, iteration=None):
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    stats = None
    if opts.outer_bicgstab and hasattr(be, "solve_reduced_bicgstab"):
        # OUTER_SOLVE=2: BiCGStab on the full structured KKT, direct solve
        # as preconditioner (reference gmspips.cpp:79 forces this mode)
        dx, dy, dz, stats = be.solve_reduced_bicgstab(
            fac, rhs, max_iters=opts.outer_max_iters,
            tol=_bicg_tol(opts, iteration))
    else:
        dx, dy, dz = be.solve_reduced(fac, rhs, opts.refinement_steps)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)
    if want_stats:
        return d, stats
    return d


def _alphas(be, it, d, opts: Options):
    if opts.step_mode == StepMode.PRIMAL:
        return F.step_bound_single(be, it, d)
    return F.step_bounds_pd(be, it, d)


def ipm_step(be, it: F.Iterate, delta_p, delta_d, opts: Options,
             iteration=None, res=None):
    """One full IPM iteration. Returns (new_iterate, StepStats).

    `iteration` (traced int or None) gates the late-iteration mechanisms:
    small-complementarity-pair correctors (first_iter_small_correctors)
    and the adaptive outer-BiCGStab tolerance.  `res` optionally passes
    residuals already computed for THIS iterate (the fused loop evaluates
    them for termination right before stepping; recomputing them across
    the lax.cond boundary would double the matvec work per iteration)."""
    if res is None:
        res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, delta_p, delta_d)
    ok = be.factorization_ok(fac)

    mu = F.mu(be, it)

    # ---- predictor (affine scaling) ----
    comp_aff = F.comp_rhs_affine(be, it)
    d_aff = _solve_dir(be, it, res, comp_aff, Ominv, fac, opts,
                       iteration=iteration)
    ap_aff, ad_aff = _alphas(be, it, d_aff, opts)
    mu_aff = F.mu_after_step(be, it, d_aff, ap_aff, ad_aff)

    # ---- centering parameter sigma = (mu_aff/mu)^3 (reference :154-168) ----
    sigma = (mu_aff / mu) ** 3
    sigma_mu = sigma * mu

    # ---- corrector (combined direction) ----
    comp_corr = F.comp_rhs_corrector(be, it, d_aff, sigma_mu)
    d, bicg = _solve_dir(be, it, res, comp_corr, Ominv, fac, opts,
                         want_stats=True, iteration=iteration)

    # ---- weighted predictor-corrector line search (reference :459-526) --
    if opts.n_linesearch_points > 1:
        d, a_p, a_d = _weighted_pc_search(be, it, d_aff, d, opts)
    else:
        a_p, a_d = _alphas(be, it, d, opts)

    # dynamic corrector budget: when the outer BiCGStab had to work hard,
    # skip extra correctors (reference :639-653 limits Gondzio correctors
    # by BiCGStab iteration count — the Observer feedback)
    allow_gondzio = jnp.asarray(True)
    if bicg is not None:
        allow_gondzio = (bicg["iterations"]
                         < max(opts.outer_max_iters - 1, 1)) \
            & bicg["converged"]

    # ---- Gondzio multiple centrality correctors (reference :236-358) ----
    zero_res = jax.tree.map(jnp.zeros_like, res)
    n_gondzio = jnp.zeros((), jnp.int32)

    if opts.max_gondzio_correctors > 0:
        it_idx = (jnp.asarray(iteration, jnp.int32) if iteration is not None
                  else jnp.asarray(-1, jnp.int32))
        small_allowed = (opts.small_pair_correctors
                         and opts.max_additional_correctors > 0)

        def cond(carry):
            d_c, ap_c, ad_c, k, n_small, small_corr, go = carry
            unconverged = jnp.minimum(ap_c, ad_c) < 1.0
            return (go & unconverged & allow_gondzio
                    & (k < opts.max_gondzio_correctors)
                    & (n_small < max(opts.max_additional_correctors, 1)))

        def body(carry):
            d_c, ap_c, ad_c, k, n_small, small_corr, _ = carry
            # enlarged trial steps alpha_t = min(1, f1*alpha + f0)
            # (reference step_factor0/1, InteriorPointMethod.cpp:253-254)
            ap_t = jnp.minimum(opts.step_factor1 * ap_c + opts.step_factor0,
                               1.0)
            ad_t = jnp.minimum(opts.step_factor1 * ad_c + opts.step_factor0,
                               1.0)
            # small-pair correctors lift the upper projection bound to +inf
            # so only tiny complementarity products are pushed (reference
            # compute_gondzio_corrector :446-457 with rmax = infinity)
            beta_hi = jnp.where(small_corr, jnp.inf, opts.beta_max)
            comp_g = F.comp_rhs_gondzio(be, it, d_c, ap_t, ad_t, sigma_mu,
                                        opts.beta_min, beta_hi)
            corr = _solve_dir(be, it, zero_res, comp_g, Ominv, fac, opts,
                              iteration=iteration)

            # per-side weighted corrector addition (reference
            # calculate_alpha_pd_weight_candidate :459-526): scan weights,
            # pick the best primal and dual weights INDEPENDENTLY
            nw = max(opts.n_linesearch_points, 1)
            ws = jnp.linspace(1.0 / nw, 1.0, nw)

            def eval_w(w):
                dw = F.add_weighted(d_c, corr, w, w)
                return _alphas(be, it, dw, opts)

            aps, ads = jax.vmap(eval_w)(ws)
            ip = jnp.argmax(aps)
            idd = jnp.argmax(ads)
            ap_n, wp = aps[ip], ws[ip]
            ad_n, wd = ads[idd], ws[idd]

            tol = 1.0 + opts.acceptance_tolerance
            acc_p = ap_n >= tol * ap_c
            acc_d = ad_n >= tol * ad_c
            # apply the corrector with per-side weights (zero on the side
            # that did not improve — reference :298-331)
            d_new = F.add_weighted(d_c, corr,
                                   jnp.where(acc_p, wp, 0.0),
                                   jnp.where(acc_d, wd, 0.0))
            accepted = acc_p | acc_d
            ap_c2 = jnp.where(acc_p, ap_n, ap_c)
            ad_c2 = jnp.where(acc_d, ad_n, ad_c)
            # on rejection: switch to small-pair correctors once, when the
            # step is still poor and the IPM is late enough (reference
            # :341-352, GONDZIO_STOCH_FIRST_ITER/MAX_ALPHA_SMALL_CORRECTORS)
            can_small = (jnp.asarray(small_allowed)
                         & ~small_corr
                         & (it_idx >= opts.first_iter_small_correctors)
                         & (jnp.minimum(ap_c, ad_c)
                            < opts.max_alpha_small_correctors))
            switch_small = ~accepted & can_small
            go = accepted | switch_small
            return (d_new, ap_c2, ad_c2, k + jnp.asarray(accepted, jnp.int32),
                    n_small + jnp.asarray(accepted & small_corr, jnp.int32),
                    small_corr | switch_small, go)

        d, a_p, a_d, n_gondzio, _, _, _ = jax.lax.while_loop(
            cond, body, (d, a_p, a_d, n_gondzio, jnp.zeros((), jnp.int32),
                         jnp.asarray(False), jnp.asarray(True)))

    # ---- final step lengths ----
    a_p_f, a_d_f = _final_steplengths(be, it, d, a_p, a_d, mu, opts)

    # ---- probing (reference compute_probing_factor, :528-627): when the
    # step looks troubled, evaluate residuals and mu at the candidate point
    # and damp the step so neither grows more than 10x ----
    if opts.probing:
        trouble = jnp.minimum(a_p_f, a_d_f) < opts.probing_trigger
        if bicg is not None:
            trouble = trouble | ~bicg["converged"]

        def probing_factor(_):
            trial = F.take_step(it, d, a_p_f, a_d_f)
            res_t = F.compute_residuals(be, trial)
            rn_t = F.residual_norm(res_t, be.axis)
            rn_0 = F.residual_norm(res, be.axis)
            mu_t = F.mu(be, trial)
            f = jnp.ones_like(mu)
            f = jnp.minimum(f, jnp.where(
                rn_t > 10.0 * rn_0,
                9.0 * rn_0 / jnp.maximum(rn_t - rn_0, 1e-300) * 0.9995, f))
            f = jnp.minimum(f, jnp.where(
                mu_t > 10.0 * mu,
                9.0 * mu / jnp.maximum(mu_t - mu, 1e-300) * 0.9995, f))
            return f

        factor = jax.lax.cond(trouble, probing_factor,
                              lambda _: jnp.ones_like(mu), None)
        a_p_f = a_p_f * factor
        a_d_f = a_d_f * factor

    # ---- numerical-troubles path (reference :528-627): when the combined
    # step collapses, retry with a PURE CENTERING direction (sigma = 1,
    # complementarity target mu) and a damped step to restore centrality
    # before attempting progress again ----
    if opts.centering_retry:
        trouble = (a_p_f + a_d_f) < opts.small_step_threshold

        def centered(_):
            comp_c = F.comp_rhs_corrector(
                be, it, jax.tree.map(jnp.zeros_like, d_aff), mu)
            d_c = _solve_dir(be, it, res, comp_c, Ominv, fac, opts,
                             iteration=iteration)
            ap_c, ad_c = _alphas(be, it, d_c, opts)
            return d_c, 0.7 * ap_c, 0.7 * ad_c

        def normal(_):
            return d, a_p_f, a_d_f

        d, a_p_f, a_d_f = jax.lax.cond(trouble, centered, normal, None)

    new_it = F.take_step(it, d, a_p_f, a_d_f)

    stats = StepStats(mu=mu, sigma=sigma, alpha_primal=a_p_f,
                      alpha_dual=a_d_f, n_gondzio=n_gondzio, factor_ok=ok)
    return new_it, stats


def _final_steplengths(be, it, d, a_p_max, a_d_max, mu, opts: Options):
    """Mehrotra's step-length heuristic with the EXACT blocking pair
    (reference PrimalDualInteriorPointMethod::mehrotra_step_length,
    InteriorPointMethod.cpp:746-816, over find_blocking's distributed
    minloc pair, DistributedVector.C:702-726).

    mufull = mu(alpha_max) / gamma_a.  For the primal side with blocking
    pair (v_b, dv_b) and partner (g_b, dg_b):

        alpha_p = (-v_b + mufull / (g_b + alpha_d_max * dg_b)) / dv_b

    clamped to [gamma_f * alpha_max, alpha_max], then damped by
    steplength_factor; alpha = 1 when nothing blocks."""
    gf = opts.gamma_f
    sf = opts.steplength_factor
    mu_full = F.mu_after_step(be, it, d, a_p_max, a_d_max) / opts.gamma_a

    ap_m, vp, dvp, gp, dgp, blk_p = F.find_blocking(be, it, d, primal=True)
    ad_m, vd, dvd, gd, dgd, blk_d = F.find_blocking(be, it, d, primal=False)
    # the alpha_max from the exact reduction equals the step_bounds_pd
    # values; use the passed ones (post-Gondzio they are identical)
    del ap_m, ad_m

    def side(a_max, other_max, val, dval, par, dpar, blocking):
        par_estim = par + other_max * dpar
        degenerate = jnp.abs(par_estim) < 1e-300
        alpha = (-val + mu_full / jnp.where(degenerate, 1.0, par_estim)) \
            / jnp.where(dval < 0, dval, -1.0)
        alpha = jnp.where(degenerate, 0.0, alpha)
        alpha = jnp.where(blocking, alpha, 1.0)
        # safeguard (reference :800-812)
        alpha = jnp.minimum(alpha, a_max)
        alpha = jnp.maximum(alpha, gf * a_max)
        return alpha * sf

    a_p = side(a_p_max, a_d_max, vp, dvp, gp, dgp, blk_p)
    a_d = side(a_d_max, a_p_max, vd, dvd, gd, dgd, blk_d)
    if opts.step_mode == StepMode.PRIMAL:
        a = jnp.minimum(a_p, a_d)
        return a, a
    return a_p, a_d


def _weighted_pc_search(be, it, d_aff, d_corr, opts: Options):
    """Weighted predictor-corrector line search (reference
    InteriorPointMethod.cpp:459-526): evaluate n_linesearch_points
    interpolates d(w) = d_aff + w (d_corr - d_aff), w in (0, 1], and keep
    the weight maximizing the combined step length."""
    n = max(opts.n_linesearch_points, 1)
    ws = jnp.linspace(1.0 / n, 1.0, n)

    d_delta = jax.tree.map(lambda a, b: b - a, d_aff, d_corr)

    def eval_w(w):
        dw = jax.tree.map(lambda a, dd: a + w * dd, d_aff, d_delta)
        a_p, a_d = _alphas(be, it, dw, opts)
        return a_p + a_d, a_p, a_d

    scores, aps, ads = jax.vmap(eval_w)(ws)
    best = jnp.argmax(scores)
    w_best = ws[best]
    d = jax.tree.map(lambda a, dd: a + w_best * dd, d_aff, d_delta)
    return d, aps[best], ads[best]
