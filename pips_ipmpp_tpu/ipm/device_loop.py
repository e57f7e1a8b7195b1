"""Fully on-device IPM solve: the entire outer loop (residual evaluation,
termination tests, regularization escalation, predictor-corrector step) runs
inside one jitted `lax.while_loop` — zero host<->device roundtrips until the
solve finishes.

This replaces the reference's rank-0-driven outer loop
(PIPSIPMppSolver.cpp:29-194): where MPI ranks synchronize per iteration
anyway, a single-controller program pays a host round trip per sync, so
the control flow moves onto the device.  Per-iteration statistics are
written into preallocated arrays and fetched once at the end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.ipm import formulation as F
from pips_ipmpp_tpu.ipm.mehrotra import ipm_step
from pips_ipmpp_tpu.ipm.solver import _init_fn

# status codes inside the device loop
RUNNING = 0
SUCCESS = 1
INFEASIBLE = 2
STALLED = 3
FACTOR_FAIL = 4


@dataclass
class FusedHistory:
    mu: Any
    residual: Any
    objective: Any
    alpha_primal: Any
    alpha_dual: Any


jax.tree_util.register_pytree_node(
    FusedHistory,
    lambda h: ((h.mu, h.residual, h.objective, h.alpha_primal,
                h.alpha_dual), None),
    lambda _, c: FusedHistory(*c))


def solve_on_device(be_ctor, opts: Options, lp):
    """Run the full solve on device. Returns (iterate, info dict of arrays).

    Traceable end-to-end: call under jit (or shard_map) with the LP pytree."""
    mu_tol, res_tol = opts.tolerances()
    max_it = opts.max_iterations

    be = be_ctor(lp)
    it0, datanorm = _init_fn(be_ctor, opts, lp)
    res_scale = res_tol * jnp.maximum(datanorm, 1.0)

    hist0 = FusedHistory(
        mu=jnp.full((max_it,), jnp.nan, datanorm.dtype),
        residual=jnp.full((max_it,), jnp.nan, datanorm.dtype),
        objective=jnp.full((max_it,), jnp.nan, datanorm.dtype),
        alpha_primal=jnp.full((max_it,), jnp.nan, datanorm.dtype),
        alpha_dual=jnp.full((max_it,), jnp.nan, datanorm.dtype))

    from pips_ipmpp_tpu.ipm.regularization import make_regularization
    strat = make_regularization(opts)
    rstate0 = strat.init_state(datanorm.dtype)

    def eval_all(it):
        res = F.compute_residuals(be, it)
        return res, (F.mu(be, it), F.residual_norm(res, be.axis),
                     be.objective(it.x))

    # linear residual updates (options.residual_update_every): carry the
    # residual pytree and scale primal rows by (1-alpha_p) / dual rows by
    # (1-alpha_d) after each step — exact for the eliminated rows by
    # construction (recover_step identities; correctors solve with ZERO
    # residual rows so weighted additions keep them homogeneous), and
    # accurate to reduced-solve error for rL/rA/rC.  Exact re-evaluation
    # happens every k steps and whenever mu nears tolerance, so the
    # termination test always sees freshly evaluated residuals.
    upd_every = max(int(opts.residual_update_every), 0)

    def cond(carry):
        (it, k, turns, rstate, attempt, status, best_mu, stall, hist,
         res_c, since) = carry
        return (status == RUNNING) & (k < max_it)

    def body(carry):
        (it, k, turns, rstate, attempt, status, best_mu, stall, hist,
         res_c, since) = carry
        if upd_every == 0:
            res_it, (mu_v, res_v, obj_v) = eval_all(it)
            since2 = since
        else:
            mu_v = F.mu(be, it)
            due = (since >= upd_every) | (mu_v <= 4.0 * mu_tol) | (k == 0)
            res_it = jax.lax.cond(
                due, lambda: F.compute_residuals(be, it), lambda: res_c)
            since2 = jnp.where(due, 0, since)
            res_v = F.residual_norm(res_it, be.axis)
            obj_v = be.objective(it.x)
        # a retry turn re-evaluates the UNCHANGED iterate after a failed
        # factorization: it must not advance the stall detector
        is_retry = attempt > 0

        converged = (mu_v <= mu_tol) & (res_v <= res_scale)
        # relative divergence test after a settling period (reference
        # PIPSIPMppSolver.cpp:164-169), matching the host loop: big LPs
        # legitimately START with mu above any absolute cap
        diverged = ~jnp.isfinite(mu_v) | (
            (k >= 10) & (mu_v > opts.divergence_mu)
            & (mu_v > 1e4 * best_mu))
        improving = mu_v < best_mu * 0.999
        stall = jnp.where(is_retry, stall,
                          jnp.where(improving, 0, stall + 1))
        best_mu = jnp.where(is_retry, best_mu,
                            jnp.minimum(best_mu, mu_v))
        stalled = stall >= 30

        new_status = jnp.where(
            converged, SUCCESS,
            jnp.where(diverged, INFEASIBLE,
                      jnp.where(stalled, STALLED, RUNNING))).astype(jnp.int32)

        def do_step(args):
            it, rstate, attempt = args
            # a fresh IPM iteration advances the strategy schedule; a
            # retry after a failed factorization does not (reference
            # notify_new_step vs get_regularization_parameters)
            ns = strat.new_step(rstate)
            rs = jax.tree.map(
                lambda a, b: jnp.where(attempt == 0, a, b), ns, rstate)
            dp, dd = strat.deltas(rs)
            # res_it: the residuals eval_all just computed for this very
            # iterate — reuse instead of recomputing across the cond
            new_it, stats = ipm_step(be, it, dp, dd, opts, iteration=k,
                                     res=res_it)
            ok = stats.factor_ok
            # on factorization failure: keep iterate, escalate via the
            # strategy (inertia-free; retried next loop turn)
            kept = jax.tree.map(
                lambda a, b: jnp.where(ok, a, b), new_it, it)
            fs = strat.on_failure(rs, mu_v, attempt)
            rs2 = jax.tree.map(
                lambda a, b: jnp.where(ok, a, b), rs, fs)
            attempt2 = jnp.where(ok, 0, attempt + 1)
            too_big = ~ok & (strat.give_up(rs2)
                             | (attempt2 > opts.max_regularization_retries))
            return kept, rs2, attempt2, stats, too_big

        def no_step(args):
            it, rstate, attempt = args
            from pips_ipmpp_tpu.ipm.mehrotra import StepStats
            zero = jnp.zeros((), mu_v.dtype)
            stats = StepStats(mu=mu_v, sigma=zero, alpha_primal=zero,
                              alpha_dual=zero,
                              n_gondzio=jnp.zeros((), jnp.int32),
                              factor_ok=jnp.asarray(True))
            return it, rstate, attempt, stats, jnp.asarray(False)

        it2, rstate2, attempt2, stats, reg_fail = jax.lax.cond(
            new_status == RUNNING, do_step, no_step, (it, rstate, attempt))
        new_status = jnp.where(reg_fail, FACTOR_FAIL,
                               new_status).astype(jnp.int32)

        # `k` counts completed IPM STEPS (matching the host loop): retry
        # turns and the terminal evaluation turn neither consume the
        # iteration budget nor write a history row (mode="drop" discards
        # the out-of-range write on non-step turns)
        stepped = (new_status == RUNNING) & stats.factor_ok
        row = jnp.where(stepped, k, max_it)
        hist = FusedHistory(
            mu=hist.mu.at[row].set(mu_v, mode="drop"),
            residual=hist.residual.at[row].set(res_v, mode="drop"),
            objective=hist.objective.at[row].set(obj_v, mode="drop"),
            alpha_primal=hist.alpha_primal.at[row].set(
                stats.alpha_primal, mode="drop"),
            alpha_dual=hist.alpha_dual.at[row].set(
                stats.alpha_dual, mode="drop"))
        if upd_every == 0:
            res_c2, since3 = res_c, since2
        else:
            fp = 1.0 - stats.alpha_primal
            fd = 1.0 - stats.alpha_dual
            scaled = F.Residuals(
                rL=jax.tree.map(lambda a: a * fd, res_it.rL),
                rA=jax.tree.map(lambda a: a * fp, res_it.rA),
                rC=jax.tree.map(lambda a: a * fp, res_it.rC),
                rz=jax.tree.map(lambda a: a * fd, res_it.rz),
                rv=jax.tree.map(lambda a: a * fp, res_it.rv),
                rw=jax.tree.map(lambda a: a * fp, res_it.rw),
                rt=jax.tree.map(lambda a: a * fp, res_it.rt),
                ru=jax.tree.map(lambda a: a * fp, res_it.ru))
            res_c2 = jax.tree.map(
                lambda a, b: jnp.where(stepped, a, b), scaled, res_it)
            since3 = jnp.where(stepped, since2 + 1, since2)
        return (it2, k + stepped.astype(k.dtype), turns + 1, rstate2,
                attempt2, new_status, best_mu, stall, hist, res_c2,
                since3)

    res0 = F.compute_residuals(be, it0)
    init = (it0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            rstate0, jnp.zeros((), jnp.int32),
            jnp.asarray(RUNNING, jnp.int32),
            jnp.asarray(jnp.inf, datanorm.dtype),
            jnp.zeros((), jnp.int32), hist0, res0,
            jnp.zeros((), jnp.int32))
    (it, k, turns, rstate, _, status, _, _, hist, _, _) = jax.lax.while_loop(
        cond, body, init)
    dp, dd = strat.deltas(rstate)
    _, (mu_f, res_f, obj_f) = eval_all(it)
    # `turns` = while-loop body executions: iterations + factorization
    # retries + the terminal evaluation turn.  turns - iterations - 1 is
    # the wasted-work count (each retry re-runs the full iteration body).
    info = dict(status=status, iterations=k, turns=turns, mu=mu_f,
                residual_norm=res_f, objective=obj_f, history=hist,
                delta_p=dp, delta_d=dd)
    return it, info


_STATUS_MAP = {
    SUCCESS: TerminationStatus.SUCCESSFUL_TERMINATION,
    INFEASIBLE: TerminationStatus.INFEASIBLE,
    STALLED: TerminationStatus.UNKNOWN,
    FACTOR_FAIL: TerminationStatus.UNKNOWN,
    RUNNING: TerminationStatus.MAX_ITS_EXCEEDED,
}


def decode_status(code: int) -> TerminationStatus:
    return _STATUS_MAP[int(code)]
