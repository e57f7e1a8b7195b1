"""Outer IPM loop: initial point, termination, regularization escalation.

Reimplements the reference's PIPSIPMppSolver::solve outer loop
(Core/InteriorPointMethod/PIPSIPMppSolver.cpp:29-194): evaluate residuals ->
unscaled gap/residual norm -> status (mu <= 1e-6 and resid <= 1e-4*||data||
-> success; divergence -> INFEASIBLE; slow convergence -> UNKNOWN; max 300
iterations) -> one predictor-corrector iteration.  The per-iteration work is
one jitted call; the Python loop only reads back a handful of scalars
(mirroring the reference where rank 0 prints per-iteration statistics).

Numerical-troubles handling: on a failed factorization (NaN/Inf in a
Cholesky factor) the primal/dual regularization ladder is escalated and the
iteration retried — the inertia-free analog of the reference's
factorize_with_correct_inertia loop (LinearSystem.C:296-325) with
Friedlander-Orban-style deltas (Core/KKTFormulation/LinearSystems/
RegularizationStrategy.h:15-38).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.ipm import formulation as F
from pips_ipmpp_tpu.ipm.mehrotra import ipm_step


# default persistent compile cache: a fixed path inside the checkout (the
# path is part of the cache key, so it must not move between runs)
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Directory of the persistent XLA compile cache on an accelerator:
    JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself), else
    REPO_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn on the persistent compile cache (fused-loop compiles take tens
    of seconds).  Returns the directory in use, or None on the CPU, whose
    cache entries are pinned to the host's CPU features (SIGILL risk
    across heterogeneous hosts)."""
    if jax.devices()[0].platform == "cpu":
        return None
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return compilation_cache_dir()


@dataclass
class IterationInfo:
    iteration: int
    mu: float
    residual_norm: float
    duality_gap: float
    objective: float
    alpha_primal: float
    alpha_dual: float
    sigma: float
    n_gondzio: int


@dataclass
class SolveResult:
    status: TerminationStatus
    iterate: F.Iterate
    iterations: int
    objective: float
    mu: float
    residual_norm: float
    history: list = field(default_factory=list)


def _eval_fn(be_ctor, lp, it):
    be = be_ctor(lp)
    res = F.compute_residuals(be, it)
    return (F.mu(be, it), F.residual_norm(res, be.axis),
            F.duality_gap(be, it), be.objective(it.x))


def _step_fn(be_ctor, opts, lp, it, dp, dd, k=None):
    be = be_ctor(lp)
    return ipm_step(be, it, dp, dd, opts, iteration=k)


def _init_fn(be_ctor, opts, lp):
    be = be_ctor(lp)
    datanorm = be.datanorm()
    shift = jnp.sqrt(datanorm)
    it = F.initial_iterate(be, shift)
    # one affine solve from the pushed point, full step, then re-shift
    # (reference Solver.cpp:16-31)
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, opts.primal_regularization,
                       opts.dual_regularization)
    # the init point is a heuristic: if the f32 factorization fails at base
    # regularization (borderline-definite root Schur), redo it heavily
    # regularized rather than poisoning the iterate with NaN
    ok = be.factorization_ok(fac)
    big = 1e-6 * (1.0 + datanorm)
    fac = jax.lax.cond(ok, lambda: fac,
                       lambda: be.factorize(Dx, Ominv, big, big))
    comp = F.comp_rhs_affine(be, it)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, opts.refinement_steps)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)
    it = F.take_step(it, d, 1.0, 1.0)
    viol = F.violation(be, it)
    it = F.shift_bound_variables(be, it, 1e3 + 2.0 * viol)
    return it, datanorm


class IPMSolver:
    """Drives the IPM to termination over any backend family.

    `be_ctor(lp) -> backend` must be traceable (called inside jit with the
    LP pytree as argument, so problem data is not baked into the
    executable)."""

    def __init__(self, be_ctor: Callable, opts: Optional[Options] = None,
                 troubles_hook: Optional[Callable] = None):
        # f32 matmuls may run in reduced precision (TF32 on the GPU at
        # "high"/"default"), which costs the factorization accuracy the
        # IPM needs; Options.matmul_precision defaults to "highest" (full
        # f32).  No effect on f64 matmuls.
        jax.config.update("jax_default_matmul_precision",
                          (opts or Options()).matmul_precision)
        enable_compilation_cache()
        self.opts = opts or Options()
        # `troubles_hook() -> be_ctor | None` is consulted when the
        # regularization ladder is exhausted: it may relax the backend
        # (e.g. SCsparsifier.decrease_diag_dom_bound -> a less aggressive
        # preconditioner, the reference's InteriorPointMethod.cpp:629-637)
        # and return a replacement constructor, triggering a re-jit
        self.troubles_hook = troubles_hook
        self._set_ctor(be_ctor)

    def _set_ctor(self, be_ctor: Callable):
        self.be_ctor = be_ctor
        self._step = jax.jit(partial(_step_fn, be_ctor, self.opts))
        self._eval = jax.jit(partial(_eval_fn, be_ctor))
        self._init = jax.jit(partial(_init_fn, be_ctor, self.opts))
        self._datanorm = jax.jit(lambda lp: be_ctor(lp).datanorm())
        if hasattr(self, "_fused"):
            del self._fused

    def _assert_precision(self):
        """jax_default_matmul_precision is PROCESS-GLOBAL and baked in at
        trace time: another solver constructed later with a different
        matmul_precision would silently retrace this solver's functions
        under its setting.  Re-assert our own setting at every solve
        entry so construction order cannot change numerics."""
        if jax.config.jax_default_matmul_precision != \
                self.opts.matmul_precision:
            jax.config.update("jax_default_matmul_precision",
                              self.opts.matmul_precision)

    def solve(self, lp, callback=None, checkpoint_path: str | None = None,
              checkpoint_every: int = 10,
              resume: bool = False) -> SolveResult:
        opts = self.opts
        self._assert_precision()
        mu_tol, res_tol = opts.tolerances()

        from pips_ipmpp_tpu.ipm.regularization import make_regularization
        strat = make_regularization(opts)
        rdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        rstate = strat.init_state(rdt)
        k0 = 0

        import os
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            from pips_ipmpp_tpu.ipm.checkpoint import load_checkpoint
            it, k0, dp_c, dd_c, _ = load_checkpoint(checkpoint_path)
            rstate = (jnp.asarray(dp_c, rdt),
                      jnp.asarray(dd_c, rdt), rstate[2])
            datanorm = float(self._datanorm(lp))
        else:
            it, datanorm = self._init(lp)
            datanorm = float(datanorm)

        history: list[IterationInfo] = []
        status = TerminationStatus.MAX_ITS_EXCEEDED
        mu_v = res_v = float("nan")
        best_mu = float("inf")
        stall = 0
        n_steps = k0   # completed IPM steps (the reported iteration count)

        for k in range(k0, opts.max_iterations):
            # single host<->device roundtrip for all four scalars (per-scalar
            # float() costs one transfer each)
            mu_v, res_v, gap_v, obj_v = [
                float(v) for v in jax.device_get(self._eval(lp, it))]

            if opts.print_level >= 10:
                print(f"iter {k:3d}  obj {obj_v: .8e}  mu {mu_v:.3e}  "
                      f"resid {res_v:.3e}")

            # -- termination tests (reference compute_status :143-194) --
            if mu_v <= mu_tol and res_v <= res_tol * max(datanorm, 1.0):
                status = TerminationStatus.SUCCESSFUL_TERMINATION
                break
            # divergence is RELATIVE to the best mu seen, only after the
            # iteration has had a chance to settle (reference
            # PIPSIPMppSolver.cpp:164-169: iteration >= 10 and
            # phi >= 1e4 * phi_min) — an absolute cap would misreport big
            # LPs whose INITIAL mu already exceeds it as infeasible
            if not np.isfinite(mu_v) or (
                    k - k0 >= 10 and mu_v > opts.divergence_mu
                    and mu_v > 1e4 * best_mu):
                status = TerminationStatus.INFEASIBLE
                break
            # slow-progress detection (reference :176-185)
            if mu_v < best_mu * 0.999:
                best_mu, stall = mu_v, 0
            else:
                stall += 1
                if stall >= 30:
                    status = TerminationStatus.UNKNOWN
                    break

            rstate = strat.new_step(rstate)
            dp, dd = (float(v) for v in strat.deltas(rstate))
            new_it, stats = self._step(lp, it, dp, dd, k)
            stats_h = jax.device_get(stats)   # one transfer for all scalars
            ok = bool(stats_h.factor_ok)
            retries = 0
            while not ok and retries < opts.max_regularization_retries:
                # inertia-free escalation via the strategy schedule
                # (factorize_with_correct_inertia, LinearSystem.C:296-325)
                rstate = strat.on_failure(rstate, mu_v, retries)
                if bool(strat.give_up(rstate)):
                    break
                dp, dd = (float(v) for v in strat.deltas(rstate))
                new_it, stats = self._step(lp, it, dp, dd, k)
                stats_h = jax.device_get(stats)
                ok = bool(stats_h.factor_ok)
                retries += 1
            if not ok and self.troubles_hook is not None:
                new_ctor = self.troubles_hook()
                if new_ctor is not None:
                    self._set_ctor(new_ctor)
                    new_it, stats = self._step(lp, it, dp, dd, k)
                    stats_h = jax.device_get(stats)
                    ok = bool(stats_h.factor_ok)
            if not ok:
                status = TerminationStatus.UNKNOWN
                break

            it = new_it
            n_steps += 1
            if (checkpoint_path and checkpoint_every > 0
                    and (k + 1) % checkpoint_every == 0):
                from pips_ipmpp_tpu.ipm.checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, it, k + 1, dp, dd)
            if opts.record_history:
                history.append(IterationInfo(
                    iteration=k, mu=mu_v, residual_norm=res_v,
                    duality_gap=float(gap_v), objective=float(obj_v),
                    alpha_primal=float(stats_h.alpha_primal),
                    alpha_dual=float(stats_h.alpha_dual),
                    sigma=float(stats_h.sigma),
                    n_gondzio=int(stats_h.n_gondzio)))
            if callback is not None:
                callback(k, it, history[-1] if history else None)

        # final evaluation of the FINAL iterate: on the max-iterations
        # path the loop-top mu/residual belong to the pre-step iterate
        mu_v, res_v, _, obj_v = [
            float(v) for v in jax.device_get(self._eval(lp, it))]
        return SolveResult(status=status, iterate=it, iterations=n_steps,
                           objective=obj_v, mu=mu_v, residual_norm=res_v,
                           history=history)

    # ------------------------------------------------------------------
    def solve_fused_async(self, lp):
        """Dispatch one fully on-device solve WITHOUT synchronizing.

        Returns the raw (iterate, info) device pytree: dispatches queue
        behind each other on the device, so a stream of solves runs at
        device throughput — host latency is paid once, at the first
        fetch (production serving pattern; the reference's MPI
        outer loop synchronizes every iteration instead,
        PIPSIPMppSolver.cpp:29-194)."""
        from pips_ipmpp_tpu.ipm.device_loop import solve_on_device
        self._assert_precision()
        if not hasattr(self, "_fused"):
            self._fused = jax.jit(
                partial(solve_on_device, self.be_ctor, self.opts))
        return self._fused(lp)

    def solve_fused_batch_async(self, lps):
        """Run B independent same-shape LPs as ONE vmapped fused device
        program.  At small per-iteration shapes the IPM's solve phases
        are matvec-shaped (single RHS) and op-overhead-bound; vmapping
        the whole solve turns every matvec into a batch-B matmul — the
        production serving pattern for streams of scenario LPs.  The
        while_loop runs until the LAST instance converges (done
        instances are masked); per-instance iteration counters stop at
        their own convergence.  Returns the raw batched (iterate, info)
        pytree — index leaf b for instance b."""
        from pips_ipmpp_tpu.ipm.device_loop import solve_on_device
        self._assert_precision()
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *lps)
        if not hasattr(self, "_fused_batch"):
            self._fused_batch = jax.jit(jax.vmap(
                partial(solve_on_device, self.be_ctor, self.opts)))
        return self._fused_batch(stacked)

    def solve_fused(self, lp) -> SolveResult:
        """Fully on-device solve (lax.while_loop outer loop, one compile,
        zero host roundtrips until done) — see ipm.device_loop."""
        from pips_ipmpp_tpu.ipm.device_loop import decode_status
        it, info = self.solve_fused_async(lp)
        info_h = jax.device_get({k: v for k, v in info.items()
                                 if k != "history"})
        hist = jax.device_get(info["history"]) if self.opts.record_history \
            else None
        history = []
        if hist is not None:
            for i in range(int(info_h["iterations"])):
                history.append(IterationInfo(
                    iteration=i, mu=float(hist.mu[i]),
                    residual_norm=float(hist.residual[i]),
                    duality_gap=float("nan"),
                    objective=float(hist.objective[i]),
                    alpha_primal=float(hist.alpha_primal[i]),
                    alpha_dual=float(hist.alpha_dual[i]),
                    sigma=float("nan"), n_gondzio=-1))
        return SolveResult(
            status=decode_status(info_h["status"]), iterate=it,
            iterations=int(info_h["iterations"]),
            objective=float(info_h["objective"]),
            mu=float(info_h["mu"]),
            residual_norm=float(info_h["residual_norm"]),
            history=history)
