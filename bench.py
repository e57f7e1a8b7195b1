"""Headline benchmark: full IPM solves to optimality on production-shaped
arrowhead LPs (one GPU), fused on-device loop.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}; exits
non-zero without a line when JAX finds no GPU.

The headline metric is SUSTAINED IPM iterations/second across a stream
of converged solves of the flagship shape (64 blocks x 256 vars), the
whole stream vmapped into ONE fused on-device `lax.while_loop` program
(solve_fused_batch_async) — the production serving pattern for streams
of scenario LPs; per-iteration matvec-shaped phases run as batch-B
matmuls.  Each iteration = batched factorization of all block KKTs
(XLA batched Cholesky + explicit inverses) + Schur assembly + root
factorization + predictor/corrector/Gondzio solves + adaptive refinement.
Compile and timing use distinct input batches.

Extra keys (same line):
  single_solve_ms / tto_ms   one-solve latency incl. dispatch+fetch
                             (time-to-optimality)
  analytic_tflops_per_s      analytic FLOPs/iter (factorize dominates;
                             see _flops_per_iter) over sustained time
  cfg_512blk / cfg_linkdom   scale + linking-dominated configs
                             (BASELINE.json north-star shapes)
"""
import dataclasses
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _mark(name):
    print(f"[bench] {time.strftime('%H:%M:%S')} {name}", file=sys.stderr,
          flush=True)


# Debug filter: PIPS_BENCH_ONLY="cfg_a,cfg_b" runs only the named side
# configs (the flagship always runs — it defines the headline metric).
# Unset = run everything.
_ONLY = {k for k in os.environ.get("PIPS_BENCH_ONLY", "").split(",") if k}


def _want(key: str) -> bool:
    return not _ONLY or key in _ONLY


# f32 matmul precision of every config: "highest" (full f32); "high" is
# TF32 on the GPU
PRECISION = "highest"

# flagship: 64 scenario blocks, 256 vars / 128+128 rows each,
# 64 first-stage vars, 32+32 linking rows
SHAPE = dict(N=64, n=256, mE=128, mI=128, n0=64, m0E=32, m0I=32,
             mEl=32, mIl=32)
STREAM = 16


def _flops_per_iter(N, n, mE, mI, n0, mEl, mIl, n_core_solves=6):
    """Analytic per-iteration FLOPs of the fused arrowhead iteration
    (dominant terms; elementwise ops excluded)."""
    a = mE + mI
    nS = n0 + mEl + mIl
    fact = (2 * N * a * a * n          # Neq assembly  M Einv M'
            + (8 / 3) * N * a ** 3     # Cholesky + explicit inverse
            + 2 * N * a * n * nS       # border rhs
            + 2 * N * a * a * nS       # Um = Ninv @ rhs
            + 2 * N * a * n * nS       # Ux back-substitution
            + 2 * N * nS * (n0 * a + (mEl + mIl) * n))   # Schur contrib
    core = (2 * N * (2 * a * n + a * a)          # leaf solve
            + 2 * N * (n + a) * nS               # Ltsolve caches
            + 2 * N * (n0 * a + (mEl + mIl) * n))  # border products
    return fact + n_core_solves * core


def _stream_lps(lp, k):
    return [dataclasses.replace(lp, c0=lp.c0 * (1.0 + 1e-5 * i),
                                cN=lp.cN * (1.0 + 1e-5 * i))
            for i in range(k)]


def _run_config(solver, lps):
    """Compile + converged stream; returns (iters_total, sustained_s,
    single_solve_s, iters_single).

    The stream protocol is the BATCHED one: all solves vmapped into one
    device program (solve_fused_batch_async) — per-iteration matvec
    phases become batch-B matmuls, the production pattern for streams of
    scenario LPs.  Compile and timing use DISTINCT input batches."""
    from pips_ipmpp_tpu.core.status import TerminationStatus

    res = solver.solve_fused(lps[0])
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION, res.status
    t0 = time.perf_counter()
    res = solver.solve_fused(lps[0])
    single = time.perf_counter() - t0
    iters_single = res.iterations
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION

    # async serial stream (dispatches queue on device)
    t0 = time.perf_counter()
    outs = [solver.solve_fused_async(l) for l in lps]
    its_a = jax.device_get([o[1]["iterations"] for o in outs])
    sts_a = jax.device_get([o[1]["status"] for o in outs])
    t_async = time.perf_counter() - t0
    assert all(int(s) == 1 for s in sts_a), sts_a

    # batched stream (one vmapped program over half the stream)
    half = max(1, len(lps) // 2)
    warm, timed = lps[:half], lps[half:] or lps[:half]
    out = solver.solve_fused_batch_async(warm)    # compile + settle
    jax.device_get(out[1]["iterations"])
    t0 = time.perf_counter()
    out = solver.solve_fused_batch_async(timed)
    its_b = jax.device_get(out[1]["iterations"])
    sts_b = jax.device_get(out[1]["status"])
    t_batch = time.perf_counter() - t0
    assert all(int(s) == 1 for s in sts_b), sts_b

    rate_a = sum(int(v) for v in its_a) / t_async
    rate_b = sum(int(v) for v in its_b) / t_batch
    if rate_b > rate_a:
        return int(sum(its_b)), t_batch, single, iters_single
    return int(sum(its_a)), t_async, single, iters_single


def main():
    from pips_ipmpp_tpu.core.options import Options, ScalerType
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.scale import make_scaler

    dtype = jnp.float32
    # equilibrated f32 + explicit-inverse leaf factors; one Gondzio
    # corrector minimizes TTO.  residual_update_every=4: linear residual
    # updates between exact evaluations (the recover_step elimination
    # identities make the per-iteration residual matvecs redundant
    # between re-anchors)
    opts = Options(refinement_steps=0, max_gondzio_correctors=1,
                   matmul_precision=PRECISION, residual_update_every=4)
    scaler = make_scaler(ScalerType.EQUILIBRIUM)
    be_kw = dict(factor_dtype=dtype)

    # ---- flagship config ----
    lp = scaler.scale(random_arrowhead_lp(0, dtype=dtype, **SHAPE))
    solver = IPMSolver(partial(ArrowBackend, **be_kw), opts)
    iters, sustained, single_s, it1 = _run_config(
        solver, _stream_lps(lp, STREAM))
    fpi = _flops_per_iter(SHAPE["N"], SHAPE["n"], SHAPE["mE"], SHAPE["mI"],
                          SHAPE["n0"], SHAPE["mEl"], SHAPE["mIl"])
    dev = jax.devices()[0]
    out = {
        "metric": "ipm_iterations_per_s_64blk_256v",
        "value": iters / sustained,
        "unit": "iter/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "single_solve_ms": single_s * 1e3,
        "tto_ms": single_s * 1e3,
        "single_solve_iter_s": it1 / single_s,
        "analytic_tflops_per_s": fpi * iters / sustained / 1e12,
    }

    def _side_config(key, seed, sh, stream=4, flops=False):
        """Measure one side config; record its error distinctly."""
        if not _want(key):
            return
        _mark(key)
        try:
            lpc = scaler.scale(random_arrowhead_lp(seed, dtype=dtype, **sh))
            sv = IPMSolver(partial(ArrowBackend, **be_kw), opts)
            itc, susc, singc, _ = _run_config(sv, _stream_lps(lpc, stream))
            entry = {"iter_s": itc / susc, "tto_ms": singc * 1e3}
            if flops:
                fpi_c = _flops_per_iter(sh["N"], sh["n"], sh["mE"],
                                        sh["mI"], sh["n0"], sh["mEl"],
                                        sh["mIl"])
                entry["analytic_tflops_per_s"] = fpi_c * itc / susc / 1e12
            out[key] = entry
        except Exception as e:
            out[key] = {"error": str(e)[:120]}

    # ---- scale config: 512 blocks x 128 vars (BASELINE.json config #4) --
    _side_config("cfg_512blk_128v", 1,
                 dict(N=512, n=128, mE=64, mI=64, n0=64, m0E=16, m0I=16,
                      mEl=16, mIl=16))

    # ---- linking-dominated config: Schur size nS = 448 ----
    _side_config("cfg_linkdom_nS448", 2,
                 dict(N=32, n=128, mE=64, mI=64, n0=64, m0E=16, m0I=16,
                      mEl=192, mIl=192))

    # ---- big-leaf config: factorize FLOPs dominate dispatch latency ----
    _side_config("cfg_bigleaf_64blk_1024v", 3,
                 dict(N=64, n=1024, mE=512, mI=512, n0=64, m0E=32, m0I=32,
                      mEl=32, mIl=32), stream=4, flops=True)

    # ---- real-world class: 102k-var energy dispatch/expansion TTO,
    # reported as the FULL pipeline split (presolve / scale / solve /
    # postsolve — the reference Interface prints the same phases,
    # PIPSIPMppInterface.cpp:53-129).  solve_ms keeps the reused-solver
    # perturbed-instance protocol (compile excluded, like every config);
    # presolve/scale/postsolve are host-or-small phases timed directly.
    def run_energy():
        import numpy as _np

        from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
        from pips_ipmpp_tpu.io.energy import dispatch_blocks
        from pips_ipmpp_tpu.presolve import Presolver
        blocks, first, leq, liq, meta = dispatch_blocks(
            T=96, R=150, G=550, L=350, S=4, seed=5)
        # host=True: presolve is host-side numpy
        elp = make_arrowhead_lp(blocks, first, leq, liq,
                                dtype=jnp.float64, host=True)
        t0 = time.perf_counter()
        plog = Presolver(max_rounds=2).presolve(elp)
        presolve_s = time.perf_counter() - t0
        _mark("energy: presolve done")
        plp = plog.lp.astype(dtype)
        # warm the scaling program (compile excluded, like the solve)
        _w = scaler.scale(plp)
        jax.device_get(jax.tree.leaves(_w)[0])
        _mark("energy: scale warmed")
        plp2 = dataclasses.replace(plp, c0=plp.c0 * (1 + 1e-9))
        t0 = time.perf_counter()
        slp = scaler.scale(plp2)
        jax.device_get(jax.tree.leaves(slp)[0])
        scale_s = time.perf_counter() - t0
        sv = IPMSolver(partial(ArrowBackend, factor_dtype=dtype),
                       Options(max_gondzio_correctors=1,
                               refinement_steps=2,
                               matmul_precision=PRECISION))
        _mark("energy: solve stream (compile on first call)")
        it_e, sus_e, sing_e, it1_e = _run_config(sv, _stream_lps(slp, 2))
        _mark("energy: solve stream done")
        # postsolve: reverse-replay the reductions on the solution
        # (host; the facade's gather path does the same work)
        from pips_ipmpp_tpu.presolve.postsolve import Postsolver, Solution
        r = sv.solve_fused(slp)   # reuse the compiled fused program
        it = r.iterate
        g = jax.device_get
        t0 = time.perf_counter()
        sol = Solution(
            x0=_np.array(g(it.x.first), _np.float64),
            xN=_np.array(g(it.x.blocks), _np.float64),
            y0=_np.array(g(it.y.first), _np.float64),
            yN=_np.array(g(it.y.blocks), _np.float64),
            yl=_np.array(g(it.y.link), _np.float64),
            z0=_np.array(g(it.z.first), _np.float64),
            zN=_np.array(g(it.z.blocks), _np.float64),
            zl=_np.array(g(it.z.link), _np.float64))
        Postsolver(elp).postsolve(plog.events, sol)
        postsolve_s = time.perf_counter() - t0
        return (it_e, sus_e, sing_e, it1_e, presolve_s, scale_s,
                postsolve_s)

    if _want("cfg_energy_102kvar"):
        _mark("cfg_energy_102kvar")
        try:
            (it_e, sus_e, sing_e, it1_e, pre_s, sc_s, post_s) = run_energy()
            out["cfg_energy_102kvar"] = {
                "presolve_ms": pre_s * 1e3,
                "scale_ms": sc_s * 1e3,
                "solve_ms": sing_e * 1e3,
                "postsolve_ms": post_s * 1e3,
                "tto_ms": (pre_s + sc_s + sing_e + post_s) * 1e3,
                "iters": int(it1_e),
                "iter_s": it_e / sus_e}
        except Exception as e:
            out["cfg_energy_102kvar"] = {"error": str(e)[:120]}

    # ---- sparse instance, DENSIFIED (sparse_densify_max_mb routes
    # in-budget sparse LPs to the batched-dense path) ----
    def run_sparse_densified():
        from pips_ipmpp_tpu.core.sparse import dense_from_sparse
        from pips_ipmpp_tpu.core.status import TerminationStatus
        from pips_ipmpp_tpu.io.synthetic import random_sparse_arrowhead_lp
        slp = random_sparse_arrowhead_lp(
            0, N=8, n=2048, mE=1024, mI=1024, nnz_per_row=10,
            n0=16, m0E=4, m0I=4, mEl=4, mIl=4, dtype=dtype)
        dlp = scaler.scale(dense_from_sparse(slp))
        sv = IPMSolver(partial(ArrowBackend, **be_kw), opts)
        r = sv.solve_fused(dlp)
        assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
            r.status
        dlp2 = dataclasses.replace(dlp, c0=dlp.c0 * (1 + 1e-6))
        t0 = time.perf_counter()
        r = sv.solve_fused(dlp2)
        dtt = time.perf_counter() - t0
        assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
            r.status
        return r.iterations, dtt

    if _want("cfg_sparse_8x2048_densified"):
        _mark("cfg_sparse_8x2048_densified")
        try:
            its_d, t_d = run_sparse_densified()
            out["cfg_sparse_8x2048_densified"] = {
                "tto_ms": t_d * 1e3, "iters": int(its_d)}
        except Exception as e:
            out["cfg_sparse_8x2048_densified"] = {"error": str(e)[:120]}

    # ---- genuinely sparse leaf (ELL gathers + CG): converged
    # non-densified TTO.  cg_iters=100 + the reference's reduced-accuracy
    # targets (IP_ACCURACY_REDUCED: mu 1e-5 / resid 1e-3) match the f32
    # CG accuracy floor.
    def run_sparse_cfg(n, mE, mI):
        from pips_ipmpp_tpu.core.status import TerminationStatus
        from pips_ipmpp_tpu.io.synthetic import random_sparse_arrowhead_lp
        from pips_ipmpp_tpu.linalg.sparse_backend import SparseArrowBackend
        slp = random_sparse_arrowhead_lp(
            0, N=8, n=n, mE=mE, mI=mI, nnz_per_row=10,
            n0=16, m0E=4, m0I=4, mEl=4, mIl=4, dtype=dtype)
        sv = IPMSolver(partial(SparseArrowBackend, factor_dtype=dtype,
                               cg_iters=100),
                       Options(max_gondzio_correctors=1,
                               refinement_steps=2,
                               reduced_accuracy=True,
                               matmul_precision=PRECISION))
        r = sv.solve(slp)
        assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
            r.status
        slp2 = dataclasses.replace(slp, c0=slp.c0 * (1 + 1e-6))
        t0 = time.perf_counter()
        r = sv.solve(slp2)         # distinct input
        dtt = time.perf_counter() - t0
        assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
            r.status
        return r.iterations, dtt

    # ---- 8 x 8192-row blocks: the dense twin (~2 GB) is over the 256 MB
    # default densify budget — the regime where the reference's PARDISO
    # sparse leaves are mandatory, PardisoSchurSolver.C:84 ----
    for key, (n, mE, mI) in (("cfg_sparse_8x2048", (2048, 1024, 1024)),
                             ("cfg_sparse_8x8192", (8192, 4096, 4096))):
        if not _want(key):
            continue
        _mark(key)
        try:
            its_s, t_s = run_sparse_cfg(n, mE, mI)
            out[key] = {"tto_ms": t_s * 1e3, "iters": int(its_s)}
        except Exception as e:
            out[key] = {"error": str(e)[:120]}

    print(json.dumps(out))


if __name__ == "__main__":
    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform "
              f"{jax.devices()[0].platform!r}); nothing measured",
              file=sys.stderr)
        sys.exit(2)
    main()
