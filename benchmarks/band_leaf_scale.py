"""Banded-leaf scale demonstration: block row counts beyond what the dense
leaf path can hold.

For a blocks of `a` constraint rows, the dense leaf stores Neq + its
explicit inverse — 2 * N * a^2 floats — and forming Neq costs O(N a^2 n).
The banded backend (linalg/band_backend.py) stores 2 * N * a * b and costs
O(N a b n): at a = 12288 rows and bandwidth b ~ 64, that is a ~100x
memory/flop reduction, the regime of the reference's sparse leaf solver
(PardisoSchurSolver.C) where a dense [a, a] factor cannot exist.

Default compares banded vs dense factor+solve at a size both can run, then
runs the banded path at a size whose dense equivalent would need more
memory than the device has.  Prints one JSON line per phase.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--rows", type=int, default=4096,
                    help="constraint rows per block (mE + mI)")
    ap.add_argument("--n", type=int, default=2048, help="vars per block")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--big-rows", type=int, default=0,
                    help="banded-only run at this row count (0 = 3x --rows)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the platform "
                         "default, i.e. the GPU when available)")
    ap.add_argument("--skip-dense", action="store_true")
    ap.add_argument("--solve", action="store_true",
                    help="run full IPM solves instead of factor+solve")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    from pips_ipmpp_tpu.io.synthetic import banded_arrowhead_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.linalg.band_backend import (BandArrowBackend,
                                                    plan_banded)

    fd = jnp.float64 if args.cpu else jnp.float32
    dt = jnp.float64 if args.cpu else jnp.float32

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    def run(tag, be_ctor, lp):
        if args.solve:
            solver = IPMSolver(be_ctor)
            t0 = time.perf_counter()
            res = solver.solve_fused(lp)
            dt_s = time.perf_counter() - t0
            emit(phase=tag, mode="solve", status=int(res.status),
                 iters=int(res.iterations), obj=float(res.objective),
                 seconds=round(dt_s, 3))
            return
        be = be_ctor(lp)
        from pips_ipmpp_tpu.core.spaces import RVec, XVec
        Dx = XVec(jnp.ones(lp.n0, dt),
                  jnp.ones((lp.N, lp.n), dt))
        Ominv = RVec(jnp.ones(lp.m0I, dt),
                     jnp.ones((lp.N, lp.mI), dt), jnp.ones(lp.mIl, dt))
        fac_fn = jax.jit(lambda: be.factorize(Dx, Ominv, 1e-8, 1e-8))
        fac = jax.block_until_ready(fac_fn())  # compile+run
        t0 = time.perf_counter()
        fac = jax.block_until_ready(fac_fn())
        t_fac = time.perf_counter() - t0
        # one leaf multi-solve (the per-iteration unit of work)
        rng = np.random.default_rng(0)
        t = jnp.asarray(rng.normal(size=(lp.N, lp.mE + lp.mI, 8)), dt)
        sol_fn = jax.jit(lambda tt: be._apply_Ninv_multi(
            fac.L, fac.Ninv, tt.astype(be.factor_dtype)))
        out = jax.block_until_ready(sol_fn(t))
        t0 = time.perf_counter()
        out = jax.block_until_ready(sol_fn(t))
        t_sol = time.perf_counter() - t0
        # residual check: Neq out ?= t  via matvec with M, Einv, Fd
        M = jnp.concatenate([lp.B, lp.D], axis=1)
        outw = out.astype(dt)
        Neq_out = (jnp.einsum("iam,imc->iac", M,
                              jnp.einsum("ibm,ibc->imc", M, outw))
                   + jnp.concatenate(
                       [jnp.full((lp.N, lp.mE), 1e-8, dt),
                        jnp.ones((lp.N, lp.mI), dt) + 1e-8],
                       axis=1)[:, :, None] * outw)
        relerr = float(jnp.linalg.norm(Neq_out - t)
                       / jnp.maximum(jnp.linalg.norm(t), 1e-30))
        emit(phase=tag, mode="factor+solve", ok=bool(fac.ok),
             factorize_s=round(t_fac, 3), solve_s=round(t_sol, 4),
             leaf_solve_relerr=relerr)

    mE = mI = args.rows // 2
    lp = banded_arrowhead_lp(0, N=args.blocks, n=args.n, mE=mE, mI=mI,
                             window=args.window, dtype=dt)
    plan = plan_banded(lp)
    a = args.rows
    emit(phase="plan", rows=a, half_bandwidth=plan.half_bandwidth,
         panel=plan.panel, n_panels=plan.n_panels,
         dense_factor_mb=round(2 * args.blocks * a * a * 4 / 2**20, 1),
         band_factor_mb=round(
             2 * args.blocks * plan.n_panels * plan.panel**2 * 4 / 2**20,
             1))

    if not args.skip_dense:
        run("dense", partial(ArrowBackend, factor_dtype=fd), lp)
    run("banded", partial(BandArrowBackend, plan=plan, factor_dtype=fd), lp)

    big = args.big_rows or 3 * args.rows
    mEb = mIb = big // 2
    lp_big = banded_arrowhead_lp(1, N=args.blocks, n=args.n, mE=mEb,
                                 mI=mIb, window=args.window, dtype=dt)
    plan_big = plan_banded(lp_big)
    emit(phase="plan_big", rows=big, half_bandwidth=plan_big.half_bandwidth,
         panel=plan_big.panel,
         dense_factor_mb=round(2 * args.blocks * big * big * 4 / 2**20, 1),
         band_factor_mb=round(
             2 * args.blocks * plan_big.n_panels * plan_big.panel**2 * 4
             / 2**20, 1))
    run("banded_big", partial(BandArrowBackend, plan=plan_big,
                              factor_dtype=fd), lp_big)


if __name__ == "__main__":
    main()
