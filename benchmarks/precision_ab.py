"""Precision A/B on one GPU: the measurement behind the factor dtype that
`resolve_factor_dtype` picks and the matmul precision bench.py uses.

  factor  the 102k-variable energy dispatch LP, presolved and
          equilibrium-scaled as the facade does it (x64 on), solved with
          f32 and with f64 factors: solve time of a warm run, IPM
          iterations, objective (compare with chip_smoke phase 3's HiGHS
          objective)
  matmul  the flagship 64 x 256 LP in f32 with f32 factors on the fused
          loop (bench.py's options, x64 off) at matmul precision
          "highest" (full f32) and "high" (TF32): status, iterations, TTO

Prints one JSON line per run, each with the device kind.

    python benchmarks/precision_ab.py [--only factor|matmul]
"""
import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pips_ipmpp_tpu.core.options import Options, ScalerType  # noqa: E402


def emit(**kw):
    kw["device_kind"] = jax.devices()[0].device_kind
    print(json.dumps(kw), flush=True)


def factor_ab():
    """Presolve + scale the energy LP once (as the facade does), then
    solve it with f32 and with f64 factors on the host loop."""
    from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
    from pips_ipmpp_tpu.io.energy import dispatch_blocks
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.presolve import Presolver
    from pips_ipmpp_tpu.scale import make_scaler

    jax.config.update("jax_enable_x64", True)
    blocks, first, leq, liq, _ = dispatch_blocks(
        T=96, R=150, G=550, L=350, S=4, seed=5)
    lp = make_arrowhead_lp(blocks, first, leq, liq, host=True)
    plog = Presolver().presolve(lp)
    slp = make_scaler(ScalerType.EQUILIBRIUM).scale(plog.lp)
    for fd in (jnp.float32, jnp.float64):
        solver = IPMSolver(partial(ArrowBackend, factor_dtype=fd),
                           Options())
        solver.solve(slp)                 # compile
        t0 = time.perf_counter()
        r = solver.solve(slp)
        emit(run="energy_102kvar", factor_dtype=jnp.dtype(fd).name,
             status=r.status.name, iterations=r.iterations,
             solve_s=time.perf_counter() - t0,
             objective=r.objective + plog.objective_offset)


def matmul_ab():
    import dataclasses

    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.scale import make_scaler

    jax.config.update("jax_enable_x64", False)   # as bench.py runs
    shape = dict(N=64, n=256, mE=128, mI=128, n0=64, m0E=32, m0I=32,
                 mEl=32, mIl=32)
    lp = make_scaler(ScalerType.EQUILIBRIUM).scale(
        random_arrowhead_lp(0, dtype=jnp.float32, **shape))
    lp2 = dataclasses.replace(lp, c0=lp.c0 * (1 + 1e-5), cN=lp.cN * (1 + 1e-5))
    for prec in ("highest", "high"):
        solver = IPMSolver(
            partial(ArrowBackend, factor_dtype=jnp.float32),
            Options(refinement_steps=0, max_gondzio_correctors=1,
                    matmul_precision=prec, residual_update_every=4))
        solver.solve_fused(lp)            # compile
        t0 = time.perf_counter()
        r = solver.solve_fused(lp2)
        emit(run="flagship_f32", matmul_precision=prec, status=r.status.name,
             iterations=r.iterations, tto_s=time.perf_counter() - t0,
             objective=r.objective, mu=r.mu)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["factor", "matmul"])
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("precision_ab: no GPU; nothing measured", file=sys.stderr)
        sys.exit(2)
    if args.only in (None, "matmul"):
        matmul_ab()
    if args.only in (None, "factor"):
        factor_ab()


if __name__ == "__main__":
    main()
