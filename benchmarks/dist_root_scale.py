"""Distributed-root scale demonstration: linking dimensions beyond what a
replicated root can hold per device.

Solves an arrowhead LP with --link-rows linking rows (default 4096+) on an
8-virtual-device CPU mesh (or the GPUs of one host, --real-mesh) with the
column-sharded root (`dist_root=True`): the persistent root factor per
device is nD * nD/P floats instead of the replicated ~3 * nD^2 (chol2 +
Sdual + T or the explicit inverses), and the O(nD^3) factorization flops
are split P ways.

Prints one JSON line per phase.  Use --link-rows 1024 for a quick run.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--link-rows", type=int, default=4096,
                    help="total linking rows (split eq/ineq)")
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--n", type=int, default=128, help="vars per block")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--solve", action="store_true",
                    help="run the full IPM to convergence (slow on CPU); "
                         "default does factorize + root-solve consistency")
    ap.add_argument("--real-mesh", action="store_true",
                    help="use the default platform's devices (the GPUs of "
                         "this host) instead of a CPU virtual mesh")
    args = ap.parse_args()

    # the virtual mesh needs the flag BEFORE backend init: append to
    # whatever XLA_FLAGS holds, then force the CPU platform below
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax

    # probing jax.devices() would initialize the default backend and make
    # the platform switch a no-op, so decide from the flag alone
    if not args.real_mesh:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from functools import partial
    from pips_ipmpp_tpu.core.options import Options
    from pips_ipmpp_tpu.core.spaces import RVec, XVec
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.parallel.dist_solver import DistributedIPMSolver
    from pips_ipmpp_tpu.parallel.mesh import (BLOCK_AXIS, lp_pspecs,
                                              make_mesh, shard_arrowhead_lp)

    P = args.devices
    mEl = mIl = args.link_rows // 2
    m0 = 32
    nD = 2 * m0 + mEl + mIl
    assert nD % P == 0, f"nD={nD} must divide {P}"
    dtype = jnp.float32
    lp = random_arrowhead_lp(5, N=args.blocks, n=args.n, mE=args.n // 2,
                             mI=args.n // 2, n0=64, m0E=m0, m0I=m0,
                             mEl=mEl, mIl=mIl, dtype=dtype)
    mesh = make_mesh(P)
    t0 = time.perf_counter()

    if args.solve:
        opts = Options(refinement_steps=2, max_gondzio_correctors=1)
        solver = DistributedIPMSolver(mesh, opts, mode="shard_map",
                                      factor_dtype=dtype, dist_root=True)
        r = solver.solve(lp)
        print(json.dumps({
            "metric": "dist_root_solve", "link_rows": args.link_rows,
            "status": str(r.status), "iterations": int(r.iterations),
            "objective": float(r.objective),
            "seconds": round(time.perf_counter() - t0, 2)}))
        return

    # factorize + one root solve, dist vs replicated consistency + memory
    lps = shard_arrowhead_lp(lp, mesh)
    specs = lp_pspecs(lps)
    from jax.sharding import PartitionSpec as Pspec

    def fact_and_solve(lp, dist):
        kw = dict(factor_dtype=dtype, axis=BLOCK_AXIS,
                  blockwise_sc=256 if dist else 0)
        if dist:
            kw.update(dist_root=True, n_shards=P)
        be = ArrowBackend(lp, **kw)
        Dx = XVec(jnp.ones((lp.n0,), dtype), jnp.ones((lp.N, lp.n), dtype))
        Ominv = RVec(jnp.ones((lp.m0I,), dtype),
                     jnp.ones((lp.N, lp.mI), dtype),
                     jnp.ones((lp.mIl,), dtype))
        fac = be.factorize(Dx, Ominv, 1e-6, 1e-6)
        p = jnp.ones((lp.n0,), dtype)
        q = jnp.ones((lp.m0E + lp.m0I + lp.mEl + lp.mIl,), dtype)
        a, d = be._root_solve(fac, p, q)
        root_bytes = sum(
            v.size * v.dtype.itemsize for v in
            (fac.Wd, fac.chol1, fac.T, fac.chol2, fac.Sdinv, fac.S11inv)
            if hasattr(v, "size") and v.ndim >= 2)
        return a, d, jnp.asarray(root_bytes // (1 if dist else 1))

    out_specs = (Pspec(), Pspec(), Pspec())
    runs = {}
    for dist in (True, False):
        f = jax.jit(jax.shard_map(
            partial(fact_and_solve, dist=dist), mesh=mesh,
            in_specs=(specs,), out_specs=out_specs, check_vma=False))
        t1 = time.perf_counter()
        a, d, root_bytes = jax.device_get(f(lps))
        runs[dist] = (a, d, int(root_bytes))
        print(json.dumps({
            "metric": "dist_root_factorize" if dist else "replicated_root",
            "nD": nD, "per_device_root_factor_MB":
                round(int(root_bytes) / 2**20, 1),
            "seconds": round(time.perf_counter() - t1, 2)}))

    import numpy as np
    err = max(float(np.max(np.abs(runs[True][0] - runs[False][0]))),
              float(np.max(np.abs(runs[True][1] - runs[False][1]))))
    rel = err / max(1e-30, float(np.max(np.abs(runs[False][1]))))
    print(json.dumps({
        "metric": "dist_vs_replicated_root_solve_relerr", "value": rel,
        "memory_ratio": runs[False][2] / max(runs[True][2], 1)}))


if __name__ == "__main__":
    main()
