"""Weak-scaling harness: IPM iterations/s as blocks-per-device is held
constant while the mesh grows (the north-star metric: >=0.8 weak-scaling
efficiency from 1 to N devices, BASELINE.md).

With --cpu this exercises an 8-device virtual CPU mesh; on a host with
several GPUs (4 H100s joined all to all by NVLink) the same script
measures multi-GPU scaling. Prints one JSON line per mesh size + a
summary.
"""
import argparse
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks-per-device", type=int, default=8)
    ap.add_argument("--n", type=int, default=64, help="vars per block")
    ap.add_argument("--mE", type=int, default=32)
    ap.add_argument("--mI", type=int, default=32)
    ap.add_argument("--mode", default="shard_map",
                    choices=["shard_map", "gspmd"])
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU with 8 virtual devices")
    args = ap.parse_args()

    if args.cpu:
        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from pips_ipmpp_tpu.core.options import Options, ScalerType
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.parallel.dist_solver import DistributedIPMSolver
    from pips_ipmpp_tpu.parallel.mesh import make_mesh
    from pips_ipmpp_tpu.scale import make_scaler

    ndev_avail = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev_avail]
    dtype = (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    opts = Options(refinement_steps=4, max_gondzio_correctors=2)

    results = []
    for nd in sizes:
        N = args.blocks_per_device * nd
        lp = random_arrowhead_lp(0, dtype=dtype, N=N, n=args.n, mE=args.mE,
                                 mI=args.mI, n0=16, m0E=8, m0I=8,
                                 mEl=8, mIl=8)
        lp = make_scaler(ScalerType.EQUILIBRIUM).scale(lp)
        solver = DistributedIPMSolver(make_mesh(nd), opts, mode=args.mode,
                                      factor_dtype=dtype)
        r = solver.solve(lp)          # warm-up + compile
        t0 = time.perf_counter()
        r = solver.solve(lp)
        dt = time.perf_counter() - t0
        ips = r.iterations / dt
        results.append((nd, ips, r.iterations, r.status.name))
        print(json.dumps({"devices": nd, "blocks": N,
                          "iters_per_s": round(ips, 3),
                          "iterations": r.iterations,
                          "status": r.status.name}), flush=True)

    base = results[0][1]
    for nd, ips, _, _ in results:
        eff = ips / base
        print(json.dumps({"devices": nd,
                          "weak_scaling_efficiency": round(eff, 3)}))


if __name__ == "__main__":
    main()
