#!/usr/bin/env python3
"""Smoke test of the structured IPM on an NVIDIA GPU.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only: the 4-card mesh

Phases:
  0  device and environment (no GPU -> exit non-zero, no CPU fallback)
  1  f32 matmul precision probe ("highest" vs numpy f64; "high" = TF32)
  2  the hot path's XLA kernels against numpy/scipy at real widths
     (tests/test_xla_kernels.py, the `gpu` checks, run in-process)
  3  102k-variable energy dispatch LP through the facade (presolve +
     equilibrium scaling) against the HiGHS oracle
  4  flagship 64 x 256 LP on the fused on-device loop, single solve and a
     4-LP batched stream, against an f64 solve of the same scaled LP
     flattened to dense normal equations
  5  8 x 2048-row sparse LP on the ELL + CG leaf (densify budget 0)
     against the densified solve
  6  (--four-cards) 512-block LP on a 4-card mesh in every distributed
     mode against the single-card solve

Each phase prints one line with its numbers, the JAX device kind and the
card's name and power limit.  A failing check raises, so the script exits
non-zero before the last line; the last line is the JSON result
{"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def nvidia_smi() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


class Reporter:
    def __init__(self, kind: str, smi: str):
        self.kind, self.smi = kind, smi

    def line(self, phase: str, numbers: dict):
        print(f"[phase {phase}] {json.dumps(numbers)} | device_kind="
              f"{self.kind} | nvidia-smi: {self.smi}", flush=True)


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def peak_bytes(dev):
    """Device peak bytes in use (None where the backend keeps no stats)."""
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def note(msg: str):
    """Progress line on stderr (the phase lines go to stdout)."""
    print(f"[chip_smoke {time.perf_counter() - T0:9.1f}s] {msg}",
          file=sys.stderr, flush=True)


T0 = time.perf_counter()


# ---- HiGHS oracle: scipy only, in a child process that never imports
# JAX, so it runs on the host CPU while the parent drives the card ----

def oracle_child(npz_path: str, out_path: str):
    """Child-process entry: solve the LP stored in `npz_path` with scipy
    HiGHS and write {"objective", "seconds", "message"} to `out_path`."""
    import scipy.sparse as sp
    from scipy.optimize import linprog
    d = np.load(npz_path)
    mat = lambda k: sp.csr_matrix((d[k + "_data"], d[k + "_indices"],  # noqa
                                   d[k + "_indptr"]), shape=d[k + "_shape"])
    t0 = time.perf_counter()
    res = linprog(d["c"], A_ub=mat("A_ub"), b_ub=d["b_ub"],
                  A_eq=mat("A_eq"), b_eq=d["b_eq"], bounds=d["bounds"],
                  method="highs")
    with open(out_path, "w") as fh:
        json.dump(dict(objective=float(res.fun) if res.success else None,
                       seconds=time.perf_counter() - t0,
                       message=str(res.message)), fh)


class Oracle:
    """One HiGHS solve of linprog arrays (c, A_ub, b_ub, A_eq, b_eq,
    bounds) running in a child process (see oracle_child)."""

    def __init__(self, c, A_ub, b_ub, A_eq, b_eq, bounds, workdir):
        npz = os.path.join(workdir, "oracle.npz")
        self.out = os.path.join(workdir, "oracle.json")
        arrays = dict(c=c, b_ub=b_ub, b_eq=b_eq, bounds=bounds)
        for k, m in (("A_ub", A_ub), ("A_eq", A_eq)):
            m = m.tocsr()
            arrays.update({k + "_data": m.data, k + "_indices": m.indices,
                           k + "_indptr": m.indptr,
                           k + "_shape": np.asarray(m.shape)})
        np.savez(npz, **arrays)
        code = (f"import sys; sys.path.insert(0, {REPO!r}); import "
                f"chip_smoke; chip_smoke.oracle_child({npz!r}, "
                f"{self.out!r})")
        self.proc = subprocess.Popen([sys.executable, "-c", code])

    def result(self, timeout: float = 900.0) -> dict:
        if self.proc.wait(timeout=timeout) != 0:
            raise RuntimeError("HiGHS oracle crashed")
        with open(self.out) as fh:
            out = json.load(fh)
        if out["objective"] is None:
            raise RuntimeError(f"HiGHS oracle: {out['message']}")
        note(f"HiGHS oracle: {out}")
        return out


def kernel_checks():
    """tests/test_xla_kernels.py loaded by path (a `tests` package of some
    other distribution on sys.path must not shadow it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_xla_kernels", os.path.join(REPO, "tests", "test_xla_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------

def phase0(rep_factory):
    """Device and environment; returns the Reporter."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); "
              "this check runs only on an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    from pips_ipmpp_tpu import native
    from pips_ipmpp_tpu.ipm.solver import enable_compilation_cache
    rep = rep_factory(dev.device_kind, nvidia_smi())
    rep.line("0", dict(
        device_count=len(jax.devices()), jax=jax.__version__,
        x64=bool(jax.config.jax_enable_x64),
        XLA_FLAGS=os.environ.get("XLA_FLAGS", ""),
        compile_cache_dir=enable_compilation_cache(),
        native_library_loaded=native.available()))
    return rep


def phase1(rep):
    rep.line("1", kernel_checks().check_precision())


def phase2(rep, leaf_shapes=None, ell_rows=None):
    K = kernel_checks()
    for N, a in leaf_shapes or K.LEAF_SHAPES:
        for dtype in ("float32", "float64"):
            rep.line("2", dict(check="xla_leaf_factor",
                               **K.check_leaf_factor(N, a, dtype, reps=3)))
    for rows in ell_rows or K.ELL_ROWS:
        rep.line("2", dict(check="xla_ell_spmv", **K.check_ell_spmv(rows)))


ENERGY = dict(T=96, R=150, G=550, L=350, S=4, seed=5)
FLAGSHIP = dict(N=64, n=256, mE=128, mI=128, n0=64, m0E=32, m0I=32, mEl=32,
                mIl=32)


def energy_lp(energy):
    """The energy dispatch blocks and the linprog arrays of their flat LP
    (the HiGHS oracle's input)."""
    from pips_ipmpp_tpu.io.energy import dispatch_blocks, linprog_arrays
    data = dispatch_blocks(**energy)
    return data, linprog_arrays(*data[:4])


def flagship_lp(shape):
    from pips_ipmpp_tpu.core.options import ScalerType
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.scale import make_scaler
    return make_scaler(ScalerType.EQUILIBRIUM).scale(
        random_arrowhead_lp(0, **shape))


def phase3(rep, data, oracle, energy, leaf_check=True):
    import jax
    from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
    from pips_ipmpp_tpu.core.options import (Options, PresolverType,
                                             ScalerType)
    from pips_ipmpp_tpu.core.status import TerminationStatus
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface

    blocks, first, leq, liq, meta = data
    n_vars = meta["n0"] + sum(len(b["c"]) for b in blocks)
    lp = make_arrowhead_lp(blocks, first, leq, liq)
    iface = PIPSIPMppTPUInterface(lp, Options(
        presolve=PresolverType.PRESOLVE, scaler=ScalerType.EQUILIBRIUM))
    runs = []
    for k in range(2):            # first run compiles, second is warm
        t0 = time.perf_counter()
        status = iface.run()
        runs.append(dict(wall_s=time.perf_counter() - t0,
                         phase_times=dict(iface.phase_times)))
        note(f"energy run {k}: {status.name} {runs[-1]}")
        if status != TerminationStatus.SUCCESSFUL_TERMINATION:
            raise AssertionError(f"energy LP: {status}")
        if k == 0:
            highs = oracle.result()
            obj_h = highs["objective"]
        # objective of the original LP: the solver's (scaling leaves c'x
        # invariant) plus the constant presolve moved out of it.  The
        # facade's getObjective() postsolves the full primal first, which
        # at this size is many minutes of host time
        obj = (iface.result.objective
               + iface._presolve_log.objective_offset)
        err = rel_err(obj, obj_h)
        if err > 1e-4:
            raise AssertionError(f"energy LP objective {obj} vs HiGHS "
                                 f"{obj_h}: rel err {err}")
    plp = iface._presolve_log.lp
    rep.line("3", dict(
        lp=f"dispatch_blocks({energy})",
        variables=n_vars, presolved_leaf=[plp.N, plp.mE + plp.mI, plp.n],
        factor_dtype=np.dtype(
            iface._solver.be_ctor.keywords["factor_dtype"]).name,
        status=status.name, iterations=iface.n_iterations,
        objective=obj, highs_objective=obj_h,
        rel_err=err, highs_s=highs["seconds"], cold=runs[0], warm=runs[1],
        compile_s=runs[0]["phase_times"]["solve"]
        - runs[1]["phase_times"]["solve"],
        tto_s=runs[1]["wall_s"],
        peak_bytes_in_use=peak_bytes(jax.devices()[0])))
    if leaf_check:
        a = plp.mE + plp.mI
        for dtype in ("float32", "float64"):
            rep.line("3", dict(check="xla_leaf_factor_energy_shape",
                               **kernel_checks().check_leaf_factor(
                                   plp.N, a, dtype, reps=3)))


def phase4(rep, lp, stream=4):
    import jax
    import jax.numpy as jnp
    from pips_ipmpp_tpu.core.options import Options
    from pips_ipmpp_tpu.core.status import TerminationStatus
    from pips_ipmpp_tpu.interface import resolve_factor_dtype
    from pips_ipmpp_tpu.ipm.device_loop import SUCCESS
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.linalg.dense_backend import DenseBackend

    opts = Options()
    fd = resolve_factor_dtype(opts)
    # reference: the same LP flattened (to_dense) and solved in f64 with
    # unstructured dense normal equations — no arrowhead, no Schur
    # complement.  (scipy HiGHS, simplex or IPM, takes many CPU minutes
    # on this dense-block LP, so it checks only phase 3.)
    t0 = time.perf_counter()
    ref = IPMSolver(partial(DenseBackend, factor_dtype=jnp.float64),
                    opts).solve(lp.to_dense())
    ref_s = time.perf_counter() - t0
    note(f"flagship dense reference: {ref.status.name} {ref.iterations} "
         f"its {ref_s} s")
    if ref.status != TerminationStatus.SUCCESSFUL_TERMINATION:
        raise AssertionError(f"dense reference: {ref.status}")
    obj_ref = ref.objective
    solver = IPMSolver(partial(ArrowBackend, factor_dtype=fd), opts)
    times = []
    for _ in range(2):            # first call compiles
        t0 = time.perf_counter()
        res = solver.solve_fused(lp)
        times.append(time.perf_counter() - t0)
    note(f"flagship fused: {res.status.name} {res.iterations} its {times}")
    if res.status != TerminationStatus.SUCCESSFUL_TERMINATION:
        raise AssertionError(f"flagship fused: {res.status}")
    lps = [dataclasses.replace(lp, c0=lp.c0 * (1.0 + 1e-5 * i),
                               cN=lp.cN * (1.0 + 1e-5 * i))
           for i in range(stream)]
    batch_times = []
    for _ in range(2):            # first call compiles
        t0 = time.perf_counter()
        _, info = solver.solve_fused_batch_async(lps)
        info = jax.device_get(info)
        batch_times.append(time.perf_counter() - t0)
    note(f"flagship batch: {info['status']} {batch_times}")
    if not all(int(s) == SUCCESS for s in info["status"]):
        raise AssertionError(f"batched stream statuses {info['status']}")
    err = rel_err(res.objective, obj_ref)
    if err > 1e-4:
        raise AssertionError(f"flagship objective {res.objective} vs dense "
                             f"reference {obj_ref}: rel err {err}")
    err_b = rel_err(float(info["objective"][0]), obj_ref)
    if err_b > 1e-4:
        raise AssertionError(f"batched stream objective "
                             f"{info['objective'][0]} vs dense reference "
                             f"{obj_ref}")
    rep.line("4", dict(
        lp=f"random_arrowhead_lp(0, N={lp.N}, n={lp.n}, mE={lp.mE}, "
           f"mI={lp.mI}, n0={lp.n0}, m0E={lp.m0E}, m0I={lp.m0I}, "
           f"mEl={lp.mEl}, mIl={lp.mIl}) equilibrium-scaled",
        factor_dtype=np.dtype(fd).name, iterations=res.iterations,
        objective=res.objective, dense_reference_objective=obj_ref,
        dense_reference_iterations=ref.iterations, dense_reference_s=ref_s,
        rel_err=err, fused_first_call_s=times[0], fused_tto_s=times[1],
        stream=stream, batch_iterations=[int(v) for v in info["iterations"]],
        batch_rel_err=err_b, batch_first_call_s=batch_times[0],
        batch_s=batch_times[1],
        solves_per_s=stream / batch_times[1],
        peak_bytes_in_use=peak_bytes(jax.devices()[0])))


def phase5(rep, N=8, n=2048, mE=1024, mI=1024):
    import jax
    from pips_ipmpp_tpu.core.options import Options
    from pips_ipmpp_tpu.core.status import TerminationStatus
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
    from pips_ipmpp_tpu.io.synthetic import random_sparse_arrowhead_lp

    slp = random_sparse_arrowhead_lp(0, N=N, n=n, mE=mE, mI=mI,
                                     nnz_per_row=10, n0=16, m0E=4, m0I=4,
                                     mEl=4, mIl=4)
    out = {}
    for name, opts in (
            ("ell_cg", Options(sparse_densify_max_mb=0,
                               reduced_accuracy=True)),
            ("densified", Options(sparse_densify_max_mb=1e6))):
        iface = PIPSIPMppTPUInterface(slp, opts)
        t0 = time.perf_counter()
        status = iface.run()
        note(f"sparse {name}: {status.name} {time.perf_counter() - t0}")
        if status != TerminationStatus.SUCCESSFUL_TERMINATION:
            raise AssertionError(f"sparse LP ({name}): {status}")
        out[name] = dict(wall_s=time.perf_counter() - t0,
                         iterations=iface.n_iterations,
                         objective=iface.getObjective(),
                         backend=iface._solver.be_ctor.func.__name__)
    err = rel_err(out["ell_cg"]["objective"], out["densified"]["objective"])
    if err > 1e-3:
        raise AssertionError(f"sparse CG vs densified: rel err {err}")
    rep.line("5", dict(lp=f"random_sparse_arrowhead_lp(0, N={N}, n={n}, "
                          f"mE={mE}, mI={mI}, nnz_per_row=10)",
                       rel_err=err, peak_bytes_in_use=peak_bytes(
                           jax.devices()[0]), **out))


def phase6(rep, N=512, n=128, mE=64, mI=64, n0=64, mD=16, n_cards=4,
           hier_groups=8):
    import jax
    from pips_ipmpp_tpu.core.options import Options
    from pips_ipmpp_tpu.interface import resolve_factor_dtype
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.parallel.dist_solver import DistributedIPMSolver
    from pips_ipmpp_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    if len(devs) < n_cards:
        raise AssertionError(f"--four-cards needs {n_cards} devices, "
                             f"JAX sees {len(devs)}")
    lp = random_arrowhead_lp(0, N=N, n=n, mE=mE, mI=mI, n0=n0, m0E=mD,
                             m0I=mD, mEl=mD, mIl=mD)
    opts = Options()
    fd = resolve_factor_dtype(opts)
    t0 = time.perf_counter()
    ref = IPMSolver(partial(ArrowBackend, factor_dtype=fd), opts).solve(lp)
    rep.line("6", dict(mode="single card", wall_s=time.perf_counter() - t0,
                       status=ref.status.name, iterations=ref.iterations,
                       objective=ref.objective))
    mesh = make_mesh(n_cards)
    for name, mode, kw in (
            ("shard_map", "shard_map", {}),
            ("gspmd", "gspmd", {}),
            (f"hier_groups={hier_groups}", "shard_map",
             dict(hier_groups=hier_groups)),
            ("dist_root", "shard_map", dict(dist_root=True))):
        t0 = time.perf_counter()
        res = DistributedIPMSolver(mesh, opts, mode=mode, factor_dtype=fd,
                                   **kw).solve(lp)
        wall = time.perf_counter() - t0
        err = rel_err(res.objective, ref.objective)
        rep.line("6", dict(
            mode=name, wall_s=wall, status=res.status.name,
            iterations=res.iterations, objective=res.objective,
            rel_err_vs_single=err,
            bytes_in_use=[(d.memory_stats() or {}).get("bytes_in_use")
                          for d in devs[:n_cards]]))
        if (res.status != ref.status or err > 1e-6
                or abs(res.iterations - ref.iterations) > 1):
            raise AssertionError(
                f"{name}: {res.status} {res.iterations} its obj "
                f"{res.objective} vs single card {ref.status} "
                f"{ref.iterations} its obj {ref.objective}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    rep = phase0(Reporter)
    if args.four_cards:
        phase6(rep)
    else:
        import tempfile
        with tempfile.TemporaryDirectory() as work:
            data, arrays = energy_lp(ENERGY)
            energy_oracle = Oracle(*arrays, workdir=work)
            note("HiGHS oracle started")
            for name, phase in (
                    ("1", phase1), ("2", phase2),
                    ("3", lambda r: phase3(r, data, energy_oracle, ENERGY)),
                    ("4", lambda r: phase4(r, flagship_lp(FLAGSHIP))),
                    ("5", phase5)):
                t0 = time.perf_counter()
                phase(rep)
                note(f"phase {name} done in {time.perf_counter() - t0} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
