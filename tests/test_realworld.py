"""Real-world-class LP validation (round-3 verdict #2): multi-period
energy dispatch/expansion instances (the reference's SIMPLE/ELMOD
workload class, README.md:1-5) solved end-to-end and validated against
the scipy HiGHS f64 oracle — through the annotated structured path, the
MPS + automatic-structure-discovery CLI path, and the banded-root
2-link-exploiting path.  The reference's own CI equivalent is the raw
8-block solves of pipsipmMultiTests.sh:26-42 (20data/LandSdata/ssndata).
"""
import numpy as np
import pytest

from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
from pips_ipmpp_tpu.core.options import (Options, PresolverType,
                                         ScalerType)
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
from pips_ipmpp_tpu.io.energy import (dispatch_blocks, highs_oracle,
                                      to_scipy, write_mps)

REL_TOL = 1e-6


def _relerr(a, b):
    return abs(a - b) / max(1.0, abs(b))


def test_energy_arrowhead_vs_highs():
    """Annotated structured path with the reference's recommended config
    (presolve + geometric/equilibrium scaling) vs the HiGHS oracle."""
    blocks, first, leq, liq, meta = dispatch_blocks(
        T=24, R=10, G=30, L=15, S=2, seed=1)
    obj_h, _ = highs_oracle(blocks, first, leq, liq)
    lp = make_arrowhead_lp(blocks, first, leq, liq)
    iface = PIPSIPMppTPUInterface(lp, Options(
        max_iterations=200,
        scaler=ScalerType.GEOMETRIC_MEAN_EQUILIBRIUM,
        presolve=PresolverType.PRESOLVE))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert _relerr(iface.getObjective(), obj_h) < REL_TOL
    # gathered primal is feasible in the ORIGINAL flat space
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-5


def test_energy_mps_auto_blocks_cli(tmp_path, capsys):
    """--mps --auto-blocks end-to-end: write MPS, rediscover the block
    structure with no annotations (core/dissect.py — a capability gmspips
    does not have), solve, write the solution mapped back to the original
    MPS ordering, validate objective + feasibility vs HiGHS."""
    from pips_ipmpp_tpu.cli import main

    blocks, first, leq, liq, _ = dispatch_blocks(
        T=12, R=8, G=20, L=10, S=2, seed=2)
    obj_h, _ = highs_oracle(blocks, first, leq, liq)
    mps = str(tmp_path / "energy12.mps")
    write_mps(mps, blocks, first, leq, liq)

    rc = main(["--mps", mps, "--auto-blocks", "12", "printsol"])
    assert rc == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("optimal objective:"))
    obj = float(line.split(":")[1])
    assert _relerr(obj, obj_h) < REL_TOL

    # the written solution is in the ORIGINAL MPS column order: check
    # primal feasibility against the flat oracle matrices
    sol = np.load(str(tmp_path / "energy12_solution.npz"))
    x = sol["x"]
    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = to_scipy(
        blocks, first, leq, liq)
    assert x.shape == c.shape
    assert _relerr(float(c @ x), obj_h) < REL_TOL
    assert np.max(np.abs(A_eq @ x - b_eq)) < 1e-5
    act = A_ub @ x
    assert np.all(act <= ub_ub + 1e-5)
    assert np.all(act >= lb_ub - 1e-5)
    assert np.all(x >= lo - 1e-6) and np.all(x <= hi + 1e-6)


def test_energy_banded_root_2link():
    """Storage-heavy instance: mEl = S*T 2-link continuity rows dominate
    the dual Schur — exactly the regime the banded root (window-ordered
    banded dual SC, linalg/band_root.py) exploits, mirroring the
    reference's link-structure exploitation."""
    blocks, first, leq, liq, meta = dispatch_blocks(
        T=16, R=8, G=20, L=10, S=6, seed=4)
    assert meta["mEl"] == 6 * 16      # 96 linking rows vs n0 = 20
    obj_h, _ = highs_oracle(blocks, first, leq, liq)
    lp = make_arrowhead_lp(blocks, first, leq, liq)

    plain = PIPSIPMppTPUInterface(lp, Options(max_iterations=200))
    assert plain.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert _relerr(plain.getObjective(), obj_h) < REL_TOL

    banded = PIPSIPMppTPUInterface(lp, Options(max_iterations=200,
                                               banded_root=True))
    assert banded.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert _relerr(banded.getObjective(), obj_h) < REL_TOL


@pytest.mark.slow
@pytest.mark.skipif(not __import__("os").environ.get("PIPS_XL_TESTS"),
                    reason="~30 min CPU f64; set PIPS_XL_TESTS=1 "
                           "(converged in 30 iters, obj 522861.96; on "
                           "the GPU chip_smoke.py phase 3 solves it)")
def test_energy_100k_vars_vs_highs():
    """The >= 1e5-variable acceptance case (round-3 verdict #2): 96
    periods x (550 gens + 350 lines + 4 storages + 150 regions) =
    102k variables, 10^3-row-class blocks, linking rows AND columns;
    objective validated against HiGHS."""
    blocks, first, leq, liq, meta = dispatch_blocks(
        T=96, R=150, G=550, L=350, S=4, seed=5)
    total_vars = meta["n0"] + sum(len(b["c"]) for b in blocks)
    assert total_vars >= 100_000, total_vars
    obj_h, _ = highs_oracle(blocks, first, leq, liq)
    lp = make_arrowhead_lp(blocks, first, leq, liq)
    iface = PIPSIPMppTPUInterface(lp, Options(max_iterations=300))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert _relerr(iface.getObjective(), obj_h) < REL_TOL


@pytest.mark.skipif(not __import__("os").environ.get("PIPS_XL_TESTS"),
                    reason="~1 h CPU f64; set PIPS_XL_TESTS=1")
def test_energy_1M_vars_vs_highs():
    """The ~10^6-variable regime (round-4 verdict #8, first point on the
    BASELINE north-star's pod-scale road): 300 periods x (1760 gens +
    1120 lines + 4 storages + 480 regions) ~ 1.01M variables, full
    pipeline (presolve -> scale -> solve -> postsolve-consistent
    objective), validated against HiGHS."""
    import time

    blocks, first, leq, liq, meta = dispatch_blocks(
        T=300, R=480, G=1760, L=1120, S=4, seed=7)
    total_vars = meta["n0"] + sum(len(b["c"]) for b in blocks)
    assert total_vars >= 1_000_000, total_vars
    obj_h, _ = highs_oracle(blocks, first, leq, liq)
    lp = make_arrowhead_lp(blocks, first, leq, liq)
    t0 = time.perf_counter()
    iface = PIPSIPMppTPUInterface(lp, Options(
        max_iterations=300,
        presolve=PresolverType.PRESOLVE,
        scaler=ScalerType.EQUILIBRIUM))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    print(f"1M-var pipeline: {iface.phase_times} "
          f"total {time.perf_counter() - t0:.1f}s "
          f"iters {iface.n_iterations}")
    assert _relerr(iface.getObjective(), obj_h) < REL_TOL
