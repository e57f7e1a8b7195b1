"""Sparse (ELL + matrix-free CG leaf) path: core/sparse.py,
linalg/sparse_backend.py — the stand-in for the reference's
sparse leaf engine (SparseStorage.C, PardisoSchurSolver.C:84-252)."""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.sparse import (Ell, ell_from_dense, ell_mv,
                                        ell_mv_multi, ell_sq_diag,
                                        ell_to_dense, ell_transpose,
                                        sparse_from_dense)
from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.io.synthetic import (random_arrowhead_lp,
                                         random_sparse_arrowhead_lp)
from pips_ipmpp_tpu.ipm.solver import IPMSolver
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu.linalg.sparse_backend import SparseArrowBackend


def test_ell_roundtrip_and_products():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, 10, 14)) * (rng.random((3, 10, 14)) < 0.3)
    e = ell_from_dense(M)
    assert np.allclose(ell_to_dense(e, 14), M)
    et = ell_transpose(e, 14)
    assert np.allclose(ell_to_dense(et, 10), np.swapaxes(M, 1, 2))
    x = rng.normal(size=(3, 14))
    assert np.allclose(ell_mv(e, jnp.asarray(x)),
                       np.einsum("imn,in->im", M, x))
    X = rng.normal(size=(3, 14, 5))
    assert np.allclose(ell_mv_multi(e, jnp.asarray(X)),
                       np.einsum("imn,inc->imc", M, X))
    w = rng.random((3, 14))
    assert np.allclose(ell_sq_diag(e, jnp.asarray(w)),
                       np.einsum("imn,in,imn->im", M, w, M))


def test_ell_duplicate_entries_sum():
    # COO semantics: duplicate (row, col) slots add in products
    val = jnp.asarray([[[1.0, 2.0]]])
    col = jnp.asarray([[[3, 3]]], dtype=jnp.int32)
    e = Ell(val, col)
    x = jnp.asarray([[0.0, 0.0, 0.0, 5.0]])
    assert float(ell_mv(e, x)[0, 0]) == 15.0


@pytest.fixture(scope="module")
def small_pair():
    lp = random_arrowhead_lp(3, N=4, n=24, mE=10, mI=12, n0=6, m0E=3,
                             m0I=3, mEl=3, mIl=3)
    return lp, sparse_from_dense(lp)


def test_sparse_backend_matches_dense(small_pair):
    lp, slp = small_pair
    ref = IPMSolver(ArrowBackend, Options()).solve(lp)
    res = IPMSolver(SparseArrowBackend, Options()).solve(slp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(res.objective - ref.objective) < 1e-8
    assert res.iterations <= ref.iterations + 2


def test_sparse_backend_fused_loop(small_pair):
    lp, slp = small_pair
    ref = IPMSolver(ArrowBackend, Options()).solve(lp)
    res = IPMSolver(SparseArrowBackend, Options()).solve_fused(slp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(res.objective - ref.objective) < 1e-8


def test_sparse_generator_end_to_end():
    lp = random_sparse_arrowhead_lp(1, N=4, n=192, mE=96, mI=96,
                                    nnz_per_row=6, n0=8, m0E=3, m0I=3,
                                    mEl=3, mIl=3)
    res = IPMSolver(partial(SparseArrowBackend, cg_iters=300),
                    Options()).solve(lp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    # KKT quality at the solution, not just termination flags
    assert res.mu < 1e-6
    assert res.residual_norm < 1e-5 * max(float(lp.datanorm()), 1.0)


def test_sparse_large_block_scale():
    """10^4-row-class blocks: ELL storage is ~0.1% of dense (which would
    be 2 GB and is never materialized); the condensed leaf machinery
    stays consistent at this size."""
    lp = random_sparse_arrowhead_lp(0, N=2, n=8192, mE=4096, mI=4096,
                                    nnz_per_row=8, n0=16, m0E=4, m0I=4,
                                    mEl=4, mIl=4)
    dense_bytes = lp.N * (lp.mE + lp.mI) * lp.n * 8
    ell_bytes = sum(int(e.val.size) * 8 + int(e.col.size) * 4
                    for e in (lp.B, lp.Bt, lp.D, lp.Dt))
    assert dense_bytes > 1e9
    assert ell_bytes < 0.01 * dense_bytes

    be = SparseArrowBackend(lp, cg_iters=300)
    # factorize + one reduced solve, then check the augmented residual —
    # the same consistency contract the dense backend's refinement uses
    Dx = XVec(jnp.ones(lp.n0), jnp.ones((lp.N, lp.n)))
    Ominv = RVec(jnp.ones(lp.m0I), jnp.ones((lp.N, lp.mI)),
                 jnp.ones(lp.mIl))
    fac = be.factorize(Dx, Ominv, 1e-8, 1e-8)
    assert bool(be.factorization_ok(fac))

    rng = np.random.default_rng(7)
    from pips_ipmpp_tpu.ipm.formulation import ReducedRhs
    rx = XVec(jnp.asarray(rng.normal(size=lp.n0)),
              jnp.asarray(rng.normal(size=(lp.N, lp.n))))
    rA = RVec(jnp.asarray(rng.normal(size=lp.m0E)),
              jnp.asarray(rng.normal(size=(lp.N, lp.mE))),
              jnp.asarray(rng.normal(size=lp.mEl)))
    rz = RVec(jnp.asarray(rng.normal(size=lp.m0I)),
              jnp.asarray(rng.normal(size=(lp.N, lp.mI))),
              jnp.asarray(rng.normal(size=lp.mIl)))
    rhs = ReducedRhs(rhat_x=rx, rA=rA, rhat_z=rz, rbar_z=rz)
    p0 = -rx.first
    q0 = jnp.concatenate([-rA.first, -rz.first, -rA.link, -rz.link])
    rho_x = -rx.blocks
    rho_m = jnp.concatenate([-rA.blocks, -rz.blocks], axis=1)
    state = be._solve_core(fac, p0, q0, rho_x, rho_m)
    errs = be._aug_residual(fac, p0, q0, rho_x, rho_m, *state)
    err = max(float(jnp.max(jnp.abs(e))) for e in errs if e.size)
    assert err < 1e-6


def test_sparse_astype_preserves_int_cols(small_pair):
    _, slp = small_pair
    s32 = slp.astype(jnp.float32)
    assert s32.B.col.dtype == jnp.int32
    assert s32.B.val.dtype == jnp.float32
    assert s32.cN.dtype == jnp.float32


def test_sparse_lp_shards_over_mesh():
    """SparseArrowheadLP (Ell pytree fields) shards over the mesh and the
    GSPMD sparse solve matches single-device (the spec builder used to
    crash on Ell fields and mis-replicate Bt/Dt)."""
    from functools import partial
    from pips_ipmpp_tpu.parallel.mesh import make_mesh, shard_arrowhead_lp
    lp = random_sparse_arrowhead_lp(0, N=8, n=64, mE=24, mI=24,
                                    nnz_per_row=4, dtype=jnp.float64)
    ref = IPMSolver(partial(SparseArrowBackend,
                            factor_dtype=jnp.float64)).solve(lp)
    slp = shard_arrowhead_lp(lp, make_mesh(8))
    res = IPMSolver(partial(SparseArrowBackend,
                            factor_dtype=jnp.float64)).solve(slp)
    assert res.status == ref.status
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(float(res.objective), float(ref.objective),
                               rtol=1e-10)


def _mu_trajectory_no_stall(history, from_mu=1.0):
    """Every recorded mu below `from_mu` must keep decreasing — the
    round-3 verdict's stall criterion for the inexact CG leaf."""
    mus = [h.mu for h in history if h.mu < from_mu]
    return all(b < a for a, b in zip(mus, mus[1:]))


def test_sparse_cg_leaf_converged_8blocks_2048rows():
    """Converged IPM on 8 genuinely sparse blocks of 2048 rows (~10
    nnz/row) through the CG leaf — mu-trajectory monotone below 1.0 (no
    late-IPM stall), KKT satisfied at termination."""
    lp = random_sparse_arrowhead_lp(0, N=8, n=2048, mE=1024, mI=1024,
                                    nnz_per_row=10, n0=16, m0E=4, m0I=4,
                                    mEl=4, mIl=4)
    opts = Options(record_history=True)
    res = IPMSolver(partial(SparseArrowBackend, cg_iters=500),
                    opts).solve(lp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert res.mu < 1e-6
    assert res.residual_norm < 1e-4 * max(float(lp.datanorm()), 1.0)
    assert _mu_trajectory_no_stall(res.history)


@pytest.mark.skipif(not __import__("os").environ.get("PIPS_XL_TESTS"),
                    reason="reference-scale sparse solve (~10-45 min CPU); "
                           "set PIPS_XL_TESTS=1 (run + recorded in "
                           "ROUND_NOTES.md round 4)")
def test_sparse_cg_leaf_converged_8blocks_8192rows_reference_scale():
    """The round-3 verdict #3 acceptance case at full reference scale:
    N=8 blocks x 8192 rows, ~10 nnz/row.  Recorded round-4 run: SUCCESS
    in 14 iterations, mu 7.7e-8, objective -27135.6898 vs the HiGHS f64
    oracle -27135.6929 (rel 1.2e-7; see ROUND_NOTES.md)."""
    lp = random_sparse_arrowhead_lp(0, N=8, n=8192, mE=4096, mI=4096,
                                    nnz_per_row=10, n0=16, m0E=4, m0I=4,
                                    mEl=4, mIl=4)
    opts = Options(record_history=True)
    res = IPMSolver(partial(SparseArrowBackend, cg_iters=500),
                    opts).solve(lp)
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert res.mu < 1e-6
    assert _mu_trajectory_no_stall(res.history)
    # HiGHS f64 oracle on the same instance (tools run, round 4)
    assert abs(float(res.objective) - (-27135.692927917404)) < 5e-2


def test_facade_densify_budget_routing():
    """sparse_densify_max_mb routes in-budget sparse LPs to the dense
    path (same optimum, gathers work); 0 opts out and keeps the ELL leaf.
    The DEFAULT options densify (256 MB budget, core/options.py) — a
    default-config user gets the fast path without knowing the knob."""
    from pips_ipmpp_tpu.core.lp import ArrowheadLP
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface

    slp = random_sparse_arrowhead_lp(1, N=4, n=192, mE=96, mI=96,
                                     nnz_per_row=6, n0=8, m0E=3, m0I=3,
                                     mEl=3, mIl=3)
    i_cg = PIPSIPMppTPUInterface(slp, Options(sparse_densify_max_mb=0))
    assert not isinstance(i_cg.lp, ArrowheadLP)  # 0 = opt-out: ELL leaf
    assert i_cg.run() == TerminationStatus.SUCCESSFUL_TERMINATION

    i_d = PIPSIPMppTPUInterface(slp, Options())
    assert isinstance(i_d.lp, ArrowheadLP)     # densified at intake
    assert i_d.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(i_d.getObjective() - float(i_cg.result.objective)) < 1e-6
    # full gather surface works on the densified problem
    import numpy as np
    assert np.max(np.abs(i_d.gatherPrimalResidsEQ())) < 1e-6


def test_facade_gathers_on_ell_sparse():
    """The full gather surface works on a NON-densified ELL sparse LP
    (B/D matvecs ride the stored ELL/transpose forms)."""
    import numpy as np
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface

    slp = random_sparse_arrowhead_lp(3, N=4, n=192, mE=96, mI=96,
                                     nnz_per_row=6, n0=8, m0E=3, m0I=3,
                                     mEl=3, mIl=3)
    iface = PIPSIPMppTPUInterface(slp, Options(sparse_densify_max_mb=0))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-6
    assert np.max(np.abs(iface.gatherPrimalResidsIneqLow())) < 1e-6
    assert np.max(np.abs(iface.gatherDualResids())) < 1e-5
    x = iface.gatherPrimalSolution()
    assert iface.gatherDualSolutionVarBounds().shape == x.shape
    norms = iface.printComplementarityResiduals()
    assert all(v < 1e-5 for v in norms.values())
