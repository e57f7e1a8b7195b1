"""Mixed precision: f32 factorization + f64 residuals/adaptive refinement
must converge to full f64 tolerances (the f32-factor configuration —
SURVEY.md §7 'fp64 vs fp32' risk item)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.interface import resolve_factor_dtype
from pips_ipmpp_tpu.ipm.solver import IPMSolver
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu.linalg.dense_backend import DenseBackend, random_dense_lp

from tests.fixtures import random_arrowhead_lp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arrow_f32_factor_converges(seed):
    lp = random_arrowhead_lp(seed, N=4, n=8, mE=4, mI=5, n0=4, m0E=2,
                             m0I=2, mEl=2, mIl=2)
    opts = Options(refinement_steps=6)
    ref = IPMSolver(partial(ArrowBackend, factor_dtype=jnp.float64),
                    opts).solve(lp)
    mixed = IPMSolver(partial(ArrowBackend, factor_dtype=jnp.float32),
                      opts).solve(lp)
    assert ref.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert mixed.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
        f"mixed: mu={mixed.mu} resid={mixed.residual_norm}"
    assert abs(mixed.objective - ref.objective) < 1e-5 * max(
        1.0, abs(ref.objective))
    # mixed precision should not cost many extra IPM iterations
    assert mixed.iterations <= ref.iterations + 5


def test_dense_f32_factor_converges():
    lp = random_dense_lp(jax.random.PRNGKey(5), n=30, mE=10, mI=15)
    opts = Options(refinement_steps=6)
    ref = IPMSolver(partial(DenseBackend, factor_dtype=jnp.float64),
                    opts).solve(lp)
    mixed = IPMSolver(partial(DenseBackend, factor_dtype=jnp.float32),
                      opts).solve(lp)
    assert mixed.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(mixed.objective - ref.objective) < 1e-5


def test_resolve_factor_dtype():
    assert resolve_factor_dtype(Options(factor_dtype="float32")) == jnp.float32
    assert resolve_factor_dtype(Options(factor_dtype="float64")) == jnp.float64
    # auto on CPU tests with x64 -> f64
    assert resolve_factor_dtype(Options()) == jnp.float64


def test_explicit_inverse_path():
    """Explicit-inverse solve path (the f32-factor default) must match the
    triangular path to refinement accuracy."""
    from tests.helpers import (interior_iterate, max_newton_error,
                               newton_residuals)
    from pips_ipmpp_tpu.ipm import formulation as F
    lp = random_arrowhead_lp(4, N=4)
    be_tri = ArrowBackend(lp, explicit_inverse=False)
    be_inv = ArrowBackend(lp, explicit_inverse=True)
    it = interior_iterate(be_tri, jax.random.PRNGKey(2))
    res = F.compute_residuals(be_tri, it)
    Dx, Om = F.kkt_diagonals(be_tri, it)
    for be in (be_tri, be_inv):
        fac = be.factorize(Dx, Om, 0.0, 0.0)
        comp = F.comp_rhs_affine(be, it)
        rhs = F.assemble_reduced_rhs(be, it, res, comp, Om)
        dx, dy, dz = be.solve_reduced(fac, rhs, refinement_steps=2)
        d = F.recover_step(be, it, res, comp, Om, rhs, dx, dy, dz)
        errs = max_newton_error(newton_residuals(be, it, d, res, comp))
        assert max(errs.values()) < 1e-8, (be.explicit_inverse, errs)

    r1 = IPMSolver(partial(ArrowBackend, explicit_inverse=True),
                   Options()).solve(lp)
    r2 = IPMSolver(partial(ArrowBackend, explicit_inverse=False),
                   Options()).solve(lp)
    assert r1.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r1.objective - r2.objective) < 1e-7


def test_blockwise_sc_matches_cached():
    """Streamed Schur computation (no K^{-1}R caches) must match the cached
    path bit-for-bit in objective and satisfy the Newton oracle."""
    from tests.helpers import (interior_iterate, max_newton_error,
                               newton_residuals)
    from pips_ipmpp_tpu.ipm import formulation as F
    lp = random_arrowhead_lp(6, N=4, n=6, mE=3, mI=4, n0=3, m0E=2, m0I=2,
                             mEl=4, mIl=3)
    be_c = ArrowBackend(lp)
    be_b = ArrowBackend(lp, blockwise_sc=2)
    it = interior_iterate(be_c, jax.random.PRNGKey(0))
    res = F.compute_residuals(be_c, it)
    Dx, Om = F.kkt_diagonals(be_c, it)
    for be in (be_c, be_b):
        fac = be.factorize(Dx, Om, 0.0, 0.0)
        comp = F.comp_rhs_affine(be, it)
        rhs = F.assemble_reduced_rhs(be, it, res, comp, Om)
        dx, dy, dz = be.solve_reduced(fac, rhs, refinement_steps=2)
        d = F.recover_step(be, it, res, comp, Om, rhs, dx, dy, dz)
        errs = max_newton_error(newton_residuals(be, it, d, res, comp))
        assert max(errs.values()) < 1e-8, (be.blockwise_sc, errs)
    # factorize memory: blockwise stores no caches
    fac_b = be_b.factorize(Dx, Om, 1e-10, 1e-10)
    assert fac_b.Ux.ndim == 0 and fac_b.Um.ndim == 0

    r_c = IPMSolver(ArrowBackend, Options()).solve(lp)
    r_b = IPMSolver(partial(ArrowBackend, blockwise_sc=3),
                    Options()).solve(lp)
    assert r_b.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r_b.objective - r_c.objective) < 1e-8
