"""Arrowhead backend verification:
1. matvecs match the flattened dense LP,
2. the structured Schur solve satisfies the full Newton oracle,
3. end-to-end IPM on arrowhead LPs matches the dense solve / known optima.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.ipm import formulation as F
from pips_ipmpp_tpu.ipm.solver import IPMSolver
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu.linalg.dense_backend import DenseBackend

from tests.fixtures import random_arrowhead_lp, two_scenario_linking_lp
from tests.helpers import (flatten_r, flatten_x, interior_iterate,
                           max_newton_error, newton_residuals)


def rand_xvec(key, lp):
    k1, k2 = jax.random.split(key)
    return XVec(jax.random.normal(k1, (lp.n0,)),
                jax.random.normal(k2, (lp.N, lp.n)))


def rand_rvec(key, lp, kind):
    k1, k2, k3 = jax.random.split(key, 3)
    if kind == "eq":
        return RVec(jax.random.normal(k1, (lp.m0E,)),
                    jax.random.normal(k2, (lp.N, lp.mE)),
                    jax.random.normal(k3, (lp.mEl,)))
    return RVec(jax.random.normal(k1, (lp.m0I,)),
                jax.random.normal(k2, (lp.N, lp.mI)),
                jax.random.normal(k3, (lp.mIl,)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("het", [False, True])
def test_matvecs_match_dense(seed, het):
    lp = random_arrowhead_lp(seed, heterogeneous=het)
    dense = lp.to_dense()
    be = ArrowBackend(lp)
    key = jax.random.PRNGKey(seed + 100)

    x = rand_xvec(key, lp)
    y = rand_rvec(jax.random.fold_in(key, 1), lp, "eq")
    z = rand_rvec(jax.random.fold_in(key, 2), lp, "ineq")

    xf = flatten_x(x)
    np.testing.assert_allclose(flatten_r(be.Ax(x)), np.asarray(dense.A) @ xf,
                               atol=1e-12)
    np.testing.assert_allclose(flatten_r(be.Cx(x)), np.asarray(dense.C) @ xf,
                               atol=1e-12)
    np.testing.assert_allclose(flatten_x(be.ATy(y)),
                               np.asarray(dense.A).T @ flatten_r(y),
                               atol=1e-12)
    np.testing.assert_allclose(flatten_x(be.CTz(z)),
                               np.asarray(dense.C).T @ flatten_r(z),
                               atol=1e-12)
    np.testing.assert_allclose(float(be.datanorm()),
                               float(dense.datanorm()), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schur_solve_matches_newton_oracle(seed):
    """The structured (block-condensed + Schur) solve must satisfy the full
    linearized KKT system — same oracle as the dense path."""
    lp = random_arrowhead_lp(seed, N=3, n=5, mE=2, mI=3, n0=2, m0E=1,
                             m0I=2, mEl=2, mIl=1)
    be = ArrowBackend(lp)
    it = interior_iterate(be, jax.random.PRNGKey(seed + 7))

    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, 0.0, 0.0)
    assert bool(be.factorization_ok(fac))

    comp = F.comp_rhs_affine(be, it)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, refinement_steps=2)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)

    errs = max_newton_error(newton_residuals(be, it, d, res, comp))
    for name, err in errs.items():
        assert err < 1e-8, f"Newton residual {name} = {err} (all: {errs})"


@pytest.mark.parametrize("seed", [0, 1])
def test_no_linking_rows(seed):
    """Two-stage stochastic form: linking columns only (mEl = mIl = 0)."""
    lp = random_arrowhead_lp(seed, N=3, n=4, mE=2, mI=2, n0=2, m0E=1,
                             m0I=1, mEl=0, mIl=0)
    be = ArrowBackend(lp)
    it = interior_iterate(be, jax.random.PRNGKey(seed))
    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, 0.0, 0.0)
    comp = F.comp_rhs_affine(be, it)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, refinement_steps=2)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)
    errs = max_newton_error(newton_residuals(be, it, d, res, comp))
    for name, err in errs.items():
        assert err < 1e-8, f"{name}: {err}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipm_arrowhead_matches_dense(seed):
    """Full IPM on the arrowhead backend == dense backend on the flattened
    LP (objective to 1e-6)."""
    lp = random_arrowhead_lp(seed, N=4, n=6, mE=3, mI=4, n0=3, m0E=2,
                             m0I=2, mEl=2, mIl=2)
    dense = lp.to_dense()

    r_dense = IPMSolver(DenseBackend, Options()).solve(dense)
    r_arrow = IPMSolver(ArrowBackend, Options()).solve(lp)

    assert r_dense.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert r_arrow.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
        f"mu={r_arrow.mu} resid={r_arrow.residual_norm}"
    assert abs(r_arrow.objective - r_dense.objective) < 1e-5 * max(
        1.0, abs(r_dense.objective))


def test_two_scenario_linking_lp():
    lp, opt = two_scenario_linking_lp()
    result = IPMSolver(ArrowBackend, Options()).solve(lp)
    assert result.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(result.objective - opt) < 1e-6
    assert result.iterations <= 30


def test_heterogeneous_blocks_end_to_end():
    """Padding of heterogeneous blocks must preserve the optimum exactly."""
    lp_het = random_arrowhead_lp(5, N=4, heterogeneous=True)
    dense = lp_het.to_dense()
    r_dense = IPMSolver(DenseBackend, Options()).solve(dense)
    r_arrow = IPMSolver(ArrowBackend, Options()).solve(lp_het)
    assert r_arrow.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r_arrow.objective - r_dense.objective) < 1e-5


def test_root_escalation_inert_when_healthy():
    """The in-factorize root escalation (reference inertia-correction role,
    LinearSystem.C:296-325, applied ONLY to the root system) must not
    perturb a healthy factorization: extra_root stays 0 and the f32
    condensation-root solve still hits the known optimum."""
    from functools import partial

    lp, opt = two_scenario_linking_lp(jnp.float32)
    be = ArrowBackend(lp, factor_dtype=jnp.float32)
    it = interior_iterate(be, jax.random.PRNGKey(0))
    fac = jax.jit(lambda l, i: ArrowBackend(
        l, factor_dtype=jnp.float32).factorize(
            *F.kkt_diagonals(ArrowBackend(l, factor_dtype=jnp.float32), i),
            1e-8, 1e-8))(lp, it)
    assert bool(fac.ok)
    assert float(fac.extra_root) == 0.0
    r = IPMSolver(partial(ArrowBackend, factor_dtype=jnp.float32),
                  Options(refinement_steps=2)).solve(lp)
    assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r.objective - opt) < 1e-3 * (1.0 + abs(opt))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_root_escalation_fires_on_indefinite_root(dtype):
    """A root whose primal block S11 is slightly indefinite (-1e-6 I) fails
    the plain condensation; the escalation retries with the first shift
    rung (1e-4), succeeds, and records it for the refinement residual.
    With the escalation off the same root reports failure."""
    lp = random_arrowhead_lp(3, N=3, n=6, mE=3, mI=3, n0=3, m0E=1,
                             m0I=1, mEl=1, mIl=1)
    be = ArrowBackend(lp, factor_dtype=dtype)
    it = interior_iterate(be, jax.random.PRNGKey(1))
    Dx, Ominv = F.kkt_diagonals(be, it)
    dp = dd = 1e-8
    L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok = be.leaf_factorize(
        Dx.blocks, Ominv.blocks, dp, dd)
    n0 = lp.n0
    # S11 = diag(Dx0 + dp) - contrib[:n0, :n0]  ->  -1e-6 I
    S11 = jnp.diag(Dx.first + dp) - contrib[:n0, :n0]
    contrib = contrib.at[:n0, :n0].add(S11 + 1e-6 * jnp.eye(n0))
    args = (Dx, Ominv, dp, dd, L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok)

    fac = be._assemble_root(*args)
    assert bool(fac.ok)
    assert float(fac.extra_root) == pytest.approx(1e-4)
    np.testing.assert_allclose(fac.Einv0,
                               1.0 / (Dx.first + dp + 1e-4), rtol=1e-6)
    off = ArrowBackend(lp, factor_dtype=dtype, root_escalation=False)
    assert not bool(off._assemble_root(*args).ok)
