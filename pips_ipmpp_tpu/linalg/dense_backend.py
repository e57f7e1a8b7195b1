"""Dense (unstructured) backend: the minimum end-to-end slice.

Solves the augmented system for a flat DenseLP by condensing to SPD normal
equations (the (1,1) block is diagonal for an LP):

    K = [ E   M' ]    E = Dx + dp   (diagonal)      M = [A; C]
        [ M  -F  ]    F = diag(dd*1_mE, Om + dd)    Om = 1/Ominv

    (M E^{-1} M' + F) d = M E^{-1} rho_x - rho_m    (Cholesky)
    dx = E^{-1} (rho_x - M' d)

This plays the role the direct solvers play at the reference's root
(DenseSymmetricIndefinitSolver, DeSymIndefSolver.C:28-126) but exploits LP
diagonality to stay SPD.  Mixed precision: the Cholesky runs in
`factor_dtype` (f32 on request), while iterative refinement of the *augmented*
residual runs in f64 (the role of solveCompressedIterRefin,
LinearSystem.C:877).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import DenseLP, _register
from pips_ipmpp_tpu.ipm.formulation import Bounds, ReducedRhs


@_register
@dataclass
class DenseFactors:
    chol: jax.Array     # [mE+mI, mE+mI] Cholesky factor of normal matrix
    Einv: jax.Array     # [n] 1/(Dx+dp)
    Om: jax.Array       # [mI]
    delta_p: jax.Array
    delta_d: jax.Array


class DenseBackend:
    """Backend over an unstructured DenseLP."""

    axis: Optional[str] = None

    def __init__(self, lp: DenseLP, factor_dtype=jnp.float64):
        self.lp = lp
        self.factor_dtype = factor_dtype
        self.bounds = Bounds(
            c=lp.c, b=lp.b,
            ixlow=lp.ixlow, xlow=lp.xlow, ixupp=lp.ixupp, xupp=lp.xupp,
            iclow=lp.iclow, clow=lp.clow, icupp=lp.icupp, cupp=lp.cupp,
        )
        self.num_bound_pairs = jnp.maximum(
            jnp.sum(lp.ixlow) + jnp.sum(lp.ixupp)
            + jnp.sum(lp.iclow) + jnp.sum(lp.icupp), 1.0)

    # ---- matvecs ----
    def Ax(self, x):
        return self.lp.A @ x

    def ATy(self, y):
        return self.lp.A.T @ y

    def Cx(self, x):
        return self.lp.C @ x

    def CTz(self, z):
        return self.lp.C.T @ z

    def objective(self, x):
        return jnp.vdot(self.lp.c, x)

    def datanorm(self):
        return self.lp.datanorm()

    # ---- factorization ----
    def factorize(self, Dx, Ominv, delta_p, delta_d) -> DenseFactors:
        lp = self.lp
        fd = self.factor_dtype
        E = Dx + delta_p
        Einv = 1.0 / E
        Om = 1.0 / Ominv
        M = jnp.concatenate([lp.A, lp.C], axis=0)
        Fd = jnp.concatenate([jnp.full((lp.mE,), delta_d, E.dtype),
                              Om + delta_d])
        Mf = M.astype(fd)
        N = (Mf * Einv.astype(fd)[None, :]) @ Mf.T + jnp.diag(Fd.astype(fd))
        chol = jnp.linalg.cholesky(N)
        return DenseFactors(chol=chol, Einv=Einv, Om=Om,
                            delta_p=jnp.asarray(delta_p, E.dtype),
                            delta_d=jnp.asarray(delta_d, E.dtype))

    def factorization_ok(self, fac: DenseFactors) -> jax.Array:
        return jnp.all(jnp.isfinite(fac.chol))

    # ---- solves ----
    def _solve_once(self, fac: DenseFactors, rho_x, rho_m):
        lp = self.lp
        fd = self.factor_dtype
        M = jnp.concatenate([lp.A, lp.C], axis=0)
        rhs = (M @ (fac.Einv * rho_x) - rho_m).astype(fd)
        u = jax.scipy.linalg.solve_triangular(fac.chol, rhs, lower=True)
        d = jax.scipy.linalg.solve_triangular(
            fac.chol.T, u, lower=False).astype(rho_x.dtype)
        dx = fac.Einv * (rho_x - M.T @ d)
        return dx, d

    def _apply_K(self, fac: DenseFactors, dx, d):
        """Augmented-system matvec for refinement: K (dx; d)."""
        lp = self.lp
        M = jnp.concatenate([lp.A, lp.C], axis=0)
        E = 1.0 / fac.Einv
        Fd = jnp.concatenate([jnp.full((lp.mE,), fac.delta_d, dx.dtype),
                              fac.Om + fac.delta_d])
        top = E * dx + M.T @ d
        bot = M @ dx - Fd * d
        return top, bot

    def solve_reduced(self, fac: DenseFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        """Solve the augmented system; returns (dx, dy, dz)."""
        lp = self.lp
        rho_x = -rhs.rhat_x
        rho_m = jnp.concatenate([-rhs.rA, -rhs.rhat_z])
        dx, d = self._solve_once(fac, rho_x, rho_m)
        if refinement_steps > 0:
            rhs_norm = jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(rho_x)) if rho_x.size else 0.0,
                            jnp.max(jnp.abs(rho_m)) if rho_m.size else 0.0),
                1e-30)

            def resid(dx, d):
                top, bot = self._apply_K(fac, dx, d)
                ex, em = rho_x - top, rho_m - bot
                nrm = jnp.maximum(
                    jnp.max(jnp.abs(ex)) if ex.size else 0.0,
                    jnp.max(jnp.abs(em)) if em.size else 0.0)
                return ex, em, nrm

            def cond(carry):
                dx, d, ex, em, k, nrm = carry
                return (k < refinement_steps) & (nrm > 1e-11 * rhs_norm)

            def body(carry):
                dx, d, ex, em, k, _ = carry
                cx, cd = self._solve_once(fac, ex, em)
                dx, d = dx + cx, d + cd
                ex2, em2, nrm2 = resid(dx, d)
                return dx, d, ex2, em2, k + 1, nrm2

            ex0, em0, nrm0 = resid(dx, d)
            dx, d, _, _, _, _ = jax.lax.while_loop(
                cond, body, (dx, d, ex0, em0, jnp.zeros((), jnp.int32), nrm0))
        yhat = d[:lp.mE]
        zhat = d[lp.mE:]
        return dx, -yhat, -zhat


def random_dense_lp(key, n=20, mE=8, mI=12, dtype=jnp.float64,
                    bound_prob=0.7) -> DenseLP:
    """Random feasible-by-construction LP for tests (interior x* exists)."""
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    A = rng.normal(size=(mE, n))
    C = rng.normal(size=(mI, n))
    x_feas = rng.normal(size=(n,)) * 0.5
    b = A @ x_feas
    Cx = C @ x_feas
    iclow = (rng.random(mI) < bound_prob).astype(float)
    icupp = np.where(iclow > 0, (rng.random(mI) < 0.5).astype(float), 1.0)
    clow = np.where(iclow > 0, Cx - 0.5 - rng.random(mI), 0.0)
    cupp = np.where(icupp > 0, Cx + 0.5 + rng.random(mI), 0.0)
    ixlow = (rng.random(n) < bound_prob).astype(float)
    ixupp = (rng.random(n) < bound_prob).astype(float)
    # every variable gets at least one bound (free vars need delta_p > 0;
    # covered by dedicated tests, not the zero-regularization oracle)
    ixlow = np.where((ixlow == 0) & (ixupp == 0), 1.0, ixlow)
    xlow = np.where(ixlow > 0, x_feas - 0.5 - rng.random(n), 0.0)
    xupp = np.where(ixupp > 0, x_feas + 0.5 + rng.random(n), 0.0)
    c = rng.normal(size=(n,))
    arr = lambda v: jnp.asarray(v, dtype)
    return DenseLP(c=arr(c), A=arr(A), b=arr(b), C=arr(C),
                   iclow=arr(iclow), clow=arr(clow),
                   icupp=arr(icupp), cupp=arr(cupp),
                   ixlow=arr(ixlow), xlow=arr(xlow),
                   ixupp=arr(ixupp), xupp=arr(xupp))
