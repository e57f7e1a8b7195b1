"""Matrix-free sparse leaf backend: CG on the condensed block systems.

The reference factorizes each (sparse) leaf KKT with PARDISO and extracts
a Schur complement (PardisoSchurSolver.C:84-252).  The replacement
here for *genuinely sparse* blocks — energy LPs with 10^4+ rows at
~10 nnz/row, where the batched-dense condensation of ArrowBackend cannot
even represent the blocks — keeps the same two-level condensation but
solves the SPD condensed system

    Neq = M E^{-1} M' + F_d,     M = [B; D]  (ELL, core/sparse.py)

*matrix-free* with Jacobi-preconditioned CG, batched over blocks and over
all Schur right-hand sides at once.  Products are static-shape ELL
gathers; there is no factorization, no fill-in, and leaf memory stays
O(nnz).  Accuracy is carried by the same machinery as the dense path:
the IPM's adaptive iterative refinement on the augmented residual and the
regularization ladder (solver.py) absorb the inexact leaf solves — the
role BiCGStab + refinement play around PARDISO's factors in the reference
(LinearSystem.C:550-877).

Everything above the leaves (root Schur assembly, two-level root solve,
distribution over the mesh axis) is inherited from ArrowBackend.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from pips_ipmpp_tpu.core.sparse import (SparseArrowheadLP, ell_mv,
                                        ell_mv_multi, ell_sq_diag)
from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend


def batched_pcg(apply_A, B, dinv, max_iters: int, tol: float):
    """Jacobi-preconditioned CG on independent SPD systems batched over
    (block, rhs-column): B [N, a, c].  Returns (X, iterations).

    Stops when every column's residual norm is below tol * ||b|| (or at
    max_iters); zero columns take alpha = 0 and stay exactly zero."""
    dt = B.dtype
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    X = jnp.zeros_like(B)
    R = B
    Z = dinv[:, :, None] * R
    P = Z
    rz = jnp.sum(R * Z, axis=1, keepdims=True)
    bnorm = jnp.sqrt(jnp.sum(B * B, axis=1, keepdims=True))
    thresh = (tol * jnp.maximum(bnorm, tiny)) ** 2

    def cond(carry):
        _X, R, _P, _rz, k = carry
        rn2 = jnp.sum(R * R, axis=1, keepdims=True)
        return (k < max_iters) & jnp.any(rn2 > thresh)

    def body(carry):
        X, R, P, rz, k = carry
        Ap = apply_A(P)
        den = jnp.sum(P * Ap, axis=1, keepdims=True)
        alpha = jnp.where(den > tiny, rz / jnp.maximum(den, tiny), 0.0)
        X = X + alpha * P
        R = R - alpha * Ap
        Z = dinv[:, :, None] * R
        rz2 = jnp.sum(R * Z, axis=1, keepdims=True)
        beta = jnp.where(rz > tiny, rz2 / jnp.maximum(rz, tiny), 0.0)
        P = Z + beta * P
        return X, R, P, rz2, k + 1

    X, _R, _P, _rz, k = jax.lax.while_loop(
        cond, body, (X, R, P, rz, jnp.zeros((), jnp.int32)))
    return X, k


class SparseArrowBackend(ArrowBackend):
    """ArrowBackend over a SparseArrowheadLP: ELL matvecs + CG leaf solves.

    The root (first stage + linking) stays dense — its dimension is the
    small Schur size nS = n0 + mEl + mIl, exactly as in the reference's
    dense root solvers (DenseSymmetricIndefinite, sLinsysRootAug.C)."""

    def __init__(self, lp: SparseArrowheadLP, factor_dtype=jnp.float64,
                 axis: Optional[str] = None,
                 cg_iters: int = 500, cg_tol: float = 0.0, **kwargs):
        if kwargs.pop("blockwise_sc", 0):
            raise ValueError("blockwise_sc: the sparse leaf already "
                             "streams; caches are O(n * nS) only")
        # leaf-factor switches are meaningless here; the root keeps the
        # explicit-inverse default of the dense backend
        super().__init__(lp, factor_dtype=factor_dtype, axis=axis, **kwargs)
        self.cg_iters = cg_iters
        if cg_tol == 0.0:
            cg_tol = 1e-12 if jnp.dtype(factor_dtype) == jnp.float64 \
                else 1e-7
        self.cg_tol = cg_tol

    # ---- sparse products -------------------------------------------------
    def _Mmv(self, x):
        """[B; D] @ x for x [N, n] -> [N, mE+mI]."""
        return jnp.concatenate([ell_mv(self.lp.B, x),
                                ell_mv(self.lp.D, x)], axis=1)

    def _Mtmv(self, a):
        """[B; D]' @ a for a [N, mE+mI] -> [N, n]."""
        mE = self.lp.mE
        return ell_mv(self.lp.Bt, a[:, :mE]) + ell_mv(self.lp.Dt, a[:, mE:])

    def _Mmv_multi(self, X):
        return jnp.concatenate([ell_mv_multi(self.lp.B, X),
                                ell_mv_multi(self.lp.D, X)], axis=1)

    def _Mtmv_multi(self, A_):
        mE = self.lp.mE
        return (ell_mv_multi(self.lp.Bt, A_[:, :mE])
                + ell_mv_multi(self.lp.Dt, A_[:, mE:]))

    # ---- matvecs (same structure as the dense backend; B/D terms go
    #      through the ELL gathers) ----------------------------------------
    def Ax(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.A0 @ x.first
        blocks = (jnp.einsum("imk,k->im", lp.A, x.first)
                  + ell_mv(lp.B, x.blocks))
        link = lp.F0 @ x.first + self._psum(
            jnp.einsum("iln,in->l", lp.F, x.blocks))
        return RVec(first, blocks, link)

    def ATy(self, y: RVec) -> XVec:
        lp = self.lp
        first = (lp.A0.T @ y.first + lp.F0.T @ y.link
                 + self._psum(jnp.einsum("imk,im->k", lp.A, y.blocks)))
        blocks = (ell_mv(lp.Bt, y.blocks)
                  + jnp.einsum("iln,l->in", lp.F, y.link))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.C0 @ x.first
        blocks = (jnp.einsum("imk,k->im", lp.C, x.first)
                  + ell_mv(lp.D, x.blocks))
        link = lp.G0 @ x.first + self._psum(
            jnp.einsum("iln,in->l", lp.G, x.blocks))
        return RVec(first, blocks, link)

    def CTz(self, z: RVec) -> XVec:
        lp = self.lp
        first = (lp.C0.T @ z.first + lp.G0.T @ z.link
                 + self._psum(jnp.einsum("imk,im->k", lp.C, z.blocks)))
        blocks = (ell_mv(lp.Dt, z.blocks)
                  + jnp.einsum("iln,l->in", lp.G, z.link))
        return XVec(first, blocks)

    # ---- condensed-system tools ------------------------------------------
    def _Fd(self, Om, delta_d):
        lp = self.lp
        dd = jnp.broadcast_to(jnp.asarray(delta_d, Om.dtype), (lp.N, lp.mE))
        return jnp.concatenate([dd, Om + delta_d], axis=1)

    def _neq_apply(self, Einv, Fd, V):
        """Neq @ V = M E^{-1} M' V + F_d V, multi-RHS V [N, a, c]."""
        t = Einv[:, :, None] * self._Mtmv_multi(V)
        return self._Mmv_multi(t) + Fd[:, :, None] * V

    def _leaf_cg(self, Einv, Fd, dinv, Bc):
        return batched_pcg(lambda V: self._neq_apply(Einv, Fd, V),
                           Bc, dinv, self.cg_iters, self.cg_tol)

    # ---- factorize: condensation + Schur contribution, no leaf factor ----
    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d):
        lp = self.lp
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI, n = lp.mE, lp.mI, lp.n

        Einv = 1.0 / (Dx.blocks + delta_p)                    # [N, n]
        Om = 1.0 / Ominv.blocks                               # [N, mI]
        Fd = self._Fd(Om, delta_d)                            # [N, a]
        # Jacobi preconditioner: diag(Neq) = sum_n M^2 Einv + Fd
        diag = (jnp.concatenate([ell_sq_diag(lp.B, Einv),
                                 ell_sq_diag(lp.D, Einv)], axis=1) + Fd)
        dinv = 1.0 / diag

        # border right-hand sides (columns [x0 | yl | zl]), as in the
        # dense path (arrow_backend.py factorize) but with ELL products
        dt = Einv.dtype
        EiRx = jnp.concatenate([
            jnp.zeros((lp.N, n, n0), dt),
            jnp.swapaxes(lp.F, 1, 2) * Einv[:, :, None],
            jnp.swapaxes(lp.G, 1, 2) * Einv[:, :, None]], axis=2)
        Rm = jnp.concatenate([
            jnp.concatenate([lp.A, jnp.zeros((lp.N, mE, mEl + mIl), dt)],
                            axis=2),
            jnp.concatenate([lp.C, jnp.zeros((lp.N, mI, mEl + mIl), dt)],
                            axis=2)], axis=1)                 # [N, a, nS]

        rhsU = self._Mmv_multi(EiRx) - Rm
        Um, _iters = self._leaf_cg(Einv, Fd, dinv, rhsU)      # [N, a, nS]
        Ux = EiRx - Einv[:, :, None] * self._Mtmv_multi(Um)

        contrib_x0 = (jnp.einsum("imk,imS->kS", lp.A, Um[:, :mE])
                      + jnp.einsum("imk,imS->kS", lp.C, Um[:, mE:]))
        contrib_yl = jnp.einsum("ilm,imS->lS", lp.F, Ux)
        contrib_zl = jnp.einsum("ilm,imS->lS", lp.G, Ux)
        contrib = self._psum(jnp.concatenate(
            [contrib_x0, contrib_yl, contrib_zl], axis=0))

        leaf_ok = (jnp.all(jnp.isfinite(Um)) & jnp.all(diag > 0.0))
        # fac.Ninv carries the Jacobi diagonal inverse (leaf CG state);
        # fac.L is unused on this path
        return self._assemble_root(
            Dx, Ominv, delta_p, delta_d, jnp.zeros((), dt), dinv, Einv, Om,
            Ux, Um, contrib, leaf_ok)

    # ---- leaf solves ------------------------------------------------------
    def _leaf_solve(self, fac, rho_x, rho_m):
        """K_b^{-1}(rho_x, rho_m) via one CG on the condensed system."""
        Fd = self._Fd(fac.Om, fac.delta_d)
        t = self._Mmv(fac.Einv * rho_x) - rho_m               # [N, a]
        gm, _ = self._leaf_cg(fac.Einv, Fd, fac.Ninv, t[:, :, None])
        gm = gm[:, :, 0]
        gx = fac.Einv * (rho_x - self._Mtmv(gm))
        return gx, gm

    def _leaf_apply_inv(self, L, Ninv, Einv, M, rx, rm):
        raise NotImplementedError(
            "sparse leaves stream through factorize(); blockwise_sc is "
            "dense-only")
