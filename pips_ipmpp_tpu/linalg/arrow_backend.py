r"""Arrowhead backend: batched block KKT condensation + Schur complement.

The core of the framework.  Per IPM iteration, for every block i (all N
at once, as batched dense linear algebra — this replaces the reference's
per-rank loop over PARDISO Schur factorizations,
DistributedRootLinearSystem::factor2, DistributedRootLinearSystem.C:206-243
and PardisoSchurSolver::computeSC):

  block augmented KKT (quasidefinite; x-block diagonal for LPs):

      K_i = [ E_i    M_i' ]   E_i = Dx_i + dp (diag)   M_i = [B_i; D_i]
            [ M_i   -F_i  ]   F_i = diag(dd, Om_i + dd)

  border to the root unknowns s0 = [x0 | yl | zl] (reference: Amat border +
  Blmat linking strips, DistributedMatrix.h:44-48):

      R_i = [ 0    F_i'  G_i' ]      (x_i rows)
            [ A_i  0     0    ]      (y_i rows)
            [ C_i  0     0    ]      (z_i rows)

  condensation: Neq_i = M_i E_i^{-1} M_i' + F_i  (SPD) -> batched Cholesky;
  border solves U_i = K_i^{-1} R_i and the Schur contribution
  -R_i' K_i^{-1} R_i are evaluated with batched matmuls only.

The root system over s0full = [x0; y0; z0; yl; zl]:

      S = K_0 - sum_i R_i' K_i^{-1} R_i        (psum over the mesh axis —
                                                the reference's chunked
                                                MPI_Allreduce, :860-975)

is quasidefinite with SPD x0-block, solved by a second condensation
(dense Cholesky of S11, then of the dual Schur complement) — the role of
the reference's dense root solvers (DeSymIndefSolver.C, sLinsysRootAug.C).

Per-RHS solves then cost one batched triangular sweep + two small dense
triangular solves + one batched matmul with the cached U_i
(sLinsysRootAug Lsolve/Dsolve/Ltsolve, sLinsysRootAug.C:323-365).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from pips_ipmpp_tpu.core.lp import ArrowheadLP, _register
from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.ipm.formulation import Bounds, ReducedRhs


@_register
@dataclass
class ArrowFactors:
    L: jax.Array        # [N, mE+mI, mE+mI] batched Cholesky of Neq_i
    Ninv: jax.Array     # [N, a, a] explicit Neq^{-1} (matmul solve path) or ()
    Einv: jax.Array     # [N, n]
    Om: jax.Array       # [N, mI]
    Ux: jax.Array       # [N, n, nS]      K^{-1}R rows x
    Um: jax.Array       # [N, mE+mI, nS]  K^{-1}R rows (y,z)
    chol1: jax.Array    # [n0, n0] Cholesky of S11 (x0 block)
    S11inv: jax.Array   # [n0, n0] explicit inverse or ()
    T: jax.Array        # [n0, nD] S11^{-1} S12
    chol2: jax.Array    # [nD, nD] Cholesky of -(S22 - S12'T) (dual Schur)
    Sdinv: jax.Array    # [nD, nD] explicit inverse or ()
    Einv0: jax.Array    # [n0]
    Om0: jax.Array      # [m0I]
    Oml: jax.Array      # [mIl]
    delta_p: jax.Array
    delta_d: jax.Array
    ok: jax.Array       # scalar factorization-health flag (local)
    Wd: jax.Array       # [nD, nD/P] column-sharded dual-Schur inverse
                        # (distributed-root mode, linalg/dist_root.py) or ()
    Sd: jax.Array = ()  # [nD, nD] dense dual Schur complement (iterative-
                        # root mode: kept for the CG matvec) or ()
    Pchol: jax.Array = ()  # [k, pb, pb] sparsified block-Jacobi panel
                        # Cholesky (linalg/sc_precond.py) or ()
    RbG: jax.Array = ()  # [nb, 1, b, b] banded-root panel inverses
                        # (linalg/band_root.py, 2-link SC exploitation) or ()
    RbC: jax.Array = ()  # [nb, 1, b, b] banded-root sub-diagonal factors
    extra_root: jax.Array = 0.0  # extra root-only regularization applied by
                        # the in-factorize escalation (scalar; the root
                        # system carries delta_p + extra_root on its primal
                        # diagonal and delta_d + extra_root on its dual rows)


def _bchol_solve(L, b):
    """Batched SPD solve via cached Cholesky: L L' x = b."""
    u = jax.lax.linalg.triangular_solve(L, b, left_side=True, lower=True,
                                        transpose_a=False)
    return jax.lax.linalg.triangular_solve(L, u, left_side=True, lower=True,
                                           transpose_a=True)


def batched_cholesky_factor(Neq, explicit_inverse: bool):
    """Batched Cholesky of SPD Neq [N, a, a], plus the explicit inverse
    Neq^{-1} (two batched triangular solves of the identity) when asked.
    Returns (L, Ninv or (), ok) with ok = every entry finite."""
    L = jnp.linalg.cholesky(Neq)
    if not explicit_inverse:
        return L, jnp.zeros((), Neq.dtype), jnp.all(jnp.isfinite(L))
    eye = jnp.broadcast_to(jnp.eye(Neq.shape[-1], dtype=Neq.dtype),
                           Neq.shape)
    Ninv = _bchol_solve(L, eye)
    return L, Ninv, jnp.all(jnp.isfinite(L)) & jnp.all(jnp.isfinite(Ninv))


def _spd_solve(chol, b):
    u = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
    return jax.scipy.linalg.solve_triangular(chol.T, u, lower=False)



def preconditioned_bicgstab(b, precond, applyK, dot, max_iters, tol):
    """Layout-generic preconditioned BiCGStab on K u = b.

    `b` is any pytree; `precond(v)`/`applyK(v)` map pytree->pytree;
    `dot(a, b)` is the (collective-aware) inner product.  Returns
    (u, stats dict) with breakdown/divergence flags (the reference's
    BiCGStabSolver stagnation/breakdown detection, BiCGStabSolver.h:14-39).
    """
    tadd = lambda s, t, c: jax.tree.map(lambda a, bb: a + c * bb, s, t)
    tsub = lambda s, t, c: jax.tree.map(lambda a, bb: a - c * bb, s, t)

    bnorm = jnp.sqrt(jnp.maximum(dot(b, b), 1e-300))
    u0 = precond(b)
    r0 = jax.tree.map(lambda x, y: x - y, b, applyK(u0))
    rhat = r0
    rho0 = dot(rhat, r0)
    rnorm0 = jnp.sqrt(jnp.maximum(dot(r0, r0), 0.0))

    def cond(carry):
        u, r, p, v, rho, alpha, omega, k, rnorm, flag = carry
        return (k < max_iters) & (rnorm > tol * bnorm) & (flag == 0)

    def body(carry):
        u, r, p, v, rho_prev, alpha, omega, k, rnorm, flag = carry
        rho = dot(rhat, r)
        breakdown = jnp.abs(rho) < 1e-300
        beta = (rho / jnp.where(breakdown, 1.0, rho_prev)) \
            * (alpha / jnp.where(jnp.abs(omega) < 1e-300, 1.0, omega))
        p = jax.tree.map(lambda rr, pp, vv: rr + beta * (pp - omega * vv),
                         r, p, v)
        ph = precond(p)
        v2 = applyK(ph)
        denom = dot(rhat, v2)
        alpha2 = rho / jnp.where(jnp.abs(denom) < 1e-300, 1.0, denom)
        s = tsub(r, v2, alpha2)
        sh = precond(s)
        t = applyK(sh)
        tt = dot(t, t)
        omega2 = dot(t, s) / jnp.maximum(tt, 1e-300)
        u2 = tadd(tadd(u, ph, alpha2), sh, omega2)
        r2 = tsub(s, t, omega2)
        rnorm2 = jnp.sqrt(jnp.maximum(dot(r2, r2), 0.0))
        flag2 = jnp.where(breakdown | (jnp.abs(denom) < 1e-300),
                          jnp.asarray(1, jnp.int32),
                          jnp.where(rnorm2 > 1e4 * rnorm0,
                                    jnp.asarray(2, jnp.int32),
                                    jnp.asarray(0, jnp.int32)))
        return (u2, r2, p, v2, rho, alpha2, omega2, k + 1, rnorm2, flag2)

    zerov = jax.tree.map(jnp.zeros_like, b)
    carry0 = (u0, r0, zerov, zerov, rho0,
              jnp.ones((), bnorm.dtype), jnp.ones((), bnorm.dtype),
              jnp.zeros((), jnp.int32), rnorm0, jnp.zeros((), jnp.int32))
    u, r, _, _, _, _, _, k, rnorm, flag = jax.lax.while_loop(
        cond, body, carry0)
    stats = dict(iterations=k, relres=rnorm / bnorm,
                 converged=(rnorm <= tol * bnorm), flag=flag)
    return u, stats



def preconditioned_cg(b, precond, applyK, dot, max_iters, tol):
    """Layout-generic preconditioned conjugate gradients (the reference's
    CGSolver/PCGSolver family) for SPD operators; same pytree contract as
    preconditioned_bicgstab. Returns (u, stats)."""
    bnorm = jnp.sqrt(jnp.maximum(dot(b, b), 1e-300))
    u0 = jax.tree.map(jnp.zeros_like, b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    rn0 = jnp.sqrt(jnp.maximum(dot(r0, r0), 0.0))

    def cond(c):
        u, r, z, p, rz, k, rn, flag = c
        return (k < max_iters) & (rn > tol * bnorm) & (flag == 0)

    def body(c):
        u, r, z, p, rz, k, rn, flag = c
        Kp = applyK(p)
        denom = dot(p, Kp)
        breakdown = jnp.abs(denom) < 1e-300
        alpha = rz / jnp.where(breakdown, 1.0, denom)
        u2 = jax.tree.map(lambda a, bb: a + alpha * bb, u, p)
        r2 = jax.tree.map(lambda a, bb: a - alpha * bb, r, Kp)
        z2 = precond(r2)
        rz2 = dot(r2, z2)
        beta = rz2 / jnp.where(jnp.abs(rz) < 1e-300, 1.0, rz)
        p2 = jax.tree.map(lambda a, bb: a + beta * bb, z2, p)
        rn2 = jnp.sqrt(jnp.maximum(dot(r2, r2), 0.0))
        flag2 = jnp.where(breakdown, jnp.asarray(1, jnp.int32),
                          jnp.asarray(0, jnp.int32))
        return (u2, r2, z2, p2, rz2, k + 1, rn2, flag2)

    u, r, _, _, _, k, rn, flag = jax.lax.while_loop(
        cond, body, (u0, r0, z0, p0, rz0, jnp.zeros((), jnp.int32), rn0,
                     jnp.zeros((), jnp.int32)))
    return u, dict(iterations=k, relres=rn / bnorm,
                   converged=(rn <= tol * bnorm), flag=flag)


class ArrowBackend:
    """Backend over an ArrowheadLP. `axis` names the mesh axis when running
    inside shard_map (block batch sharded; first-stage/link replicated)."""

    def __init__(self, lp: ArrowheadLP, factor_dtype=jnp.float64,
                 axis: Optional[str] = None,
                 explicit_inverse: Optional[bool] = None,
                 blockwise_sc: int = 0,
                 dist_root: bool = False,
                 n_shards: int = 1,
                 iterative_root: int = 0,
                 sc_diag_dom_bound: float = 0.001,
                 it_root_tol: float = 1e-9,
                 it_root_maxiter: int = 200,
                 band_root_plan=None,
                 root_escalation: bool = True,
                 root_escalation_base: float = 1e-4,
                 root_escalation_growth: float = 100.0,
                 root_escalation_max: float = 10.0):
        self.lp = lp
        self.axis = axis
        self.factor_dtype = factor_dtype
        # f32 factors apply explicit inverses: one multi-RHS solve at
        # factorize time buys matvec-only back-substitutions, and
        # refinement in the working dtype absorbs the inverse round-off
        if explicit_inverse is None:
            explicit_inverse = (jnp.dtype(factor_dtype) == jnp.float32)
        self.explicit_inverse = explicit_inverse
        # in-factorize ROOT-ONLY shift escalation (see _assemble_root):
        # retries the tiny root factor with growing extra shifts instead of
        # reporting failure to the outer loop (which would redo the leaves)
        self.root_escalation = root_escalation
        self.root_escalation_base = root_escalation_base
        self.root_escalation_growth = root_escalation_growth
        self.root_escalation_max = root_escalation_max
        # distributed root: column-shard the dual Schur complement over the
        # mesh axis and factorize it with the panel-blocked distributed
        # Cholesky (linalg/dist_root.py) — the linking dimension is no
        # longer replicated-memory-bound (reference: MUMPS root over a
        # sub-communicator, MumpsSolverBase.h:28-72)
        if dist_root and axis is None:
            raise ValueError("dist_root requires a mesh axis")
        self.dist_root = dist_root
        self.n_shards = n_shards
        # blockwise Schur computation (reference SC_COMPUTE_BLOCKWISE,
        # DistributedLinearSystem.h:77-99): border solves are streamed in
        # column chunks of this size and the K^{-1}R caches are NOT stored;
        # back-substitution recomputes them with one extra leaf solve.
        # 0 disables (full caches). Bounds factorize memory to
        # O(N * k * blockwise_sc) instead of O(N * k * nS).
        self.blockwise_sc = blockwise_sc
        # iterative root (reference PRECONDITION_SPARSE/DISTRIBUTED +
        # SCsparsifier): when > 0, the dual Schur complement is NOT
        # factorized densely; `iterative_root` is the preconditioner panel
        # size — sparsified block-Jacobi panels (linalg/sc_precond.py) +
        # preconditioned CG on the dense SC matvec.  O(nD*pb^2 + its*nD^2)
        # per iteration instead of O(nD^3).
        self.iterative_root = int(iterative_root)
        self.sc_diag_dom_bound = float(sc_diag_dom_bound)
        self.it_root_tol = float(it_root_tol)
        self.it_root_maxiter = int(it_root_maxiter)
        # banded root (linalg/band_root.py): 2-link linking structure
        # makes the dual SC banded after the plan's permutation; the root
        # factorization becomes O(nD b^2).  Exclusive with the other
        # special root modes; composes with any leaf mode.
        self.band_root_plan = band_root_plan
        if band_root_plan is not None:
            if dist_root or iterative_root:
                raise ValueError("band_root_plan is exclusive with "
                                 "dist_root/iterative_root")
            self._rb_perm = jnp.asarray(band_root_plan.perm)
            self._rb_iperm = jnp.asarray(band_root_plan.iperm)
        if self.iterative_root and dist_root:
            raise ValueError("iterative_root and dist_root are "
                             "mutually exclusive root modes")
        self.bounds = Bounds(
            c=XVec(lp.c0, lp.cN),
            b=RVec(lp.b0, lp.bN, lp.bl),
            ixlow=XVec(lp.ixlow0, lp.ixlowN), xlow=XVec(lp.xlow0, lp.xlowN),
            ixupp=XVec(lp.ixupp0, lp.ixuppN), xupp=XVec(lp.xupp0, lp.xuppN),
            iclow=RVec(lp.iclow0, lp.iclowN, lp.iclowl),
            clow=RVec(lp.clow0, lp.clowN, lp.clowl),
            icupp=RVec(lp.icupp0, lp.icuppN, lp.icuppl),
            cupp=RVec(lp.cupp0, lp.cuppN, lp.cuppl),
        )
        local = (jnp.sum(lp.ixlowN) + jnp.sum(lp.ixuppN)
                 + jnp.sum(lp.iclowN) + jnp.sum(lp.icuppN))
        if axis is not None:
            local = jax.lax.psum(local, axis)
        rep = (jnp.sum(lp.ixlow0) + jnp.sum(lp.ixupp0)
               + jnp.sum(lp.iclow0) + jnp.sum(lp.icupp0)
               + jnp.sum(lp.iclowl) + jnp.sum(lp.icuppl))
        self.num_bound_pairs = jnp.maximum(local + rep, 1.0)

    # ---- helpers ----
    def _psum(self, v):
        return jax.lax.psum(v, self.axis) if self.axis is not None else v

    # ---- matvecs (recursive tree mult of the reference,
    #      DistributedMatrix.C mult/transMult, collapsed to batched einsum) --
    def Ax(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.A0 @ x.first
        blocks = (jnp.einsum("imk,k->im", lp.A, x.first)
                  + jnp.einsum("imn,in->im", lp.B, x.blocks))
        link = lp.F0 @ x.first + self._psum(
            jnp.einsum("iln,in->l", lp.F, x.blocks))
        return RVec(first, blocks, link)

    def ATy(self, y: RVec) -> XVec:
        lp = self.lp
        first = (lp.A0.T @ y.first + lp.F0.T @ y.link
                 + self._psum(jnp.einsum("imk,im->k", lp.A, y.blocks)))
        blocks = (jnp.einsum("imn,im->in", lp.B, y.blocks)
                  + jnp.einsum("iln,l->in", lp.F, y.link))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        lp = self.lp
        first = lp.C0 @ x.first
        blocks = (jnp.einsum("imk,k->im", lp.C, x.first)
                  + jnp.einsum("imn,in->im", lp.D, x.blocks))
        link = lp.G0 @ x.first + self._psum(
            jnp.einsum("iln,in->l", lp.G, x.blocks))
        return RVec(first, blocks, link)

    def CTz(self, z: RVec) -> XVec:
        lp = self.lp
        first = (lp.C0.T @ z.first + lp.G0.T @ z.link
                 + self._psum(jnp.einsum("imk,im->k", lp.C, z.blocks)))
        blocks = (jnp.einsum("imn,im->in", lp.D, z.blocks)
                  + jnp.einsum("iln,l->in", lp.G, z.link))
        return XVec(first, blocks)

    def objective(self, x: XVec) -> jax.Array:
        return (jnp.vdot(self.lp.c0, x.first)
                + self._psum(jnp.vdot(self.lp.cN, x.blocks)))

    def datanorm(self) -> jax.Array:
        local = self.lp.datanorm()
        return (jax.lax.pmax(local, self.axis)
                if self.axis is not None else local)

    # ---- overridable leaf-factorization hooks (structure-exploiting
    #      subclasses — e.g. the banded backend — replace only these) ----
    def _leaf_factor(self, M, MEi, Fd):
        """Factor the condensed leaf systems Neq_i = MEi M' + diag(Fd).

        Returns (L, Ninv, leaf_ok).  L/Ninv are whatever pytrees
        `_apply_Ninv_multi` consumes; the dense base class stores the
        batched Cholesky factor and (optionally) the explicit inverse."""
        fd = self.factor_dtype
        Neq = (jnp.einsum("iak,ibk->iab", MEi.astype(fd), M.astype(fd))
               + jax.vmap(jnp.diag)(Fd.astype(fd)))
        return batched_cholesky_factor(Neq, self.explicit_inverse)

    def _apply_Ninv_multi(self, L, Ninv, t):
        """Neq^{-1} t for multi-RHS t [N, a, c] via the stored leaf factor.

        Dispatch is shape-driven (which factor is populated), so any
        subclass combination of leaf mode and root mode works: explicit
        Ninv [N, a, a], or Cholesky L."""
        if getattr(Ninv, "ndim", 0) == 3:
            return jnp.einsum("iab,ibc->iac", Ninv, t)
        return _bchol_solve(L, t)

    # ------------------------------------------------------------------
    def leaf_factorize(self, Dx_blocks, Ominv_blocks, delta_p, delta_d):
        """Leaf phase of factorize: batched condensation, border solves,
        and the LOCAL (un-psummed) Schur contribution of this backend's
        blocks.  Returns (L, Ninv, Einv, Om, Ux, Um, contrib_local,
        leaf_ok) — split out so composite backends (bucketed heterogeneous
        block sizes) can run it once per bucket and sum contributions
        before a single shared root assembly."""
        lp = self.lp
        fd = self.factor_dtype
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI = lp.mE, lp.mI

        # ---- leaf condensation (batched over blocks) ----
        Einv = 1.0 / (Dx_blocks + delta_p)                     # [N, n]
        Om = 1.0 / Ominv_blocks                                # [N, mI]
        M = jnp.concatenate([lp.B, lp.D], axis=1)              # [N, mE+mI, n]
        Fd = jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(delta_d, Einv.dtype), (lp.N, mE)),
            Om + delta_d], axis=1)                             # [N, mE+mI]
        MEi = M * Einv[:, None, :]
        L, Ninv, leaf_ok = self._leaf_factor(M, MEi, Fd)
        if self.blockwise_sc > 0:
            contrib = self._contrib_blockwise(
                L, Ninv, Einv, M).astype(Einv.dtype)
            Ux = jnp.zeros((), Einv.dtype)
            Um = jnp.zeros((), Einv.dtype)
            return L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok

        # ---- border solves U = K^{-1} R (structure-exploiting) ----
        # E^{-1} R_x = [0 | Einv*F' | Einv*G']
        EiRx = jnp.concatenate([
            jnp.zeros((lp.N, lp.n, n0), Einv.dtype),
            jnp.swapaxes(lp.F, 1, 2) * Einv[:, :, None],
            jnp.swapaxes(lp.G, 1, 2) * Einv[:, :, None]], axis=2)  # [N,n,nS]
        Rm = jnp.concatenate([
            jnp.concatenate([lp.A, jnp.zeros((lp.N, mE, mEl + mIl),
                                             Einv.dtype)], axis=2),
            jnp.concatenate([lp.C, jnp.zeros((lp.N, mI, mEl + mIl),
                                             Einv.dtype)], axis=2)],
            axis=1)                                            # [N,mE+mI,nS]
        Mf = M.astype(fd)
        EiRxf = EiRx.astype(fd)
        rhsU = jnp.einsum("iam,imS->iaS", Mf, EiRxf) - Rm.astype(fd)
        Um = self._apply_Ninv_multi(L, Ninv, rhsU)
        Ux = EiRxf - Einv.astype(fd)[:, :, None] * jnp.einsum(
            "iam,iaS->imS", Mf, Um)

        # ---- Schur contribution  -R' U ----
        # R'U rows: [A'U_my + C'U_mz ; F U_x ; G U_x]; matmuls in the
        # factor dtype — refinement absorbs the error in the working dtype
        contrib_x0 = (jnp.einsum("imk,imS->kS", lp.A.astype(fd), Um[:, :mE])
                      + jnp.einsum("imk,imS->kS", lp.C.astype(fd), Um[:, mE:]))
        contrib_yl = jnp.einsum("ilm,imS->lS", lp.F.astype(fd), Ux)
        contrib_zl = jnp.einsum("ilm,imS->lS", lp.G.astype(fd), Ux)
        Um = Um.astype(Einv.dtype)
        Ux = Ux.astype(Einv.dtype)
        contrib = jnp.concatenate(
            [contrib_x0, contrib_yl, contrib_zl], axis=0).astype(Einv.dtype)
        return L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok

    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> ArrowFactors:
        L, Ninv, Einv, Om, Ux, Um, contrib, leaf_ok = self.leaf_factorize(
            Dx.blocks, Ominv.blocks, delta_p, delta_d)
        # psum = the SC allreduce (reference chunked MPI_Allreduce,
        # DistributedRootLinearSystem.C:860-975)
        contrib = self._psum(contrib)
        return self._assemble_root(Dx, Ominv, delta_p, delta_d, L, Ninv,
                                   Einv, Om, Ux, Um, contrib, leaf_ok)

    def _assemble_root(self, Dx, Ominv, delta_p, delta_d, L, Ninv, Einv,
                       Om, Ux, Um, contrib, leaf_ok=None):
        lp = self.lp
        fd = self.factor_dtype
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mEl, mIl = lp.mEl, lp.mIl
        # ---- root matrix S over s0full = [x0; y0; z0; yl; zl] ----
        Einv0 = 1.0 / (Dx.first + delta_p)
        Om0 = 1.0 / Ominv.first
        Oml = 1.0 / Ominv.link
        nD = m0E + m0I + mEl + mIl
        dt = Einv.dtype

        S11 = jnp.diag(Dx.first + delta_p)                     # [n0, n0]
        # dual rows stacked [y0; z0; yl; zl] vs x0 columns
        M0 = jnp.concatenate([lp.A0, lp.C0, lp.F0, lp.G0], axis=0)  # [nD,n0]
        F0d = jnp.concatenate([
            jnp.full((m0E,), delta_d, dt), Om0 + delta_d,
            jnp.full((mEl,), delta_d, dt), Oml + delta_d])
        S22 = -jnp.diag(F0d)

        # embed -contrib (rows/cols [x0, yl, zl]) into S
        # order inside contrib: [x0(n0), yl(mEl), zl(mIl)]
        # target rows in s0full: x0 -> 0:n0 ; yl -> n0+m0E+m0I : +mEl ;
        #                        zl -> tail
        def split_S(Cm):
            cx, cyl, czl = (Cm[:n0], Cm[n0:n0 + mEl], Cm[n0 + mEl:])
            return cx, cyl, czl

        cxx, cylx, czlx = split_S(contrib)   # rows
        # columns have same ordering; build full blocks
        S11 = S11 - cxx[:, :n0]
        # dual-space layout: [y0(m0E), z0(m0I), yl(mEl), zl(mIl)]
        dy0, dz0 = m0E, m0I
        S12 = jnp.zeros((n0, nD), dt)
        S12 = S12.at[:, :m0E].set(lp.A0.T)
        S12 = S12.at[:, m0E:m0E + m0I].set(lp.C0.T)
        S12 = S12.at[:, m0E + m0I:m0E + m0I + mEl].set(
            lp.F0.T - cxx[:, n0:n0 + mEl])
        S12 = S12.at[:, m0E + m0I + mEl:].set(lp.G0.T - cxx[:, n0 + mEl:])
        # dual-dual contributions (yl/zl rows x yl/zl cols)
        S22 = S22.at[m0E + m0I:m0E + m0I + mEl, m0E + m0I:m0E + m0I + mEl
                     ].add(-cylx[:, n0:n0 + mEl])
        S22 = S22.at[m0E + m0I:m0E + m0I + mEl, m0E + m0I + mEl:
                     ].add(-cylx[:, n0 + mEl:])
        S22 = S22.at[m0E + m0I + mEl:, m0E + m0I:m0E + m0I + mEl
                     ].add(-czlx[:, n0:n0 + mEl])
        S22 = S22.at[m0E + m0I + mEl:, m0E + m0I + mEl:
                     ].add(-czlx[:, n0 + mEl:])

        if leaf_ok is None:
            leaf_ok = jnp.asarray(True)

        if self.band_root_plan is not None:
            # ---- banded root: dual block eliminated FIRST via the
            # block-tridiagonal Cholesky of the permuted SDD = -S22 (the
            # 2-link sparse-SC exploitation, DistributedProblem.hpp:66-77);
            # the small primal Schur complement S11x = S11 + S12 SDD^{-1}
            # S12' is factored dense ----
            from pips_ipmpp_tpu.linalg.band_backend import (
                block_tridiag_factor)
            plan = self.band_root_plan
            b, nb, kd = plan.panel, plan.n_panels, plan.n_dense
            nband = nD - kd
            P = self._rb_perm
            SDD = -(S22[P][:, P]).astype(fd)             # SPD, banded+dense
            Bb = SDD[:nband, :nband]
            pad = nb * b - nband
            if pad:
                Bb = jnp.pad(Bb, ((0, pad), (0, pad)))
                Bb = Bb.at[nband:, nband:].set(jnp.eye(pad, dtype=fd))
            Adiag = jnp.stack([Bb[k * b:(k + 1) * b, k * b:(k + 1) * b]
                               for k in range(nb)])[:, None]
            Asub = jnp.stack(
                [Bb[(k + 1) * b:(k + 2) * b, k * b:(k + 1) * b]
                 for k in range(nb - 1)]
                + [jnp.zeros((b, b), fd)])[:, None]
            Ginv, Cb, okd = block_tridiag_factor(Adiag, Asub)
            if kd:
                # peeled wide/global linking rows: trailing dense Schur
                Ud = SDD[:nband, nband:]                 # [nband, kd]
                Wdns = self._rb_band_solve(Ginv, Cb, Ud)
                Sd_ = SDD[nband:, nband:] - Ud.T @ Wdns
                cholSd = jnp.linalg.cholesky(Sd_)
                Sdinv_d = _spd_solve(cholSd, jnp.eye(kd, dtype=fd))
                okd = okd & jnp.all(jnp.isfinite(Sdinv_d))
                Rb = (Ginv, Cb, Ud, Wdns, Sdinv_d)
            else:
                Rb = (Ginv, Cb)
            S12p = S12[:, P].astype(fd)                  # [n0, nD]
            Td = self._rb_solve(Rb, S12p.T)              # SDD^{-1} S12'
            S11x = S11.astype(fd) + S12p @ Td
            chol1 = jnp.linalg.cholesky(S11x)
            root_ok = okd & jnp.all(jnp.isfinite(chol1))
            z = jnp.zeros((), fd)
            return ArrowFactors(L=L, Ninv=Ninv, Einv=Einv, Om=Om, Ux=Ux,
                                Um=Um, chol1=chol1, S11inv=z,
                                T=S12p.astype(dt), chol2=z, Sdinv=z,
                                Einv0=Einv0, Om0=Om0, Oml=Oml,
                                delta_p=jnp.asarray(delta_p, Einv.dtype),
                                delta_d=jnp.asarray(delta_d, Einv.dtype),
                                ok=leaf_ok & root_ok, Wd=z,
                                RbG=Rb, RbC=z)

        if self.dist_root:
            from pips_ipmpp_tpu.linalg.dist_root import (dist_chol_inverse,
                                                         own_slice)
            nD_total = nD
            # first-stage block stays replicated (n0 is small); the big
            # dual Schur complement is column-sharded over the mesh
            chol1 = jnp.linalg.cholesky(S11.astype(fd))
            S12f = S12.astype(fd)
            S12_cols = own_slice(S12f, self.axis, self.n_shards)  # [n0,nDp]
            T_cols = _spd_solve(chol1, S12_cols)                  # [n0,nDp]
            S22_cols = own_slice(S22.astype(fd), self.axis, self.n_shards)
            Sdual_cols = -(S22_cols - S12f.T @ T_cols)            # [nD,nDp]
            Wd, root_ok = dist_chol_inverse(Sdual_cols, self.axis,
                                            self.n_shards)
            root_ok = root_ok & jnp.all(jnp.isfinite(chol1))
            z = jnp.zeros((), fd)
            return ArrowFactors(L=L, Ninv=Ninv, Einv=Einv, Om=Om, Ux=Ux,
                                Um=Um, chol1=chol1, S11inv=z,
                                T=T_cols.astype(Einv.dtype), chol2=z,
                                Sdinv=z, Einv0=Einv0, Om0=Om0, Oml=Oml,
                                delta_p=jnp.asarray(delta_p, Einv.dtype),
                                delta_d=jnp.asarray(delta_d, Einv.dtype),
                                ok=leaf_ok & root_ok, Wd=Wd)

        if self.iterative_root:
            # ---- preconditioned iterative root (reference SCsparsifier +
            # precondSC path) ----: factor only S11 and the sparsified
            # block-Jacobi panels of the dual SC; Dsolve runs CG
            from pips_ipmpp_tpu.linalg.sc_precond import block_jacobi_factors
            chol1 = jnp.linalg.cholesky(S11.astype(fd))
            T = _spd_solve(chol1, S12.astype(fd))
            Sdual = -(S22.astype(fd) - S12.astype(fd).T @ T)
            Pchol, _dropped = block_jacobi_factors(
                Sdual, self.iterative_root, self.sc_diag_dom_bound)
            root_ok = (jnp.all(jnp.isfinite(chol1))
                       & jnp.all(jnp.isfinite(Pchol)))
            z = jnp.zeros((), fd)
            return ArrowFactors(L=L, Ninv=Ninv, Einv=Einv, Om=Om, Ux=Ux,
                                Um=Um, chol1=chol1, S11inv=z,
                                T=T.astype(dt), chol2=z, Sdinv=z,
                                Einv0=Einv0, Om0=Om0, Oml=Oml,
                                delta_p=jnp.asarray(delta_p, Einv.dtype),
                                delta_d=jnp.asarray(delta_d, Einv.dtype),
                                ok=leaf_ok & root_ok, Wd=z,
                                Sd=Sdual, Pchol=Pchol)

        # ---- root two-level condensation ----
        S11f, S12f, S22f = S11.astype(fd), S12.astype(fd), S22.astype(fd)
        eye1 = jnp.eye(n0, dtype=fd)
        eyeD = jnp.eye(nD, dtype=fd)

        def _root_factor(extra):
            # the shifted quasidefinite root [[S11 + e I, S12],
            # [S12', S22 - e I]]: SPD primal block, negative-definite dual
            chol1 = jnp.linalg.cholesky(S11f + extra * eye1)
            T = _spd_solve(chol1, S12f)
            chol2 = jnp.linalg.cholesky(-(S22f - extra * eyeD - S12f.T @ T))
            ok_ = jnp.all(jnp.isfinite(chol1)) & jnp.all(jnp.isfinite(chol2))
            return (chol1, T, chol2), ok_

        root, root_ok = _root_factor(jnp.zeros((), fd))
        extra = jnp.zeros((), fd)
        if self.root_escalation:
            # A wrong-inertia failure in f32 sits in THIS small root
            # system, not in the leaves: escalate only the root shift in
            # place instead of failing the whole factorization — an
            # outer-loop retry would redo every leaf factorization just to
            # rebuild this [n0 + nD] factor.  Zero extra cost on healthy
            # turns (the while_loop exits immediately).
            def _cond(c):
                ex, _, ok_ = c
                return (~ok_) & (ex < self.root_escalation_max)

            def _body(c):
                ex, _, _ = c
                ex2 = jnp.where(
                    ex == 0.0, self.root_escalation_base,
                    ex * self.root_escalation_growth).astype(fd)
                # clamp so the configured max is the LAST rung tried,
                # never overshot by a growth factor
                ex2 = jnp.minimum(
                    ex2, jnp.asarray(self.root_escalation_max, fd))
                root2, ok2 = _root_factor(ex2)
                return ex2, root2, ok2

            extra, root, root_ok = jax.lax.while_loop(
                _cond, _body, (extra, root, root_ok))
            # the solved system now carries delta_p + extra on the
            # first-stage primal diagonal and delta_d + extra on the root
            # dual rows; Einv0/extra_root keep the refinement residual
            # (_aug_residual) consistent with it
            Einv0 = 1.0 / (Dx.first + delta_p + extra.astype(dt))
        chol1, T, chol2 = root
        if self.explicit_inverse:
            S11inv = _spd_solve(chol1, eye1)
            Sdinv = _spd_solve(chol2, eyeD)
            root_ok = (root_ok & jnp.all(jnp.isfinite(S11inv))
                       & jnp.all(jnp.isfinite(Sdinv)))
        else:
            S11inv = jnp.zeros((), fd)
            Sdinv = jnp.zeros((), fd)

        return ArrowFactors(L=L, Ninv=Ninv, Einv=Einv, Om=Om, Ux=Ux, Um=Um,
                            chol1=chol1, S11inv=S11inv, T=T.astype(dt),
                            chol2=chol2, Sdinv=Sdinv,
                            Einv0=Einv0, Om0=Om0, Oml=Oml,
                            delta_p=jnp.asarray(delta_p, Einv.dtype),
                            delta_d=jnp.asarray(delta_d, Einv.dtype),
                            ok=leaf_ok & root_ok,
                            Wd=jnp.zeros((), fd),
                            extra_root=extra.astype(Einv.dtype))

    def _rb_band_solve(self, Ginv, Cb, rhs):
        """Band-part solve for rhs [nband, c] (permuted order)."""
        from pips_ipmpp_tpu.linalg.band_backend import block_tridiag_solve
        plan = self.band_root_plan
        b, nb = plan.panel, plan.n_panels
        nband, c = rhs.shape
        pad = nb * b - nband
        r = rhs if not pad else jnp.concatenate(
            [rhs, jnp.zeros((pad, c), rhs.dtype)], axis=0)
        r = r.reshape(nb, 1, b, c)
        x = block_tridiag_solve(Ginv, Cb, r.astype(Ginv.dtype))
        return x.reshape(nb * b, c)[:nband]

    def _rb_solve(self, Rb, rhs):
        """Banded-root SDD^{-1} rhs for rhs [nD, c] (permuted order);
        handles the trailing peeled dense block via its Schur factors."""
        if len(Rb) == 2:
            return self._rb_band_solve(*Rb, rhs)
        Ginv, Cb, Ud, Wdns, Sdinv = Rb
        nband = Ud.shape[0]
        r1, r2 = rhs[:nband], rhs[nband:]
        u1 = self._rb_band_solve(Ginv, Cb, r1)
        x2 = Sdinv @ (r2 - Ud.T @ u1)
        x1 = u1 - Wdns @ x2
        return jnp.concatenate([x1, x2], axis=0)

    def _leaf_apply_inv(self, L, Ninv, Einv, M, rx, rm):
        """K_b^{-1} applied to (rx [N,n,c], rm [N,a,c]) multi-RHS."""
        fd = self.factor_dtype
        t = (jnp.einsum("iam,imc->iac", M.astype(fd),
                        (Einv[:, :, None] * rx).astype(fd))
             - rm.astype(fd))
        um = self._apply_Ninv_multi(L, Ninv, t)
        ux = (Einv[:, :, None].astype(fd) * (rx.astype(fd) - jnp.einsum(
            "iam,iac->imc", M.astype(fd), um)))
        return ux, um

    def _contrib_blockwise(self, L, Ninv, Einv, M):
        """Streamed Schur contribution R' K^{-1} R in column chunks
        (reference SC_COMPUTE_BLOCKWISE / addTermToSchurComplBlocked):
        column groups are [x0 (n0) | yl (mEl) | zl (mIl)]; each chunk of
        columns is solved and contracted against the full border without
        ever materializing [N, k, nS] caches."""
        lp = self.lp
        fd = self.factor_dtype
        n0, mEl, mIl = lp.n0, lp.mEl, lp.mIl
        mE, mI, n = lp.mE, lp.mI, lp.n
        nS = n0 + mEl + mIl
        ch = self.blockwise_sc
        dt = Einv.dtype

        contrib = jnp.zeros((nS, nS), fd)

        def rt_u(ux, um):
            """R' U for a column chunk: rows [x0; yl; zl]."""
            r_x0 = (jnp.einsum("imk,imc->kc", lp.A.astype(fd), um[:, :mE])
                    + jnp.einsum("imk,imc->kc", lp.C.astype(fd), um[:, mE:]))
            r_yl = jnp.einsum("ilm,imc->lc", lp.F.astype(fd), ux)
            r_zl = jnp.einsum("ilm,imc->lc", lp.G.astype(fd), ux)
            return jnp.concatenate([r_x0, r_yl, r_zl], axis=0)   # [nS, c]

        # part 1: x0 columns (R_x = 0, R_m = [A; C] cols)
        for s in range(0, n0, ch):
            e = min(s + ch, n0)
            rx = jnp.zeros((lp.N, n, e - s), dt)
            rm = jnp.concatenate([lp.A[:, :, s:e], lp.C[:, :, s:e]], axis=1)
            ux, um = self._leaf_apply_inv(L, Ninv, Einv, M, rx, rm)
            contrib = contrib.at[:, s:e].set(rt_u(ux, um))
        # part 2: yl columns (R_x = F', R_m = 0)
        for s in range(0, mEl, ch):
            e = min(s + ch, mEl)
            rx = jnp.swapaxes(lp.F[:, s:e, :], 1, 2)
            rm = jnp.zeros((lp.N, mE + mI, e - s), dt)
            ux, um = self._leaf_apply_inv(L, Ninv, Einv, M, rx, rm)
            contrib = contrib.at[:, n0 + s:n0 + e].set(rt_u(ux, um))
        # part 3: zl columns (R_x = G', R_m = 0)
        for s in range(0, mIl, ch):
            e = min(s + ch, mIl)
            rx = jnp.swapaxes(lp.G[:, s:e, :], 1, 2)
            rm = jnp.zeros((lp.N, mE + mI, e - s), dt)
            ux, um = self._leaf_apply_inv(L, Ninv, Einv, M, rx, rm)
            contrib = contrib.at[:, n0 + mEl + s:n0 + mEl + e].set(
                rt_u(ux, um))
        return contrib

    def factorization_ok(self, fac: ArrowFactors) -> jax.Array:
        ok = fac.ok
        if self.axis is not None:
            ok = jax.lax.pmin(ok.astype(jnp.int32), self.axis) > 0
        return ok

    # ------------------------------------------------------------------
    def _leaf_solve(self, fac: ArrowFactors, rho_x, rho_m):
        """Batched K_i^{-1} applied to (rho_x [N,n], rho_m [N,mE+mI])."""
        lp = self.lp
        fd = self.factor_dtype
        M = jnp.concatenate([lp.B, lp.D], axis=1)
        t = jnp.einsum("iam,im->ia", M, fac.Einv * rho_x) - rho_m
        gm = self._apply_Ninv_multi(
            fac.L, fac.Ninv, t[..., None].astype(fd))[..., 0]
        gm = gm.astype(rho_x.dtype)
        gx = fac.Einv * (rho_x - jnp.einsum("iam,ia->im", M, gm))
        return gx, gm

    def _root_solve(self, fac: ArrowFactors, p, q):
        """Solve S [a; d] = [p; q] via the cached two-level factorization."""
        fd = self.factor_dtype
        dt = p.dtype
        if self.band_root_plan is not None:
            # banded-root Dsolve: S11x a = p + S12 SDD^{-1} q;
            # d = -SDD^{-1} (q - S12' a)   (two banded sweeps + one small
            # dense solve — the 2-link root counterpart of Dsolve)
            S12p = fac.T.astype(fd)                      # [n0, nD] permuted
            qp = q[self._rb_perm].astype(fd)[:, None]
            t = self._rb_solve(fac.RbG, qp)
            a = _spd_solve(fac.chol1, p.astype(fd) + (S12p @ t)[:, 0])
            rd = qp - (S12p.T @ a)[:, None]
            dperm = -self._rb_solve(fac.RbG, rd)[:, 0]
            d = dperm[self._rb_iperm].astype(dt)
            return a.astype(dt), d
        if self.dist_root:
            from pips_ipmpp_tpu.linalg.dist_root import own_slice
            # q2_own = (q - T' p)[own rows]; d = -psum(W q2_own); a = ...
            q_own = own_slice(q.astype(fd), self.axis, self.n_shards, 0)
            q2_own = q_own - fac.T.astype(fd).T @ p.astype(fd)
            d = -jax.lax.psum(fac.Wd @ q2_own, self.axis).astype(dt)
            d_own = own_slice(d.astype(fd), self.axis, self.n_shards, 0)
            Td = jax.lax.psum(fac.T.astype(fd) @ d_own, self.axis)
            a = (_spd_solve(fac.chol1, p.astype(fd)) - Td).astype(dt)
            return a, d
        if self.iterative_root:
            # Dsolve via preconditioned CG on the SPD dual SC (the
            # reference's iterative root solve with the sparsified
            # preconditioner, sLinsysRootAug.C:930, precondSC)
            from pips_ipmpp_tpu.linalg.sc_precond import block_jacobi_apply
            q2 = q.astype(fd) - fac.T.astype(fd).T @ p.astype(fd)
            dsol, _stats = preconditioned_cg(
                q2, lambda v: block_jacobi_apply(fac.Pchol, v),
                lambda v: fac.Sd @ v, lambda x_, y_: jnp.vdot(x_, y_),
                self.it_root_maxiter, self.it_root_tol)
            d = -dsol.astype(dt)
            a = (_spd_solve(fac.chol1, p.astype(fd)).astype(dt)
                 - fac.T @ d)
            return a, d
        q2 = (q - fac.T.T @ p).astype(fd)
        if self.explicit_inverse:
            d = -(fac.Sdinv @ q2).astype(dt)
            a = (fac.S11inv @ p.astype(fd)).astype(dt) - fac.T @ d
        else:
            d = -_spd_solve(fac.chol2, q2).astype(dt)  # Sdual = -(S22 - ..)
            a = _spd_solve(fac.chol1, p.astype(fd)).astype(dt) - fac.T @ d
        return a, d

    def solve_reduced(self, fac: ArrowFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        lp = self.lp
        n0, m0E, m0I, mEl, mIl = lp.n0, lp.m0E, lp.m0I, lp.mEl, lp.mIl
        mE = lp.mE

        rho_x_first = -rhs.rhat_x.first
        rho_x = -rhs.rhat_x.blocks
        rho_m = jnp.concatenate([-rhs.rA.blocks, -rhs.rhat_z.blocks], axis=1)
        p0 = rho_x_first
        q0 = jnp.concatenate([-rhs.rA.first, -rhs.rhat_z.first,
                              -rhs.rA.link, -rhs.rhat_z.link])

        dx_first, dx_blocks, d0, gm = self._solve_core(
            fac, p0, q0, rho_x, rho_m)

        if refinement_steps > 0:
            # adaptive iterative refinement on the f64 augmented residual
            # (absorbs f32 factorization error; the role of
            # solveCompressedIterRefin, LinearSystem.C:877)
            shard_max = (jnp.max(jnp.abs(rho_x)) if rho_x.size
                         else jnp.zeros((), p0.dtype))
            if self.axis is not None:
                shard_max = jax.lax.pmax(shard_max, self.axis)
            rhs_norm = jnp.maximum(
                shard_max,
                jnp.maximum(jnp.max(jnp.abs(p0)) if p0.size else 0.0,
                            jnp.max(jnp.abs(q0)) if q0.size else 0.0))
            rhs_norm = jnp.maximum(rhs_norm, 1e-30)

            def resid_norm(state):
                dxf, dxb, dd0, dgm = state
                ex0, eq0, ex, em = self._aug_residual(
                    fac, p0, q0, rho_x, rho_m, dxf, dxb, dd0, dgm)
                nrm = jnp.maximum(
                    jnp.max(jnp.abs(ex)) if ex.size else 0.0,
                    jnp.maximum(jnp.max(jnp.abs(em)) if em.size else 0.0,
                                jnp.maximum(
                                    jnp.max(jnp.abs(ex0)) if ex0.size else 0.0,
                                    jnp.max(jnp.abs(eq0)) if eq0.size else 0.0)))
                if self.axis is not None:
                    nrm = jax.lax.pmax(nrm, self.axis)
                return (ex0, eq0, ex, em), nrm

            def cond(carry):
                state, res, k, nrm, prev = carry
                improving = nrm < 0.25 * prev
                return ((k < refinement_steps)
                        & (nrm > 1e-11 * rhs_norm) & improving)

            def body(carry):
                state, (ex0, eq0, ex, em), k, nrm, _prev = carry
                cx0, cxb, cd0, cgm = self._solve_core(fac, ex0, eq0, ex, em)
                dxf, dxb, dd0, dgm = state
                new = (dxf + cx0, dxb + cxb, dd0 + cd0, dgm + cgm)
                res2, nrm2 = resid_norm(new)
                # keep the better iterate if refinement diverged
                worse = nrm2 > nrm
                keep = jax.tree.map(
                    lambda a, b: jnp.where(worse, a, b), state, new)
                return (keep, res2, k + 1, jnp.where(worse, nrm, nrm2),
                        nrm)

            state0 = (dx_first, dx_blocks, d0, gm)
            res0, nrm0 = resid_norm(state0)
            (dx_first, dx_blocks, d0, gm), _, _, _, _ = jax.lax.while_loop(
                cond, body, (state0, res0, jnp.zeros((), jnp.int32), nrm0,
                             jnp.asarray(jnp.inf, nrm0.dtype)))

        # unpack: d0 = [yhat0, zhat0, yhat_l, zhat_l]; gm = [yhat_i, zhat_i]
        yhat = RVec(d0[:m0E], gm[:, :mE], d0[m0E + m0I:m0E + m0I + mEl])
        zhat = RVec(d0[m0E:m0E + m0I], gm[:, mE:], d0[m0E + m0I + mEl:])
        dx = XVec(dx_first, dx_blocks)
        neg = jax.tree.map(lambda v: -v, (yhat, zhat))
        return dx, neg[0], neg[1]

    def _solve_core(self, fac: ArrowFactors, p0, q0, rho_x, rho_m):
        """One pass of Lsolve -> Dsolve -> Ltsolve (sLinsysRootAug.C:323-365)."""
        lp = self.lp
        n0, m0E, m0I, mEl, mIl = lp.n0, lp.m0E, lp.m0I, lp.mEl, lp.mIl
        mE = lp.mE

        # Lsolve: leaf solves + accumulate border products (allreduce)
        gx, gm = self._leaf_solve(fac, rho_x, rho_m)
        acc_x0 = self._psum(
            jnp.einsum("imk,im->k", lp.A, gm[:, :mE])
            + jnp.einsum("imk,im->k", lp.C, gm[:, mE:]))
        acc_yl = self._psum(jnp.einsum("ilm,im->l", lp.F, gx))
        acc_zl = self._psum(jnp.einsum("ilm,im->l", lp.G, gx))

        p = p0 - acc_x0
        q = q0.at[m0E + m0I:m0E + m0I + mEl].add(-acc_yl)
        q = q.at[m0E + m0I + mEl:].add(-acc_zl)

        # Dsolve: root dense solve
        a, d = self._root_solve(fac, p, q)

        # Ltsolve: back-substitute into blocks
        s0 = jnp.concatenate([a, d[m0E + m0I:m0E + m0I + mEl],
                              d[m0E + m0I + mEl:]])
        if self.blockwise_sc > 0:
            # no cached K^{-1}R (streamed SC): recompute K^{-1}(R s0) with
            # one extra leaf solve (reference blockwise Ltsolve)
            yl_s = s0[lp.n0:lp.n0 + mEl]
            zl_s = s0[lp.n0 + mEl:]
            rx2 = (jnp.einsum("ilm,l->im", lp.F, yl_s)
                   + jnp.einsum("ilm,l->im", lp.G, zl_s))
            rm2 = jnp.concatenate([
                jnp.einsum("imk,k->im", lp.A, s0[:lp.n0]),
                jnp.einsum("imk,k->im", lp.C, s0[:lp.n0])], axis=1)
            gx2, gm2 = self._leaf_solve(fac, rx2, rm2)
            return a, gx - gx2, d, gm - gm2
        dx_blocks = gx - jnp.einsum("imS,S->im", fac.Ux, s0)
        gm_out = gm - jnp.einsum("iaS,S->ia", fac.Um, s0)
        return a, dx_blocks, d, gm_out

    # ------------------------------------------------------------------
    # Outer BiCGStab on the full structured augmented system, preconditioned
    # by one structured solve (the reference's OUTER_SOLVE=2 path:
    # LinearSystem::solveCompressedBiCGStab, LinearSystem.C:550, with the
    # preconditioner being solveCompressed, :500-515).
    # ------------------------------------------------------------------
    def _state_dot(self, a, b):
        ax0, axb, ad0, agm = a
        bx0, bxb, bd0, bgm = b
        rep = jnp.vdot(ax0, bx0) + jnp.vdot(ad0, bd0)
        shard = jnp.vdot(axb, bxb) + jnp.vdot(agm, bgm)
        return rep + self._psum(shard)

    def _apply_K(self, fac, state):
        """K . state (uses _aug_residual with zero rhs)."""
        dxf, dxb, dd0, dgm = state
        z0 = jnp.zeros_like(dxf)
        zb = jnp.zeros_like(dxb)
        zq = jnp.zeros_like(dd0)
        zm = jnp.zeros_like(dgm)
        ex0, eq0, ex, em = self._aug_residual(
            fac, z0, zq, zb, zm, dxf, dxb, dd0, dgm)
        # residual of 0 rhs = -K.state; reorder to state layout
        return (-ex0, -ex, -eq0, -em)

    def solve_reduced_bicgstab(self, fac: ArrowFactors, rhs: ReducedRhs,
                               max_iters: int = 8, tol: float = 1e-10):
        """BiCGStab on K u = rho with M^{-1} = structured direct solve.
        Returns (dx, dy, dz, stats dict) — stats feed the IPM's
        numerical-troubles logic (the Subject/Observer pattern of the
        reference, Core/Base/Observer.h + InteriorPointMethod.cpp:819-831).
        """
        lp = self.lp
        m0E, m0I, mEl = lp.m0E, lp.m0I, lp.mEl
        mE = lp.mE

        b = (-rhs.rhat_x.first,
             -rhs.rhat_x.blocks,
             jnp.concatenate([-rhs.rA.first, -rhs.rhat_z.first,
                              -rhs.rA.link, -rhs.rhat_z.link]),
             jnp.concatenate([-rhs.rA.blocks, -rhs.rhat_z.blocks], axis=1))

        def precond(v):
            x0, xb, d0, gm = v
            return self._solve_core(fac, x0, d0, xb, gm)

        u, stats = preconditioned_bicgstab(
            b, precond, lambda v: self._apply_K(fac, v), self._state_dot,
            max_iters, tol)

        dx_first, dx_blocks, d0, gm = u
        yhat = RVec(d0[:m0E], gm[:, :mE], d0[m0E + m0I:m0E + m0I + mEl])
        zhat = RVec(d0[m0E:m0E + m0I], gm[:, mE:], d0[m0E + m0I + mEl:])
        dx = XVec(dx_first, dx_blocks)
        return dx, jax.tree.map(lambda v_: -v_, yhat), \
            jax.tree.map(lambda v_: -v_, zhat), stats

    def _aug_residual(self, fac, p0, q0, rho_x, rho_m,
                      dx_first, dx_blocks, d0, gm):
        """Residual of the full augmented arrowhead system (for refinement).

        Unknown layout: (dx_first, dx_blocks) primal; duals with *hat* sign
        (yhat = -dy): d0 = [y0,z0,yl,zl] root, gm = [y_i, z_i] per block."""
        lp = self.lp
        n0, m0E, m0I, mEl, mIl = lp.n0, lp.m0E, lp.m0I, lp.mEl, lp.mIl
        mE, mI = lp.mE, lp.mI
        dp, dd = fac.delta_p, fac.delta_d
        # root rows carry the extra in-factorize escalation shift (the
        # leaves stay at dd); E0 = 1/Einv0 already embeds dp + extra
        dd_root = dd + fac.extra_root

        y0h, z0h = d0[:m0E], d0[m0E:m0E + m0I]
        ylh, zlh = (d0[m0E + m0I:m0E + m0I + mEl], d0[m0E + m0I + mEl:])
        yih, zih = gm[:, :mE], gm[:, mE:]

        yh = RVec(y0h, yih, ylh)
        zh = RVec(z0h, zih, zlh)
        x = XVec(dx_first, dx_blocks)

        ATyh = self.ATy(yh)
        CTzh = self.CTz(zh)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        Eb = 1.0 / fac.Einv
        top_first = E0 * dx_first + ATyh.first + CTzh.first
        top_blocks = Eb * dx_blocks + ATyh.blocks + CTzh.blocks
        eq_first = Ax.first - dd_root * y0h
        eq_blocks = Ax.blocks - dd * yih
        eq_link = Ax.link - dd_root * ylh
        iq_first = Cx.first - (fac.Om0 + dd_root) * z0h
        iq_blocks = Cx.blocks - (fac.Om + dd) * zih
        iq_link = Cx.link - (fac.Oml + dd_root) * zlh

        ex0 = p0 - top_first
        ex = rho_x - top_blocks
        em = rho_m - jnp.concatenate([eq_blocks, iq_blocks], axis=1)
        eq0 = q0 - jnp.concatenate([eq_first, iq_first, eq_link, iq_link])
        return ex0, eq0, ex, em
