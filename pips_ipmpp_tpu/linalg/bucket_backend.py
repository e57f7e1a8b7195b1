"""Bucketed arrowhead backend: heterogeneous block sizes, batched.

Composes one `ArrowBackend` per size bucket (core/bucketed.py) under a
single shared root: every bucket runs the batched leaf condensation and
border solves at its OWN padded shape, the Schur contributions are summed
(then psum'd across the mesh axis once — the reference's single chunked
MPI_Allreduce of the SC, DistributedRootLinearSystem.C:860-975) and the
root is assembled and factorized exactly once.

This replaces global max-shape padding (O(N * max^2) waste when blocks
vary 10x) with per-bucket padding — the batched analog of the reference's
per-node sparse blocks of arbitrary individual size
(DistributedMatrix.h:44-48, DistributedProblem.hpp:80-96).

Space vectors carry `blocks` as tuples of per-bucket arrays; the IPM layer
is already leaf-generic (core/spaces.py reductions, tree_map fused ops,
find_blocking leaf loops), so only this backend knows about buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from pips_ipmpp_tpu.core.bucketed import BucketedArrowheadLP
from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.ipm.formulation import Bounds, ReducedRhs
from pips_ipmpp_tpu.linalg.arrow_backend import (ArrowBackend, ArrowFactors,
                                                 preconditioned_bicgstab)


class BucketedArrowBackend:
    """Backend over a BucketedArrowheadLP.  Supports the dense leaf modes
    of ArrowBackend (explicit inverse / LDL kernel / factored inverse) and
    the standard root modes; the special root modes (dist_root,
    iterative_root, band_root) and blockwise SC streaming are not wired
    through the bucketed path."""

    def __init__(self, lp: BucketedArrowheadLP, factor_dtype=jnp.float64,
                 axis: Optional[str] = None, **kw):
        for bad in ("dist_root", "iterative_root", "band_root_plan",
                    "blockwise_sc"):
            if kw.pop(bad, None):
                raise ValueError(f"{bad} is not supported with bucketed "
                                 "blocks")
        self.lp = lp
        self.axis = axis
        self.factor_dtype = factor_dtype
        self.subs = tuple(ArrowBackend(b, factor_dtype=factor_dtype,
                                       axis=None, **kw)
                          for b in lp.buckets)
        # the mesh-collective boundary lives HERE (one psum of the summed
        # SC contribution / accumulators), not inside the sub-backends
        root = self.subs[0]
        b0 = root.bounds
        self.bounds = Bounds(
            c=XVec(b0.c.first, tuple(s.bounds.c.blocks for s in self.subs)),
            b=RVec(b0.b.first, tuple(s.bounds.b.blocks for s in self.subs),
                   b0.b.link),
            ixlow=self._xv("ixlow"), xlow=self._xv("xlow"),
            ixupp=self._xv("ixupp"), xupp=self._xv("xupp"),
            iclow=self._rv("iclow"), clow=self._rv("clow"),
            icupp=self._rv("icupp"), cupp=self._rv("cupp"),
        )
        local = sum(jnp.sum(b.ixlowN) + jnp.sum(b.ixuppN)
                    + jnp.sum(b.iclowN) + jnp.sum(b.icuppN)
                    for b in lp.buckets)
        if axis is not None:
            local = jax.lax.psum(local, axis)
        f = lp.buckets[0]
        rep = (jnp.sum(f.ixlow0) + jnp.sum(f.ixupp0) + jnp.sum(f.iclow0)
               + jnp.sum(f.icupp0) + jnp.sum(f.iclowl) + jnp.sum(f.icuppl))
        self.num_bound_pairs = jnp.maximum(local + rep, 1.0)

    def _xv(self, name):
        b0 = self.subs[0].bounds
        return XVec(getattr(b0, name).first,
                    tuple(getattr(s.bounds, name).blocks for s in self.subs))

    def _rv(self, name):
        b0 = self.subs[0].bounds
        return RVec(getattr(b0, name).first,
                    tuple(getattr(s.bounds, name).blocks for s in self.subs),
                    getattr(b0, name).link)

    # ---- helpers ----
    def _psum(self, v):
        return jax.lax.psum(v, self.axis) if self.axis is not None else v

    # ---- matvecs ----
    def Ax(self, x: XVec) -> RVec:
        f = self.lp.buckets[0]
        first = f.A0 @ x.first
        blocks = tuple(
            jnp.einsum("imk,k->im", b.A, x.first)
            + jnp.einsum("imn,in->im", b.B, xb)
            for b, xb in zip(self.lp.buckets, x.blocks))
        link = f.F0 @ x.first + self._psum(sum(
            jnp.einsum("iln,in->l", b.F, xb)
            for b, xb in zip(self.lp.buckets, x.blocks)))
        return RVec(first, blocks, link)

    def ATy(self, y: RVec) -> XVec:
        f = self.lp.buckets[0]
        first = (f.A0.T @ y.first + f.F0.T @ y.link
                 + self._psum(sum(
                     jnp.einsum("imk,im->k", b.A, yb)
                     for b, yb in zip(self.lp.buckets, y.blocks))))
        blocks = tuple(
            jnp.einsum("imn,im->in", b.B, yb)
            + jnp.einsum("iln,l->in", b.F, y.link)
            for b, yb in zip(self.lp.buckets, y.blocks))
        return XVec(first, blocks)

    def Cx(self, x: XVec) -> RVec:
        f = self.lp.buckets[0]
        first = f.C0 @ x.first
        blocks = tuple(
            jnp.einsum("imk,k->im", b.C, x.first)
            + jnp.einsum("imn,in->im", b.D, xb)
            for b, xb in zip(self.lp.buckets, x.blocks))
        link = f.G0 @ x.first + self._psum(sum(
            jnp.einsum("iln,in->l", b.G, xb)
            for b, xb in zip(self.lp.buckets, x.blocks)))
        return RVec(first, blocks, link)

    def CTz(self, z: RVec) -> XVec:
        f = self.lp.buckets[0]
        first = (f.C0.T @ z.first + f.G0.T @ z.link
                 + self._psum(sum(
                     jnp.einsum("imk,im->k", b.C, zb)
                     for b, zb in zip(self.lp.buckets, z.blocks))))
        blocks = tuple(
            jnp.einsum("imn,im->in", b.D, zb)
            + jnp.einsum("iln,l->in", b.G, z.link)
            for b, zb in zip(self.lp.buckets, z.blocks))
        return XVec(first, blocks)

    def objective(self, x: XVec) -> jax.Array:
        f = self.lp.buckets[0]
        return jnp.vdot(f.c0, x.first) + self._psum(sum(
            jnp.vdot(b.cN, xb) for b, xb in zip(self.lp.buckets, x.blocks)))

    def datanorm(self) -> jax.Array:
        local = jnp.max(jnp.stack([b.datanorm() for b in self.lp.buckets]))
        return (jax.lax.pmax(local, self.axis)
                if self.axis is not None else local)

    # ------------------------------------------------------------------
    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> ArrowFactors:
        pieces = [s.leaf_factorize(Dx.blocks[b], Ominv.blocks[b],
                                   delta_p, delta_d)
                  for b, s in enumerate(self.subs)]
        contrib = self._psum(sum(p[6] for p in pieces))
        leaf_ok = pieces[0][7]
        for p in pieces[1:]:
            leaf_ok = leaf_ok & p[7]
        L0, N0, E0, O0, Ux0, Um0, _, _ = pieces[0]
        fac = self.subs[0]._assemble_root(
            Dx, Ominv, delta_p, delta_d, L0, N0, E0, O0, Ux0, Um0,
            contrib, leaf_ok)
        return dataclasses.replace(
            fac,
            L=tuple(p[0] for p in pieces),
            Ninv=tuple(p[1] for p in pieces),
            Einv=tuple(p[2] for p in pieces),
            Om=tuple(p[3] for p in pieces),
            Ux=tuple(p[4] for p in pieces),
            Um=tuple(p[5] for p in pieces))

    def factorization_ok(self, fac: ArrowFactors) -> jax.Array:
        ok = fac.ok
        if self.axis is not None:
            ok = jax.lax.pmin(ok.astype(jnp.int32), self.axis) > 0
        return ok

    def _sub_fac(self, fac: ArrowFactors, b: int) -> ArrowFactors:
        return dataclasses.replace(
            fac, L=fac.L[b], Ninv=fac.Ninv[b], Einv=fac.Einv[b],
            Om=fac.Om[b], Ux=fac.Ux[b], Um=fac.Um[b])

    # ------------------------------------------------------------------
    def _solve_core(self, fac: ArrowFactors, p0, q0, rho_x, rho_m):
        """Lsolve -> Dsolve -> Ltsolve over all buckets with one shared
        root solve (sLinsysRootAug.C:323-365)."""
        f = self.lp.buckets[0]
        m0E, m0I, mEl = f.m0E, f.m0I, f.mEl

        gxs, gms = [], []
        acc_x0 = jnp.zeros((f.n0,), p0.dtype)
        acc_yl = jnp.zeros((f.mEl,), p0.dtype)
        acc_zl = jnp.zeros((f.mIl,), p0.dtype)
        for b, s in enumerate(self.subs):
            blp = s.lp
            gx, gm = s._leaf_solve(self._sub_fac(fac, b), rho_x[b], rho_m[b])
            acc_x0 = acc_x0 + (
                jnp.einsum("imk,im->k", blp.A, gm[:, :blp.mE])
                + jnp.einsum("imk,im->k", blp.C, gm[:, blp.mE:]))
            acc_yl = acc_yl + jnp.einsum("ilm,im->l", blp.F, gx)
            acc_zl = acc_zl + jnp.einsum("ilm,im->l", blp.G, gx)
            gxs.append(gx)
            gms.append(gm)
        acc_x0 = self._psum(acc_x0)
        acc_yl = self._psum(acc_yl)
        acc_zl = self._psum(acc_zl)

        p = p0 - acc_x0
        q = q0.at[m0E + m0I:m0E + m0I + mEl].add(-acc_yl)
        q = q.at[m0E + m0I + mEl:].add(-acc_zl)

        a, d = self.subs[0]._root_solve(fac, p, q)

        s0 = jnp.concatenate([a, d[m0E + m0I:m0E + m0I + mEl],
                              d[m0E + m0I + mEl:]])
        dx_blocks = tuple(
            gxs[b] - jnp.einsum("imS,S->im", fac.Ux[b], s0)
            for b in range(len(self.subs)))
        gm_out = tuple(
            gms[b] - jnp.einsum("iaS,S->ia", fac.Um[b], s0)
            for b in range(len(self.subs)))
        return a, dx_blocks, d, gm_out

    def _aug_residual(self, fac, p0, q0, rho_x, rho_m,
                      dx_first, dx_blocks, d0, gm):
        """Residual of the full augmented system (tuple-block layout);
        mirrors ArrowBackend._aug_residual."""
        f = self.lp.buckets[0]
        m0E, m0I, mEl = f.m0E, f.m0I, f.mEl
        dp, dd = fac.delta_p, fac.delta_d
        dd_root = dd + fac.extra_root

        y0h, z0h = d0[:m0E], d0[m0E:m0E + m0I]
        ylh, zlh = (d0[m0E + m0I:m0E + m0I + mEl], d0[m0E + m0I + mEl:])
        yih = tuple(gm[b][:, :s.lp.mE] for b, s in enumerate(self.subs))
        zih = tuple(gm[b][:, s.lp.mE:] for b, s in enumerate(self.subs))

        yh = RVec(y0h, yih, ylh)
        zh = RVec(z0h, zih, zlh)
        x = XVec(dx_first, dx_blocks)

        ATyh = self.ATy(yh)
        CTzh = self.CTz(zh)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        top_first = E0 * dx_first + ATyh.first + CTzh.first
        ex0 = p0 - top_first
        ex = tuple(
            rho_x[b] - ((1.0 / fac.Einv[b]) * dx_blocks[b]
                        + ATyh.blocks[b] + CTzh.blocks[b])
            for b in range(len(self.subs)))
        em = tuple(
            rho_m[b] - jnp.concatenate(
                [Ax.blocks[b] - dd * yih[b],
                 Cx.blocks[b] - (fac.Om[b] + dd) * zih[b]], axis=1)
            for b in range(len(self.subs)))
        eq_first = Ax.first - dd_root * y0h
        iq_first = Cx.first - (fac.Om0 + dd_root) * z0h
        eq_link = Ax.link - dd_root * ylh
        iq_link = Cx.link - (fac.Oml + dd_root) * zlh
        eq0 = q0 - jnp.concatenate([eq_first, iq_first, eq_link, iq_link])
        return ex0, eq0, ex, em

    # ------------------------------------------------------------------
    def solve_reduced(self, fac: ArrowFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        f = self.lp.buckets[0]
        m0E, m0I, mEl = f.m0E, f.m0I, f.mEl

        rho_x_first = -rhs.rhat_x.first
        rho_x = tuple(-v for v in rhs.rhat_x.blocks)
        rho_m = tuple(
            jnp.concatenate([-rhs.rA.blocks[b], -rhs.rhat_z.blocks[b]],
                            axis=1) for b in range(len(self.subs)))
        p0 = rho_x_first
        q0 = jnp.concatenate([-rhs.rA.first, -rhs.rhat_z.first,
                              -rhs.rA.link, -rhs.rhat_z.link])

        state = self._solve_core(fac, p0, q0, rho_x, rho_m)

        if refinement_steps > 0:
            def mx(x):
                return jnp.max(jnp.abs(x)) if x.size else jnp.zeros((), x.dtype)

            # max (not sum) across buckets + pmax across the mesh, matching
            # ArrowBackend.solve_reduced so the 1e-11*rhs_norm refinement
            # exit threshold keeps the same meaning on the bucketed path
            blk_max = jnp.zeros((), p0.dtype)
            for r in rho_x:
                blk_max = jnp.maximum(blk_max, mx(r))
            rhs_norm = jnp.maximum(
                jnp.maximum(mx(p0), mx(q0)), self._pmax_scalar(blk_max))
            rhs_norm = jnp.maximum(rhs_norm, 1e-30)

            def resid_norm(st):
                dxf, dxb, dd0, dgm = st
                res = self._aug_residual(fac, p0, q0, rho_x, rho_m,
                                         dxf, dxb, dd0, dgm)
                ex0, eq0, ex, em = res
                nrm = jnp.maximum(mx(ex0), mx(eq0))
                shard = jnp.zeros((), nrm.dtype)
                for e in (*ex, *em):
                    shard = jnp.maximum(shard, mx(e))
                nrm = jnp.maximum(nrm, self._pmax_scalar(shard))
                return res, nrm

            def cond(carry):
                st, res, k, nrm, prev = carry
                return ((k < refinement_steps)
                        & (nrm > 1e-11 * rhs_norm) & (nrm < 0.25 * prev))

            def body(carry):
                st, (ex0, eq0, ex, em), k, nrm, _prev = carry
                corr = self._solve_core(fac, ex0, eq0, ex, em)
                new = jax.tree.map(lambda a, b: a + b, st, corr)
                res2, nrm2 = resid_norm(new)
                worse = nrm2 > nrm
                keep = jax.tree.map(lambda a, b: jnp.where(worse, a, b),
                                    st, new)
                return (keep, res2, k + 1,
                        jnp.where(worse, nrm, nrm2), nrm)

            res0, nrm0 = resid_norm(state)
            state, _, _, _, _ = jax.lax.while_loop(
                cond, body, (state, res0, jnp.zeros((), jnp.int32), nrm0,
                             jnp.asarray(jnp.inf, nrm0.dtype)))

        dx_first, dx_blocks, d0, gm = state
        yhat = RVec(d0[:m0E],
                    tuple(gm[b][:, :s.lp.mE]
                          for b, s in enumerate(self.subs)),
                    d0[m0E + m0I:m0E + m0I + mEl])
        zhat = RVec(d0[m0E:m0E + m0I],
                    tuple(gm[b][:, s.lp.mE:]
                          for b, s in enumerate(self.subs)),
                    d0[m0E + m0I + mEl:])
        dx = XVec(dx_first, dx_blocks)
        neg = jax.tree.map(lambda v: -v, (yhat, zhat))
        return dx, neg[0], neg[1]

    def _pmax_scalar(self, v):
        return jax.lax.pmax(v, self.axis) if self.axis is not None else v

    # ------------------------------------------------------------------
    def _state_dot(self, a, b):
        ax0, axb, ad0, agm = a
        bx0, bxb, bd0, bgm = b
        rep = jnp.vdot(ax0, bx0) + jnp.vdot(ad0, bd0)
        shard = sum(jnp.vdot(x, y) for x, y in zip(axb, bxb))
        shard = shard + sum(jnp.vdot(x, y) for x, y in zip(agm, bgm))
        return rep + self._psum(shard)

    def _apply_K(self, fac, state):
        dxf, dxb, dd0, dgm = state
        z0 = jnp.zeros_like(dxf)
        zb = tuple(jnp.zeros_like(v) for v in dxb)
        zq = jnp.zeros_like(dd0)
        zm = tuple(jnp.zeros_like(v) for v in dgm)
        ex0, eq0, ex, em = self._aug_residual(
            fac, z0, zq, zb, zm, dxf, dxb, dd0, dgm)
        return (-ex0, tuple(-e for e in ex), -eq0, tuple(-e for e in em))

    def solve_reduced_bicgstab(self, fac: ArrowFactors, rhs: ReducedRhs,
                               max_iters: int = 8, tol: float = 1e-10):
        f = self.lp.buckets[0]
        m0E, m0I, mEl = f.m0E, f.m0I, f.mEl

        b = (-rhs.rhat_x.first,
             tuple(-v for v in rhs.rhat_x.blocks),
             jnp.concatenate([-rhs.rA.first, -rhs.rhat_z.first,
                              -rhs.rA.link, -rhs.rhat_z.link]),
             tuple(jnp.concatenate([-rhs.rA.blocks[i],
                                    -rhs.rhat_z.blocks[i]], axis=1)
                   for i in range(len(self.subs))))

        def precond(v):
            x0, xb, d0, gm = v
            return self._solve_core(fac, x0, d0, xb, gm)

        u, stats = preconditioned_bicgstab(
            b, precond, lambda v: self._apply_K(fac, v), self._state_dot,
            max_iters, tol)

        dx_first, dx_blocks, d0, gm = u
        yhat = RVec(d0[:m0E],
                    tuple(gm[i][:, :s.lp.mE]
                          for i, s in enumerate(self.subs)),
                    d0[m0E + m0I:m0E + m0I + mEl])
        zhat = RVec(d0[m0E:m0E + m0I],
                    tuple(gm[i][:, s.lp.mE:]
                          for i, s in enumerate(self.subs)),
                    d0[m0E + m0I + mEl:])
        dx = XVec(dx_first, dx_blocks)
        return dx, jax.tree.map(lambda v_: -v_, yhat), \
            jax.tree.map(lambda v_: -v_, zhat), stats


def scatter_to_buckets(lp: BucketedArrowheadLP, values: list):
    """Host helper: reorder a per-original-block list into per-bucket
    stacked arrays (intake order -> bucket layout)."""
    import numpy as np
    out = [[None] * b.N for b in lp.buckets]
    for i, (bi, pos) in enumerate(lp.placement):
        out[bi][pos] = values[i]
    return [np.stack(v) for v in out]


def gather_from_buckets(lp: BucketedArrowheadLP, blocks: tuple) -> list:
    """Host helper: per-bucket arrays -> list in original block order."""
    return [blocks[bi][pos] for (bi, pos) in lp.placement]
