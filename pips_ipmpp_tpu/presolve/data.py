"""Mutable presolve-time problem state + event log.

The analog of the reference's PresolveData (Core/Preprocessing/
PresolveData.C, 3963 LoC) and the event-sourcing side of StochPostsolver
(StochPostsolver.h:28-71): every reduction emits a typed event; postsolve
replays them in reverse.

Key design difference (static shapes): reductions DEACTIVATE rows/columns in
place instead of compacting the arrays — shapes stay static (XLA-friendly)
and indices stay valid for the whole presolve/postsolve round trip.
Deactivated variables become inert boxed [-1,1] columns with zero objective;
deactivated eq rows become zero rows with b=0; deactivated ineq rows become
zero rows bounded [-1,1] (exactly the padding convention of core.lp).

Addressing: block index -1 denotes the first stage; -2 the linking rows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP

FIRST = -1    # first-stage block id
LINK = -2     # linking-row "block" id for row addressing


@dataclass
class Event:
    kind: str
    data: dict


@dataclass
class PresolveData:
    """Numpy mirror of an ArrowheadLP plus reduction state."""
    # first stage
    c0: np.ndarray
    A0: np.ndarray
    b0: np.ndarray
    C0: np.ndarray
    iclow0: np.ndarray
    clow0: np.ndarray
    icupp0: np.ndarray
    cupp0: np.ndarray
    ixlow0: np.ndarray
    xlow0: np.ndarray
    ixupp0: np.ndarray
    xupp0: np.ndarray
    # blocks
    cN: np.ndarray
    A: np.ndarray
    B: np.ndarray
    bN: np.ndarray
    C: np.ndarray
    D: np.ndarray
    iclowN: np.ndarray
    clowN: np.ndarray
    icuppN: np.ndarray
    cuppN: np.ndarray
    ixlowN: np.ndarray
    xlowN: np.ndarray
    ixuppN: np.ndarray
    xuppN: np.ndarray
    # linking
    F0: np.ndarray
    F: np.ndarray
    bl: np.ndarray
    G0: np.ndarray
    G: np.ndarray
    iclowl: np.ndarray
    clowl: np.ndarray
    icuppl: np.ndarray
    cuppl: np.ndarray

    # reduction state
    objective_offset: float = 0.0
    events: list = field(default_factory=list)
    var_active0: np.ndarray = None
    var_activeN: np.ndarray = None
    rowE_active0: np.ndarray = None
    rowE_activeN: np.ndarray = None
    rowE_activel: np.ndarray = None
    rowI_active0: np.ndarray = None
    rowI_activeN: np.ndarray = None
    rowI_activel: np.ndarray = None
    infeasible: bool = False
    # per-eq-row accumulated |a * val| from substitutions: the scale of
    # float cancellation a later emptiness/infeasibility test must
    # tolerate (absolute FEASTOL mis-declares infeasible after O(1e9)
    # substitutions cancel to an O(1e-7) residual)
    rhs_shift0: np.ndarray = None
    rhs_shiftN: np.ndarray = None
    rhs_shiftl: np.ndarray = None
    rhs_shiftI0: np.ndarray = None
    rhs_shiftIN: np.ndarray = None
    rhs_shiftIl: np.ndarray = None

    # ------------------------------------------------------------------
    @staticmethod
    def from_lp(lp: ArrowheadLP) -> "PresolveData":
        kw = {}
        for f in dataclasses.fields(lp):
            kw[f.name] = np.array(getattr(lp, f.name), dtype=np.float64)
        pd = PresolveData(**kw)
        pd.var_active0 = np.ones(lp.n0, bool)
        pd.var_activeN = np.ones((lp.N, lp.n), bool)
        pd.rowE_active0 = np.ones(lp.m0E, bool)
        pd.rowE_activeN = np.ones((lp.N, lp.mE), bool)
        pd.rowE_activel = np.ones(lp.mEl, bool)
        pd.rowI_active0 = np.ones(lp.m0I, bool)
        pd.rowI_activeN = np.ones((lp.N, lp.mI), bool)
        pd.rowI_activel = np.ones(lp.mIl, bool)
        pd.rhs_shift0 = np.zeros(lp.m0E)
        pd.rhs_shiftN = np.zeros((lp.N, lp.mE))
        pd.rhs_shiftl = np.zeros(lp.mEl)
        pd.rhs_shiftI0 = np.zeros(lp.m0I)
        pd.rhs_shiftIN = np.zeros((lp.N, lp.mI))
        pd.rhs_shiftIl = np.zeros(lp.mIl)
        return pd

    def to_lp(self, dtype) -> ArrowheadLP:
        import jax.numpy as jnp
        kw = {}
        for f in dataclasses.fields(ArrowheadLP):
            kw[f.name] = jnp.asarray(getattr(self, f.name), dtype)
        return ArrowheadLP(**kw)

    @property
    def N(self):
        return self.cN.shape[0]

    def emit(self, kind: str, **data):
        self.events.append(Event(kind, data))

    # ---- accessors treating first stage / blocks uniformly ----
    def var_arrays(self, blk: int):
        """(c, ixlow, xlow, ixupp, xupp, active) views for block or FIRST."""
        if blk == FIRST:
            return (self.c0, self.ixlow0, self.xlow0, self.ixupp0,
                    self.xupp0, self.var_active0)
        return (self.cN[blk], self.ixlowN[blk], self.xlowN[blk],
                self.ixuppN[blk], self.xuppN[blk], self.var_activeN[blk])

    # ------------------------------------------------------------------
    def eq_column(self, blk: int, j: int):
        """All equality-matrix entries of variable (blk, j) as a list of
        (row_block, row_idx, value) over active rows."""
        out = []
        if blk == FIRST:
            for r in np.nonzero(self.A0[:, j])[0]:
                if self.rowE_active0[r]:
                    out.append((FIRST, int(r), self.A0[r, j]))
            for i in range(self.N):
                for r in np.nonzero(self.A[i][:, j])[0]:
                    if self.rowE_activeN[i, r]:
                        out.append((i, int(r), self.A[i][r, j]))
            for r in np.nonzero(self.F0[:, j])[0]:
                if self.rowE_activel[r]:
                    out.append((LINK, int(r), self.F0[r, j]))
        else:
            for r in np.nonzero(self.B[blk][:, j])[0]:
                if self.rowE_activeN[blk, r]:
                    out.append((blk, int(r), self.B[blk][r, j]))
            for r in np.nonzero(self.F[blk][:, j])[0]:
                if self.rowE_activel[r]:
                    out.append((LINK, int(r), self.F[blk][r, j]))
        return out

    def ineq_column(self, blk: int, j: int):
        out = []
        if blk == FIRST:
            for r in np.nonzero(self.C0[:, j])[0]:
                if self.rowI_active0[r]:
                    out.append((FIRST, int(r), self.C0[r, j]))
            for i in range(self.N):
                for r in np.nonzero(self.C[i][:, j])[0]:
                    if self.rowI_activeN[i, r]:
                        out.append((i, int(r), self.C[i][r, j]))
            for r in np.nonzero(self.G0[:, j])[0]:
                if self.rowI_activel[r]:
                    out.append((LINK, int(r), self.G0[r, j]))
        else:
            for r in np.nonzero(self.D[blk][:, j])[0]:
                if self.rowI_activeN[blk, r]:
                    out.append((blk, int(r), self.D[blk][r, j]))
            for r in np.nonzero(self.G[blk][:, j])[0]:
                if self.rowI_activel[r]:
                    out.append((LINK, int(r), self.G[blk][r, j]))
        return out

    # ------------------------------------------------------------------
    def fix_variable(self, blk: int, j: int, val: float, reason: str):
        """Substitute x[blk,j] = val everywhere and deactivate the column.
        Emits FIXED_COLUMN with everything needed for dual postsolve."""
        c, ixl, xl, ixu, xu, active = self.var_arrays(blk)
        if not active[j]:
            return
        eq_col = self.eq_column(blk, j)
        iq_col = self.ineq_column(blk, j)
        self.emit("FIXED_COLUMN", blk=blk, j=j, val=val, c=float(c[j]),
                  eq_col=eq_col, iq_col=iq_col, reason=reason)
        self.objective_offset += float(c[j]) * val

        # substitute in equality rows (tracking the substitution
        # magnitude per row for scale-aware feasibility tests)
        for (rb, r, a) in eq_col:
            if rb == FIRST:
                self.b0[r] -= a * val
                self.rhs_shift0[r] += abs(a * val)
            elif rb == LINK:
                self.bl[r] -= a * val
                self.rhs_shiftl[r] += abs(a * val)
            else:
                self.bN[rb, r] -= a * val
                self.rhs_shiftN[rb, r] += abs(a * val)
        # substitute in inequality rows (shift both bounds)
        for (rb, r, a) in iq_col:
            if rb == FIRST:
                self.clow0[r] -= a * val
                self.cupp0[r] -= a * val
                self.rhs_shiftI0[r] += abs(a * val)
            elif rb == LINK:
                self.clowl[r] -= a * val
                self.cuppl[r] -= a * val
                self.rhs_shiftIl[r] += abs(a * val)
            else:
                self.clowN[rb, r] -= a * val
                self.cuppN[rb, r] -= a * val
                self.rhs_shiftIN[rb, r] += abs(a * val)

        # zero the column + deactivate (inert boxed var)
        self._zero_column(blk, j)
        c[j] = 0.0
        ixl[j] = 1.0
        xl[j] = -1.0
        ixu[j] = 1.0
        xu[j] = 1.0
        active[j] = False

    def _zero_column(self, blk: int, j: int):
        if blk == FIRST:
            self.A0[:, j] = 0.0
            self.C0[:, j] = 0.0
            self.F0[:, j] = 0.0
            self.G0[:, j] = 0.0
            self.A[:, :, j] = 0.0
            self.C[:, :, j] = 0.0
        else:
            self.B[blk][:, j] = 0.0
            self.D[blk][:, j] = 0.0
            self.F[blk][:, j] = 0.0
            self.G[blk][:, j] = 0.0

    # ------------------------------------------------------------------
    def remove_eq_row(self, blk: int, r: int, reason: str, **extra):
        self.emit("REMOVED_EQ_ROW", blk=blk, r=r, reason=reason,
                  row=self._eq_row_copy(blk, r), **extra)
        if blk == FIRST:
            # first-stage rows span only x0 (A0); block borders A_i belong
            # to block rows, not here
            self.A0[r, :] = 0.0
            self.b0[r] = 0.0
            self.rowE_active0[r] = False
        elif blk == LINK:
            self.F0[r, :] = 0.0
            self.bl[r] = 0.0
            self.F[:, r, :] = 0.0
            self.rowE_activel[r] = False
        else:
            self.A[blk][r, :] = 0.0
            self.B[blk][r, :] = 0.0
            self.bN[blk, r] = 0.0
            self.rowE_activeN[blk, r] = False

    def remove_ineq_row(self, blk: int, r: int, reason: str, **extra):
        self.emit("REMOVED_INEQ_ROW", blk=blk, r=r, reason=reason,
                  row=self._ineq_row_copy(blk, r), **extra)
        if blk == FIRST:
            self.C0[r, :] = 0.0
            self.iclow0[r] = 1.0
            self.clow0[r] = -1.0
            self.icupp0[r] = 1.0
            self.cupp0[r] = 1.0
            self.rowI_active0[r] = False
        elif blk == LINK:
            self.G0[r, :] = 0.0
            self.G[:, r, :] = 0.0
            self.iclowl[r] = 1.0
            self.clowl[r] = -1.0
            self.icuppl[r] = 1.0
            self.cuppl[r] = 1.0
            self.rowI_activel[r] = False
        else:
            self.C[blk][r, :] = 0.0
            self.D[blk][r, :] = 0.0
            self.iclowN[blk, r] = 1.0
            self.clowN[blk, r] = -1.0
            self.icuppN[blk, r] = 1.0
            self.cuppN[blk, r] = 1.0
            self.rowI_activeN[blk, r] = False

    def _eq_row_copy(self, blk, r):
        if blk == FIRST:
            return dict(A0=self.A0[r].copy(), b=float(self.b0[r]))
        if blk == LINK:
            return dict(F0=self.F0[r].copy(),
                        F=[self.F[i][r].copy() for i in range(self.N)],
                        b=float(self.bl[r]))
        return dict(A=self.A[blk][r].copy(), B=self.B[blk][r].copy(),
                    b=float(self.bN[blk, r]))

    def _ineq_row_copy(self, blk, r):
        if blk == FIRST:
            return dict(C0=self.C0[r].copy(),
                        iclow=float(self.iclow0[r]), clow=float(self.clow0[r]),
                        icupp=float(self.icupp0[r]), cupp=float(self.cupp0[r]))
        if blk == LINK:
            return dict(G0=self.G0[r].copy(),
                        G=[self.G[i][r].copy() for i in range(self.N)],
                        iclow=float(self.iclowl[r]), clow=float(self.clowl[r]),
                        icupp=float(self.icuppl[r]), cupp=float(self.cuppl[r]))
        return dict(C=self.C[blk][r].copy(), D=self.D[blk][r].copy(),
                    iclow=float(self.iclowN[blk, r]),
                    clow=float(self.clowN[blk, r]),
                    icupp=float(self.icuppN[blk, r]),
                    cupp=float(self.cuppN[blk, r]))

    # ------------------------------------------------------------------
    def tighten_bounds(self, blk: int, j: int, new_low: Optional[float],
                       new_upp: Optional[float], reason: str,
                       implied_lo=None, implied_upp=None):
        """Tighten variable bounds; detects crossing bounds -> infeasible.

        `implied_lo`/`implied_upp` optionally record the IMPLYING ROW of
        each side as ("eq"|"ineq", row_blk, r) — postsolve uses this for
        the exact (directed) dual transfer when the solver leaves a bound
        multiplier on the tightened bound (the reference's per-reduction
        dual replay for BOUNDS_TIGHTENED, StochPostsolver.C)."""
        c, ixl, xl, ixu, xu, active = self.var_arrays(blk)
        old = (float(ixl[j]), float(xl[j]), float(ixu[j]), float(xu[j]))
        changed = False
        tight_lo = tight_up = False
        if new_low is not None and (ixl[j] == 0 or new_low > xl[j] + 1e-14):
            ixl[j] = 1.0
            xl[j] = new_low
            changed = tight_lo = True
        if new_upp is not None and (ixu[j] == 0 or new_upp < xu[j] - 1e-14):
            ixu[j] = 1.0
            xu[j] = new_upp
            changed = tight_up = True
        if changed:
            self.emit("TIGHTENED_BOUNDS", blk=blk, j=j, old=old,
                      reason=reason,
                      implied_lo=implied_lo if tight_lo else None,
                      implied_upp=implied_upp if tight_up else None)
            if ixl[j] > 0 and ixu[j] > 0 and xl[j] > xu[j] + 1e-9:
                self.infeasible = True
        return changed
