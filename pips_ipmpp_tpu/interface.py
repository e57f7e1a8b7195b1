"""Public facade — the equivalent of the reference's PIPSIPMppInterface
(Core/Interface/PIPSIPMppInterface.hpp:32-128): construct from problem data
+ options; run() -> TerminationStatus; getObjective(); gather* accessors.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, DenseLP
from pips_ipmpp_tpu.core.options import Options, PresolverType, ScalerType
from pips_ipmpp_tpu.core.status import TerminationStatus


def _is_sparse_arrowhead(lp) -> bool:
    from pips_ipmpp_tpu.core.sparse import SparseArrowheadLP
    return isinstance(lp, SparseArrowheadLP)


def _is_bucketed(lp) -> bool:
    from pips_ipmpp_tpu.core.bucketed import BucketedArrowheadLP
    return isinstance(lp, BucketedArrowheadLP)


def resolve_factor_dtype(opts: Options):
    """Factorization dtype.  "auto" factorizes in the working dtype: f64
    when x64 is on (CPU and GPU alike), else f32; residuals and refinement
    always run in the working dtype.  An f32 factor relies on iterative
    refinement to absorb its error (the role of the reference's
    LinearSystem.C:877, SURVEY.md §7 'fp64 vs fp32').  On an H100 (400 W
    limit) the 102k-variable energy LP solved in 29 iterations / 1.67 s
    with f64 factors against 30 / 1.99 s with f32 ones, both within 1e-7
    of the HiGHS objective (benchmarks/precision_ab.py)."""
    import jax
    import jax.numpy as jnp
    if opts.factor_dtype == "float32":
        return jnp.float32
    if opts.factor_dtype == "float64":
        return jnp.float64
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _auto_groups(N: int) -> int:
    """Largest divisor of N not exceeding sqrt(N) (reference
    mapChildrenToNSubTrees picks ~sqrt(N) sub-roots, DistributedTree.h:166)."""
    import math
    best = 1
    for g in range(1, int(math.isqrt(N)) + 1):
        if N % g == 0:
            best = g
    return best


class PIPSIPMppTPUInterface:
    """Facade wiring scaler -> solver -> postsolve (ctor order mirrors
    PIPSIPMppInterface.cpp:20-130)."""

    def __init__(self, lp, options: Optional[Options] = None):
        self.lp = lp
        self.options = options or Options()
        self.result = None
        self._scaler = None
        self._presolve_log = None
        self._hier_meta = None
        self._orig_link_dims = None

        from functools import partial

        from pips_ipmpp_tpu.ipm.solver import IPMSolver

        fd = resolve_factor_dtype(self.options)
        if isinstance(lp, DenseLP):
            if self.options.banded_leaf or self.options.banded_root:
                import warnings
                warnings.warn("banded_leaf/banded_root apply to "
                              "ArrowheadLP only; ignored for DenseLP")
            from pips_ipmpp_tpu.linalg.dense_backend import DenseBackend
            self._solver = IPMSolver(partial(DenseBackend, factor_dtype=fd),
                                     self.options)
        elif isinstance(lp, ArrowheadLP):
            from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
            be_cls = ArrowBackend
            kw = dict(factor_dtype=fd,
                      blockwise_sc=self.options.sc_blockwise,
                      iterative_root=self.options.iterative_root_panel,
                      sc_diag_dom_bound=self.options.sc_diag_dom_bound,
                      it_root_tol=self.options.it_root_tol,
                      it_root_maxiter=self.options.it_root_maxiter)
            if (self.options.banded_leaf or self.options.banded_root) \
                    and self.options.hierarchical:
                raise ValueError("banded_leaf/banded_root are exclusive "
                                 "with hierarchical mode")
            if self.options.banded_leaf:
                from pips_ipmpp_tpu.linalg.band_backend import (
                    BandArrowBackend, plan_banded)
                be_cls = BandArrowBackend
                kw["plan"] = plan_banded(lp)
            if self.options.banded_root:
                from pips_ipmpp_tpu.linalg.band_root import plan_banded_root
                kw["band_root_plan"] = plan_banded_root(lp)
            self._solver = IPMSolver(partial(be_cls, **kw), self.options)
        elif _is_sparse_arrowhead(lp):
            from pips_ipmpp_tpu.core.sparse import (dense_bytes,
                                                    dense_from_sparse)
            budget = self.options.sparse_densify_max_mb * 1024 * 1024
            if budget > 0 and dense_bytes(lp) <= budget:
                # within budget the batched dense factorization replaces
                # the CG leaf; the CG leaf remains the answer for blocks
                # that cannot densify
                from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
                lp = self.lp = dense_from_sparse(lp)
                self._solver = IPMSolver(
                    partial(ArrowBackend, factor_dtype=fd), self.options)
            else:
                from pips_ipmpp_tpu.linalg.sparse_backend import \
                    SparseArrowBackend
                self._solver = IPMSolver(
                    partial(SparseArrowBackend, factor_dtype=fd),
                    self.options)
        elif _is_bucketed(lp):
            if (self.options.banded_leaf or self.options.banded_root
                    or self.options.hierarchical):
                raise ValueError("banded/hierarchical modes are not "
                                 "supported with bucketed blocks")
            from pips_ipmpp_tpu.linalg.bucket_backend import \
                BucketedArrowBackend
            self._solver = IPMSolver(
                partial(BucketedArrowBackend, factor_dtype=fd), self.options)
        else:
            raise TypeError(f"unsupported problem type {type(lp)}")

    # ------------------------------------------------------------------
    def run(self) -> TerminationStatus:
        """Presolve -> scale -> (transform) -> solve.  Per-phase wall
        times land in `self.phase_times` (seconds) — the reference's
        Interface prints the same pipeline split
        (PIPSIPMppInterface.cpp:53-129)."""
        import time as _time
        self.phase_times = {}
        lp = self.lp
        # presolve (ArrowheadLP only; reference presolves before scaling,
        # PIPSIPMppInterface.cpp:39-57,101-119)
        if (self.options.presolve == PresolverType.PRESOLVE
                and isinstance(lp, ArrowheadLP)):
            from pips_ipmpp_tpu.presolve import Presolver
            t0 = _time.perf_counter()
            pres = Presolver(max_rounds=self.options.presolve_max_rounds)
            self._presolve_log = pres.presolve(lp)
            self.phase_times["presolve"] = _time.perf_counter() - t0
            if self._presolve_log.infeasible:
                self.result = None
                self._status_override = TerminationStatus.INFEASIBLE
                return TerminationStatus.INFEASIBLE
            lp = self._presolve_log.lp
        if self.options.scaler != ScalerType.NONE:
            from pips_ipmpp_tpu.scale import make_scaler
            import jax as _jax
            t0 = _time.perf_counter()
            self._scaler = make_scaler(self.options.scaler)
            lp = self._scaler.scale(lp)
            _jax.device_get(_jax.tree.leaves(lp)[0])  # materialize
            self.phase_times["scale"] = _time.perf_counter() - t0
        # hierarchical two-level Schur (reference switchToHierarchicalData,
        # PIPSIPMppInterface.cpp:81-89): transform last so every other
        # stage sees the flat layout
        if self.options.hierarchical and isinstance(lp, ArrowheadLP):
            from functools import partial

            from pips_ipmpp_tpu.ipm.solver import IPMSolver
            from pips_ipmpp_tpu.linalg.hier_backend import (
                HierArrowBackend, build_hierarchical_lp)
            layers = self.options.hierarchical_layers
            if layers < 2:
                raise ValueError(
                    f"hierarchical_layers={layers}: must be >= 2")
            ng = self.options.hierarchical_num_groups or _auto_groups(lp.N)
            # depth is a PARAMETER (reference splitTree recursion for
            # HIERARCHICAL_APPROACH_N_LAYERS, DistributedTreeCallbacks.C:
            # 1123,1194-1217): layers = 2 + len(chain); each coarser
            # level groups the previous one (divisor near its sqrt), and
            # rows local to a level are eliminated by one batched Schur
            # stage each at the top.  The chain stops early if grouping
            # degenerates (one group contains everything).
            chain = []
            c = ng
            for _ in range(layers - 2):
                c = _auto_groups(c)
                if c <= 1:
                    break
                chain.append(c)
            self._orig_link_dims = (lp.mEl, lp.mIl)
            lp, self._hier_meta = build_hierarchical_lp(
                lp, ng, coarse_levels=tuple(chain))
            fd = resolve_factor_dtype(self.options)
            self._solver = IPMSolver(
                partial(HierArrowBackend, meta=self._hier_meta,
                        factor_dtype=fd), self.options)
        t0 = _time.perf_counter()
        self.result = self._solver.solve(lp)
        self.phase_times["solve"] = _time.perf_counter() - t0
        self._postsolved = None
        self._gather_cache = {}
        return self.result.status

    # ------------------------------------------------------------------
    def _require_result(self):
        if self.result is None:
            raise RuntimeError("call run() first")

    def _cached(self, key, fn):
        """Per-run memo for derived quantities (x, Cx, reduced cost):
        the 8 bound-dual/slack gathers share them instead of re-deriving
        the full original-space pipeline each call."""
        cache = getattr(self, "_gather_cache", None)
        if cache is None:
            cache = self._gather_cache = {}
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    def _postsolve(self):
        """Reconstruct the original-space solution if presolve ran
        (reference postsolveComputedSolution, PIPSIPMppInterface.cpp:531)."""
        if self._presolve_log is None:
            return None
        if getattr(self, "_postsolved", None) is not None:
            return self._postsolved
        from pips_ipmpp_tpu.presolve.postsolve import Postsolver, Solution
        it = self.result.iterate
        x = self._unscale_x(it)

        def parts(vec, which, factors):
            # np.array (copy): postsolve mutates these in place
            first = np.array(vec.first, np.float64)
            blocks = np.array(vec.blocks, np.float64)
            link = self._unpermute_link(np.array(vec.link, np.float64),
                                        which)
            if factors is not None:
                first = first * np.asarray(factors.first)
                blocks = blocks * np.asarray(factors.blocks)
                link = link * np.asarray(factors.link)
            return first, blocks, link

        y0, yN, yl = parts(it.y, "E",
                           self._scaler.rE if self._scaler else None)
        z0, zN, zl = parts(it.z, "I",
                           self._scaler.rC if self._scaler else None)
        sol = Solution(
            x0=np.array(x.first, np.float64),
            xN=np.array(x.blocks, np.float64),
            y0=y0, yN=yN, yl=yl, z0=z0, zN=zN, zl=zl)
        self._postsolved = Postsolver(self.lp).postsolve(
            self._presolve_log.events, sol)
        return self._postsolved

    @property
    def n_iterations(self) -> int:
        self._require_result()
        return self.result.iterations

    def getObjective(self) -> float:
        """Objective of the (unscaled) solution (reference
        PIPSIPMppInterface::getObjective :193-211)."""
        self._require_result()
        if _is_bucketed(self.lp):
            # diagonal (pow2) scaling leaves the LP objective value
            # invariant, so the solver's objective is already original
            return float(self.result.objective)
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return float(np.dot(np.asarray(self.lp.c), x))
        lp = self.lp
        return float(np.dot(np.asarray(lp.c0), x[:lp.n0])
                     + np.dot(np.asarray(lp.cN).reshape(-1), x[lp.n0:]))

    def _unscale_x(self, it):
        if self._scaler is not None:
            return self._scaler.unscale_x(it.x)
        return it.x

    def gatherPrimalSolution(self) -> np.ndarray:
        self._require_result()
        return self._cached("x", self._gather_primal)

    def _gather_primal(self) -> np.ndarray:
        ps = self._postsolve()
        if ps is not None:
            return np.concatenate([ps.x0, ps.xN.reshape(-1)])
        x = self._unscale_x(self.result.iterate)
        if isinstance(self.lp, DenseLP):
            return np.asarray(x)
        if _is_bucketed(self.lp):   # [first | bucket0.flat | bucket1.flat …]
            return np.concatenate(
                [np.asarray(x.first)]
                + [np.asarray(b).reshape(-1) for b in x.blocks])
        return np.concatenate([np.asarray(x.first),
                               np.asarray(x.blocks).reshape(-1)])

    # ------------------------------------------------------------------
    # original-space matvecs (numpy, off the hot path — used by the
    # cons-value/residual gathers the way the reference combines gathered
    # residuals with problem data, PIPSIPMppInterface.cpp:337-384)
    @staticmethod
    def _flatcat(first, blocks, link=None) -> np.ndarray:
        """[first | blocks.flat | link] where `blocks` is either a batched
        [N, k] array (uniform ArrowheadLP) or a tuple of per-bucket batched
        arrays (BucketedArrowheadLP)."""
        parts = [np.asarray(first, np.float64).reshape(-1)]
        if isinstance(blocks, (tuple, list)):
            parts += [np.asarray(b, np.float64).reshape(-1) for b in blocks]
        else:
            parts.append(np.asarray(blocks, np.float64).reshape(-1))
        if link is not None:
            parts.append(np.asarray(link, np.float64).reshape(-1))
        return np.concatenate(parts)

    @staticmethod
    def _blocks_op(blocks, factors, op):
        """Elementwise op between a blocks part and matching scale factors;
        both are tuples (bucketed) or batched arrays (uniform)."""
        if isinstance(blocks, (tuple, list)):
            return tuple(op(np.asarray(b, np.float64), np.asarray(f))
                         for b, f in zip(blocks, factors))
        return op(np.asarray(blocks, np.float64), np.asarray(factors))

    def _split_x(self, xflat: np.ndarray):
        lp = self.lp
        if _is_bucketed(lp):
            xN, off = [], lp.n0
            for b in lp.buckets:
                xN.append(xflat[off:off + b.N * b.n].reshape(b.N, b.n))
                off += b.N * b.n
            return xflat[:lp.n0], xN
        return xflat[:lp.n0], xflat[lp.n0:].reshape(lp.N, lp.n)

    @staticmethod
    def _bd_mv(mat, x) -> np.ndarray:
        """Diagonal-block matvec that accepts dense [N, m, n] or Ell."""
        from pips_ipmpp_tpu.core.sparse import Ell, ell_mv
        if isinstance(mat, Ell):
            return np.asarray(ell_mv(mat, jnp.asarray(x)), np.float64)
        return np.einsum("nij,nj->ni", np.asarray(mat, np.float64), x)

    def _arrow_Ax(self, x0, xN) -> np.ndarray:
        lp = self.lp
        if _is_bucketed(lp):
            lp0 = lp.buckets[0]     # first-stage/link data shared
            r0 = np.asarray(lp0.A0, np.float64) @ x0
            rl = np.asarray(lp0.F0, np.float64) @ x0
            rNs = []
            for b, xb in zip(lp.buckets, xN):
                A, B = (np.asarray(b.A, np.float64),
                        np.asarray(b.B, np.float64))
                rNs.append(A @ x0 + np.einsum("nij,nj->ni", B, xb))
                rl = rl + np.einsum("nij,nj->i",
                                    np.asarray(b.F, np.float64), xb)
            return self._flatcat(r0, rNs, rl)
        A0, A = (np.asarray(lp.A0, np.float64),
                 np.asarray(lp.A, np.float64))
        F0, F = np.asarray(lp.F0, np.float64), np.asarray(lp.F, np.float64)
        r0 = A0 @ x0
        rN = A @ x0 + self._bd_mv(lp.B, xN)   # dense or ELL diag block
        rl = F0 @ x0 + np.einsum("nij,nj->i", F, xN)
        return np.concatenate([r0, rN.reshape(-1), rl])

    def _arrow_Cx(self, x0, xN) -> np.ndarray:
        lp = self.lp
        if _is_bucketed(lp):
            lp0 = lp.buckets[0]
            r0 = np.asarray(lp0.C0, np.float64) @ x0
            rl = np.asarray(lp0.G0, np.float64) @ x0
            rNs = []
            for b, xb in zip(lp.buckets, xN):
                C, D = (np.asarray(b.C, np.float64),
                        np.asarray(b.D, np.float64))
                rNs.append(C @ x0 + np.einsum("nij,nj->ni", D, xb))
                rl = rl + np.einsum("nij,nj->i",
                                    np.asarray(b.G, np.float64), xb)
            return self._flatcat(r0, rNs, rl)
        C0, C = (np.asarray(lp.C0, np.float64),
                 np.asarray(lp.C, np.float64))
        G0, G = np.asarray(lp.G0, np.float64), np.asarray(lp.G, np.float64)
        r0 = C0 @ x0
        rN = C @ x0 + self._bd_mv(lp.D, xN)   # dense or ELL diag block
        rl = G0 @ x0 + np.einsum("nij,nj->i", G, xN)
        return np.concatenate([r0, rN.reshape(-1), rl])

    def gatherEqualityConsValues(self) -> np.ndarray:
        """Values A x of the equality rows in the ORIGINAL space (reference
        gatherEqualityConsValues = gathered eq residuals + rhs,
        PIPSIPMppInterface.cpp:337-357)."""
        self._require_result()
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return np.asarray(self.lp.A, np.float64) @ x
        return self._arrow_Ax(*self._split_x(x))

    def gatherInequalityConsValues(self) -> np.ndarray:
        """Values C x of the inequality rows in the ORIGINAL space
        (reference :360-384, gathered ineq residuals + slacks)."""
        self._require_result()
        return self._cached("Cx", self._gather_ineq_values)

    def _gather_ineq_values(self) -> np.ndarray:
        x = self.gatherPrimalSolution()
        if isinstance(self.lp, DenseLP):
            return np.asarray(self.lp.C, np.float64) @ x
        return self._arrow_Cx(*self._split_x(x))

    def _unpermute_link(self, vec: np.ndarray, which: str) -> np.ndarray:
        """Map hierarchical-layout link vectors back to user row order."""
        if self._hier_meta is None:
            return vec
        from pips_ipmpp_tpu.linalg.hier_backend import unpermute_link_one
        size = (self._orig_link_dims[0] if which == "E"
                else self._orig_link_dims[1])
        return unpermute_link_one(self._hier_meta, vec, which, size)

    def _gather_row_dual(self, vec, which: str, factors) -> np.ndarray:
        """Unpermute (hier layout -> flat), then unscale, then flatten."""
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        link = self._unpermute_link(np.asarray(vec.link, np.float64), which)
        if factors is not None:
            first = first * np.asarray(factors.first)
            blocks = self._blocks_op(blocks, factors.blocks, np.multiply)
            link = link * np.asarray(factors.link)
        return self._flatcat(first, blocks, link)

    def gatherDualSolutionEq(self) -> np.ndarray:
        self._require_result()
        ps = self._postsolve()
        if ps is not None:
            return np.concatenate([ps.y0, ps.yN.reshape(-1), ps.yl])
        y = self.result.iterate.y
        if isinstance(self.lp, DenseLP):
            if self._scaler is not None:
                y = self._scaler.unscale_y(y)
            return np.asarray(y)
        rE = self._scaler.rE if self._scaler is not None else None
        return self._gather_row_dual(y, "E", rE)

    def gatherDualSolutionIneq(self) -> np.ndarray:
        self._require_result()
        ps = self._postsolve()
        if ps is not None:
            return np.concatenate([ps.z0, ps.zN.reshape(-1), ps.zl])
        z = self.result.iterate.z
        if isinstance(self.lp, DenseLP):
            if self._scaler is not None:
                z = self._scaler.unscale_z(z)
            return np.asarray(z)
        rC = self._scaler.rC if self._scaler is not None else None
        return self._gather_row_dual(z, "I", rC)

    # ------------------------------------------------------------------
    # slack / bound-gap gathers (reference gatherSlacks*,
    # PIPSIPMppInterface.cpp:386-400).  Without presolve these return the
    # iterate's gap vectors unscaled; with presolve the gaps are
    # reconstructed in the original space from the postsolved solution
    # (exact at convergence: the rv/rw/rt/ru residuals are ~0, reference
    # Residuals.h:84-87).
    def _gather_x_gap(self, vec) -> np.ndarray:
        """x-space gap (v or w): unscale = multiply by the column factors
        (x' = x/s => gaps scale like x)."""
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v * np.asarray(self._scaler.s) if self._scaler else v
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        if self._scaler is not None:
            first = first * np.asarray(self._scaler.s.first)
            blocks = self._blocks_op(blocks, self._scaler.s.blocks,
                                     np.multiply)
        return self._flatcat(first, blocks)

    def _gather_row_gap(self, vec, which: str) -> np.ndarray:
        """ineq-row-space gap (t or u): unscale = divide by the row factors
        (slack' = rC * slack)."""
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v / np.asarray(self._scaler.rC) if self._scaler else v
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        link = self._unpermute_link(np.asarray(vec.link, np.float64), which)
        if self._scaler is not None:
            # the scaler ran BEFORE the hierarchical transform, so its
            # factors are already in original row order — only the
            # iterate's link vector needed unpermuting
            rc = self._scaler.rC
            first = first / np.asarray(rc.first)
            blocks = self._blocks_op(blocks, rc.blocks, np.divide)
            link = link / np.asarray(rc.link, np.float64)
        return self._flatcat(first, blocks, link)

    def _gather_bound_dual(self, vec) -> np.ndarray:
        """x-space bound dual (gamma or phi): unscale = divide by the
        column factors."""
        if isinstance(self.lp, DenseLP):
            v = np.asarray(vec, np.float64)
            return v / np.asarray(self._scaler.s) if self._scaler else v
        first = np.asarray(vec.first, np.float64)
        blocks = vec.blocks
        if self._scaler is not None:
            first = first / np.asarray(self._scaler.s.first)
            blocks = self._blocks_op(blocks, self._scaler.s.blocks,
                                     np.divide)
        return self._flatcat(first, blocks)

    def _orig_var_bounds(self):
        """(ixlow, xlow, ixupp, xupp) flattened in the original space."""
        lp = self.lp
        if isinstance(lp, DenseLP):
            return (np.asarray(lp.ixlow, np.float64),
                    np.asarray(lp.xlow, np.float64),
                    np.asarray(lp.ixupp, np.float64),
                    np.asarray(lp.xupp, np.float64))
        if _is_bucketed(lp):
            lp0 = lp.buckets[0]
            return (self._flatcat(lp0.ixlow0, [b.ixlowN for b in lp.buckets]),
                    self._flatcat(lp0.xlow0, [b.xlowN for b in lp.buckets]),
                    self._flatcat(lp0.ixupp0, [b.ixuppN for b in lp.buckets]),
                    self._flatcat(lp0.xupp0, [b.xuppN for b in lp.buckets]))
        cat = lambda a, b: np.concatenate(
            [np.asarray(a, np.float64), np.asarray(b, np.float64).reshape(-1)])
        return (cat(lp.ixlow0, lp.ixlowN), cat(lp.xlow0, lp.xlowN),
                cat(lp.ixupp0, lp.ixuppN), cat(lp.xupp0, lp.xuppN))

    def _orig_row_bounds(self):
        """(iclow, clow, icupp, cupp) of the ineq rows, flattened."""
        lp = self.lp
        if isinstance(lp, DenseLP):
            return (np.asarray(lp.iclow, np.float64),
                    np.asarray(lp.clow, np.float64),
                    np.asarray(lp.icupp, np.float64),
                    np.asarray(lp.cupp, np.float64))
        if _is_bucketed(lp):
            lp0 = lp.buckets[0]
            return (self._flatcat(lp0.iclow0,
                                  [b.iclowN for b in lp.buckets], lp0.iclowl),
                    self._flatcat(lp0.clow0,
                                  [b.clowN for b in lp.buckets], lp0.clowl),
                    self._flatcat(lp0.icupp0,
                                  [b.icuppN for b in lp.buckets], lp0.icuppl),
                    self._flatcat(lp0.cupp0,
                                  [b.cuppN for b in lp.buckets], lp0.cuppl))
        cat3 = lambda a, b, c: np.concatenate(
            [np.asarray(a, np.float64), np.asarray(b, np.float64).reshape(-1),
             np.asarray(c, np.float64)])
        return (cat3(lp.iclow0, lp.iclowN, lp.iclowl),
                cat3(lp.clow0, lp.clowN, lp.clowl),
                cat3(lp.icupp0, lp.icuppN, lp.icuppl),
                cat3(lp.cupp0, lp.cuppN, lp.cuppl))

    def gatherSlacksVarsLow(self) -> np.ndarray:
        """v = x - xlow on lower-bounded variables (reference :398)."""
        self._require_result()
        if self._presolve_log is not None:
            x = self.gatherPrimalSolution()
            il, lo, _, _ = self._orig_var_bounds()
            return il * (x - lo)
        return self._gather_x_gap(self.result.iterate.v)

    def gatherSlacksVarsUp(self) -> np.ndarray:
        """w = xupp - x on upper-bounded variables (reference :394)."""
        self._require_result()
        if self._presolve_log is not None:
            x = self.gatherPrimalSolution()
            _, _, iu, up = self._orig_var_bounds()
            return iu * (up - x)
        return self._gather_x_gap(self.result.iterate.w)

    def gatherSlacksInequalityLow(self) -> np.ndarray:
        """t = s - clow on lower-bounded ineq rows (reference :390)."""
        self._require_result()
        if self._presolve_log is not None:
            cx = self.gatherInequalityConsValues()
            il, lo, _, _ = self._orig_row_bounds()
            return il * (cx - lo)
        return self._gather_row_gap(self.result.iterate.t, "I")

    def gatherSlacksInequalityUp(self) -> np.ndarray:
        """u = cupp - s on upper-bounded ineq rows (reference :386)."""
        self._require_result()
        if self._presolve_log is not None:
            cx = self.gatherInequalityConsValues()
            _, _, iu, up = self._orig_row_bounds()
            return iu * (up - cx)
        return self._gather_row_gap(self.result.iterate.u, "I")

    # ------------------------------------------------------------------
    # bound-dual gathers (reference gatherDualSolutionVarBounds*/IneqUpp/
    # IneqLow, :302-335).  With presolve, bound duals are recovered from
    # the sign-split reduced costs / ineq duals (standard LP dual
    # recovery; exact at complementarity).
    def _reduced_cost(self) -> np.ndarray:
        """c - A'y - C'z in the original space (= gamma - phi at KKT)."""
        return self._cached("red", self._reduced_cost_impl)

    def _reduced_cost_impl(self) -> np.ndarray:
        x = self.gatherPrimalSolution()
        y = self.gatherDualSolutionEq()
        z = self.gatherDualSolutionIneq()
        lp = self.lp
        if isinstance(lp, DenseLP):
            return (np.asarray(lp.c, np.float64)
                    - np.asarray(lp.A, np.float64).T @ y
                    - np.asarray(lp.C, np.float64).T @ z)
        if _is_bucketed(lp):
            it = self.result.iterate
            lp0 = lp.buckets[0]
            y0 = np.asarray(it.y.first, np.float64)
            yl = np.asarray(it.y.link, np.float64)
            z0 = np.asarray(it.z.first, np.float64)
            zl = np.asarray(it.z.link, np.float64)
            g0 = (np.asarray(lp0.A0, np.float64).T @ y0
                  + np.asarray(lp0.F0, np.float64).T @ yl
                  + np.asarray(lp0.C0, np.float64).T @ z0
                  + np.asarray(lp0.G0, np.float64).T @ zl)
            gN = []
            for b, yb, zb in zip(lp.buckets, it.y.blocks, it.z.blocks):
                yb = np.asarray(yb, np.float64)
                zb = np.asarray(zb, np.float64)
                g0 = g0 + (np.einsum("nij,ni->j",
                                     np.asarray(b.A, np.float64), yb)
                           + np.einsum("nij,ni->j",
                                       np.asarray(b.C, np.float64), zb))
                gN.append(np.einsum("nij,ni->nj",
                                    np.asarray(b.B, np.float64), yb)
                          + np.einsum("nij,i->nj",
                                      np.asarray(b.F, np.float64), yl)
                          + np.einsum("nij,ni->nj",
                                      np.asarray(b.D, np.float64), zb)
                          + np.einsum("nij,i->nj",
                                      np.asarray(b.G, np.float64), zl))
            c = self._flatcat(lp0.c0, [b.cN for b in lp.buckets])
            return c - self._flatcat(g0, gN)
        y0, yN, yl = (y[:lp.m0E], y[lp.m0E:lp.m0E + lp.N * lp.mE]
                      .reshape(lp.N, lp.mE), y[lp.m0E + lp.N * lp.mE:])
        z0, zN, zl = (z[:lp.m0I], z[lp.m0I:lp.m0I + lp.N * lp.mI]
                      .reshape(lp.N, lp.mI), z[lp.m0I + lp.N * lp.mI:])
        A0, A = (np.asarray(lp.A0, np.float64),
                 np.asarray(lp.A, np.float64))
        C0, C = (np.asarray(lp.C0, np.float64),
                 np.asarray(lp.C, np.float64))
        F0, F = np.asarray(lp.F0, np.float64), np.asarray(lp.F, np.float64)
        G0, G = np.asarray(lp.G0, np.float64), np.asarray(lp.G, np.float64)
        g0 = (A0.T @ y0 + np.einsum("nij,ni->j", A, yN) + F0.T @ yl
              + C0.T @ z0 + np.einsum("nij,ni->j", C, zN) + G0.T @ zl)
        # B'y / D'z through the stored transposes when the diag blocks
        # are ELL (non-densified sparse problems)
        if _is_sparse_arrowhead(lp):
            BtY = self._bd_mv(lp.Bt, yN)
            DtZ = self._bd_mv(lp.Dt, zN)
        else:
            BtY = np.einsum("nij,ni->nj", np.asarray(lp.B, np.float64), yN)
            DtZ = np.einsum("nij,ni->nj", np.asarray(lp.D, np.float64), zN)
        gN = (BtY + np.einsum("nij,i->nj", F, yl)
              + DtZ + np.einsum("nij,i->nj", G, zl))
        c = np.concatenate([np.asarray(lp.c0, np.float64),
                            np.asarray(lp.cN, np.float64).reshape(-1)])
        return c - np.concatenate([g0, gN.reshape(-1)])

    def gatherDualSolutionVarBoundsLow(self) -> np.ndarray:
        """gamma (dual of x >= xlow), reference :333."""
        self._require_result()
        if self._presolve_log is not None:
            rc = self._reduced_cost()
            il, _, _, _ = self._orig_var_bounds()
            return il * np.maximum(rc, 0.0)
        return self._gather_bound_dual(self.result.iterate.gamma)

    def gatherDualSolutionVarBoundsUpp(self) -> np.ndarray:
        """phi (dual of x <= xupp), reference :328."""
        self._require_result()
        if self._presolve_log is not None:
            rc = self._reduced_cost()
            _, _, iu, _ = self._orig_var_bounds()
            return iu * np.maximum(-rc, 0.0)
        return self._gather_bound_dual(self.result.iterate.phi)

    def gatherDualSolutionVarBounds(self) -> np.ndarray:
        """gamma - phi (low minus upp, reference :312-324)."""
        return (self.gatherDualSolutionVarBoundsLow()
                - self.gatherDualSolutionVarBoundsUpp())

    def gatherDualSolutionIneqLow(self) -> np.ndarray:
        """lambda (dual of C x >= clow), reference :307.  Row-space dual:
        unscales like z (multiply by the row factors)."""
        self._require_result()
        if self._presolve_log is not None:
            z = self.gatherDualSolutionIneq()
            il, _, _, _ = self._orig_row_bounds()
            return il * np.maximum(z, 0.0)
        it = self.result.iterate
        if isinstance(self.lp, DenseLP):
            lam = np.asarray(it.lam, np.float64)
            return (lam * np.asarray(self._scaler.rC)
                    if self._scaler else lam)
        rC = self._scaler.rC if self._scaler is not None else None
        return self._gather_row_dual(it.lam, "I", rC)

    def gatherDualSolutionIneqUpp(self) -> np.ndarray:
        """pi (dual of C x <= cupp), reference :302."""
        self._require_result()
        if self._presolve_log is not None:
            z = self.gatherDualSolutionIneq()
            _, _, iu, _ = self._orig_row_bounds()
            return iu * np.maximum(-z, 0.0)
        it = self.result.iterate
        if isinstance(self.lp, DenseLP):
            pi = np.asarray(it.pi, np.float64)
            return (pi * np.asarray(self._scaler.rC)
                    if self._scaler else pi)
        rC = self._scaler.rC if self._scaler is not None else None
        return self._gather_row_dual(it.pi, "I", rC)

    # ------------------------------------------------------------------
    # residual gathers (reference gatherPrimalResids*/gatherDualResids,
    # :403-417) — evaluated in the ORIGINAL space from the gathered
    # solution, so they are meaningful after presolve/scaling too.
    def gatherPrimalResidsEQ(self) -> np.ndarray:
        """rA = A x - b (reference :403)."""
        self._require_result()
        ax = self.gatherEqualityConsValues()
        lp = self.lp
        if isinstance(lp, DenseLP):
            return ax - np.asarray(lp.b, np.float64)
        if _is_bucketed(lp):
            b = self._flatcat(lp.buckets[0].b0,
                              [bk.bN for bk in lp.buckets], lp.buckets[0].bl)
            return ax - b
        b = np.concatenate([np.asarray(lp.b0, np.float64),
                            np.asarray(lp.bN, np.float64).reshape(-1),
                            np.asarray(lp.bl, np.float64)])
        return ax - b

    def gatherPrimalResidsIneqLow(self) -> np.ndarray:
        """rt = min(C x - clow, 0) violation on lower-bounded rows
        (reference rt, :411)."""
        self._require_result()
        cx = self.gatherInequalityConsValues()
        il, lo, _, _ = self._orig_row_bounds()
        return il * np.minimum(cx - lo, 0.0)

    def gatherPrimalResidsIneqUp(self) -> np.ndarray:
        """ru = max(C x - cupp, 0) violation on upper-bounded rows
        (reference ru, :407)."""
        self._require_result()
        cx = self.gatherInequalityConsValues()
        _, _, iu, up = self._orig_row_bounds()
        return iu * np.maximum(cx - up, 0.0)

    def gatherDualResids(self) -> np.ndarray:
        """Lagrangian gradient c - A'y - C'z - gamma + phi (reference
        :415)."""
        self._require_result()
        return (self._reduced_cost()
                - self.gatherDualSolutionVarBoundsLow()
                + self.gatherDualSolutionVarBoundsUpp())

    # ------------------------------------------------------------------
    def getFirstStageObjective(self) -> float:
        """c0' x0 in the original space (reference :213-218)."""
        self._require_result()
        x = self.gatherPrimalSolution()
        lp = self.lp
        if isinstance(lp, DenseLP):
            return float(np.dot(np.asarray(lp.c, np.float64), x))
        c0 = lp.buckets[0].c0 if _is_bucketed(lp) else lp.c0
        return float(np.dot(np.asarray(c0, np.float64), x[:lp.n0]))

    def getFirstStagePrimalColSolution(self) -> np.ndarray:
        """x0 (reference :419-422)."""
        self._require_result()
        lp = self.lp
        x = self.gatherPrimalSolution()
        return x if isinstance(lp, DenseLP) else x[:lp.n0]

    def getSecondStagePrimalColSolution(self, scen: int) -> np.ndarray:
        """x_scen (reference :424-430)."""
        self._require_result()
        lp = self.lp
        if isinstance(lp, DenseLP):
            raise TypeError("second-stage solution requires ArrowheadLP")
        x = self.gatherPrimalSolution()
        if _is_bucketed(lp):
            bi, pos = lp.placement[scen]
            off = lp.n0 + sum(b.N * b.n for b in lp.buckets[:bi])
            nb = lp.buckets[bi].n
            return x[off + pos * nb: off + (pos + 1) * nb]
        return x[lp.n0 + scen * lp.n: lp.n0 + (scen + 1) * lp.n]

    def allgatherBlocksizes(self) -> tuple:
        """Per-block (column, equality-row, inequality-row) lengths of the
        ORIGINAL problem, as three uint32 arrays:

        - cols:  [n0, n_1, ..., n_N]                       (N+1 entries)
        - eq:    [m0E, mE_1, ..., mE_N, mEl]               (N+2 entries)
        - ineq:  [m0I, mI_1, ..., mI_N, mIl]               (N+2 entries)

        Reference PIPSIPMppInterface::allgatherBlocksizes
        (PIPSIPMppInterface.hpp:84, .cpp:432-497): ranks sum their local
        child lengths; here the single-controller layout holds every
        block, so the "allgather" is a direct read."""
        lp = self.lp
        if isinstance(lp, DenseLP):
            raise TypeError("allgatherBlocksizes requires a block problem")
        u32 = np.uint32
        if _is_bucketed(lp):
            b0 = lp.buckets[0]
            cols = [lp.n0] + [lp.buckets[bi].n for bi, _ in lp.placement]
            eq = ([b0.m0E] + [lp.buckets[bi].mE for bi, _ in lp.placement]
                  + [b0.mEl])
            ineq = ([b0.m0I] + [lp.buckets[bi].mI for bi, _ in lp.placement]
                    + [b0.mIl])
            return (np.array(cols, u32), np.array(eq, u32),
                    np.array(ineq, u32))
        cols = np.full(lp.N + 1, lp.n, u32)
        cols[0] = lp.n0
        eq = np.full(lp.N + 2, lp.mE, u32)
        eq[0], eq[-1] = lp.m0E, lp.mEl
        ineq = np.full(lp.N + 2, lp.mI, u32)
        ineq[0], ineq[-1] = lp.m0I, lp.mIl
        return cols, eq, ineq

    def printComplementarityResiduals(self) -> dict:
        """inf-norms of the complementarity products v*gamma, w*phi,
        t*lambda, u*pi (reference printComplementarityResiduals,
        :497-528).  Returns the norms and prints them."""
        self._require_result()
        pairs = {
            "vars_low (v*gamma)": (self.gatherSlacksVarsLow(),
                                   self.gatherDualSolutionVarBoundsLow()),
            "vars_upp (w*phi)": (self.gatherSlacksVarsUp(),
                                 self.gatherDualSolutionVarBoundsUpp()),
            "ineq_low (t*lambda)": (self.gatherSlacksInequalityLow(),
                                    self.gatherDualSolutionIneqLow()),
            "ineq_upp (u*pi)": (self.gatherSlacksInequalityUp(),
                                self.gatherDualSolutionIneqUpp()),
        }
        norms = {}
        for name, (a, b) in pairs.items():
            norms[name] = float(np.max(np.abs(a * b))) if a.size else 0.0
            print(f"complementarity {name}: {norms[name]:.3e}")
        return norms
