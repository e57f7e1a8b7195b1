"""Callback-based problem input: the equivalent of the
reference's `DistributedInputTree` (Core/Readers/Distributed/
DistributedInputTree.h:11-39): the user supplies per-block callbacks that
return sizes and data on demand; the tree is materialized into the batched
ArrowheadLP.  CSR triplets are accepted and densified (the batched-dense
layout IS the device storage format)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, make_arrowhead_lp


def csr_to_dense(m: int, n: int, krow, jcol, vals) -> np.ndarray:
    """Row-major CSR triplets (the reference's FMAT callback format,
    DistributedInputTree.h:13) to dense."""
    out = np.zeros((m, n))
    krow = np.asarray(krow)
    jcol = np.asarray(jcol)
    vals = np.asarray(vals, dtype=np.float64)
    rows = np.repeat(np.arange(m), np.diff(krow))
    out[rows, jcol[:len(rows)]] = vals[:len(rows)]
    return out


@dataclass
class BlockCallbacks:
    """Per-node data provider. Each callback takes the block id and returns
    numpy data; matrix callbacks may return either a dense array or a CSR
    triple (krow, jcol, vals) with shape metadata handled by the tree."""
    id: int
    n_vars: Callable[[int], int]
    n_eq: Callable[[int], int]
    n_ineq: Callable[[int], int]
    vec_c: Callable[[int], np.ndarray]
    mat_A: Callable[[int], object]      # border (eq) — ignored for id 0
    mat_B: Callable[[int], object]      # diagonal (eq); A0 for id 0
    vec_b: Callable[[int], np.ndarray]
    mat_C: Callable[[int], object]
    mat_D: Callable[[int], object]
    vec_clow: Callable[[int], np.ndarray]
    vec_iclow: Callable[[int], np.ndarray]
    vec_cupp: Callable[[int], np.ndarray]
    vec_icupp: Callable[[int], np.ndarray]
    vec_xlow: Callable[[int], np.ndarray]
    vec_ixlow: Callable[[int], np.ndarray]
    vec_xupp: Callable[[int], np.ndarray]
    vec_ixupp: Callable[[int], np.ndarray]
    mat_F: Optional[Callable[[int], object]] = None    # linking eq strip
    mat_G: Optional[Callable[[int], object]] = None    # linking ineq strip


@dataclass
class InputTree:
    """Root (id 0) + children (ids 1..N) + linking-row data."""
    root: BlockCallbacks
    children: list
    n_linking_eq: int = 0
    n_linking_ineq: int = 0
    vec_bl: Optional[Callable[[], np.ndarray]] = None
    vec_dllow: Optional[Callable[[], np.ndarray]] = None
    vec_idllow: Optional[Callable[[], np.ndarray]] = None
    vec_dlupp: Optional[Callable[[], np.ndarray]] = None
    vec_idlupp: Optional[Callable[[], np.ndarray]] = None

    def build(self, dtype=jnp.float64, max_block_vars: int | None = None,
              bucketed: bool = False):
        """Assemble the batched problem.  `max_block_vars` splits
        oversized blocks at intake (core/dissect.refine_blocks);
        `bucketed` groups heterogeneous block sizes into size-quantized
        buckets (core/bucketed.py) instead of padding to the global max.
        Returns ArrowheadLP, or BucketedArrowheadLP when `bucketed`.

        When blocks were split, `self.refine_placement[i]` holds the
        (new_block | FIRST, local_index) per original block-i variable so
        callers can map solutions back to the pre-split ordering."""
        mEl, mIl = self.n_linking_eq, self.n_linking_ineq

        def mat(cb, blk_id, m, n):
            if cb is None:
                return np.zeros((m, n))
            out = cb(blk_id)
            if isinstance(out, tuple):
                return csr_to_dense(m, n, *out)
            out = np.asarray(out, dtype=np.float64)
            assert out.shape == (m, n), (out.shape, (m, n))
            return out

        r = self.root
        n0 = r.n_vars(0)
        m0E, m0I = r.n_eq(0), r.n_ineq(0)
        first = dict(
            c=np.asarray(r.vec_c(0), np.float64),
            A=mat(r.mat_B, 0, m0E, n0),     # root diag = A0 (reference Bmat)
            b=np.asarray(r.vec_b(0), np.float64),
            C=mat(r.mat_D, 0, m0I, n0),
            iclow=np.asarray(r.vec_iclow(0), np.float64),
            clow=np.asarray(r.vec_clow(0), np.float64),
            icupp=np.asarray(r.vec_icupp(0), np.float64),
            cupp=np.asarray(r.vec_cupp(0), np.float64),
            ixlow=np.asarray(r.vec_ixlow(0), np.float64),
            xlow=np.asarray(r.vec_xlow(0), np.float64),
            ixupp=np.asarray(r.vec_ixupp(0), np.float64),
            xupp=np.asarray(r.vec_xupp(0), np.float64),
            F0=mat(r.mat_F, 0, mEl, n0),
            G0=mat(r.mat_G, 0, mIl, n0),
        )
        blocks = []
        for cb in self.children:
            i = cb.id
            ni, mEi, mIi = cb.n_vars(i), cb.n_eq(i), cb.n_ineq(i)
            blocks.append(dict(
                c=np.asarray(cb.vec_c(i), np.float64),
                A=mat(cb.mat_A, i, mEi, n0),
                B=mat(cb.mat_B, i, mEi, ni),
                b=np.asarray(cb.vec_b(i), np.float64),
                C=mat(cb.mat_C, i, mIi, n0),
                D=mat(cb.mat_D, i, mIi, ni),
                iclow=np.asarray(cb.vec_iclow(i), np.float64),
                clow=np.asarray(cb.vec_clow(i), np.float64),
                icupp=np.asarray(cb.vec_icupp(i), np.float64),
                cupp=np.asarray(cb.vec_cupp(i), np.float64),
                ixlow=np.asarray(cb.vec_ixlow(i), np.float64),
                xlow=np.asarray(cb.vec_xlow(i), np.float64),
                ixupp=np.asarray(cb.vec_ixupp(i), np.float64),
                xupp=np.asarray(cb.vec_xupp(i), np.float64),
                F=mat(cb.mat_F, i, mEl, ni),
                G=mat(cb.mat_G, i, mIl, ni),
            ))
        linking_eq = {"b": (np.asarray(self.vec_bl(), np.float64)
                            if self.vec_bl else np.zeros(mEl))}
        linking_ineq = {
            "iclow": (np.asarray(self.vec_idllow(), np.float64)
                      if self.vec_idllow else np.zeros(mIl)),
            "clow": (np.asarray(self.vec_dllow(), np.float64)
                     if self.vec_dllow else np.zeros(mIl)),
            "icupp": (np.asarray(self.vec_idlupp(), np.float64)
                      if self.vec_idlupp else np.zeros(mIl)),
            "cupp": (np.asarray(self.vec_dlupp(), np.float64)
                     if self.vec_dlupp else np.zeros(mIl)),
        }
        self.refine_placement = None
        if max_block_vars is not None:
            from pips_ipmpp_tpu.core.dissect import refine_blocks
            blocks, first, self.refine_placement = refine_blocks(
                blocks, first, max_block_vars)
        if bucketed:
            from pips_ipmpp_tpu.core.bucketed import \
                make_bucketed_arrowhead_lp
            return make_bucketed_arrowhead_lp(
                blocks, first, linking_eq, linking_ineq, dtype=dtype)
        return make_arrowhead_lp(blocks, first, linking_eq, linking_ineq,
                                 dtype=dtype)

    def build_sparse(self, dtype=jnp.float64, K: int | None = None):
        """Build a SparseArrowheadLP keeping the diagonal blocks B/D in
        CSR->ELL form end-to-end — never densified (the intake for
        reference-class sparse instances; the reference's FMAT callbacks
        deliver CSR, DistributedInputTree.h:13, and SparseStorage keeps
        them sparse).  Borders (A, C) and linking strips (F, G) stay
        dense: their minor dimension is the small root/link size."""
        from pips_ipmpp_tpu.core.csr import CsrMatrix
        from pips_ipmpp_tpu.core.sparse import make_sparse_arrowhead_lp

        mEl, mIl = self.n_linking_eq, self.n_linking_ineq

        def mat(cb, blk_id, m, n):
            if cb is None:
                return np.zeros((m, n))
            out = cb(blk_id)
            if isinstance(out, tuple):
                return csr_to_dense(m, n, *out)
            out = np.asarray(out, dtype=np.float64)
            assert out.shape == (m, n), (out.shape, (m, n))
            return out

        def sparse_mat(cb, blk_id, m, n):
            if cb is None:
                return CsrMatrix.from_triplets([], [], [], (m, n))
            out = cb(blk_id)
            if isinstance(out, CsrMatrix):
                return out
            if isinstance(out, tuple):
                krow, jcol, vals = out
                indptr = np.asarray(krow, np.int64)
                nnz = int(indptr[-1])
                return CsrMatrix(indptr,
                                 np.asarray(jcol, np.int32)[:nnz],
                                 np.asarray(vals, np.float64)[:nnz],
                                 (m, n))
            return CsrMatrix.from_dense(np.asarray(out, np.float64))

        r = self.root
        n0 = r.n_vars(0)
        m0E, m0I = r.n_eq(0), r.n_ineq(0)
        first = dict(
            c=np.asarray(r.vec_c(0), np.float64),
            A=mat(r.mat_B, 0, m0E, n0),
            b=np.asarray(r.vec_b(0), np.float64),
            C=mat(r.mat_D, 0, m0I, n0),
            iclow=np.asarray(r.vec_iclow(0), np.float64),
            clow=np.asarray(r.vec_clow(0), np.float64),
            icupp=np.asarray(r.vec_icupp(0), np.float64),
            cupp=np.asarray(r.vec_cupp(0), np.float64),
            ixlow=np.asarray(r.vec_ixlow(0), np.float64),
            xlow=np.asarray(r.vec_xlow(0), np.float64),
            ixupp=np.asarray(r.vec_ixupp(0), np.float64),
            xupp=np.asarray(r.vec_xupp(0), np.float64),
            F0=mat(r.mat_F, 0, mEl, n0),
            G0=mat(r.mat_G, 0, mIl, n0),
        )
        blocks = []
        for cb in self.children:
            i = cb.id
            ni, mEi, mIi = cb.n_vars(i), cb.n_eq(i), cb.n_ineq(i)
            blocks.append(dict(
                c=np.asarray(cb.vec_c(i), np.float64),
                A=mat(cb.mat_A, i, mEi, n0),
                B=sparse_mat(cb.mat_B, i, mEi, ni),
                b=np.asarray(cb.vec_b(i), np.float64),
                C=mat(cb.mat_C, i, mIi, n0),
                D=sparse_mat(cb.mat_D, i, mIi, ni),
                iclow=np.asarray(cb.vec_iclow(i), np.float64),
                clow=np.asarray(cb.vec_clow(i), np.float64),
                icupp=np.asarray(cb.vec_icupp(i), np.float64),
                cupp=np.asarray(cb.vec_cupp(i), np.float64),
                ixlow=np.asarray(cb.vec_ixlow(i), np.float64),
                xlow=np.asarray(cb.vec_xlow(i), np.float64),
                ixupp=np.asarray(cb.vec_ixupp(i), np.float64),
                xupp=np.asarray(cb.vec_xupp(i), np.float64),
                F=mat(cb.mat_F, i, mEl, ni),
                G=mat(cb.mat_G, i, mIl, ni),
            ))
        linking_eq = {"b": (np.asarray(self.vec_bl(), np.float64)
                            if self.vec_bl else np.zeros(mEl))}
        linking_ineq = {
            "iclow": (np.asarray(self.vec_idllow(), np.float64)
                      if self.vec_idllow else np.zeros(mIl)),
            "clow": (np.asarray(self.vec_dllow(), np.float64)
                     if self.vec_dllow else np.zeros(mIl)),
            "icupp": (np.asarray(self.vec_idlupp(), np.float64)
                      if self.vec_idlupp else np.zeros(mIl)),
            "cupp": (np.asarray(self.vec_dlupp(), np.float64)
                     if self.vec_dlupp else np.zeros(mIl)),
        }
        return make_sparse_arrowhead_lp(blocks, first, linking_eq,
                                        linking_ineq, dtype=dtype, K=K)
