"""Automatic structure detection: nested-dissection reblocking of an
unstructured sparse LP onto the batched arrowhead path.

The reference's answer to large sparse per-block KKTs is a supernodal
sparse LDL^T inside PARDISO (PardisoSchurSolver.C:84-252 symbolic setup;
SparseStorage.C), and it REQUIRES the user to annotate block structure
up front (gmspips GAMS annotations, DistributedInputTree callbacks).
This module lifts the same idea — fill-reducing ordering +
separator elimination — from the factorization level to the PROBLEM
level: RCM-order the column-interaction graph, cut it into contiguous
chunks (the "supernodes"), promote high-traffic crossing columns to the
first stage (the "separator"), turn the residual crossing rows into
linking rows, and hand the result to the existing batched dense
machinery (ArrowBackend / hierarchical / bucketed).  Sub-block
factorizations then run as one batched dense Cholesky instead of
irregular scalar sparsity.

Bonus capability the reference does not have: `auto_structure` accepts
ANY flat LP (e.g. straight from the MPS reader) with no annotations and
discovers the block structure itself.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, DenseLP, make_arrowhead_lp

FIRST = -1
LINK = -2


@dataclasses.dataclass
class DissectMap:
    """Column/row placement of the dissected LP, for solution recovery.

    col_place[v] = (blk, j): original column v lives at block `blk`
    (FIRST = first stage) local index j.  eq_place/ineq_place likewise
    for rows ("link" blocks use LINK = -2 with the linking-row index).
    """
    n: int
    col_place: list
    eq_place: list
    ineq_place: list
    num_blocks: int

    def recover_x(self, x0: np.ndarray, xN: np.ndarray) -> np.ndarray:
        """Assemble the original flat x from first-stage + block parts."""
        x = np.zeros(self.n, dtype=np.asarray(x0).dtype)
        for v, (blk, j) in enumerate(self.col_place):
            x[v] = x0[j] if blk == FIRST else xN[blk][j]
        return x

    @staticmethod
    def _recover_rows(place, first, blocks, link) -> np.ndarray:
        out = np.zeros(len(place), dtype=np.float64)
        for r, (blk, i) in enumerate(place):
            if blk == FIRST:
                out[r] = first[i]
            elif blk == LINK:
                out[r] = link[i]
            else:
                out[r] = blocks[blk][i]
        return out

    def recover_eq_rows(self, first, blocks, link) -> np.ndarray:
        """Original-order eq-row vector from (first, [N][mE], link) parts
        (duals or residuals)."""
        return self._recover_rows(self.eq_place, first, blocks, link)

    def recover_ineq_rows(self, first, blocks, link) -> np.ndarray:
        return self._recover_rows(self.ineq_place, first, blocks, link)


def _column_chunks(K, n: int, num_blocks: int) -> np.ndarray:
    """RCM-order the column-interaction graph of pattern matrix K [m, n]
    and cut into `num_blocks` contiguous chunks.  Returns chunk id per
    original column."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    Kb = sp.csr_matrix(K, copy=False).astype(bool)
    G = (Kb.T @ Kb).tocsr()      # column graph (pattern of K'K)
    perm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
    chunk_of = np.empty(n, dtype=np.int64)
    # equal-size contiguous cuts of the RCM order
    bounds = np.linspace(0, n, num_blocks + 1).astype(np.int64)
    for b in range(num_blocks):
        chunk_of[perm[bounds[b]:bounds[b + 1]]] = b
    return chunk_of


def dissect(lp: DenseLP, num_blocks: int,
            promote_threshold: int = 2,
            max_first_frac: float = 0.25):
    """Discover an arrowhead structure in a flat LP.

    1. RCM the column graph, cut into `num_blocks` contiguous chunks.
    2. Rows whose columns span >1 chunk are CROSSING.  Columns that
       appear in >= `promote_threshold` crossing rows are promoted to the
       first stage (separator vertices, capped at `max_first_frac * n`).
    3. Remaining crossing rows become linking rows (F/G strips).

    Returns (ArrowheadLP, DissectMap).  Exact: the dissected problem is
    the original under a permutation; objective values coincide.
    """
    import scipy.sparse as sp

    cA = np.asarray(lp.c, np.float64)
    A = np.asarray(lp.A, np.float64)
    C = np.asarray(lp.C, np.float64)
    n = cA.size
    mE, mI = A.shape[0], C.shape[0]
    if num_blocks < 1:
        raise ValueError("num_blocks must be >= 1")

    K = sp.vstack([sp.csr_matrix(A), sp.csr_matrix(C)]).tocsr()
    chunk_of = _column_chunks(K, n, num_blocks)

    rows = [K.indices[K.indptr[r]:K.indptr[r + 1]] for r in range(mE + mI)]

    # ---- separator promotion ----
    def crossing_rows(first_mask):
        out = []
        for r, cols in enumerate(rows):
            local = cols[~first_mask[cols]]
            if local.size and np.unique(chunk_of[local]).size > 1:
                out.append(r)
        return out

    first_mask = np.zeros(n, dtype=bool)
    cross = crossing_rows(first_mask)
    if cross and promote_threshold > 0:
        counts = np.zeros(n, dtype=np.int64)
        for r in cross:
            counts[rows[r]] += 1
        cap = max(1, int(max_first_frac * n))
        cand = np.nonzero(counts >= promote_threshold)[0]
        if cand.size > cap:      # keep the busiest separator vertices
            cand = cand[np.argsort(-counts[cand])[:cap]]
        first_mask[cand] = True
        cross = crossing_rows(first_mask)
    cross_set = set(cross)

    # ---- placements ----
    first_cols = np.nonzero(first_mask)[0]
    f_idx = {int(v): i for i, v in enumerate(first_cols)}
    blk_cols = [np.nonzero(~first_mask & (chunk_of == b))[0]
                for b in range(num_blocks)]
    b_idx = [{int(v): i for i, v in enumerate(cols)} for cols in blk_cols]

    col_place = [None] * n
    for v in first_cols:
        col_place[v] = (FIRST, f_idx[int(v)])
    for b, cols in enumerate(blk_cols):
        for v in cols:
            col_place[v] = (b, b_idx[b][int(v)])

    def row_home(r):
        """Owning block of a non-crossing row (rows with only first-stage
        columns live in the first stage)."""
        local = rows[r][~first_mask[rows[r]]]
        return int(chunk_of[local[0]]) if local.size else FIRST

    n0 = first_cols.size
    iclow = np.asarray(lp.iclow, np.float64)
    clow = np.asarray(lp.clow, np.float64)
    icupp = np.asarray(lp.icupp, np.float64)
    cupp = np.asarray(lp.cupp, np.float64)

    eq_rows_of = [[] for _ in range(num_blocks)]
    iq_rows_of = [[] for _ in range(num_blocks)]
    eq0, iq0, eql, iql = [], [], [], []
    for r in range(mE):
        if r in cross_set:
            eql.append(r)
        else:
            h = row_home(r)
            (eq0 if h == FIRST else eq_rows_of[h]).append(r)
    for r0 in range(mI):
        r = mE + r0
        if r in cross_set:
            iql.append(r0)
        else:
            h = row_home(r)
            (iq0 if h == FIRST else iq_rows_of[h]).append(r0)

    eq_place = [None] * mE
    ineq_place = [None] * mI
    for i, r in enumerate(eq0):
        eq_place[r] = (FIRST, i)
    for i, r in enumerate(eql):
        eq_place[r] = (LINK, i)
    for i, r in enumerate(iq0):
        ineq_place[r] = (FIRST, i)
    for i, r in enumerate(iql):
        ineq_place[r] = (LINK, i)

    ixlow = np.asarray(lp.ixlow, np.float64)
    xlow = np.asarray(lp.xlow, np.float64)
    ixupp = np.asarray(lp.ixupp, np.float64)
    xupp = np.asarray(lp.xupp, np.float64)
    b_rhs = np.asarray(lp.b, np.float64)

    mEl, mIl = len(eql), len(iql)
    blocks = []
    for bI in range(num_blocks):
        cols = blk_cols[bI]
        nb = cols.size
        er, ir = eq_rows_of[bI], iq_rows_of[bI]
        for i, r in enumerate(er):
            eq_place[r] = (bI, i)
        for i, r in enumerate(ir):
            ineq_place[r] = (bI, i)
        blocks.append(dict(
            c=cA[cols],
            A=A[np.ix_(er, first_cols)] if er else np.zeros((0, n0)),
            B=A[np.ix_(er, cols)] if er else np.zeros((0, nb)),
            b=b_rhs[er],
            C=C[np.ix_(ir, first_cols)] if ir else np.zeros((0, n0)),
            D=C[np.ix_(ir, cols)] if ir else np.zeros((0, nb)),
            iclow=iclow[ir], clow=clow[ir],
            icupp=icupp[ir], cupp=cupp[ir],
            ixlow=ixlow[cols], xlow=xlow[cols],
            ixupp=ixupp[cols], xupp=xupp[cols],
            F=A[np.ix_(eql, cols)] if mEl else np.zeros((0, nb)),
            G=C[np.ix_(iql, cols)] if mIl else np.zeros((0, nb)),
        ))

    first_stage = dict(
        c=cA[first_cols],
        A=A[np.ix_(eq0, first_cols)] if eq0 else np.zeros((0, n0)),
        b=b_rhs[eq0],
        C=C[np.ix_(iq0, first_cols)] if iq0 else np.zeros((0, n0)),
        iclow=iclow[iq0], clow=clow[iq0],
        icupp=icupp[iq0], cupp=cupp[iq0],
        ixlow=ixlow[first_cols], xlow=xlow[first_cols],
        ixupp=ixupp[first_cols], xupp=xupp[first_cols],
        F0=A[np.ix_(eql, first_cols)] if mEl else np.zeros((0, n0)),
        G0=C[np.ix_(iql, first_cols)] if mIl else np.zeros((0, n0)),
    )
    linking_eq = {"b": b_rhs[eql]}
    linking_ineq = {"iclow": iclow[iql], "clow": clow[iql],
                    "icupp": icupp[iql], "cupp": cupp[iql]}

    dmap = DissectMap(n=n, col_place=col_place, eq_place=eq_place,
                      ineq_place=ineq_place, num_blocks=num_blocks)
    return blocks, first_stage, linking_eq, linking_ineq, dmap


def auto_structure(lp: DenseLP, num_blocks: int, dtype=None,
                   promote_threshold: int = 2,
                   max_first_frac: float = 0.25,
                   ) -> tuple[ArrowheadLP, DissectMap]:
    """DenseLP -> (ArrowheadLP, DissectMap): discover block structure and
    build the batched arrowhead problem (exact reformulation)."""
    import jax.numpy as jnp
    blocks, first, leq, liq, dmap = dissect(
        lp, num_blocks, promote_threshold=promote_threshold,
        max_first_frac=max_first_frac)
    alp = make_arrowhead_lp(blocks, first, leq, liq,
                            dtype=dtype or jnp.float64)
    return alp, dmap


def structure_report(dmap: DissectMap, alp: ArrowheadLP) -> dict:
    """Sizing summary of a dissection (for logs/CLI)."""
    return dict(num_blocks=alp.N, block_vars=alp.n,
                block_eq=alp.mE, block_ineq=alp.mI,
                first_vars=alp.n0, linking_eq=alp.mEl,
                linking_ineq=alp.mIl,
                dense_kkt_entries=int(dmap.n) ** 2,
                arrow_leaf_entries=int(alp.N) * int(alp.mE + alp.mI) ** 2)


# ======================================================================
# Oversized-block refinement: split huge sparse blocks of an ANNOTATED
# arrowhead problem into sub-blocks (the per-block analog of the
# reference's supernodal leaf factorization: PARDISO eliminates a big
# sparse block via nested-dissection fronts INSIDE the factorization,
# PardisoSchurSolver.C:84-252; here the dissection happens once at
# intake and the sub-blocks run on the batched dense path).
# ======================================================================

def _greedy_split(K_pattern, n_local, sub_target):
    """Chunk local columns; greedily promote columns until no LOCAL row
    crosses chunks.  Returns (chunk_of, promoted_mask)."""
    import scipy.sparse as sp

    k = max(2, int(np.ceil(n_local / max(1, sub_target))))
    K = sp.csr_matrix(K_pattern)
    chunk_of = _column_chunks(K, n_local, k)
    rows = [K.indices[K.indptr[r]:K.indptr[r + 1]]
            for r in range(K.shape[0])]
    promoted = np.zeros(n_local, dtype=bool)
    for _ in range(n_local):   # bounded; each round promotes >= 1 column
        counts = np.zeros(n_local, dtype=np.int64)
        n_cross = 0
        for cols in rows:
            local = cols[~promoted[cols]]
            if local.size and np.unique(chunk_of[local]).size > 1:
                counts[local] += 1
                n_cross += 1
        if n_cross == 0:
            break
        # bulk round first (cover columns shared by many crossing rows),
        # then single best
        cand = np.nonzero(counts >= 2)[0]
        if cand.size == 0:
            cand = np.array([int(np.argmax(counts))])
        promoted[cand] = True
    return chunk_of, promoted


def refine_blocks(blocks: list, first_stage: dict,
                  max_block_vars: int, sub_target: Optional[int] = None):
    """Split every block with more than `max_block_vars` variables into
    sub-blocks of ~`sub_target` variables; separator columns are promoted
    into the (enlarged) first stage, rows that lose all local columns
    become first-stage rows.  Input/output are the `make_arrowhead_lp`
    block/first-stage dicts, so the result feeds the uniform batched
    path, the bucketed heterogeneous path, or the hierarchical transform
    unchanged.  Returns (new_blocks, new_first_stage, placement) with
    placement[i] = list of (new_block_index or FIRST, local index) per
    ORIGINAL block-i variable.
    """
    sub_target = sub_target or max_block_vars
    n0 = len(first_stage["c"])
    mEl = np.asarray(first_stage.get("F0", np.zeros((0, n0)))).shape[0]
    mIl = np.asarray(first_stage.get("G0", np.zeros((0, n0)))).shape[0]

    # pass 1: per-block split decisions + promoted columns
    plans = []
    total_promoted = 0
    for blk in blocks:
        nb = len(blk["c"])
        if nb <= max_block_vars:
            plans.append(None)
            continue
        B = np.asarray(blk["B"], np.float64)
        D = np.asarray(blk["D"], np.float64)
        F = np.asarray(blk.get("F", np.zeros((mEl, nb))), np.float64)
        G = np.asarray(blk.get("G", np.zeros((mIl, nb))), np.float64)
        # locality is decided by the LOCAL rows only (F/G rows are
        # already linking rows and may touch any sub-block)
        K = np.vstack([B, D]) if B.size + D.size else np.zeros((0, nb))
        chunk_of, promoted = _greedy_split(K, nb, sub_target)
        plans.append((chunk_of, promoted, B, D, F, G))
        total_promoted += int(promoted.sum())

    if all(p is None for p in plans):
        return list(blocks), dict(first_stage), \
            [[(i, j) for j in range(len(b["c"]))]
             for i, b in enumerate(blocks)]

    n0_new = n0 + total_promoted
    f = lambda a: np.asarray(a, np.float64)

    # promoted-column offsets per original block (within the new x0 tail)
    offs, off = [], n0
    for p in plans:
        offs.append(off)
        if p is not None:
            off += int(p[1].sum())

    new_blocks = []
    placement = []
    fs_extra_eq = []    # (row_x0_new, rhs) relocated first-stage eq rows
    fs_extra_iq = []    # (row_x0_new, il, lo, iu, up)
    F0_extra = np.zeros((mEl, total_promoted))
    G0_extra = np.zeros((mIl, total_promoted))
    c0_extra = np.zeros(total_promoted)
    bnd_extra = {k: np.zeros(total_promoted)
                 for k in ("ixlow", "xlow", "ixupp", "xupp")}

    def widen(mat, nrows):
        """[m, n0] -> [m, n0_new] zero-extended."""
        m = f(mat) if np.size(mat) else np.zeros((nrows, n0))
        out = np.zeros((m.shape[0], n0_new))
        out[:, :n0] = m
        return out

    for bi, (blk, plan) in enumerate(zip(blocks, plans)):
        nb = len(blk["c"])
        if plan is None:
            nb_blk = dict(blk)
            nb_blk["A"] = widen(blk["A"], len(blk["b"]))
            nb_blk["C"] = widen(blk["C"], len(blk["clow"]))
            placement.append([(len(new_blocks), j) for j in range(nb)])
            new_blocks.append(nb_blk)
            continue

        chunk_of, promoted, B, D, F, G = plan
        A = widen(blk["A"], B.shape[0])
        C = widen(blk["C"], D.shape[0])
        po = offs[bi] - n0          # offset into the promoted tail
        pcols = np.nonzero(promoted)[0]
        pidx = {int(v): n0 + po + i for i, v in enumerate(pcols)}

        # promoted columns join the first stage
        c0_extra[po:po + pcols.size] = f(blk["c"])[pcols]
        for k in bnd_extra:
            bnd_extra[k][po:po + pcols.size] = f(blk[k])[pcols]
        if mEl:
            F0_extra[:, po:po + pcols.size] = F[:, pcols]
        if mIl:
            G0_extra[:, po:po + pcols.size] = G[:, pcols]
        # fold promoted-column coefficients of local rows into the border
        A[:, n0 + po:n0 + po + pcols.size] = B[:, pcols]
        C[:, n0 + po:n0 + po + pcols.size] = D[:, pcols]

        place = [None] * nb
        for v in pcols:
            place[int(v)] = (FIRST, pidx[int(v)])

        k = int(chunk_of.max()) + 1
        sub_cols = [np.nonzero(~promoted & (chunk_of == s))[0]
                    for s in range(k)]
        # drop empty chunks (everything promoted)
        sub_cols = [sc for sc in sub_cols if sc.size]

        # assign local rows to the sub-block of their remaining columns
        def owner(rowv):
            loc = np.nonzero(rowv)[0]
            loc = loc[~promoted[loc]]
            if loc.size == 0:
                return FIRST
            return int(chunk_of[loc[0]])

        chunk_index = {}
        for i, sc in enumerate(sub_cols):
            chunk_index[int(chunk_of[sc[0]])] = i

        eq_of = [[] for _ in sub_cols]
        iq_of = [[] for _ in sub_cols]
        bN = f(blk["b"])
        il, lo = f(blk["iclow"]), f(blk["clow"])
        iu, up = f(blk["icupp"]), f(blk["cupp"])
        for r in range(B.shape[0]):
            h = owner(B[r])
            if h == FIRST:
                fs_extra_eq.append((A[r], float(bN[r])))
            else:
                eq_of[chunk_index[h]].append(r)
        for r in range(D.shape[0]):
            h = owner(D[r])
            if h == FIRST:
                fs_extra_iq.append((C[r], float(il[r]), float(lo[r]),
                                    float(iu[r]), float(up[r])))
            else:
                iq_of[chunk_index[h]].append(r)

        for si, sc in enumerate(sub_cols):
            er, ir = eq_of[si], iq_of[si]
            nbi = len(new_blocks)
            for i, v in enumerate(sc):
                place[int(v)] = (nbi, i)
            new_blocks.append(dict(
                c=f(blk["c"])[sc],
                A=A[er][:, :] if er else np.zeros((0, n0_new)),
                B=B[np.ix_(er, sc)] if er else np.zeros((0, sc.size)),
                b=bN[er],
                C=C[ir][:, :] if ir else np.zeros((0, n0_new)),
                D=D[np.ix_(ir, sc)] if ir else np.zeros((0, sc.size)),
                iclow=il[ir], clow=lo[ir], icupp=iu[ir], cupp=up[ir],
                ixlow=f(blk["ixlow"])[sc], xlow=f(blk["xlow"])[sc],
                ixupp=f(blk["ixupp"])[sc], xupp=f(blk["xupp"])[sc],
                F=F[:, sc] if mEl else np.zeros((0, sc.size)),
                G=G[:, sc] if mIl else np.zeros((0, sc.size)),
            ))
        placement.append(place)

    # ---- enlarged first stage ----
    fs = dict(first_stage)
    A0 = widen(fs["A"], len(fs["b"]))
    C0 = widen(fs["C"], len(fs["clow"]))
    b0 = f(fs["b"])
    if fs_extra_eq:
        A0 = np.vstack([A0] + [r for r, _ in fs_extra_eq])
        b0 = np.concatenate([b0, [v for _, v in fs_extra_eq]])
    il0, lo0 = f(fs["iclow"]), f(fs["clow"])
    iu0, up0 = f(fs["icupp"]), f(fs["cupp"])
    if fs_extra_iq:
        C0 = np.vstack([C0] + [r for r, *_ in fs_extra_iq])
        il0 = np.concatenate([il0, [v[1] for v in fs_extra_iq]])
        lo0 = np.concatenate([lo0, [v[2] for v in fs_extra_iq]])
        iu0 = np.concatenate([iu0, [v[3] for v in fs_extra_iq]])
        up0 = np.concatenate([up0, [v[4] for v in fs_extra_iq]])
    fs.update(
        c=np.concatenate([f(fs["c"]), c0_extra]),
        A=A0, b=b0, C=C0,
        iclow=il0, clow=lo0, icupp=iu0, cupp=up0,
        ixlow=np.concatenate([f(fs["ixlow"]), bnd_extra["ixlow"]]),
        xlow=np.concatenate([f(fs["xlow"]), bnd_extra["xlow"]]),
        ixupp=np.concatenate([f(fs["ixupp"]), bnd_extra["ixupp"]]),
        xupp=np.concatenate([f(fs["xupp"]), bnd_extra["xupp"]]),
        F0=np.hstack([widen(fs.get("F0", np.zeros((mEl, n0))), mEl)[:, :n0],
                      F0_extra]) if mEl else np.zeros((0, n0_new)),
        G0=np.hstack([widen(fs.get("G0", np.zeros((mIl, n0))), mIl)[:, :n0],
                      G0_extra]) if mIl else np.zeros((0, n0_new)),
    )
    return new_blocks, fs, placement
