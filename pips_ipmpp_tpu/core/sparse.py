"""Batched ELL sparse storage for the big per-block matrices.

The reference's leaf engine stores every block sparsely (CSR static +
dynamic, SparseStorage.C:1-2198) and factorizes it with a sparse direct
solver (PardisoSchurSolver.C:84-252).  Its direct analogue —
scalar-indexed supernodal elimination — does not batch; the device
representation here is a *static-shape batched ELL*:

    val [N, m, K]   per-row nonzero values, K = max row nnz (zero-padded)
    col [N, m, K]   column indices (padded entries point at column 0 with
                    val 0, so no masking is needed in products)

Matvecs become one `take_along_axis` gather plus a K-contraction — static
shapes, no scatter (the transpose is stored explicitly, built once on the
host), batched over blocks and over multiple right-hand sides.  Leaf
*solves* then go matrix-free (Jacobi-preconditioned CG on the SPD
condensed system) instead of through a factorization — see
linalg/sparse_backend.py.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, _register


@_register
@dataclass
class Ell:
    """Batched fixed-width sparse rows: [N, m, K] values + column ids."""
    val: jax.Array   # [N, m, K] floating
    col: jax.Array   # [N, m, K] int32, padded entries -> col 0 / val 0

    @property
    def N(self) -> int:
        return self.val.shape[0]

    @property
    def m(self) -> int:
        return self.val.shape[1]

    @property
    def K(self) -> int:
        return self.val.shape[2]

    def astype(self, dtype) -> "Ell":
        return Ell(self.val.astype(dtype), self.col)


def _ell_fill(rows, cols, vals, m, K, dtype):
    """Pack (row, col, val) triplets with rows sorted into [m, K] ELL."""
    val = np.zeros((m, K), dtype)
    col = np.zeros((m, K), np.int32)
    # slot index within each equal-row run (rows must be sorted)
    slot = np.arange(len(rows)) - np.searchsorted(rows, rows, side="left")
    val[rows, slot] = vals
    col[rows, slot] = cols
    return val, col


def ell_from_triplets(rows, cols, vals, m, n,
                      K: int | None = None) -> Ell:
    """Build ELL from per-batch triplet lists (host-side).

    `rows`/`cols`/`vals` are length-N lists of 1-D arrays (one per block).
    Duplicate (row, col) entries are COMBINED (summed) at construction —
    ell_sq_diag assumes column ids are unique within each row.  Column
    ids are validated against `n`."""
    N = len(rows)
    combined = []
    for i in range(N):
        r = np.asarray(rows[i], np.int64)
        c = np.asarray(cols[i], np.int64)
        v = np.asarray(vals[i], np.float64)
        if len(c) and (c.min() < 0 or c.max() >= n):
            raise ValueError(
                f"block {i}: column id out of range [0, {n})")
        if len(r) and (r.min() < 0 or r.max() >= m):
            raise ValueError(f"block {i}: row id out of range [0, {m})")
        key = r * n + c
        uk, inv = np.unique(key, return_inverse=True)
        sv = np.zeros(len(uk), v.dtype)
        np.add.at(sv, inv, v)
        combined.append((uk // n, uk % n, sv))
    if K is None:
        K = 1
        for r, _, _ in combined:
            if len(r):
                K = max(K, int(np.bincount(r, minlength=m).max()))
    val = np.zeros((N, m, K), np.float64)
    col = np.zeros((N, m, K), np.int32)
    for i, (r, c, v) in enumerate(combined):
        val[i], col[i] = _ell_fill(r, c, v, m, K, val.dtype)
    return Ell(jnp.asarray(val), jnp.asarray(col))


def ell_from_dense(M: np.ndarray, K: int | None = None) -> Ell:
    """Build ELL from a batched dense [N, m, n] matrix (host-side)."""
    M = np.asarray(M)
    N, m, n = M.shape
    if K is None:
        K = max(int((M != 0.0).sum(axis=2).max()), 1)
    val = np.zeros((N, m, K), M.dtype)
    col = np.zeros((N, m, K), np.int32)
    for i in range(N):
        r, c = np.nonzero(M[i])          # r already sorted (row-major)
        val[i], col[i] = _ell_fill(r, c, M[i][r, c], m, K, M.dtype)
    return Ell(jnp.asarray(val), jnp.asarray(col))


def ell_transpose(ell: Ell, n: int) -> Ell:
    """Explicit transpose ELL (host-side, once at build): rows of the
    transpose gather the same nonzeros by column.  Static sparsity means
    this replaces every scatter in transpose products with a gather."""
    val = np.asarray(ell.val)
    col = np.asarray(ell.col)
    N, m, K = val.shape
    ents = []
    Kt = 1
    for i in range(N):
        r, k = np.nonzero(val[i])
        c = col[i][r, k]
        order = np.argsort(c, kind="stable")
        ents.append((c[order], r[order], val[i][r, k][order]))
        if len(c):
            Kt = max(Kt, int(np.bincount(c, minlength=n).max()))
    tval = np.zeros((N, n, Kt), val.dtype)
    tcol = np.zeros((N, n, Kt), np.int32)
    for i, (c, r, v) in enumerate(ents):
        tval[i], tcol[i] = _ell_fill(c, r, v, n, Kt, val.dtype)
    return Ell(jnp.asarray(tval), jnp.asarray(tcol))


def ell_to_dense(ell: Ell, n: int) -> jax.Array:
    """Densify (tests / small problems only)."""
    N, m, K = ell.val.shape
    out = jnp.zeros((N, m, n), ell.val.dtype)
    rows = jnp.broadcast_to(jnp.arange(m)[None, :, None], (N, m, K))
    batch = jnp.broadcast_to(jnp.arange(N)[:, None, None], (N, m, K))
    return out.at[batch, rows, ell.col].add(ell.val)


# ----------------------------------------------------------------------
# Products (all static-shape; jit/vmap/shard_map safe)
# ----------------------------------------------------------------------

def ell_mv(ell: Ell, x: jax.Array) -> jax.Array:
    """y[i, r] = sum_k val[i,r,k] * x[i, col[i,r,k]];  x: [N, n] -> [N, m]."""
    N, m, K = ell.val.shape
    g = jnp.take_along_axis(x, ell.col.reshape(N, m * K), axis=1)
    return jnp.sum(ell.val * g.reshape(N, m, K), axis=2)


def ell_mv_multi(ell: Ell, X: jax.Array) -> jax.Array:
    """Multi-RHS matvec;  X: [N, n, c] -> [N, m, c]."""
    N, m, K = ell.val.shape
    c = X.shape[2]
    idx = jnp.broadcast_to(ell.col.reshape(N, m * K)[:, :, None],
                           (N, m * K, c))
    g = jnp.take_along_axis(X, idx, axis=1).reshape(N, m, K, c)
    return jnp.einsum("imk,imkc->imc", ell.val, g)


def ell_sq_diag(ell: Ell, w: jax.Array) -> jax.Array:
    """diag of (M W M') per row: sum_k val^2 * w[col];  w: [N, n] -> [N, m].

    Exact only when column ids are unique within each row (duplicate
    slots would need the 2*v1*v2*w cross terms); construction paths
    (ell_from_triplets, ell_from_dense, the synthetic generator) all
    guarantee uniqueness."""
    N, m, K = ell.val.shape
    g = jnp.take_along_axis(w, ell.col.reshape(N, m * K), axis=1)
    return jnp.sum(ell.val ** 2 * g.reshape(N, m, K), axis=2)


# ----------------------------------------------------------------------
# Sparse arrowhead LP
# ----------------------------------------------------------------------

@_register
@dataclass
class SparseArrowheadLP:
    """ArrowheadLP with the big diagonal blocks B [N,mE,n] / D [N,mI,n] in
    ELL form (forward + explicit transpose).  The borders to the small
    first stage (A, C: [N, m, n0]) and the thin linking strips
    (F, G: [N, ml, n]) stay dense — their minor dimension is the small
    root/link size, so dense is already the bandwidth-optimal layout.

    Mirrors reference DistributedProblem over SparseSymmetric/GenMatrix
    (DistributedProblem.hpp, SparseStorage.C); the dense twin is
    core/lp.py:ArrowheadLP."""

    # ---- first stage (block 0), replicated: same as ArrowheadLP ----
    c0: jax.Array
    A0: jax.Array
    b0: jax.Array
    C0: jax.Array
    iclow0: jax.Array
    clow0: jax.Array
    icupp0: jax.Array
    cupp0: jax.Array
    ixlow0: jax.Array
    xlow0: jax.Array
    ixupp0: jax.Array
    xupp0: jax.Array

    # ---- per-block ----
    cN: jax.Array        # [N, n]
    A: jax.Array         # [N, mE, n0] dense border
    B: Ell               # [N, mE, n] sparse diag
    Bt: Ell              # its transpose [N, n, mE]
    bN: jax.Array
    C: jax.Array         # [N, mI, n0] dense border
    D: Ell               # [N, mI, n] sparse diag
    Dt: Ell
    iclowN: jax.Array
    clowN: jax.Array
    icuppN: jax.Array
    cuppN: jax.Array
    ixlowN: jax.Array
    xlowN: jax.Array
    ixuppN: jax.Array
    xuppN: jax.Array

    # ---- linking rows ----
    F0: jax.Array
    F: jax.Array         # [N, mEl, n] dense strip
    bl: jax.Array
    G0: jax.Array
    G: jax.Array         # [N, mIl, n]
    iclowl: jax.Array
    clowl: jax.Array
    icuppl: jax.Array
    cuppl: jax.Array

    # ------------------------------------------------------------------
    @property
    def N(self) -> int:
        return self.cN.shape[0]

    @property
    def n0(self) -> int:
        return self.c0.shape[-1]

    @property
    def n(self) -> int:
        return self.cN.shape[1]

    @property
    def mE(self) -> int:
        return self.bN.shape[1]

    @property
    def mI(self) -> int:
        return self.iclowN.shape[1]

    @property
    def m0E(self) -> int:
        return self.b0.shape[0]

    @property
    def m0I(self) -> int:
        return self.iclow0.shape[0]

    @property
    def mEl(self) -> int:
        return self.bl.shape[0]

    @property
    def mIl(self) -> int:
        return self.iclowl.shape[0]

    def total_vars(self) -> int:
        return self.n0 + self.N * self.n

    def total_eq(self) -> int:
        return self.m0E + self.N * self.mE + self.mEl

    def total_ineq(self) -> int:
        return self.m0I + self.N * self.mI + self.mIl

    def astype(self, dtype) -> "SparseArrowheadLP":
        return jax.tree.map(
            lambda x: x if jnp.issubdtype(x.dtype, jnp.integer)
            else jnp.asarray(x, dtype), self)

    def datanorm(self) -> jax.Array:
        leaves = [self.c0, self.A0, self.b0, self.C0, self.cN, self.A,
                  self.B.val, self.bN, self.C, self.D.val, self.F0, self.F,
                  self.bl, self.G0, self.G,
                  self.clow0 * self.iclow0, self.cupp0 * self.icupp0,
                  self.xlow0 * self.ixlow0, self.xupp0 * self.ixupp0,
                  self.clowN * self.iclowN, self.cuppN * self.icuppN,
                  self.xlowN * self.ixlowN, self.xuppN * self.ixuppN,
                  self.clowl * self.iclowl, self.cuppl * self.icuppl]
        return jnp.max(jnp.stack(
            [jnp.max(jnp.abs(l)) if l.size else jnp.zeros((), l.dtype)
             for l in leaves]))


def make_sparse_arrowhead_lp(blocks: list, first_stage: dict,
                             linking_eq: dict | None = None,
                             linking_ineq: dict | None = None,
                             dtype=jnp.float64,
                             K: int | None = None) -> SparseArrowheadLP:
    """Build a SparseArrowheadLP from per-block dicts WITHOUT densifying
    the big diagonal blocks: `blocks[i]["B"]` / `["D"]` are
    `core.csr.CsrMatrix` (dense arrays also accepted and converted).
    Everything else follows `core.lp.make_arrowhead_lp` conventions —
    including exact-equivalence padding of heterogeneous blocks (padded
    eq rows are paired with padded variables: a unit CSR entry pins the
    padded var to 0 and keeps the condensed diagonal healthy).

    This is the intake path for reference-class sparse instances (energy
    LPs with 10^4+-row blocks at ~10 nnz/row, SparseStorage.C /
    PardisoSchurSolver.C:84) where a dense [N, m, n] layout cannot even
    be materialized.
    """
    from pips_ipmpp_tpu.core.csr import CsrMatrix
    from pips_ipmpp_tpu.core.lp import make_arrowhead_lp

    blocks = [dict(b) for b in blocks]
    n_max = max(len(b["c"]) for b in blocks)
    mE_max = max(np.asarray(b["b"]).shape[0] for b in blocks)
    mI_max = max(np.asarray(b["clow"]).shape[0] for b in blocks)

    def as_csr(M, shape):
        if isinstance(M, CsrMatrix):
            if M.shape != shape:
                raise ValueError(f"CSR block shape {M.shape} != {shape}")
            return M
        return CsrMatrix.from_dense(np.asarray(M))

    # pull the sparse diagonals out, pad them in triplet space, and hand
    # the rest (vectors, dense borders, strips) to the dense builder with
    # zero-placeholder diagonals
    trips_B, trips_D = [], []
    for b in blocks:
        n_old = len(b["c"])
        mE_old = np.asarray(b["b"]).shape[0]
        mI_old = np.asarray(b["clow"]).shape[0]
        Bc = as_csr(b["B"], (mE_old, n_old))
        Dc = as_csr(b["D"], (mI_old, n_old))
        r, c, v = Bc.to_triplets()
        # pin padded eq row j to padded var j (cf. lp._pad_block)
        npair = min(mE_max - mE_old, n_max - n_old)
        pr = np.arange(mE_old, mE_old + npair)
        pc = np.arange(n_old, n_old + npair)
        trips_B.append((np.concatenate([r, pr]), np.concatenate([c, pc]),
                        np.concatenate([v, np.ones(npair)])))
        trips_D.append(Dc.to_triplets())
        b["B"] = np.zeros((mE_old, n_old))
        b["D"] = np.zeros((mI_old, n_old))

    dense = make_arrowhead_lp(blocks, first_stage, linking_eq,
                              linking_ineq, dtype=dtype)
    B = ell_from_triplets([t[0] for t in trips_B], [t[1] for t in trips_B],
                          [t[2] for t in trips_B], mE_max, n_max, K)
    D = ell_from_triplets([t[0] for t in trips_D], [t[1] for t in trips_D],
                          [t[2] for t in trips_D], mI_max, n_max, K)
    B = B.astype(dtype)
    D = D.astype(dtype)
    sp = sparse_from_dense(dense, K=1)   # reuse field plumbing
    import dataclasses as _dc
    return _dc.replace(sp, B=B, Bt=ell_transpose(B, n_max),
                       D=D, Dt=ell_transpose(D, n_max))


def sparse_from_dense(lp: ArrowheadLP, K: int | None = None
                      ) -> SparseArrowheadLP:
    """Convert a (dense) ArrowheadLP whose B/D blocks are sparse in content
    into ELL storage (host-side; tests and small fixture ingestion)."""
    B = ell_from_dense(np.asarray(lp.B), K)
    D = ell_from_dense(np.asarray(lp.D), K)
    return SparseArrowheadLP(
        c0=lp.c0, A0=lp.A0, b0=lp.b0, C0=lp.C0,
        iclow0=lp.iclow0, clow0=lp.clow0, icupp0=lp.icupp0, cupp0=lp.cupp0,
        ixlow0=lp.ixlow0, xlow0=lp.xlow0, ixupp0=lp.ixupp0, xupp0=lp.xupp0,
        cN=lp.cN, A=lp.A, B=B, Bt=ell_transpose(B, lp.n), bN=lp.bN,
        C=lp.C, D=D, Dt=ell_transpose(D, lp.n),
        iclowN=lp.iclowN, clowN=lp.clowN, icuppN=lp.icuppN, cuppN=lp.cuppN,
        ixlowN=lp.ixlowN, xlowN=lp.xlowN, ixuppN=lp.ixuppN, xuppN=lp.xuppN,
        F0=lp.F0, F=lp.F, bl=lp.bl, G0=lp.G0, G=lp.G,
        iclowl=lp.iclowl, clowl=lp.clowl, icuppl=lp.icuppl, cuppl=lp.cuppl)


def dense_from_sparse(slp: SparseArrowheadLP) -> "ArrowheadLP":
    """Densify a SparseArrowheadLP back into the batched-dense ArrowheadLP.

    The sizing rule (SURVEY.md hard part #1: "decide empirically per
    block size"): at 10^3-row-class blocks a batched dense factorization
    replaces the CG leaf's gathers, so the facade densifies
    sparse problems whose dense twin fits the `sparse_densify_max_mb`
    budget and runs them on ArrowBackend; the ELL+CG leaf covers the
    sizes where densification cannot fit."""
    kw = {}
    for f in dataclasses.fields(ArrowheadLP):
        if f.name == "B":
            kw["B"] = ell_to_dense(slp.B, slp.n)
        elif f.name == "D":
            kw["D"] = ell_to_dense(slp.D, slp.n)
        else:
            kw[f.name] = getattr(slp, f.name)
    return ArrowheadLP(**kw)


def dense_bytes(slp: SparseArrowheadLP) -> int:
    """Bytes the densified B/D blocks would occupy (the densify budget)."""
    itemsize = jnp.dtype(slp.c0.dtype).itemsize
    return (slp.N * (slp.mE + slp.mI) * slp.n) * itemsize
