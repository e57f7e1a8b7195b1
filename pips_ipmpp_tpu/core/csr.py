"""Host-side CSR sparse storage: static + dynamic row-capacity variants.

The counterpart of the reference's sparse linear algebra layer
(SparseStorage.C:1-2198 static CSR; SparseStorageDynamic.C dynamic
row-capacity CSR used by presolve; SparseMatrix.C wrappers).  Role split:

  * device math stays in the batched formats (dense padded blocks,
    batched ELL for genuinely sparse blocks — core/sparse.py): compiled
    device programs want static shapes, not per-row indirection;
  * everything OUTSIDE the jitted hot path — intake, readers, presolve,
    scalers' statistics, fixture generation — manipulates CSR on the host,
    exactly where the reference uses SparseStorage(Dynamic).

`CsrMatrix` is immutable-shape (nnz fixed); `DynamicCsr` keeps per-row
spare capacity so presolve-style entry removal/insertion is O(row) without
reallocating, mirroring SparseStorageDynamic's row-fragment design.
`to_ell()` bridges to the device format.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CsrMatrix:
    """Static CSR (the reference's SparseStorage, SparseStorage.C)."""
    indptr: np.ndarray    # [m+1] int64
    indices: np.ndarray   # [nnz] int32 column ids, sorted within each row
    data: np.ndarray      # [nnz] float64
    shape: tuple          # (m, n)

    # ---- constructors -------------------------------------------------
    @staticmethod
    def from_triplets(rows, cols, vals, shape) -> "CsrMatrix":
        """Build from (row, col, val) triplets; duplicates are SUMMED
        (the reference combines duplicates at assembly too)."""
        m, n = shape
        r = np.asarray(rows, np.int64)
        c = np.asarray(cols, np.int64)
        v = np.asarray(vals, np.float64)
        if r.size and (r.min() < 0 or r.max() >= m):
            raise ValueError(f"row id out of range [0, {m})")
        if c.size and (c.min() < 0 or c.max() >= n):
            raise ValueError(f"column id out of range [0, {n})")
        key = r * n + c
        uk, inv = np.unique(key, return_inverse=True)
        sv = np.zeros(len(uk), np.float64)
        np.add.at(sv, inv, v)
        ur = (uk // n).astype(np.int64)
        uc = (uk % n).astype(np.int32)
        indptr = np.zeros(m + 1, np.int64)
        np.add.at(indptr, ur + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CsrMatrix(indptr, uc, sv, (m, n))

    @staticmethod
    def from_dense(M) -> "CsrMatrix":
        M = np.asarray(M, np.float64)
        m, n = M.shape
        r, c = np.nonzero(M)
        return CsrMatrix.from_triplets(r, c, M[r, c], (m, n))

    @staticmethod
    def from_fortran(krow, jcol, vals, shape) -> "CsrMatrix":
        """From 1-based CSR arrays (the reference converts PARDISO/HSL
        Fortran indexing with shiftRows_*, SparseStorage.C)."""
        indptr = np.asarray(krow, np.int64) - 1
        indices = np.asarray(jcol, np.int32) - 1
        data = np.asarray(vals, np.float64).copy()
        return CsrMatrix(indptr, indices, data, tuple(shape))

    # ---- exporters ----------------------------------------------------
    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n))
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out

    def to_fortran(self):
        """(krow, jcol, vals) with 1-based indexing."""
        return (self.indptr + 1, self.indices.astype(np.int64) + 1,
                self.data.copy())

    def to_triplets(self):
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        return rows, self.indices.copy(), self.data.copy()

    def to_ell(self, K: int | None = None):
        """Bridge to the batched device format: single-block ELL arrays
        (val [m, K], col [m, K]); callers stack across blocks."""
        m, n = self.shape
        cnt = np.diff(self.indptr)
        Kr = max(int(cnt.max()) if m else 1, 1)
        if K is None:
            K = Kr
        elif K < Kr:
            raise ValueError(f"K={K} < max row nnz {Kr}")
        val = np.zeros((m, K))
        col = np.zeros((m, K), np.int32)
        rows = np.repeat(np.arange(m), cnt)
        slot = np.arange(self.data.size) - self.indptr[rows]
        val[rows, slot] = self.data
        col[rows, slot] = self.indices
        return val, col

    # ---- properties ----------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    # ---- products (reference SparseStorage::mult/transMult) ------------
    def matvec(self, x) -> np.ndarray:
        m, _ = self.shape
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        prod = self.data * np.asarray(x)[self.indices]
        return np.bincount(rows, weights=prod, minlength=m)

    def trans_matvec(self, y) -> np.ndarray:
        m, n = self.shape
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out = np.zeros(n)
        np.add.at(out, self.indices, self.data * np.asarray(y)[rows])
        return out

    def transpose(self) -> "CsrMatrix":
        """Explicit transpose (the reference caches it per matrix for
        transMult, SparseMatrix.C)."""
        rows, cols, vals = self.to_triplets()
        return CsrMatrix.from_triplets(cols, rows, vals,
                                       (self.shape[1], self.shape[0]))

    # ---- scaling / diagonal (scaler + presolve support ops) -------------
    def scale_rows(self, s) -> None:
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        self.data *= np.asarray(s)[rows]

    def scale_cols(self, s) -> None:
        self.data *= np.asarray(s)[self.indices]

    def get_diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape))
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        on = rows == self.indices   # implies rows < min(m, n)
        d[rows[on]] = self.data[on]
        return d

    def row_abs_max(self) -> np.ndarray:
        out = np.zeros(self.shape[0])
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        np.maximum.at(out, rows, np.abs(self.data))
        return out

    def col_abs_max(self) -> np.ndarray:
        out = np.zeros(self.shape[1])
        np.maximum.at(out, self.indices, np.abs(self.data))
        return out


class DynamicCsr:
    """Dynamic row-capacity CSR (the reference's SparseStorageDynamic):
    rows own slack capacity so presolve can delete/insert entries in
    O(row nnz) without rebuilding the matrix; `compress()` emits a static
    CsrMatrix when mutation is done."""

    GROW = 2.0          # row capacity growth factor on overflow
    SPARE = 4           # initial spare slots per row

    def __init__(self, csr: CsrMatrix, spare: int | None = None):
        m, n = csr.shape
        spare = self.SPARE if spare is None else spare
        cnt = csr.row_nnz()
        cap = cnt + spare
        start = np.zeros(m + 1, np.int64)
        np.cumsum(cap, out=start[1:])
        total = int(start[-1])
        self.shape = (m, n)
        self.start = start          # [m+1] row storage offsets
        self.len = cnt.astype(np.int64)   # live entries per row
        self.col = np.full(total, -1, np.int32)
        self.val = np.zeros(total)
        rows = np.repeat(np.arange(m), cnt)
        slot = np.arange(csr.nnz) - csr.indptr[rows]
        self.col[start[rows] + slot] = csr.indices
        self.val[start[rows] + slot] = csr.data

    # ---- row access ----------------------------------------------------
    def row(self, r: int):
        s, l = self.start[r], self.len[r]
        return self.col[s:s + l], self.val[s:s + l]

    def row_nnz(self, r: int) -> int:
        return int(self.len[r])

    def get(self, r: int, c: int) -> float:
        cols, vals = self.row(r)
        hit = np.nonzero(cols == c)[0]
        return float(vals[hit[0]]) if hit.size else 0.0

    # ---- mutation (the presolve primitives) ------------------------------
    def remove_entry(self, r: int, c: int) -> float:
        """Delete (r, c); returns the removed value (0.0 if absent).
        Back-fills with the row's last entry — O(1), order not kept
        (the reference's removeEntryAtIndex does the same swap-delete)."""
        s, l = self.start[r], int(self.len[r])
        cols = self.col[s:s + l]
        hit = np.nonzero(cols == c)[0]
        if not hit.size:
            return 0.0
        i = int(hit[0])
        v = float(self.val[s + i])
        last = l - 1
        self.col[s + i] = self.col[s + last]
        self.val[s + i] = self.val[s + last]
        self.col[s + last] = -1
        self.val[s + last] = 0.0
        self.len[r] = last
        return v

    def set_entry(self, r: int, c: int, v: float) -> None:
        """Insert or overwrite (r, c) = v; grows the row via a realloc of
        the row's storage when capacity is exhausted."""
        s, l = self.start[r], int(self.len[r])
        cols = self.col[s:s + l]
        hit = np.nonzero(cols == c)[0]
        if hit.size:
            self.val[s + int(hit[0])] = v
            return
        cap = int(self.start[r + 1] - s)
        if l == cap:
            self._grow_row(r)
            s = self.start[r]
        self.col[s + l] = c
        self.val[s + l] = v
        self.len[r] = l + 1

    def clear_row(self, r: int) -> None:
        s, l = self.start[r], int(self.len[r])
        self.col[s:s + l] = -1
        self.val[s:s + l] = 0.0
        self.len[r] = 0

    def _grow_row(self, r: int) -> None:
        """Reallocate storage with extra capacity for row r (amortized;
        the reference doubles row fragments the same way)."""
        m = self.shape[0]
        old_cap = np.diff(self.start)
        new_cap = old_cap.copy()
        new_cap[r] = max(int(old_cap[r] * self.GROW), old_cap[r] + self.SPARE)
        nstart = np.zeros(m + 1, np.int64)
        np.cumsum(new_cap, out=nstart[1:])
        ncol = np.full(int(nstart[-1]), -1, np.int32)
        nval = np.zeros(int(nstart[-1]))
        for i in range(m):
            s, ns, l = self.start[i], nstart[i], int(self.len[i])
            ncol[ns:ns + l] = self.col[s:s + l]
            nval[ns:ns + l] = self.val[s:s + l]
        self.start, self.col, self.val = nstart, ncol, nval

    # ---- export ----------------------------------------------------------
    def compress(self) -> CsrMatrix:
        """Drop slack and emit static CSR with sorted row entries."""
        m, n = self.shape
        rows = np.repeat(np.arange(m), self.len)
        idx = np.concatenate([
            np.arange(self.start[r], self.start[r] + self.len[r])
            for r in range(m)]) if m else np.zeros(0, np.int64)
        return CsrMatrix.from_triplets(rows, self.col[idx], self.val[idx],
                                       (m, n))

    def to_dense(self) -> np.ndarray:
        return self.compress().to_dense()

    @property
    def nnz(self) -> int:
        return int(self.len.sum())
