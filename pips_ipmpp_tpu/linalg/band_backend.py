r"""Banded (block-tridiagonal) leaf factorization: the structure-exploiting
direct solver for blocks whose condensed normal equations are sparse.

The reference factors each block's sparse augmented KKT with a multifrontal
sparse LDL^T (PardisoSchurSolver.C:84-252, symbolic analysis in
`firstSolveCall`, numeric factor + Schur per iteration).  A literal sparse
supernodal factorization batches poorly (dynamic gather/scatter, tiny
irregular fronts).  The equivalent implemented here keeps
the same separation:

  symbolic (host, once):  the sparsity pattern of Neq_i = M_i E^{-1} M_i'
      is the row-connectivity graph of M_i = [B_i; D_i] (rows adjacent iff
      they share a variable).  A reverse-Cuthill-McKee ordering per block
      bounds its profile; the max half-bandwidth h over blocks is rounded
      up to a panel size b.  (The role of PARDISO's fill-reducing METIS
      ordering.)
  numeric (device, per IPM iteration):  with bandwidth <= b the permuted
      Neq is *block tridiagonal* in [N, nb, b, b] panels.  One lax.scan of
      length nb runs the batched block-Cholesky recurrence

          G_k G_k' = A_kk - C_{k-1} C_{k-1}',    C_k = A_{k+1,k} G_k^{-T}

      entirely out of [N, b, b] batched matmuls (all N blocks at once), storing
      the per-panel inverses G_k^{-1} so every subsequent solve is a scan
      of batched matmuls — no triangular sweeps over the full dimension.

Memory: O(N a b) for the factors instead of O(N a^2) for the dense
explicit inverse; forming the band costs O(nb b^2 n) instead of O(a^2 n).
For a 10^4-row block at bandwidth 256 that is a ~20x reduction — the
regime (power-grid / time-coupled dispatch rows with local support) where
the reference's sparse solver operates and a dense [a, a] factor cannot.

The backend plugs into ArrowBackend via the two leaf hooks
(`_leaf_factor` / `_apply_Ninv_multi`); condensation, borders, Schur
assembly, root, refinement, and the IPM above are all unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend, _bchol_solve


@dataclass(frozen=True)
class BandPlan:
    """Host-side symbolic analysis result (static under jit)."""
    perm: np.ndarray       # [N, a] original row index in permuted position
    iperm: np.ndarray      # [N, a] permuted position of original row
    half_bandwidth: int    # max over blocks, in the permuted order
    panel: int             # block-tridiagonal panel size b (>= half_bw)
    n_panels: int          # nb; nb * b >= a - n_dense
    n_dense: int = 0       # trailing peeled dense rows (Schur-handled)


def plan_banded(lp: ArrowheadLP, panel: Optional[int] = None,
                min_panel: int = 8, shared: bool = False,
                max_dense_frac: float = 0.1) -> BandPlan:
    """Symbolic analysis: RCM-order each block's row-connectivity graph.

    `lp` must be concrete (host numpy); the returned plan is baked into
    the backend as static data, like PARDISO's reusable symbolic
    factorization (firstSolveCall, PardisoSchurSolver.C:84).

    Rows with near-global support (cost/budget rows) would inflate the
    bandwidth to O(a); they are PEELED into a trailing dense block
    (capped at `max_dense_frac` of the rows, classified by connectivity
    degree) and handled by a small Schur complement at solve time — the
    dense-row treatment of multifrontal sparse codes.

    `shared=True` computes ONE ordering from the union pattern of all
    blocks (perm/iperm are 1-D [a]).  Use it when blocks share the model
    structure (multi-scenario instances) and for the distributed path:
    inside shard_map each device holds a block shard and a per-block
    permutation table cannot be closed over, but a block-independent one
    can."""
    from scipy import sparse
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    B = np.asarray(lp.B)
    D = np.asarray(lp.D)
    N = B.shape[0]
    a = B.shape[1] + D.shape[1]
    max_dense = int(max_dense_frac * a)

    def graph_of(pattern):
        M = sparse.csr_matrix(pattern.astype(np.int8))
        return (M @ M.T).tocsr()

    def dense_rows_of(S):
        """Peel rows whose connectivity degree dwarfs the median."""
        if not max_dense:
            return np.zeros(0, np.int64)
        deg = np.diff(S.indptr)
        med = max(np.median(deg), 1.0)
        cand = np.nonzero(deg > max(32, 8 * med))[0]
        if cand.size > max_dense:
            cand = cand[np.argsort(deg[cand])[::-1][:max_dense]]
        return np.sort(cand)

    def rcm_of(S, keep):
        """RCM over the kept subgraph; returns (perm over keep, h)."""
        Ssub = S[keep][:, keep].tocsr()
        p = np.asarray(reverse_cuthill_mckee(Ssub, symmetric_mode=True),
                       np.int32)
        m = keep.size
        pos = np.empty(m, np.int64)
        pos[p] = np.arange(m)
        coo = Ssub.tocoo()
        h = int(np.max(np.abs(pos[coo.row] - pos[coo.col]))) if coo.nnz \
            else 1
        return keep[p].astype(np.int32), max(h, 1)

    def analyze(pattern):
        S = graph_of(pattern)
        dense = dense_rows_of(S)
        keep = np.setdiff1d(np.arange(a), dense)
        band_perm, h = rcm_of(S, keep)
        return band_perm, dense.astype(np.int32), h

    if shared:
        union = (np.abs(B) > 0).any(axis=0)
        union = np.concatenate([union, (np.abs(D) > 0).any(axis=0)], axis=0)
        bp, dn, h = analyze(union)
        k = dn.size
        perms = np.concatenate([bp, dn])
        iperms = np.argsort(perms).astype(np.int32)
    else:
        results = [analyze(np.concatenate([B[i], D[i]], axis=0) != 0.0)
                   for i in range(N)]
        k = max(r[1].size for r in results)
        h = max(r[2] for r in results)
        perms = np.empty((N, a), np.int32)
        for i, (bp, dn, _h) in enumerate(results):
            pad = k - dn.size
            # pad the dense set from the TAIL of the band ordering (any
            # rows are correct there; trailing band rows are cheapest)
            perms[i] = np.concatenate([bp[:bp.size - pad], dn,
                                       bp[bp.size - pad:]])
        iperms = np.argsort(perms, axis=1).astype(np.int32)
    ab = a - k
    if panel is None:
        panel = max(min_panel, -(-h // min_panel) * min_panel)
        panel = min(panel, max(ab, min_panel))
    elif panel < h:
        raise ValueError(f"panel {panel} < half-bandwidth {h}")
    n_panels = max(-(-ab // panel), 1) if ab else 1
    return BandPlan(perm=perms, iperm=iperms, half_bandwidth=h,
                    panel=panel, n_panels=n_panels, n_dense=k)


def _bmm(x, y, tb=False):
    dn = (((2,), (2 if tb else 1,)), ((0,), (0,)))
    return jax.lax.dot_general(x, y, dimension_numbers=dn,
                               preferred_element_type=x.dtype)


def block_tridiag_factor(Adiag, Asub):
    """Batched block-tridiagonal Cholesky with explicit panel inverses.

    Adiag [nb, N, b, b] diagonal panels, Asub [nb, N, b, b] with Asub[k] =
    A_{k+1,k} (the last entry ignored).  Returns (Ginv, C, ok):
    Ginv[k] = G_k^{-1} (lower), C[k] = A_{k+1,k} G_k^{-T}."""
    nb, N, b, _ = Adiag.shape
    eye = jnp.broadcast_to(jnp.eye(b, dtype=Adiag.dtype), (N, b, b))

    def step(Cprev, inp):
        Akk, Ak1k = inp
        S = Akk - _bmm(Cprev, Cprev, tb=True)
        G = jnp.linalg.cholesky(S)
        Ginv = jax.lax.linalg.triangular_solve(
            G, eye, left_side=True, lower=True)
        Ck = _bmm(Ak1k, Ginv, tb=True)          # A_{k+1,k} G^{-T}
        return Ck, (Ginv, Ck)

    C0 = jnp.zeros((N, b, b), Adiag.dtype)
    _, (Ginv, C) = jax.lax.scan(step, C0, (Adiag, Asub))
    ok = jnp.all(jnp.isfinite(Ginv))
    return Ginv, C, ok


def block_tridiag_solve(Ginv, C, r):
    """Solve (L L') x = r with L from block_tridiag_factor.

    r [nb, N, b, c]; returns x of the same shape.  Two scans of batched
    [N, b, b] x [N, b, c] matmuls (forward then backward substitution)."""
    nb, N, b, c = r.shape
    z = jnp.zeros((N, b, c), r.dtype)

    def fwd(yprev, inp):
        Ginv_k, Cprev, rk = inp
        yk = _bmm(Ginv_k, rk - _bmm(Cprev, yprev))
        return yk, yk

    Cshift = jnp.concatenate([jnp.zeros_like(C[:1]), C[:-1]], axis=0)
    _, y = jax.lax.scan(fwd, z, (Ginv, Cshift, r))

    def bwd(xnext, inp):
        Ginv_k, Ck, yk = inp
        # x_k = G_k^{-T} (y_k - C_k' x_{k+1})
        t = yk - _bmm(jnp.swapaxes(Ck, 1, 2), xnext)
        xk = _bmm(jnp.swapaxes(Ginv_k, 1, 2), t)
        return xk, xk

    _, xrev = jax.lax.scan(bwd, z, (Ginv, C, y), reverse=True)
    return xrev


class BandArrowBackend(ArrowBackend):
    """ArrowBackend whose leaf factorization is banded (block tridiagonal).

    Construct with a `BandPlan` from `plan_banded` (static, host-side).
    All other machinery — condensation, border solves, Schur assembly,
    root, refinement, distribution — is inherited."""

    def __init__(self, lp: ArrowheadLP, plan: BandPlan, **kw):
        kw.setdefault("explicit_inverse", False)
        super().__init__(lp, **kw)
        # the band path owns the leaf; no dense explicit inverses
        self.explicit_inverse = False
        self.plan = plan
        self._perm = jnp.asarray(plan.perm)
        self._iperm = jnp.asarray(plan.iperm)

    def _permute(self, arr, perm):
        """Gather rows (axis 1) by a [N, a] or shared [a] permutation."""
        if perm.ndim == 1:
            return jnp.take(arr, perm, axis=1)
        idx = perm if arr.ndim == 2 else perm[:, :, None]
        return jnp.take_along_axis(arr, idx, axis=1)

    # ---- leaf hooks ----
    def _band_rhs_solve(self, Ginv, C, t):
        """Band-part solve for t [N, ab, c] (already permuted/split)."""
        b, nb = self.plan.panel, self.plan.n_panels
        N, ab, c = t.shape
        if nb * b > ab:
            t = jnp.concatenate(
                [t, jnp.zeros((N, nb * b - ab, c), t.dtype)], axis=1)
        r = t.reshape(N, nb, b, c).transpose(1, 0, 2, 3)
        x = block_tridiag_solve(Ginv, C, r)
        return x.transpose(1, 0, 2, 3).reshape(N, nb * b, c)[:, :ab]

    def _leaf_factor(self, M, MEi, Fd):
        fd = self.factor_dtype
        plan = self.plan
        b, nb, k = plan.panel, plan.n_panels, plan.n_dense
        N, a, n = M.shape
        ab = a - k
        ap = nb * b

        Mp = self._permute(M, self._perm).astype(fd)
        MEip = self._permute(MEi, self._perm).astype(fd)
        Fdp = self._permute(Fd, self._perm).astype(fd)
        Mb, Md = Mp[:, :ab], Mp[:, ab:]
        Eb, Ed = MEip[:, :ab], MEip[:, ab:]
        Fb, Fdd = Fdp[:, :ab], Fdp[:, ab:]
        if ap > ab:
            # pad with identity rows (decoupled, unit pivot)
            zrow = jnp.zeros((N, ap - ab, n), fd)
            Mb = jnp.concatenate([Mb, zrow], axis=1)
            Eb = jnp.concatenate([Eb, zrow], axis=1)
            Fb = jnp.concatenate(
                [Fb, jnp.ones((N, ap - ab), fd)], axis=1)

        Mr = Mb.reshape(N, nb, b, n)
        Er = Eb.reshape(N, nb, b, n)
        # only the tridiagonal band of Neq is formed (entries outside are
        # structurally zero by the bandwidth bound): [nb, N, b, b]
        Adiag = (jnp.einsum("iKan,iKcn->Kiac", Er, Mr)
                 + jax.vmap(jax.vmap(jnp.diag))(
                     Fb.reshape(N, nb, b)).transpose(1, 0, 2, 3))
        Asub = jnp.concatenate([
            jnp.einsum("iKan,iKcn->Kiac", Er[:, 1:], Mr[:, :-1]),
            jnp.zeros((1, N, b, b), fd)], axis=0)
        Ginv, C, ok = block_tridiag_factor(Adiag, Asub)
        if k == 0:
            return (Ginv, C), jnp.zeros((), fd), ok

        # peeled dense rows: small trailing Schur complement
        #   Neq = [[Bb, U], [U', Dd]];  S = Dd - U' Bb^{-1} U
        U = jnp.einsum("ian,icn->iac", Eb[:, :ab], Md)       # [N, ab, k]
        W = self._band_rhs_solve(Ginv, C, U)                 # Bb^{-1} U
        Dd = (jnp.einsum("ian,icn->iac", Ed, Md)
              + jax.vmap(jnp.diag)(Fdd))
        S = Dd - jnp.einsum("iam,iac->imc", U, W)            # [N, k, k]
        cholS = jnp.linalg.cholesky(S)
        eye_k = jnp.broadcast_to(jnp.eye(k, dtype=fd), (N, k, k))
        Sinv = _bchol_solve(cholS, eye_k)
        ok = ok & jnp.all(jnp.isfinite(Sinv))
        return (Ginv, C, U, W, Sinv), jnp.zeros((), fd), ok

    def _apply_Ninv_multi(self, L, Ninv, t):
        k = self.plan.n_dense
        N, a, c = t.shape
        ab = a - k
        tp = self._permute(t, self._perm)
        if k == 0:
            Ginv, C = L
            xp = self._band_rhs_solve(Ginv, C, tp)
        else:
            Ginv, C, U, W, Sinv = L
            t1, t2 = tp[:, :ab], tp[:, ab:]
            u1 = self._band_rhs_solve(Ginv, C, t1)
            rhs2 = t2 - jnp.einsum("iam,iac->imc", U, u1)
            x2 = jnp.einsum("imk,ikc->imc", Sinv, rhs2)
            x1 = u1 - jnp.einsum("iak,ikc->iac", W, x2)
            xp = jnp.concatenate([x1, x2], axis=1)
        return self._permute(xp, self._iperm)
