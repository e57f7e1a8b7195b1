"""LP containers: flat dense LP and the doubly bordered block-diagonal (arrowhead) LP.

The LP solved (same formulation as the reference, SURVEY.md §0;
reference Core/Problems/Problem.h + DistributedProblem.hpp):

    min  c'x
    s.t. A x  = b                      (equality rows)
         clow <= C x <= cupp           (inequality rows; per-row indicator
                                        masks iclow/icupp select which sides exist)
         xlow <= x <= xupp             (per-variable indicator masks ixlow/ixupp)

Arrowhead structure, for blocks i = 1..N with first-stage variables x0 and
optional linking rows at the bottom (reference DistributedMatrix.h:15-57):

    A_global = [ A0                              ]   rows: m0E     (block-0 eq)
               [ A_1  B_1                        ]   rows: mE each (block eq)
               [ A_2       B_2                   ]
               [ ...                             ]
               [ F_0  F_1  F_2  ...  F_N         ]   rows: mEl     (eq linking rows)

    C_global has the same shape with C0 / C_i, D_i / G_0, G_i     (ineq).

Device representation: all per-block matrices are stored **batched dense
and padded to uniform shapes** `[N, rows, cols]` so that every per-iteration
operation is a single batched matmul / batched Cholesky.  Padding
is constructed so the padded LP is *exactly equivalent* to the original LP
(padded variables are fixed by paired equality rows or boxed in [-1,1] with
zero objective; padded rows are zero rows with benign right-hand sides) —
this removes all masking from the hot path.  (The reference instead uses
"dummy" tree nodes for non-local blocks, DistributedDummyLinearSystem.h.)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda obj: (tuple(getattr(obj, f) for f in fields), None),
        lambda aux, children: cls(*children),
    )
    return cls


@_register
@dataclass
class DenseLP:
    """Flat (unstructured) LP. Used by the serial dense path and as the
    flattened oracle view of an ArrowheadLP in tests."""

    c: jax.Array        # [n]
    A: jax.Array        # [mE, n] equality matrix
    b: jax.Array        # [mE]
    C: jax.Array        # [mI, n] inequality matrix
    iclow: jax.Array    # [mI] 0/1 mask
    clow: jax.Array     # [mI]
    icupp: jax.Array    # [mI]
    cupp: jax.Array     # [mI]
    ixlow: jax.Array    # [n]
    xlow: jax.Array     # [n]
    ixupp: jax.Array    # [n]
    xupp: jax.Array     # [n]

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def mE(self) -> int:
        return self.b.shape[-1]

    @property
    def mI(self) -> int:
        return self.clow.shape[-1]

    def astype(self, dtype) -> "DenseLP":
        return jax.tree.map(lambda x: jnp.asarray(x, dtype), self)

    def objective(self, x: jax.Array) -> jax.Array:
        return jnp.dot(self.c, x)

    def datanorm(self) -> jax.Array:
        """inf-norm over all problem data (reference Problem::datanorm,
        Core/Problems/Problem.cpp)."""
        leaves = [self.c, self.A, self.b, self.C,
                  self.clow * self.iclow, self.cupp * self.icupp,
                  self.xlow * self.ixlow, self.xupp * self.ixupp]
        return jnp.max(jnp.stack([jnp.max(jnp.abs(l)) if l.size else jnp.zeros(()) for l in leaves]))


@_register
@dataclass
class ArrowheadLP:
    """Doubly bordered block-diagonal LP, batched-dense representation.

    Shapes (all padded-uniform): N blocks; per-block n vars, mE eq rows,
    mI ineq rows; first stage n0 vars, m0E eq, m0I ineq; linking mEl eq
    rows and mIl ineq rows.

    Per-block arrays carry the batch axis first and are sharded over the
    "blocks" mesh axis; first-stage and linking arrays are replicated.
    """

    # ---- first stage (block 0), replicated ----
    c0: jax.Array       # [n0]
    A0: jax.Array       # [m0E, n0]   block-0 eq diag (reference: B0 / Bmat of root)
    b0: jax.Array       # [m0E]
    C0: jax.Array       # [m0I, n0]
    iclow0: jax.Array   # [m0I]
    clow0: jax.Array
    icupp0: jax.Array
    cupp0: jax.Array
    ixlow0: jax.Array   # [n0]
    xlow0: jax.Array
    ixupp0: jax.Array
    xupp0: jax.Array

    # ---- per-block, batched [N, ...] ----
    cN: jax.Array       # [N, n]
    A: jax.Array        # [N, mE, n0]  border (couples to x0; reference Amat)
    B: jax.Array        # [N, mE, n]   diagonal block (reference Bmat)
    bN: jax.Array       # [N, mE]
    C: jax.Array        # [N, mI, n0]  ineq border
    D: jax.Array        # [N, mI, n]   ineq diagonal
    iclowN: jax.Array   # [N, mI]
    clowN: jax.Array
    icuppN: jax.Array
    cuppN: jax.Array
    ixlowN: jax.Array   # [N, n]
    xlowN: jax.Array
    ixuppN: jax.Array
    xuppN: jax.Array

    # ---- linking rows (bottom border; reference Blmat / linking strip) ----
    F0: jax.Array       # [mEl, n0]
    F: jax.Array        # [N, mEl, n]
    bl: jax.Array       # [mEl]
    G0: jax.Array       # [mIl, n0]
    G: jax.Array        # [N, mIl, n]
    iclowl: jax.Array   # [mIl]
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
        return self.cN.shape[-1]

    @property
    def mE(self) -> int:
        return self.bN.shape[-1]

    @property
    def mI(self) -> int:
        return self.clowN.shape[-1]

    @property
    def m0E(self) -> int:
        return self.b0.shape[-1]

    @property
    def m0I(self) -> int:
        return self.clow0.shape[-1]

    @property
    def mEl(self) -> int:
        return self.bl.shape[-1]

    @property
    def mIl(self) -> int:
        return self.clowl.shape[-1]

    def astype(self, dtype) -> "ArrowheadLP":
        return jax.tree.map(lambda x: jnp.asarray(x, dtype), self)

    # ------------------------------------------------------------------
    def total_vars(self) -> int:
        return self.n0 + self.N * self.n

    def total_eq(self) -> int:
        return self.m0E + self.N * self.mE + self.mEl

    def total_ineq(self) -> int:
        return self.m0I + self.N * self.mI + self.mIl

    def datanorm(self) -> jax.Array:
        leaves = [self.c0, self.A0, self.b0, self.C0, self.cN, self.A, self.B,
                  self.bN, self.C, self.D, self.F0, self.F, self.bl, self.G0, self.G,
                  self.clow0 * self.iclow0, self.cupp0 * self.icupp0,
                  self.xlow0 * self.ixlow0, self.xupp0 * self.ixupp0,
                  self.clowN * self.iclowN, self.cuppN * self.icuppN,
                  self.xlowN * self.ixlowN, self.xuppN * self.ixuppN,
                  self.clowl * self.iclowl, self.cuppl * self.icuppl]
        return jnp.max(jnp.stack(
            [jnp.max(jnp.abs(l)) if l.size else jnp.zeros(()) for l in leaves]))

    # ------------------------------------------------------------------
    def to_dense(self) -> DenseLP:
        """Flatten to an unstructured DenseLP (oracle/testing only —
        materializes the full matrices on host)."""
        N, n0, n = self.N, self.n0, self.n
        mE, mI, m0E, m0I, mEl, mIl = (self.mE, self.mI, self.m0E,
                                      self.m0I, self.mEl, self.mIl)
        ntot = n0 + N * n
        mEtot = m0E + N * mE + mEl
        mItot = m0I + N * mI + mIl

        c = jnp.concatenate([self.c0, self.cN.reshape(-1)])

        A = jnp.zeros((mEtot, ntot), self.c0.dtype)
        A = A.at[:m0E, :n0].set(self.A0)
        for i in range(N):
            r = m0E + i * mE
            A = A.at[r:r + mE, :n0].set(self.A[i])
            A = A.at[r:r + mE, n0 + i * n:n0 + (i + 1) * n].set(self.B[i])
        rl = m0E + N * mE
        A = A.at[rl:, :n0].set(self.F0)
        for i in range(N):
            A = A.at[rl:, n0 + i * n:n0 + (i + 1) * n].set(self.F[i])
        b = jnp.concatenate([self.b0, self.bN.reshape(-1), self.bl])

        C = jnp.zeros((mItot, ntot), self.c0.dtype)
        C = C.at[:m0I, :n0].set(self.C0)
        for i in range(N):
            r = m0I + i * mI
            C = C.at[r:r + mI, :n0].set(self.C[i])
            C = C.at[r:r + mI, n0 + i * n:n0 + (i + 1) * n].set(self.D[i])
        rl = m0I + N * mI
        C = C.at[rl:, :n0].set(self.G0)
        for i in range(N):
            C = C.at[rl:, n0 + i * n:n0 + (i + 1) * n].set(self.G[i])

        cat = jnp.concatenate
        return DenseLP(
            c=c, A=A, b=b, C=C,
            iclow=cat([self.iclow0, self.iclowN.reshape(-1), self.iclowl]),
            clow=cat([self.clow0, self.clowN.reshape(-1), self.clowl]),
            icupp=cat([self.icupp0, self.icuppN.reshape(-1), self.icuppl]),
            cupp=cat([self.cupp0, self.cuppN.reshape(-1), self.cuppl]),
            ixlow=cat([self.ixlow0, self.ixlowN.reshape(-1)]),
            xlow=cat([self.xlow0, self.xlowN.reshape(-1)]),
            ixupp=cat([self.ixupp0, self.ixuppN.reshape(-1)]),
            xupp=cat([self.xupp0, self.xuppN.reshape(-1)]),
        )


# ======================================================================
# Builders
# ======================================================================

def make_arrowhead_lp(blocks: list[dict], first_stage: dict,
                      linking_eq: Optional[dict] = None,
                      linking_ineq: Optional[dict] = None,
                      dtype=jnp.float64,
                      host: bool = False) -> ArrowheadLP:
    """Build an ArrowheadLP from per-block dicts of numpy arrays.

    `blocks[i]` keys: c, A (mE x n0 border), B (mE x n diag), b,
    C, D, iclow, clow, icupp, cupp, ixlow, xlow, ixupp, xupp,
    F (mEl x n), G (mIl x n).
    `first_stage` keys: c, A, b, C, iclow..cupp, ixlow..xupp, F0 (mEl x n0),
    G0 (mIl x n0).
    `linking_eq`: {b: [mEl]}; `linking_ineq`: {iclow, clow, icupp, cupp}.

    Blocks may have heterogeneous shapes; they are padded to the max via
    `pad_blocks` (exact-equivalence padding).
    """
    blocks = [dict(blk) for blk in blocks]
    fs = dict(first_stage)
    mEl = fs.get("F0", np.zeros((0, len(fs["c"])))).shape[0]
    mIl = fs.get("G0", np.zeros((0, len(fs["c"])))).shape[0]
    n0 = len(fs["c"])

    n_max = max(len(blk["c"]) for blk in blocks)
    mE_max = max(blk["b"].shape[0] for blk in blocks)
    mI_max = max(blk["clow"].shape[0] for blk in blocks)
    blocks = [_pad_block(blk, n_max, mE_max, mI_max, n0, mEl, mIl)
              for blk in blocks]

    def stack(key, default_shape=None):
        out = np.stack([blk[key] for blk in blocks])
        if host:
            return np.asarray(out, np.dtype(jnp.dtype(dtype).name))
        return jnp.asarray(out, dtype)

    le = linking_eq or {"b": np.zeros((mEl,))}
    li = linking_ineq or {k: np.zeros((mIl,)) for k in
                          ("iclow", "clow", "icupp", "cupp")}

    # ---- intake validation (fail HERE with row identity, not with an
    # opaque shape error or an inf/NaN solve later) ----
    if len(np.asarray(le["b"])) != mEl:
        raise ValueError(
            f"linking_eq b has {len(np.asarray(le['b']))} rows but "
            f"first_stage F0 declares mEl={mEl} (pass F0 and per-block F "
            f"strips matching the linking rhs)")
    if len(np.asarray(li["iclow"])) != mIl:
        raise ValueError(
            f"linking_ineq masks have {len(np.asarray(li['iclow']))} rows "
            f"but first_stage G0 declares mIl={mIl}")
    if mIl and linking_ineq is None:
        raise ValueError(
            "G0 declares linking inequality rows but linking_ineq is "
            "None: every inequality row needs at least one finite side "
            "(a both-sides-free row makes the IPM barrier singular)")

    def check_ineq_bounded(il, iu, what):
        il = np.asarray(il)
        iu = np.asarray(iu)
        bad = np.nonzero((il <= 0) & (iu <= 0))
        if bad[0].size:
            raise ValueError(
                f"{what}: row(s) {bad[0][:5].tolist()} have neither a "
                f"lower nor an upper bound — drop them or bound one side")

    check_ineq_bounded(fs["iclow"], fs["icupp"], "first-stage ineq")
    check_ineq_bounded(li["iclow"], li["icupp"], "linking ineq")
    for i, blk in enumerate(blocks):
        check_ineq_bounded(blk["iclow"], blk["icupp"], f"block {i} ineq")

    # host=True keeps numpy leaves (no device transfer): host-side
    # consumers like the presolver otherwise pull every block array back
    # from the device
    if host:
        arr = partial(np.asarray,
                      dtype=np.dtype(jnp.dtype(dtype).name))
    else:
        arr = partial(jnp.asarray, dtype=dtype)
    return ArrowheadLP(
        c0=arr(fs["c"]), A0=arr(fs["A"]), b0=arr(fs["b"]), C0=arr(fs["C"]),
        iclow0=arr(fs["iclow"]), clow0=arr(fs["clow"]),
        icupp0=arr(fs["icupp"]), cupp0=arr(fs["cupp"]),
        ixlow0=arr(fs["ixlow"]), xlow0=arr(fs["xlow"]),
        ixupp0=arr(fs["ixupp"]), xupp0=arr(fs["xupp"]),
        cN=stack("c"), A=stack("A"), B=stack("B"), bN=stack("b"),
        C=stack("C"), D=stack("D"),
        iclowN=stack("iclow"), clowN=stack("clow"),
        icuppN=stack("icupp"), cuppN=stack("cupp"),
        ixlowN=stack("ixlow"), xlowN=stack("xlow"),
        ixuppN=stack("ixupp"), xuppN=stack("xupp"),
        F0=arr(fs.get("F0", np.zeros((0, n0)))), F=stack("F"),
        bl=arr(le["b"]),
        G0=arr(fs.get("G0", np.zeros((0, n0)))), G=stack("G"),
        iclowl=arr(li["iclow"]), clowl=arr(li["clow"]),
        icuppl=arr(li["icupp"]), cuppl=arr(li["cupp"]),
    )


def _pad_block(blk: dict, n: int, mE: int, mI: int,
               n0: int, mEl: int, mIl: int) -> dict:
    """Pad one block to uniform (n, mE, mI) preserving exact LP equivalence.

    - padded variables get objective 0 and box bounds [-1, 1] (strictly
      interior analytic center 0, zero matrix columns) — they decouple;
    - padded eq rows are paired with padded variables where possible
      (B[pad_row, pad_col] = 1, rhs 0 → pins the padded var to 0 and keeps
      the normal-equations pivot healthy); unpaired padded eq rows are zero
      rows with rhs 0 (handled by dual regularization);
    - padded ineq rows are zero rows bounded in [-1, 1] (slack interior).
    """
    blk = dict(blk)
    n_old = len(blk["c"])
    mE_old = blk["b"].shape[0]
    mI_old = blk["clow"].shape[0]
    dn, dE, dI = n - n_old, mE - mE_old, mI - mI_old
    f = np.asarray

    blk["c"] = np.concatenate([f(blk["c"]), np.zeros(dn)])
    blk["ixlow"] = np.concatenate([f(blk["ixlow"]), np.ones(dn)])
    blk["xlow"] = np.concatenate([f(blk["xlow"]), -np.ones(dn)])
    blk["ixupp"] = np.concatenate([f(blk["ixupp"]), np.ones(dn)])
    blk["xupp"] = np.concatenate([f(blk["xupp"]), np.ones(dn)])

    B = np.zeros((mE, n))
    B[:mE_old, :n_old] = blk["B"]
    # pair padded eq rows with padded vars: x_pad(j) = 0
    npair = min(dE, dn)
    for j in range(npair):
        B[mE_old + j, n_old + j] = 1.0
    blk["B"] = B
    A = np.zeros((mE, n0))
    A[:mE_old] = blk["A"]
    blk["A"] = A
    blk["b"] = np.concatenate([f(blk["b"]), np.zeros(dE)])

    D = np.zeros((mI, n))
    D[:mI_old, :n_old] = blk["D"]
    blk["D"] = D
    C = np.zeros((mI, n0))
    C[:mI_old] = blk["C"]
    blk["C"] = C
    blk["iclow"] = np.concatenate([f(blk["iclow"]), np.ones(dI)])
    blk["clow"] = np.concatenate([f(blk["clow"]), -np.ones(dI)])
    blk["icupp"] = np.concatenate([f(blk["icupp"]), np.ones(dI)])
    blk["cupp"] = np.concatenate([f(blk["cupp"]), np.ones(dI)])

    Fm = np.zeros((mEl, n))
    Fm[:, :n_old] = blk.get("F", np.zeros((mEl, n_old)))
    blk["F"] = Fm
    Gm = np.zeros((mIl, n))
    Gm[:, :n_old] = blk.get("G", np.zeros((mIl, n_old)))
    blk["G"] = Gm
    return blk


def pad_num_blocks(lp: ArrowheadLP, n_blocks: int) -> ArrowheadLP:
    """Pad the batch axis with fully-dummy blocks so N divides the mesh.

    Mirrors the reference's dummy tree nodes (kStochDummy,
    DistributedDummyLinearSystem.h): dummy blocks contribute nothing.
    """
    N = lp.N
    if n_blocks == N:
        return lp
    assert n_blocks > N
    d = n_blocks - N

    def pad(x, fill):
        if x.ndim == 0 or x.shape[0] != N:
            return x
        pad_shape = (d,) + x.shape[1:]
        return jnp.concatenate([x, jnp.full(pad_shape, fill, x.dtype)], 0)

    out = {}
    for fld in dataclasses.fields(lp):
        v = getattr(lp, fld.name)
        out[fld.name] = v
    # per-block fields only
    for name in ("cN", "A", "B", "bN", "C", "D", "F", "G"):
        out[name] = pad(out[name], 0.0)
    for lo_mask, lo, hi_mask, hi in (("iclowN", "clowN", "icuppN", "cuppN"),
                                     ("ixlowN", "xlowN", "ixuppN", "xuppN")):
        out[lo_mask] = pad(out[lo_mask], 1.0)
        out[lo] = pad(out[lo], -1.0)
        out[hi_mask] = pad(out[hi_mask], 1.0)
        out[hi] = pad(out[hi], 1.0)
    # dummy blocks: pair each var with an eq row pinning it to 0 where possible
    if d > 0 and lp.mE > 0 and lp.n > 0:
        npair = min(lp.mE, lp.n)
        eye = jnp.zeros((lp.mE, lp.n), lp.B.dtype).at[
            jnp.arange(npair), jnp.arange(npair)].set(1.0)
        out["B"] = out["B"].at[N:].set(eye)
    return ArrowheadLP(**out)
