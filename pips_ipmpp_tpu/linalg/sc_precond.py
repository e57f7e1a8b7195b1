r"""Schur-complement sparsifier + preconditioner for the iterative root.

Counterpart of the reference's SCsparsifier + distributed
preconditioned root solve (Core/LinearSolvers/Preconditioners/
SCsparsifier.h:18-58, `DistributedRootLinearSystem::precondSC`,
DistributedRootLinearSystem.h:130): when the linking dimension grows, the
O(nD^3) dense factorization of the dual Schur complement dominates; the
reference switches the root to preconditioned BiCGStab with a *sparsified*
SC (off-diagonal entries dominated by the diagonal are dropped, threshold
ladder `diagDomBounds`) as the preconditioner.

Irregular sparsity does not batch — the dense analog of the sparsified
factorization is a *panel block-Jacobi* preconditioner:

  - the dual SC is cut into fixed [pb, pb] diagonal panels (batched,
    one batched Cholesky over the panels: O(nD * pb^2) << O(nD^3));
  - inside each panel the reference's exact drop rule is applied
    (|s_ij| kept iff >= t*|s_ii| or >= t*|s_jj|, SCsparsifier.C:213-234)
    so the preconditioner factors the same sparsified operator;
  - the root solve becomes preconditioned CG with the full dense SC as
    the (cheap, O(nD^2)) matvec.

The `diagDomBounds` ladder and its increase/decrease moves driven by the
IPM's numerical-troubles path (InteriorPointMethod.cpp:629-637) are kept
verbatim in `SCsparsifier` below.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# reference threshold ladders (SCsparsifier.h:18-20); position moves
# right = less aggressive sparsification (keeps more entries)
DIAG_DOM_BOUNDS = (0.001, 0.0005, 0.0002, 0.000025, 0.000005, 0.000001)
DIAG_DOM_BOUNDS_LEAF = (0.002, 0.001, 0.0003, 0.000025, 0.000005, 0.000001)


class SCsparsifier:
    """Host-side threshold ladder (reference SCsparsifier.C:21-78).

    `increase_diag_dom_bound` = more aggressive (drop more, cheaper/weaker
    preconditioner); `decrease_diag_dom_bound` = less aggressive — invoked
    by the IPM on numerical troubles exactly like the reference
    (InteriorPointMethod.cpp:629-637)."""

    def __init__(self):
        self.position = 0

    @property
    def diag_dom_bound(self) -> float:
        return DIAG_DOM_BOUNDS[self.position]

    @property
    def diag_dom_bound_leaf(self) -> float:
        return DIAG_DOM_BOUNDS_LEAF[self.position]

    def increase_diag_dom_bound(self) -> bool:
        if self.position > 0:
            self.position -= 1
            return True
        return False

    def decrease_diag_dom_bound(self) -> bool:
        if self.position < len(DIAG_DOM_BOUNDS) - 1:
            self.position += 1
            return True
        return False


def sparsified_panels(Sd: jax.Array, panel: int, diag_dom_bound: float):
    """Extract the [k, pb, pb] diagonal panels of Sd with the reference's
    dominance drop rule applied inside each panel.

    Drop rule (SCsparsifier::getSparsifiedSC_fortran, SCsparsifier.C:
    213-234): off-diagonal s_ij is KEPT iff |s_ij| >= t*|s_ii| or
    |s_ij| >= t*|s_jj|; the diagonal is always kept.  Returns the panels
    and the fraction of within-panel off-diagonal entries dropped (the
    reference's updateStats ratio)."""
    nD = Sd.shape[0]
    pad = (-nD) % panel
    if pad:
        Sp = jnp.zeros((nD + pad, nD + pad), Sd.dtype)
        Sp = Sp.at[:nD, :nD].set(Sd)
        Sp = Sp.at[jnp.arange(nD, nD + pad), jnp.arange(nD, nD + pad)].set(
            jnp.ones((pad,), Sd.dtype))
    else:
        Sp = Sd
    k = Sp.shape[0] // panel
    panels = Sp.reshape(k, panel, k, panel)
    panels = jnp.einsum("ipiq->ipq", panels)           # [k, pb, pb]

    diag = jnp.einsum("ipp->ip", panels)               # [k, pb]
    t = jnp.asarray(diag_dom_bound, Sd.dtype)
    keep = ((jnp.abs(panels) >= t * jnp.abs(diag)[:, :, None])
            | (jnp.abs(panels) >= t * jnp.abs(diag)[:, None, :]))
    eye = jnp.eye(panel, dtype=bool)[None]
    keep = keep | eye
    sparsified = jnp.where(keep, panels, 0.0)
    off = panel * panel - panel
    dropped = 1.0 - (jnp.sum(keep) - k * panel) / max(k * off, 1)
    return sparsified, dropped


def block_jacobi_factors(Sd: jax.Array, panel: int, diag_dom_bound: float):
    """Batched Cholesky of the sparsified diagonal panels of the SPD dual
    Schur complement — the preconditioner factorization (the role of the
    reference's PARDISO factorization of the sparsified SC)."""
    panels, dropped = sparsified_panels(Sd, panel, diag_dom_bound)
    Pchol = jnp.linalg.cholesky(panels)
    return Pchol, dropped


def block_jacobi_apply(Pchol: jax.Array, r: jax.Array) -> jax.Array:
    """Apply the preconditioner: solve block-diagonally, [nD] -> [nD]."""
    k, pb, _ = Pchol.shape
    nD = r.shape[0]
    pad = k * pb - nD
    rp = jnp.pad(r, (0, pad)) if pad else r
    rb = rp.reshape(k, pb, 1)
    u = jax.lax.linalg.triangular_solve(Pchol, rb, left_side=True,
                                        lower=True, transpose_a=False)
    u = jax.lax.linalg.triangular_solve(Pchol, u, left_side=True,
                                        lower=True, transpose_a=True)
    u = u.reshape(k * pb)
    return u[:nD] if pad else u
