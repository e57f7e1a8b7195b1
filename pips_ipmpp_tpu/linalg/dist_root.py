r"""Distributed (column-sharded) root factorization.

The reference factorizes the global Schur complement either replicated on
every rank (PARDISO/LAPACK + ALLREDUCE_SCHUR_COMPLEMENT) or distributed
via MUMPS over a sub-communicator (MumpsSolverBase.h:28-72); multi-RHS SC
solves are split round-robin over ranks (DsolveHierarchyBorder,
sLinsysRootAug.C:1815-1867).  Replicating the root caps the linking
dimension at one chip's memory and serializes the O(nD^3) factorization.

Replacement here (1-D column layout over the mesh axis):

  - the SPD dual Schur complement S [nD, nD] lives COLUMN-SHARDED: device
    d owns columns [d*nDp, (d+1)*nDp), nDp = nD / P
  - `dist_chol_inverse` runs a panel-blocked right-looking Cholesky: per
    128-column panel, the owner's current panel is broadcast with ONE
    psum, every device updates its own trailing columns with matmuls
    (flops nD^3/(3P) per device); a second panel sweep forward/back-
    substitutes the device's own identity columns, yielding the explicit
    inverse W = S^{-1} column-sharded
  - a root solve is then ONE psum:  x = psum_d( W[:, own_d] @ v[own_d] )

Memory per device: 3 * nD * nDp floats — the replicated-root footprint
divided by the mesh size.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

PANEL = 128


def _bcast_from(owner, value, dev, axis):
    """Broadcast `value` (valid on device `owner`) to all devices."""
    masked = jnp.where(dev == owner, value, jnp.zeros_like(value))
    return jax.lax.psum(masked, axis)


def dist_chol_inverse(S_cols: jax.Array, axis: str, n_shards: int,
                      panel: int = PANEL):
    """Distributed Cholesky + explicit inverse of an SPD matrix.

    S_cols: this device's column shard [nD, nDp] (nDp = nD / n_shards,
    contiguous layout).  Returns (W_cols, ok): W_cols = S^{-1}[:, own]
    and a local health flag.
    """
    nD, nDp = S_cols.shape
    if nD != nDp * n_shards:
        raise ValueError(
            f"dual Schur dimension nD={nD} must be divisible by "
            f"n_shards={n_shards} (got shard width {nDp}); pad the "
            f"linking dimensions so nD % n_shards == 0")
    # panels must tile each device's contiguous column shard exactly:
    # largest divisor of nDp not exceeding `panel`.  A degenerate divisor
    # (e.g. prime nDp -> 1-column panels) would serialize the
    # factorization into nD psum rounds — refuse with guidance instead
    pw = next(w for w in range(min(panel, nDp), 0, -1) if nDp % w == 0)
    if pw < 8 and nDp >= 8:
        raise ValueError(
            f"shard width nDp={nDp} has no panel divisor >= 8 (best "
            f"{pw}); pad the linking dimensions to a multiple of "
            f"{8 * n_shards} so the distributed root stays blocked")
    n_panels = nD // pw
    dev = jax.lax.axis_index(axis)
    dt = S_cols.dtype

    # global column ids of this device's shard
    own_cols = dev * nDp + jnp.arange(nDp)

    def get_panel(L_cols, k):
        """Broadcast L panel k from its owner (one psum, [nD, pw])."""
        off = k * pw
        o = off // nDp
        loc = off - o * nDp
        return _bcast_from(o, L_cols[:, loc:loc + pw], dev, axis)

    # ---- distributed blocked right-looking Cholesky ----
    # Only the column shards persist per device; each panel is broadcast
    # transiently (never the full L), so memory stays at O(nD * nDp).
    M = S_cols
    L_cols = jnp.zeros_like(S_cols)
    for k in range(n_panels):
        off = k * pw                       # static
        o = off // nDp                     # static owner
        loc = off - o * nDp                # static local offset on owner
        mypan = M[:, loc:loc + pw]
        pan = _bcast_from(o, mypan, dev, axis)          # [nD, pw]
        Akk = pan[off:off + pw, :]
        Lkk = jnp.linalg.cholesky(Akk)
        below = jax.lax.linalg.triangular_solve(
            Lkk, pan[off + pw:, :], left_side=False, lower=True,
            transpose_a=True)                           # [nD-off-pw, pw]
        Lpan = jnp.concatenate(
            [jnp.zeros((off, pw), dt), Lkk, below], axis=0)   # [nD, pw]
        # write own columns of L
        upd = jax.lax.dynamic_update_slice(L_cols, Lpan, (0, loc))
        L_cols = jnp.where(dev == o, upd, L_cols)
        # trailing update on own columns with global id >= off+pw
        if off + pw < nD:
            Lrows_own = jax.lax.dynamic_slice(
                Lpan, (jnp.asarray(dev * nDp, jnp.int32),
                       jnp.zeros((), jnp.int32)),
                (nDp, pw))                              # rows at own cols
            mask = (own_cols >= off + pw).astype(dt)[None, :]
            M = M - Lpan @ (Lrows_own * mask.T).T

    # ---- explicit inverse columns: solve S W = I[:, own] ----
    # forward substitution L Z = I[:, own], panel sweep (local multi-RHS:
    # every device substitutes its own nDp right-hand sides)
    eye_cols = (own_cols[None, :]
                == jnp.arange(nD)[:, None]).astype(dt)  # [nD, nDp]
    Z = eye_cols
    for k in range(n_panels):
        off = k * pw
        Lpan = get_panel(L_cols, k)
        Lkk = Lpan[off:off + pw, :]
        zp = jax.lax.linalg.triangular_solve(
            Lkk, Z[off:off + pw, :], left_side=True, lower=True)
        Z = Z.at[off:off + pw, :].set(zp)
        if off + pw < nD:
            Z = Z.at[off + pw:, :].add(-Lpan[off + pw:, :] @ zp)
    # back substitution L' W = Z
    W = Z
    for k in reversed(range(n_panels)):
        off = k * pw
        Lpan = get_panel(L_cols, k)
        Lkk = Lpan[off:off + pw, :]
        rhs = W[off:off + pw, :]
        if off + pw < nD:
            rhs = rhs - Lpan[off + pw:, :].T @ W[off + pw:, :]
        wp = jax.lax.linalg.triangular_solve(
            Lkk, rhs, left_side=True, lower=True, transpose_a=True)
        W = W.at[off:off + pw, :].set(wp)

    ok = jnp.all(jnp.isfinite(W)) & jnp.all(jnp.isfinite(L_cols))
    return W, ok


def dist_root_matvec(W_cols: jax.Array, v: jax.Array, axis: str,
                     n_shards: int) -> jax.Array:
    """x = S^{-1} v with column-sharded W = S^{-1}: one psum."""
    nD, nDp = W_cols.shape
    dev = jax.lax.axis_index(axis)
    v_own = jax.lax.dynamic_slice(
        v, (jnp.asarray(dev * nDp, jnp.int32),), (nDp,))
    return jax.lax.psum(W_cols @ v_own, axis)


def own_slice(arr: jax.Array, axis_name: str, n_shards: int,
              axis_dim: int = -1) -> jax.Array:
    """This device's contiguous shard of `arr` along `axis_dim`."""
    dim = axis_dim % arr.ndim
    total = arr.shape[dim]
    per = total // n_shards
    dev = jax.lax.axis_index(axis_name)
    starts = [jnp.zeros((), jnp.int32)] * arr.ndim
    starts[dim] = jnp.asarray(dev * per, jnp.int32)
    sizes = list(arr.shape)
    sizes[dim] = per
    return jax.lax.dynamic_slice(arr, starts, sizes)
