r"""Hierarchical (two-level) Schur complement backend.

A batched reimplementation of the reference's hierarchical approach
(HIERARCHICAL option: DistributedTreeCallbacks::splitTree + shaveDenseBorder,
DistributedTreeCallbacks.C:753,1123,1191; sLinsysRootBordered /
sLinsysRootAugHierInner; link-structure exploitation
DistributedProblem::activateLinkStructureExploitation,
DistributedProblem.hpp:105):

  - Linking rows whose support lies within ONE group of blocks ("local"
    rows — the reference's 2-link/k-link structure) are eliminated at an
    intermediate group-level Schur stage.
  - Only the first stage + truly-global linking rows reach the dense top
    system, which stays small as N and the linking-row count grow.

Layout transform (host-side, once): linking rows are permuted to
[group-0 locals | group-1 locals | ... | globals] and the per-group local
counts padded to a uniform (mElL, mIlL) with inert rows, giving a plain
ArrowheadLP in "hierarchical layout" — all formulation/IPM code is
unchanged; only factorize/solve differ.

Factorization (all levels batched):
  level 0: per-block condensed Cholesky (shared with ArrowBackend);
  level 1: per-group Schur over the group's local linking rows
           (batched Cholesky over groups, cached W_in = K_b^{-1} R_in);
  level 2: dense root over (x0, y0, z0, yl_glob, zl_glob) from
           psum/sum of group contributions (two-stage condensation).

Memory win vs. the flat backend: the cached border solves shrink from
[N, k, n0 + mEl_total + mIl_total] to [N, k, n0 + mEl_glob + mIl_glob]
plus [N, k, mElL + mIlL] — independent of the number of groups.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pips_ipmpp_tpu.core.lp import ArrowheadLP, _register
from pips_ipmpp_tpu.core.spaces import RVec, XVec
from pips_ipmpp_tpu.ipm.formulation import ReducedRhs
from pips_ipmpp_tpu.linalg.arrow_backend import (ArrowBackend, _bchol_solve,
                                                 _spd_solve,
                                                 preconditioned_bicgstab)


# ======================================================================
# Link-locality analysis + hierarchical layout construction (host-side)
# ======================================================================

@dataclass
class HierMeta:
    n_groups: int
    group_size: int          # blocks per group
    mElL: int                # padded local eq link rows per group
    mIlL: int
    mElG: int                # EFFECTIVE global eq link rows (includes the
    mIlG: int                # coarse sections when levels is non-empty)
    permE: np.ndarray        # new eq-link layout -> old row index (-1 = pad)
    permI: np.ndarray
    # ---- deeper layers (hierarchical_layers = 2 + len(levels)): rows
    # local to a level-l coarse group (but not to any finer level) sit in
    # per-level sections at the FRONT of the "global" part, padded to
    # uniform width per group, and are eliminated by one batched
    # per-group Cholesky per level before the dense top factorization.
    # Nesting keeps every level's block exactly block-diagonal even
    # after the finer levels' Schur downdates (a finer group lies inside
    # exactly one coarser group), which is what makes the depth a free
    # parameter — the analogue of the reference's recursive splitTree
    # (DistributedTreeCallbacks.C:1123, 1194-1217).
    # levels = ((C, mEl_c, mIl_c), ...) ordered finest -> coarsest;
    # () -> plain 2-layer scheme.
    levels: tuple = ()

    # backward-compatible single-coarse-level accessors (layers == 3)
    @property
    def n_coarse(self) -> int:
        return self.levels[0][0] if self.levels else 0

    @property
    def mEl2(self) -> int:
        return self.levels[0][1] if self.levels else 0

    @property
    def mIl2(self) -> int:
        return self.levels[0][2] if self.levels else 0


def analyze_link_locality(F: np.ndarray, n_groups: int) -> np.ndarray:
    """Group id per linking row: g if all nonzero block-strips lie in group
    g, else -1 (global). F: [N, ml, n]."""
    N, ml, _ = F.shape
    gs = N // n_groups
    owner = np.full(ml, -1, np.int64)
    touched = (np.abs(F) > 0).any(axis=2)    # [N, ml]
    for r in range(ml):
        blocks = np.nonzero(touched[:, r])[0]
        if blocks.size == 0:
            owner[r] = 0     # empty row: assign anywhere (group 0)
            continue
        groups = set(int(b) // gs for b in blocks)
        if len(groups) == 1:
            owner[r] = groups.pop()
    return owner


def build_hierarchical_lp(lp: ArrowheadLP, n_groups: int,
                          n_coarse: int = 0,
                          coarse_levels: tuple = ()
                          ) -> tuple[ArrowheadLP, HierMeta]:
    """Permute+pad linking rows into hierarchical layout.

    `coarse_levels = (C2, C3, ...)` (finest -> coarsest, each dividing
    the previous; `n_coarse` is the single-level shorthand) adds one
    layer per entry: rows whose support exceeds every finer grouping
    but fits one level-l group are placed in that level's section of
    the global part, padded per group, and eliminated by a batched
    per-group Schur stage before the dense top factorization
    (hierarchical_layers = 2 + len(coarse_levels); reference splitTree
    recursion, DistributedTreeCallbacks.C:1123,1194-1217)."""
    if lp.N % n_groups != 0:
        raise ValueError(f"N={lp.N} not divisible by n_groups={n_groups}")
    if n_coarse:
        coarse_levels = (n_coarse,) + tuple(coarse_levels)
    prev = n_groups
    for C in coarse_levels:
        if C <= 0 or prev % C != 0:
            raise ValueError(f"coarse level sizes {coarse_levels} must "
                             f"divide the previous level ({prev} % {C})")
        prev = C
    Fn = np.asarray(lp.F)
    Gn = np.asarray(lp.G)
    ownE = analyze_link_locality(Fn, n_groups) if lp.mEl else np.zeros(0, int)
    ownI = analyze_link_locality(Gn, n_groups) if lp.mIl else np.zeros(0, int)
    ownsE = [analyze_link_locality(Fn, C) if lp.mEl else np.zeros(0, int)
             for C in coarse_levels]
    ownsI = [analyze_link_locality(Gn, C) if lp.mIl else np.zeros(0, int)
             for C in coarse_levels]

    def layout(owner, owners_lvl):
        locs = [np.nonzero(owner == g)[0] for g in range(n_groups)]
        mL = max((len(l) for l in locs), default=0)
        perm = []
        for g in range(n_groups):
            perm += list(locs[g]) + [-1] * (mL - len(locs[g]))
        assigned = owner != -1
        widths = []
        glob_cnt = 0
        for C, own_l in zip(coarse_levels, owners_lvl):
            rows_l = [np.nonzero(~assigned & (own_l == c))[0]
                      for c in range(C)]
            mL2 = max((len(r) for r in rows_l), default=0)
            for c in range(C):
                perm += list(rows_l[c]) + [-1] * (mL2 - len(rows_l[c]))
                assigned[rows_l[c]] = True
            widths.append(mL2)
        glob = np.nonzero(~assigned)[0]
        glob_cnt = len(glob)
        perm += list(glob)
        mG = sum(C * w for C, w in zip(coarse_levels, widths)) + glob_cnt
        return np.asarray(perm, np.int64), mL, mG, widths

    permE, mElL, mElG, widthsE = layout(ownE, ownsE)
    permI, mIlL, mIlG, widthsI = layout(ownI, ownsI)
    levels = tuple((C, wE, wI) for C, wE, wI
                   in zip(coarse_levels, widthsE, widthsI))
    meta = HierMeta(n_groups=n_groups, group_size=lp.N // n_groups,
                    mElL=mElL, mIlL=mIlL, mElG=mElG, mIlG=mIlG,
                    permE=permE, permI=permI, levels=levels)

    def pick(arr, perm, pad_value, axis):
        arr = np.asarray(arr)
        out_shape = list(arr.shape)
        out_shape[axis] = len(perm)
        out = np.full(out_shape, pad_value, arr.dtype)
        sel = perm >= 0
        idx_out = [slice(None)] * arr.ndim
        idx_in = [slice(None)] * arr.ndim
        idx_out[axis] = np.nonzero(sel)[0]
        idx_in[axis] = perm[sel]
        out[tuple(idx_out)] = arr[tuple(idx_in)]
        return out

    dtype = lp.c0.dtype
    kw = {f.name: getattr(lp, f.name)
          for f in __import__("dataclasses").fields(lp)}
    kw["F0"] = jnp.asarray(pick(lp.F0, permE, 0.0, 0), dtype)
    kw["F"] = jnp.asarray(pick(lp.F, permE, 0.0, 1), dtype)
    kw["bl"] = jnp.asarray(pick(lp.bl, permE, 0.0, 0), dtype)
    kw["G0"] = jnp.asarray(pick(lp.G0, permI, 0.0, 0), dtype)
    kw["G"] = jnp.asarray(pick(lp.G, permI, 0.0, 1), dtype)
    # padded ineq link rows: inert bounds [-1, 1]
    kw["iclowl"] = jnp.asarray(pick(lp.iclowl, permI, 1.0, 0), dtype)
    kw["clowl"] = jnp.asarray(pick(lp.clowl, permI, -1.0, 0), dtype)
    kw["icuppl"] = jnp.asarray(pick(lp.icuppl, permI, 1.0, 0), dtype)
    kw["cuppl"] = jnp.asarray(pick(lp.cuppl, permI, 1.0, 0), dtype)
    return ArrowheadLP(**kw), meta


def unpermute_link_one(meta: HierMeta, vec: np.ndarray, which: str,
                       size: int) -> np.ndarray:
    """Map ONE permuted-layout link vector back to original row order
    (which in {"E", "I"}; pad rows, perm == -1, are dropped)."""
    perm = meta.permE if which == "E" else meta.permI
    out = np.zeros(size, vec.dtype)
    sel = perm >= 0
    out[perm[sel]] = vec[np.nonzero(sel)[0]]
    return out


def unpermute_link(meta: HierMeta, vecE: np.ndarray, vecI: np.ndarray,
                   mEl_orig: int, mIl_orig: int):
    """Map permuted-layout link vectors back to original row order."""
    return (unpermute_link_one(meta, vecE, "E", mEl_orig),
            unpermute_link_one(meta, vecI, "I", mIl_orig))


# ======================================================================
# Hierarchical factors + backend
# ======================================================================

@_register
@dataclass
class HierFactors:
    L: jax.Array         # [N, a, a] leaf Cholesky
    Einv: jax.Array      # [N, n]
    Om: jax.Array        # [N, mI]
    Lloc: jax.Array      # [G, mL, mL] Cholesky of -(local-link Schur)
    Win: jax.Array       # [N, n+a, mL]   K_b^{-1} R_in
    WoutB: jax.Array     # [N, n+a, nSo]  inner^{-1} R_out, block rows
    WoutL: jax.Array     # [G, mL, nSo]   inner^{-1} R_out, local-link rows
    chol1: jax.Array     # root two-stage condensation (as ArrowFactors)
    T: jax.Array
    chol2: jax.Array
    Einv0: jax.Array
    Om0: jax.Array
    OmlG: jax.Array      # [mIlG]
    OmlL: jax.Array      # [G, mIlL]
    delta_p: jax.Array
    delta_d: jax.Array
    Ninv: jax.Array = ()   # explicit leaf inverse (explicit mode) or ()
    leaf_ok: jax.Array = True
    Wd: jax.Array = ()     # dist_root: Sdual^{-1}[:, own cols]
    root_ok: jax.Array = True
    # ---- deeper layers (meta.levels): one batched coarse-Schur factor
    # per level, finest -> coarsest (tuples of arrays) ----
    L2: tuple = ()         # ([C, k2, k2] Cholesky of -(coarse dual block),)
    U1: tuple = ()         # ([C, n0, k2]    S12[:, coarse_c],)
    U2: tuple = ()         # ([C, nrest, k2] S22[rest, coarse_c],)


class HierArrowBackend(ArrowBackend):
    """Backend over a hierarchical-layout ArrowheadLP (see
    build_hierarchical_lp). Matvecs/bounds are inherited — only the KKT
    factorization/solve pipeline changes."""

    def __init__(self, lp: ArrowheadLP, meta: HierMeta,
                 factor_dtype=jnp.float64, axis: Optional[str] = None,
                 n_shards: int = 1, dist_root: bool = False):
        # HierFactors carries no explicit inverses: the root and the
        # leaves (shared _leaf_factor hook) keep the triangular solve path
        # (explicit_inverse=False).  `dist_root` distributes the TOP-level
        # dual Schur factorization over the mesh (the reference's
        # MUMPS-root-under-hierarchy, MumpsSolverBase.h:28-72 +
        # sLinsysRootBordered).
        super().__init__(lp, factor_dtype=factor_dtype, axis=axis,
                         explicit_inverse=False,
                         dist_root=dist_root, n_shards=n_shards)
        self.meta = meta
        # distributed mode (shard_map): whole groups live on one device —
        # the group-level Schur stage needs NO collectives (the reference's
        # sub-tree locality, sLinsysRootAugHierInner); only the global
        # border contributions are psum'd.  `n_shards` = mesh axis size
        # (static; lp arrays inside shard_map are the per-device shards).
        self.n_shards = n_shards if axis is not None else 1
        if meta.n_groups % self.n_shards:
            raise ValueError(
                f"n_groups={meta.n_groups} not divisible by "
                f"n_shards={self.n_shards}: groups must not straddle devices")
        self.G_loc = meta.n_groups // self.n_shards

        # ---- per-level static index maps over the dual vector
        # [m0E | m0I | ylG_eff | zlG_eff]: level-l rows of group c sit at
        # the level's section offsets within the ylG / zlG parts.  Each
        # stage's indices are POSITIONS WITHIN THE SPACE REMAINING after
        # the finer stages were eliminated; computed once here ----
        self._lvl = []
        if meta.levels:
            m0E, m0I = lp.m0E, lp.m0I
            nD = m0E + m0I + meta.mElG + meta.mIlG
            base_e = m0E + m0I
            base_i = m0E + m0I + meta.mElG
            cur = np.arange(nD)                 # original ids, current space
            off_e = off_i = 0
            pe_off = meta.n_groups * meta.mElL
            pi_off = meta.n_groups * meta.mIlL
            for (C2, mE2, mI2) in meta.levels:
                ids = np.concatenate([
                    np.stack([np.arange(base_e + off_e + c * mE2,
                                        base_e + off_e + (c + 1) * mE2)
                              for c in range(C2)]),
                    np.stack([np.arange(base_i + off_i + c * mI2,
                                        base_i + off_i + (c + 1) * mI2)
                              for c in range(C2)])], axis=1)  # [C2, k2]
                pos_map = np.full(nD, -1, np.int64)
                pos_map[cur] = np.arange(cur.size)
                idxc_pos = pos_map[ids]
                assert (idxc_pos >= 0).all()
                rest_mask = np.ones(cur.size, bool)
                rest_mask[idxc_pos.reshape(-1)] = False
                idxr_pos = np.nonzero(rest_mask)[0]
                # unit-diagonal protection for PADDED level eq rows (zero
                # rows; delta_d = 0 under the Ipopt strategy would give a
                # zero pivot) — same rule as the fine-level padE
                padE2 = (meta.permE[pe_off:pe_off + C2 * mE2] < 0
                         ).reshape(C2, mE2)
                padI2 = (meta.permI[pi_off:pi_off + C2 * mI2] < 0
                         ).reshape(C2, mI2)
                pad = np.concatenate([padE2, padI2], axis=1)
                self._lvl.append((jnp.asarray(idxc_pos),
                                  jnp.asarray(idxr_pos),
                                  jnp.asarray(pad.astype(np.float64)),
                                  int(cur.size)))
                cur = cur[rest_mask]
                off_e += C2 * mE2
                off_i += C2 * mI2
                pe_off += C2 * mE2
                pi_off += C2 * mI2
            self._nD_final = int(cur.size)

    def _dev(self):
        """Device index along the mesh axis (0 when undistributed)."""
        if self.axis is None:
            return 0
        return jax.lax.axis_index(self.axis)

    def _slice_groups(self, arr):
        """Slice the local groups out of a replicated [G_total, ...] array."""
        if self.axis is None:
            return arr
        z = jnp.zeros((), jnp.int32)
        start = (jnp.asarray(self._dev() * self.G_loc, jnp.int32),) \
            + (z,) * (arr.ndim - 1)
        return jax.lax.dynamic_slice(arr, start,
                                     (self.G_loc,) + arr.shape[1:])

    def _scatter_groups(self, arr_loc, g_total):
        """Local [G_loc, ...] -> replicated [G_total, ...] via psum."""
        if self.axis is None:
            return arr_loc
        full = jnp.zeros((g_total,) + arr_loc.shape[1:], arr_loc.dtype)
        z = jnp.zeros((), jnp.int32)
        start = (jnp.asarray(self._dev() * self.G_loc, jnp.int32),) \
            + (z,) * (arr_loc.ndim - 1)
        full = jax.lax.dynamic_update_slice(full, arr_loc, start)
        return jax.lax.psum(full, self.axis)

    # -- layout helpers ------------------------------------------------
    def _split_link(self, vec, which: str):
        """Permuted link vector -> (locals [G, mL], globals [mG])."""
        m = self.meta
        if which == "E":
            mL, cnt = m.mElL, m.n_groups * m.mElL
        else:
            mL, cnt = m.mIlL, m.n_groups * m.mIlL
        loc = vec[:cnt].reshape(m.n_groups, mL)
        return loc, vec[cnt:]

    def _join_link(self, loc, glob):
        return jnp.concatenate([loc.reshape(-1), glob])

    # ------------------------------------------------------------------
    def factorize(self, Dx: XVec, Ominv: RVec, delta_p, delta_d
                  ) -> HierFactors:
        lp = self.lp
        m = self.meta
        fd = self.factor_dtype
        G, Ng = m.n_groups, m.group_size
        gl = self.G_loc
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mE, mI, n = lp.mE, lp.mI, lp.n
        a = mE + mI
        k = n + a
        mL = m.mElL + m.mIlL
        nSo = n0 + m.mElG + m.mIlG
        dt = Dx.blocks.dtype

        # ---- level 0: leaf condensation (same as flat backend) ----
        Einv = 1.0 / (Dx.blocks + delta_p)
        Om = 1.0 / Ominv.blocks
        M = jnp.concatenate([lp.B, lp.D], axis=1)                # [N, a, n]
        Fd = jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(delta_d, dt), (lp.N, mE)),
            Om + delta_d], axis=1)
        MEi = M * Einv[:, None, :]
        L, Ninv, leaf_ok = self._leaf_factor(M, MEi, Fd)

        # split permuted link strips into per-group locals + globals:
        # reshape the block axis into (G_loc, Ng) and the local-link rows
        # into (G, mElL); local rows of a group only touch that group's
        # blocks, so take the (offset) diagonal pairing
        F_l, G_l = self._local_strips()          # [G_loc, Ng, m_local, n]
        F_g = lp.F[:, G * m.mElL:, :]                            # [N,mElG,n]
        G_g = lp.G[:, G * m.mIlL:, :]

        OmlL_inv, OmlG_inv = self._split_link(Ominv.link, "I")
        OmlL = 1.0 / OmlL_inv                    # [G, mIlL] (replicated)
        OmlG = 1.0 / OmlG_inv
        OmlL_loc = self._slice_groups(OmlL)      # [G_loc, mIlL]

        # ---- level 1: group Schur over local links (collective-free:
        # every group lives entirely on this device) ----
        # R_in rows x_i: [Floc' Gloc']  [G_loc, Ng, n, mL]
        RinX = jnp.concatenate([jnp.swapaxes(F_l, 2, 3),
                                jnp.swapaxes(G_l, 2, 3)], axis=3)
        # K_b^{-1} R_in via condensation (R_in has zero (y,z) rows):
        flatRinX = RinX.reshape(gl * Ng, n, mL)
        EiR = flatRinX * Einv[:, :, None]
        rhsW = jnp.einsum("iam,imS->iaS", M.astype(fd), EiR.astype(fd))
        Wm = self._apply_Ninv_multi(L, Ninv, rhsW)               # [N, a, mL]
        Wx = EiR.astype(fd) - Einv.astype(fd)[:, :, None] * jnp.einsum(
            "iam,iaS->imS", M.astype(fd), Wm)
        Win = jnp.concatenate([Wx, Wm], axis=1)                  # [N, k, mL]

        # local Schur: Sloc = -Floc_diag - R_in' K_b^{-1} R_in
        RtW = jnp.einsum("imS,imT->iST", flatRinX.astype(fd), Wx)  # [N,mL,mL]
        RtW = RtW.reshape(gl, Ng, mL, mL).sum(axis=1)          # [G_loc,mL,mL]
        # padded eq rows (permE == -1) are decoupled; give them a UNIT
        # diagonal so a zero delta_d (e.g. the Ipopt strategy's fresh
        # steps) cannot produce a zero pivot that poisons the solve
        padE = jnp.asarray(
            (m.permE[:G * m.mElL] < 0).reshape(G, m.mElL), dt)
        padE_loc = self._slice_groups(padE)
        FlocD = jnp.concatenate([
            jnp.asarray(delta_d, dt) + padE_loc,
            OmlL_loc + delta_d], axis=1)                         # [G_loc, mL]
        negSloc = jax.vmap(jnp.diag)(FlocD.astype(fd)) + RtW
        Lloc = jnp.linalg.cholesky(negSloc)                  # [G_loc, mL, mL]

        # ---- outer border W_out = K_inner^{-1} R_out ----
        # R_out block rows: x_i: [0 | Fg' Gg'], y_i: [A 0], z_i: [C 0]
        RoX = jnp.concatenate([
            jnp.zeros((lp.N, n, n0), dt),
            jnp.swapaxes(F_g, 1, 2), jnp.swapaxes(G_g, 1, 2)], axis=2)
        RoM = jnp.concatenate([
            jnp.concatenate([lp.A, jnp.zeros((lp.N, mE, nSo - n0), dt)], 2),
            jnp.concatenate([lp.C, jnp.zeros((lp.N, mI, nSo - n0), dt)], 2)],
            axis=1)                                              # [N, a, nSo]
        # R_out local-link rows: yl_loc: [F0loc | 0], zl_loc: [G0loc | 0]
        F0loc = self._slice_groups(
            lp.F0[:G * m.mElL].reshape(G, m.mElL, n0))
        G0loc = self._slice_groups(
            lp.G0[:G * m.mIlL].reshape(G, m.mIlL, n0))
        RoL = jnp.concatenate([
            jnp.concatenate([F0loc,
                             jnp.zeros((gl, m.mElL, nSo - n0), dt)], 2),
            jnp.concatenate([G0loc,
                             jnp.zeros((gl, m.mIlL, nSo - n0), dt)], 2)],
            axis=1)                                          # [G_loc,mL,nSo]

        # block-level K_b^{-1} R_out (condensed, multi-RHS)
        EiRo = RoX * Einv[:, :, None]
        rhsO = (jnp.einsum("iam,imS->iaS", M.astype(fd), EiRo.astype(fd))
                - RoM.astype(fd))
        WmO = self._apply_Ninv_multi(L, Ninv, rhsO)              # [N, a, nSo]
        WxO = EiRo.astype(fd) - Einv.astype(fd)[:, :, None] * jnp.einsum(
            "iam,iaS->imS", M.astype(fd), WmO)
        gB = jnp.concatenate([WxO, WmO], axis=1)                 # [N, k, nSo]

        # local-link correction: w = -negSloc^{-1} (RoL - R_in' gB_x)
        RtG = jnp.einsum("imS,imT->iST", flatRinX.astype(fd), WxO)
        RtG = RtG.reshape(gl, Ng, mL, nSo).sum(axis=1)       # [G_loc,mL,nSo]
        rhsL = RoL.astype(fd) - RtG
        WoutL = -_bchol_solve(Lloc, rhsL)                        # [G, mL, nSo]
        # u = gB - Win*w  (per block, group-shared w)
        w_per_block = jnp.repeat(WoutL, Ng, axis=0)              # [N, mL, nSo]
        WoutB = gB - jnp.einsum("ikS,iST->ikT", Win, w_per_block)

        # ---- outer Schur contribution: -(RoX'u_x + RoM'u_m + RoL'w) ----
        contrib = (jnp.einsum("imS,imT->ST", RoX.astype(fd),
                              WoutB[:, :n, :])
                   + jnp.einsum("iaS,iaT->ST", RoM.astype(fd),
                                WoutB[:, n:, :])
                   + jnp.einsum("gmS,gmT->ST", RoL.astype(fd), WoutL))
        # the SC allreduce (reference chunked MPI_Allreduce,
        # DistributedRootLinearSystem.C:860-975)
        contrib = self._psum(contrib).astype(dt)

        # ---- level 2: root over (x0, y0, z0, ylG, zlG) ----
        Einv0 = 1.0 / (Dx.first + delta_p)
        Om0 = 1.0 / Ominv.first
        F0g = lp.F0[G * m.mElL:]
        G0g = lp.G0[G * m.mIlL:]
        nD = m0E + m0I + m.mElG + m.mIlG

        S11 = jnp.diag(Dx.first + delta_p) - contrib[:n0, :n0]
        S12 = jnp.zeros((n0, nD), dt)
        S12 = S12.at[:, :m0E].set(lp.A0.T)
        S12 = S12.at[:, m0E:m0E + m0I].set(lp.C0.T)
        S12 = S12.at[:, m0E + m0I:m0E + m0I + m.mElG].set(
            F0g.T - contrib[:n0, n0:n0 + m.mElG])
        S12 = S12.at[:, m0E + m0I + m.mElG:].set(
            G0g.T - contrib[:n0, n0 + m.mElG:])
        F0d = jnp.concatenate([
            jnp.full((m0E,), delta_d, dt), Om0 + delta_d,
            jnp.full((m.mElG,), delta_d, dt), OmlG + delta_d])
        S22 = -jnp.diag(F0d)
        S22 = S22.at[m0E + m0I:, m0E + m0I:].add(
            -contrib[n0:, n0:])

        extra = {}
        coarse_ok = jnp.asarray(True)
        if self._lvl:
            # ---- deeper layers: eliminate each level's coarse-local
            # rows of the top dual block BEFORE the dense factorization,
            # finest level first.  Cross-group Schur entries within a
            # level are exactly zero — disjoint block support, preserved
            # under the finer levels' downdates because a finer group
            # lies inside exactly one coarser group — so each level is
            # one [C, k2, k2] batched Cholesky instead of its share of
            # the dense root cube (the reference's recursive splitTree,
            # DistributedTreeCallbacks.C:1123,1194-1217). ----
            S11f = S11.astype(fd)
            S12f = S12.astype(fd)
            S22f = S22.astype(fd)
            L2s, U1s, U2s = [], [], []
            for (idxc, idxr, pad, _sz) in self._lvl:
                Scc = S22f[idxc[:, :, None], idxc[:, None, :]]  # [C,k2,k2]
                negS2 = -Scc + jax.vmap(jnp.diag)(pad.astype(fd))
                L2 = jnp.linalg.cholesky(negS2)
                U1 = jnp.swapaxes(S12f[:, idxc], 0, 1)        # [C, n0, k2]
                U2 = jnp.swapaxes(S22f[idxr][:, idxc], 0, 1)  # [C, nr, k2]
                W1 = _bchol_solve(L2, jnp.swapaxes(U1, 1, 2))
                W2 = _bchol_solve(L2, jnp.swapaxes(U2, 1, 2))
                # Scc is negative definite, so the downdate ADDS the PSD
                # U negS2^{-1} U' terms (see _root_solve)
                S11f = S11f + jnp.einsum("cnk,ckm->nm", U1, W1)
                S12f = S12f[:, idxr] + jnp.einsum("cnk,ckr->nr", U1, W2)
                S22f = S22f[idxr][:, idxr] + jnp.einsum("crk,cks->rs",
                                                        U2, W2)
                coarse_ok = coarse_ok & jnp.all(jnp.isfinite(L2))
                L2s.append(L2)
                U1s.append(U1.astype(dt))
                U2s.append(U2.astype(dt))
            S11, S12, S22 = S11f, S12f, S22f
            nD = self._nD_final
            extra = dict(L2=tuple(L2s), U1=tuple(U1s), U2=tuple(U2s))

        chol1 = jnp.linalg.cholesky(S11.astype(fd))
        if self.dist_root:
            # distribute the top dual-Schur factorization over the SAME
            # mesh axis that shards the groups (the reference runs MUMPS
            # dist roots under hierarchy): column-shard Sdual, panel-
            # blocked distributed Cholesky inverse (linalg/dist_root.py)
            from pips_ipmpp_tpu.linalg.dist_root import (dist_chol_inverse,
                                                         own_slice)
            if nD % self.n_shards:
                raise ValueError(
                    f"hier dist_root: top dual Schur dim nD={nD} must be "
                    f"divisible by n_shards={self.n_shards}; pad the "
                    "global linking rows")
            S12f = S12.astype(fd)
            S12_cols = own_slice(S12f, self.axis, self.n_shards)
            T_cols = _spd_solve(chol1, S12_cols)          # [n0, nDp]
            S22_cols = own_slice(S22.astype(fd), self.axis, self.n_shards)
            Sdual_cols = -(S22_cols - S12f.T @ T_cols)    # [nD, nDp]
            Wd, root_ok = dist_chol_inverse(Sdual_cols, self.axis,
                                            self.n_shards)
            return HierFactors(
                L=L, Einv=Einv, Om=Om, Lloc=Lloc,
                Win=Win.astype(dt), WoutB=WoutB.astype(dt),
                WoutL=WoutL.astype(dt),
                chol1=chol1, T=T_cols.astype(dt), chol2=jnp.zeros((), fd),
                Einv0=Einv0, Om0=Om0, OmlG=OmlG, OmlL=OmlL,
                delta_p=jnp.asarray(delta_p),
                delta_d=jnp.asarray(delta_d, dt),
                Ninv=Ninv, leaf_ok=leaf_ok, Wd=Wd,
                root_ok=(root_ok & coarse_ok
                         & jnp.all(jnp.isfinite(chol1))), **extra)
        T = _spd_solve(chol1, S12.astype(fd))
        Sdual = -(S22.astype(fd) - S12.astype(fd).T @ T)
        chol2 = jnp.linalg.cholesky(Sdual)

        return HierFactors(
            L=L, Einv=Einv, Om=Om, Lloc=Lloc,
            Win=Win.astype(dt), WoutB=WoutB.astype(dt),
            WoutL=WoutL.astype(dt),
            chol1=chol1, T=T.astype(dt), chol2=chol2,
            Einv0=Einv0, Om0=Om0, OmlG=OmlG, OmlL=OmlL,
            delta_p=jnp.asarray(delta_p), delta_d=jnp.asarray(delta_d, dt),
            Ninv=Ninv, leaf_ok=leaf_ok, root_ok=coarse_ok, **extra)

    def _root_solve(self, fac, p, q):
        """Top solve; with deeper layers, eliminate each level's coarse
        rows (finest first), solve the reduced dense system (parent
        path), then back-substitute level by level in reverse:
        dc = -negS2^{-1}(qc - U1' a - U2' dr)."""
        if not self._lvl or not len(fac.L2):
            return super()._root_solve(fac, p, q)
        fd = self.factor_dtype
        dt = q.dtype
        stages = list(zip(self._lvl, fac.L2, fac.U1, fac.U2))
        qcs = []
        p_cur = p.astype(fd)
        q_cur = q.astype(fd)
        for (idxc, idxr, _pad, _sz), L2, U1, U2 in stages:
            U1f, U2f = U1.astype(fd), U2.astype(fd)
            qc = q_cur[idxc]                               # [C, k2]
            t = _bchol_solve(L2, qc[..., None])[..., 0]    # negS2^{-1} qc
            p_cur = p_cur + jnp.einsum("cnk,ck->n", U1f, t)
            q_cur = q_cur[idxr] + jnp.einsum("crk,ck->r", U2f, t)
            qcs.append(qc)
        a, d = super()._root_solve(fac, p_cur.astype(dt), q_cur.astype(dt))
        af = a.astype(fd)
        d = d.astype(fd)
        for ((idxc, idxr, _pad, sz), L2, U1, U2), qc in zip(
                reversed(stages), reversed(qcs)):
            U1f, U2f = U1.astype(fd), U2.astype(fd)
            rhs = (qc - jnp.einsum("cnk,n->ck", U1f, af)
                   - jnp.einsum("crk,r->ck", U2f, d))
            dc = -_bchol_solve(L2, rhs[..., None])[..., 0]
            full = jnp.zeros((sz,), fd)
            full = full.at[idxr].set(d)
            full = full.at[idxc.reshape(-1)].set(dc.reshape(-1))
            d = full
        return a, d.astype(dt)

    def factorization_ok(self, fac: HierFactors) -> jax.Array:
        ok = (fac.leaf_ok & fac.root_ok
              & jnp.all(jnp.isfinite(fac.L))
              & jnp.all(jnp.isfinite(fac.Lloc))
              & jnp.all(jnp.isfinite(fac.chol1))
              & jnp.all(jnp.isfinite(fac.chol2)))
        if self.axis is not None:
            ok = jax.lax.pmin(ok.astype(jnp.int32), self.axis) > 0
        return ok

    # ------------------------------------------------------------------
    def solve_reduced(self, fac: HierFactors, rhs: ReducedRhs,
                      refinement_steps: int = 1):
        lp = self.lp
        m = self.meta
        G, Ng = m.n_groups, m.group_size
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mE, mI, n = lp.mE, lp.mI, lp.n
        mL = m.mElL + m.mIlL

        rho_x0 = -rhs.rhat_x.first
        rho_x = -rhs.rhat_x.blocks
        rho_m = jnp.concatenate([-rhs.rA.blocks, -rhs.rhat_z.blocks], axis=1)
        rAl_loc, rAl_glob = self._split_link(-rhs.rA.link, "E")
        rzl_loc, rzl_glob = self._split_link(-rhs.rhat_z.link, "I")
        rho_lnk = jnp.concatenate([rAl_loc, rzl_loc], axis=1)     # [G, mL]
        q0 = jnp.concatenate([-rhs.rA.first, -rhs.rhat_z.first,
                              rAl_glob, rzl_glob])

        sol = self._solve_core_hier(fac, rho_x0, q0, rho_x, rho_m, rho_lnk)

        def err_norm(s):
            err = self._residual_hier(fac, rho_x0, q0, rho_x, rho_m,
                                      rho_lnk, s)
            nrm = jnp.max(jnp.stack(
                [jnp.max(jnp.abs(e)) if e.size else jnp.zeros((), dt)
                 for e in jax.tree.leaves(err)]))
            if self.axis is not None:
                nrm = jax.lax.pmax(nrm, self.axis)
            return err, nrm

        if refinement_steps > 0:
            # keep-better refinement (mirrors ArrowBackend.solve_reduced):
            # an f32-factor correction can DIVERGE; keep the better
            # iterate and stop when no longer improving
            dt = rho_x.dtype
            err0, nrm0 = err_norm(sol)

            def cond(carry):
                s, err, k, nrm, prev = carry
                return (k < refinement_steps) & (nrm > 1e-12) \
                    & (nrm < 0.5 * prev)

            def body(carry):
                s, err, k, nrm, _prev = carry
                corr = self._solve_core_hier(fac, *err)
                new = jax.tree.map(lambda a, b: a + b, s, corr)
                err2, nrm2 = err_norm(new)
                worse = nrm2 > nrm
                keep = jax.tree.map(
                    lambda a, b: jnp.where(worse, a, b), s, new)
                return (keep, err2, k + 1,
                        jnp.where(worse, nrm, nrm2), nrm)

            sol, _, _, _, _ = jax.lax.while_loop(
                cond, body, (sol, err0, jnp.zeros((), jnp.int32), nrm0,
                             jnp.asarray(jnp.inf, nrm0.dtype)))

        dx0, dxb, d0, gm, wl = sol
        # wl: [G, mL] local-link duals (hat sign); rebuild permuted link vec
        ylh_loc = wl[:, :m.mElL]
        zlh_loc = wl[:, m.mElL:]
        ylh = self._join_link(ylh_loc, d0[m0E + m0I:m0E + m0I + m.mElG])
        zlh = self._join_link(zlh_loc, d0[m0E + m0I + m.mElG:])
        yhat = RVec(d0[:m0E], gm[:, :mE], ylh)
        zhat = RVec(d0[m0E:m0E + m0I], gm[:, mE:], zlh)
        dx = XVec(dx0, dxb)
        return dx, jax.tree.map(lambda v: -v, yhat), \
            jax.tree.map(lambda v: -v, zhat)

    # ------------------------------------------------------------------
    def solve_reduced_bicgstab(self, fac: HierFactors, rhs: ReducedRhs,
                               max_iters: int = 8, tol: float = 1e-10):
        """Outer BiCGStab in the hierarchical state layout
        (x0, xb, d0_root, gm, wl_local)."""
        lp = self.lp
        m = self.meta
        m0E, m0I = lp.m0E, lp.m0I
        mE = lp.mE

        rAl_loc, rAl_glob = self._split_link(-rhs.rA.link, "E")
        rzl_loc, rzl_glob = self._split_link(-rhs.rhat_z.link, "I")
        # canonical state order (matches _solve_core_hier OUTPUT and the
        # `sol` argument of _residual_hier): (x0, xb, d0, gm, wl)
        b = (-rhs.rhat_x.first,
             -rhs.rhat_x.blocks,
             jnp.concatenate([-rhs.rA.first, -rhs.rhat_z.first,
                              rAl_glob, rzl_glob]),
             jnp.concatenate([-rhs.rA.blocks, -rhs.rhat_z.blocks], axis=1),
             jnp.concatenate([rAl_loc, rzl_loc], axis=1))

        def precond(v):
            x0, xb, d0, gm, wl = v
            # _solve_core_hier takes rhs in arg order (p0, q0, rx, rm, rl)
            return self._solve_core_hier(fac, x0, d0, xb, gm, wl)

        def applyK(v):
            x0, xb, d0, gm, wl = v
            zeros = (jnp.zeros_like(x0), jnp.zeros_like(d0),
                     jnp.zeros_like(xb), jnp.zeros_like(gm),
                     jnp.zeros_like(wl))
            err = self._residual_hier(fac, *zeros, v)
            # err = 0 - K.v in arg order (ex0, eq0, ex, em, el)
            ex0, eq0, ex, em, el = err
            return (-ex0, -ex, -eq0, -em, -el)

        def dot(a, c):
            ax0, axb, ad0, agm, awl = a
            cx0, cxb, cd0, cgm, cwl = c
            rep = (jnp.vdot(ax0, cx0) + jnp.vdot(ad0, cd0)
                   + jnp.vdot(awl, cwl))
            shard = jnp.vdot(axb, cxb) + jnp.vdot(agm, cgm)
            return rep + self._psum(shard)

        u, stats = preconditioned_bicgstab(b, precond, applyK, dot,
                                           max_iters, tol)

        dx0, dxb, d0, gm, wl = u
        ylh = self._join_link(wl[:, :m.mElL],
                              d0[m0E + m0I:m0E + m0I + m.mElG])
        zlh = self._join_link(wl[:, m.mElL:], d0[m0E + m0I + m.mElG:])
        yhat = RVec(d0[:m0E], gm[:, :mE], ylh)
        zhat = RVec(d0[m0E:m0E + m0I], gm[:, mE:], zlh)
        dx = XVec(dx0, dxb)
        return dx, jax.tree.map(lambda v_: -v_, yhat), \
            jax.tree.map(lambda v_: -v_, zhat), stats

    # ------------------------------------------------------------------
    def _solve_core_hier(self, fac: HierFactors, p0, q0, rho_x, rho_m,
                         rho_lnk):
        """Three-level Lsolve/Dsolve/Ltsolve."""
        lp = self.lp
        m = self.meta
        G, Ng = m.n_groups, m.group_size
        gl = self.G_loc
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mE, n = lp.mE, lp.n
        mL = m.mElL + m.mIlL
        fd = self.factor_dtype

        M = jnp.concatenate([lp.B, lp.D], axis=1)
        # level 0: leaf solves
        t = jnp.einsum("iam,im->ia", M, fac.Einv * rho_x) - rho_m
        gm = self._apply_Ninv_multi(fac.L, fac.Ninv,
                                    t[..., None].astype(fd))[..., 0]
        gm = gm.astype(rho_x.dtype)
        gx = fac.Einv * (rho_x - jnp.einsum("iam,ia->im", M, gm))
        gk = jnp.concatenate([gx, gm], axis=1)                   # [N, k]

        # level 1: local-link solve per LOCAL group (no collectives)
        # r_l - R_in' g_x ; R_in' has only x rows
        F_l, G_l = self._local_strips()
        RtG = (jnp.einsum("gimn,gin->gm", F_l,
                          gx.reshape(gl, Ng, n))
               if m.mElL else jnp.zeros((gl, 0), gx.dtype))
        RtG2 = (jnp.einsum("gimn,gin->gm", G_l,
                           gx.reshape(gl, Ng, n))
                if m.mIlL else jnp.zeros((gl, 0), gx.dtype))
        rl = self._slice_groups(rho_lnk) - jnp.concatenate(
            [RtG, RtG2], axis=1)                                 # [G_loc,mL]
        wl = -_bchol_solve(fac.Lloc, rl[..., None].astype(fd))[..., 0]
        wl = wl.astype(gx.dtype)                                 # [G_loc,mL]
        # back-substitute local links into blocks
        wl_pb = jnp.repeat(wl, Ng, axis=0)                       # [N_loc,mL]
        gk = gk - jnp.einsum("ikS,iS->ik", fac.Win, wl_pb)
        gx, gm = gk[:, :n], gk[:, n:]

        # accumulate outer border products (psum = linking RHS allreduce,
        # sLinsysRootAug.C:340-341)
        # R_out' g = [A' g_y + C' g_z (+ F0loc' wl etc for x0) | Fg g_x |...]
        acc_x0 = (jnp.einsum("imk,im->k", lp.A, gm[:, :mE])
                  + jnp.einsum("imk,im->k", lp.C, gm[:, mE:]))
        F0loc = self._slice_groups(
            lp.F0[:G * m.mElL].reshape(G, m.mElL, n0))
        G0loc = self._slice_groups(
            lp.G0[:G * m.mIlL].reshape(G, m.mIlL, n0))
        acc_x0 = acc_x0 + jnp.einsum("gmk,gm->k", F0loc, wl[:, :m.mElL]) \
            + jnp.einsum("gmk,gm->k", G0loc, wl[:, m.mElL:])
        F_g = lp.F[:, G * m.mElL:, :]
        G_g = lp.G[:, G * m.mIlL:, :]
        acc_yl = jnp.einsum("ilm,im->l", F_g, gx)
        acc_zl = jnp.einsum("ilm,im->l", G_g, gx)
        acc_x0 = self._psum(acc_x0)
        acc_yl = self._psum(acc_yl)
        acc_zl = self._psum(acc_zl)

        p = p0 - acc_x0
        q = q0.at[m0E + m0I:m0E + m0I + m.mElG].add(-acc_yl)
        q = q.at[m0E + m0I + m.mElG:].add(-acc_zl)

        # level 2: root (replicated)
        a, d = self._root_solve(fac, p, q)

        # back-substitution: s0out = [a, ylG, zlG]
        s0 = jnp.concatenate([a, d[m0E + m0I:m0E + m0I + m.mElG],
                              d[m0E + m0I + m.mElG:]])
        gk = jnp.concatenate([gx, gm], axis=1)
        gk = gk - jnp.einsum("ikS,S->ik", fac.WoutB, s0)
        wl = wl - jnp.einsum("gmS,S->gm", fac.WoutL, s0)
        # local-link duals back to the replicated layout
        wl = self._scatter_groups(wl, G)
        return a, gk[:, :n], d, gk[:, n:], wl

    def _local_strips(self):
        """Per-LOCAL-group local link strips, shape [G_loc, Ng, m_local, n].

        The link-row axis still spans all G_total groups (link data is
        replicated); the block axis holds only this device's G_loc groups,
        so the diagonal pairing is offset by dev * G_loc."""
        lp = self.lp
        m = self.meta
        G, Ng, n = m.n_groups, m.group_size, lp.n
        gl = self.G_loc
        off = self._dev() * gl
        gidx = jnp.arange(gl)
        F_l = lp.F[:, :G * m.mElL, :].reshape(gl, Ng, G, m.mElL, n)
        F_l = F_l[gidx, :, off + gidx]
        G_l = lp.G[:, :G * m.mIlL, :].reshape(gl, Ng, G, m.mIlL, n)
        G_l = G_l[gidx, :, off + gidx]
        return F_l, G_l

    def _residual_hier(self, fac: HierFactors, p0, q0, rho_x, rho_m,
                       rho_lnk, sol):
        """rhs - K.sol for the full system in hierarchical layout."""
        lp = self.lp
        m = self.meta
        G = m.n_groups
        n0, m0E, m0I = lp.n0, lp.m0E, lp.m0I
        mE = lp.mE
        dx0, dxb, d0, gm, wl = sol
        dd = fac.delta_d

        ylh = self._join_link(wl[:, :m.mElL],
                              d0[m0E + m0I:m0E + m0I + m.mElG])
        zlh = self._join_link(wl[:, m.mElL:], d0[m0E + m0I + m.mElG:])
        yh = RVec(d0[:m0E], gm[:, :mE], ylh)
        zh = RVec(d0[m0E:m0E + m0I], gm[:, mE:], zlh)
        x = XVec(dx0, dxb)

        ATyh = self.ATy(yh)
        CTzh = self.CTz(zh)
        Ax = self.Ax(x)
        Cx = self.Cx(x)

        E0 = 1.0 / fac.Einv0
        Eb = 1.0 / fac.Einv
        ex0 = p0 - (E0 * dx0 + ATyh.first + CTzh.first)
        ex = rho_x - (Eb * dxb + ATyh.blocks + CTzh.blocks)
        eq_b = Ax.blocks - dd * gm[:, :mE]
        iq_b = Cx.blocks - (fac.Om + dd) * gm[:, mE:]
        em = rho_m - jnp.concatenate([eq_b, iq_b], axis=1)

        # link rows (permuted layout)
        eql = Ax.link - dd * ylh
        OmlL_flat = fac.OmlL.reshape(-1)
        Oml_full = jnp.concatenate([OmlL_flat, fac.OmlG])
        iql = Cx.link - (Oml_full + dd) * zlh
        eql_loc, eql_glob = self._split_link(eql, "E")
        iql_loc, iql_glob = self._split_link(iql, "I")
        el_loc = rho_lnk - jnp.concatenate([eql_loc, iql_loc], axis=1)

        eq0 = Ax.first - dd * d0[:m0E]
        iq0 = Cx.first - (fac.Om0 + dd) * d0[m0E:m0E + m0I]
        eq0_full = q0 - jnp.concatenate([eq0, iq0, eql_glob, iql_glob])
        return ex0, eq0_full, ex, em, el_loc
