r"""Primal-dual IPM formulation: iterate, residuals, KKT reduction, recovery.

Backend-generic: every quantity is a pytree whose leaves are either flat
arrays (dense path) or XVec/RVec space vectors (arrowhead path); elementwise
work is `jax.tree.map`, reductions go through core.spaces, and matrix-vector
products go through a backend object.  This replaces the reference's
Variables/Residuals class pair (Core/KKTFormulation/Variables/Variables.h:37-72,
Residuals/Residuals.h:50-94) and the RHS block-elimination in
LinearSystem::solve (Core/KKTFormulation/LinearSystems/LinearSystem.C:327-448).

Derivation (LP; QP term structurally absent as in the reference's LP mode):

    min c'x  s.t.  Ax=b,  clow <= Cx <= cupp,  xlow <= x <= xupp

introduce slack s = Cx and nonneg gaps/duals (masked by indicators):
    v = x - xlow >= 0  dual gamma >= 0        w = xupp - x >= 0  dual phi >= 0
    t = s - clow >= 0  dual lambda >= 0       u = cupp - s >= 0  dual pi  >= 0
    y free (Ax=b),     z free (Cx-s=0),       z = lambda - pi at optimality

KKT residuals (driven to zero):
    rL = c - A'y - C'z - gamma + phi                  [x-space]
    rA = Ax - b                                       [eq rows]
    rC = Cx - s                                       [ineq rows]
    rz = z - lambda + pi                              [ineq rows]
    rv = ixlow*(x - xlow - v)     rw = ixupp*(xupp - x - w)
    rt = iclow*(s - clow - t)     ru = icupp*(cupp - s - u)
    complementarity:  v.gamma, w.phi, t.lambda, u.pi  -> targets (sigma*mu etc.)

Newton elimination of (v,w,t,u,gamma,phi,lambda,pi,s) yields the symmetric
quasidefinite *augmented system* in (dx, yhat, zhat) with yhat=-dy, zhat=-dz:

    [ Dx+dp    A'      C'        ] [dx  ]   [ -rhat_x ]
    [ A       -dd I    0         ] [yhat] = [ -rA     ]
    [ C        0      -(Om+dd I) ] [zhat]   [ -rhat_z ]

    Dx    = ixlow*gamma/v + ixupp*phi/w              (diagonal, x-space)
    Ominv = iclow*lambda/t + icupp*pi/u              (diagonal, ineq rows, > 0)
    Om    = 1/Ominv
    rhat_x  = rL + ixlow*(rG + gamma*rv)/v - ixupp*(rP + phi*rw)/w
    rbar_z  = rz + iclow*(rLam + lambda*rt)/t - icupp*(rPi + pi*ru)/u
    rhat_z  = rC + Om * rbar_z

where (rG, rP, rLam, rPi) are the complementarity right-hand sides of the
current solve (affine: v*gamma; corrector: v*gamma + dv_aff*dgamma_aff -
sigma*mu; etc.).  Because the (1,1) block is diagonal for an LP, the system
condenses to SPD normal equations (M E^{-1} M' + F) d = M E^{-1} rho_x -
rho_m — one batched Cholesky over all blocks (the role of PARDISO's
LDL', PardisoSchurSolver.C).

Recovery (signs per the derivation above):
    dy = -yhat, dz = -zhat
    ds      = -Om * (dz + rbar_z)
    dv      = dx + rv                dw = rw - dx
    dt      = ds + rt                du = ru - ds
    dgamma  = -(rG + gamma*dv)/v     dphi    = -(rP   + phi*dw)/w
    dlambda = -(rLam + lambda*dt)/t  dpi     = -(rPi  + pi*du)/u
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from pips_ipmpp_tpu.core import spaces
from pips_ipmpp_tpu.core.lp import _register


@_register
@dataclass
class Iterate:
    """The 12 iterate vectors (reference Variables.h:52-67)."""
    x: object          # x-space
    s: object          # ineq-row space
    y: object          # eq-row space
    z: object          # ineq-row space
    v: object          # x-space  (x - xlow)
    w: object          # x-space  (xupp - x)
    t: object          # ineq     (s - clow)
    u: object          # ineq     (cupp - s)
    gamma: object      # x-space  dual of v
    phi: object        # x-space  dual of w
    lam: object        # ineq     dual of t
    pi: object         # ineq     dual of u


@_register
@dataclass
class Bounds:
    """Problem bound data in generic spaces (masks are 0/1 floats)."""
    c: object
    b: object
    ixlow: object
    xlow: object
    ixupp: object
    xupp: object
    iclow: object
    clow: object
    icupp: object
    cupp: object


@_register
@dataclass
class Residuals:
    """KKT residuals (reference Residuals.h:76-87)."""
    rL: object
    rA: object
    rC: object
    rz: object
    rv: object
    rw: object
    rt: object
    ru: object


@_register
@dataclass
class CompRhs:
    """Complementarity right-hand sides for one Newton solve."""
    rG: object         # pairs (v, gamma)
    rP: object         # pairs (w, phi)
    rLam: object       # pairs (t, lam)
    rPi: object        # pairs (u, pi)


tmap = jax.tree.map


# ======================================================================
# Residuals & merit quantities
# ======================================================================

def compute_residuals(be, it: Iterate) -> Residuals:
    """Evaluate KKT residuals (reference Residuals::evaluate,
    Residuals.cpp:58-150 — distributed matvecs happen inside the backend)."""
    bd = be.bounds
    Ax = be.Ax(it.x)
    Cx = be.Cx(it.x)
    ATy = be.ATy(it.y)
    CTz = be.CTz(it.z)
    rL = tmap(lambda c, a, cz, g, p: c - a - cz - g + p,
              bd.c, ATy, CTz, it.gamma, it.phi)
    rA = tmap(lambda ax, b: ax - b, Ax, bd.b)
    rC = tmap(lambda cx, s: cx - s, Cx, it.s)
    rz = tmap(lambda z, l, p: z - l + p, it.z, it.lam, it.pi)
    rv = tmap(lambda m, x, lo, v: m * (x - lo - v), bd.ixlow, it.x, bd.xlow, it.v)
    rw = tmap(lambda m, x, up, w: m * (up - x - w), bd.ixupp, it.x, bd.xupp, it.w)
    rt = tmap(lambda m, s, lo, t: m * (s - lo - t), bd.iclow, it.s, bd.clow, it.t)
    ru = tmap(lambda m, s, up, u: m * (up - s - u), bd.icupp, it.s, bd.cupp, it.u)
    return Residuals(rL, rA, rC, rz, rv, rw, rt, ru)


def residual_norm(res: Residuals, axis=None) -> jax.Array:
    """inf-norm over all residuals."""
    return spaces.norm_inf(res, axis=axis)


def duality_gap(be, it: Iterate) -> jax.Array:
    """Complementarity gap v'gamma + w'phi + t'lambda + u'pi."""
    ax = be.axis
    return (spaces.dot(it.v, it.gamma, ax) + spaces.dot(it.w, it.phi, ax)
            + spaces.dot(it.t, it.lam, ax) + spaces.dot(it.u, it.pi, ax))


def mu(be, it: Iterate) -> jax.Array:
    """Average complementarity (reference Variables::mu, Variables.C:88)."""
    return duality_gap(be, it) / be.num_bound_pairs


def mu_after_step(be, it: Iterate, d: Iterate, alpha_p, alpha_d) -> jax.Array:
    """mu at (it + alpha_p*primal, alpha_d*dual) without forming the trial
    point (reference Variables::mustep_pd, Variables.C:109)."""
    ax = be.axis

    def pair(val, dval, dual, ddual):
        return spaces.dot(tmap(lambda a, b: a + alpha_p * b, val, dval),
                          tmap(lambda a, b: a + alpha_d * b, dual, ddual), ax)

    gap = (pair(it.v, d.v, it.gamma, d.gamma) + pair(it.w, d.w, it.phi, d.phi)
           + pair(it.t, d.t, it.lam, d.lam) + pair(it.u, d.u, it.pi, d.pi))
    return gap / be.num_bound_pairs


# ======================================================================
# Diagonals & RHS assembly for the augmented system
# ======================================================================

def kkt_diagonals(be, it: Iterate):
    """Dx (x-space) and Ominv (ineq-row space); reference
    LinearSystem::computeDiagonals (LinearSystem.C:262-294)."""
    bd = be.bounds
    Dx = tmap(lambda ml, g, v, mu_, p, w: ml * g / v + mu_ * p / w,
              bd.ixlow, it.gamma, it.v, bd.ixupp, it.phi, it.w)
    Ominv = tmap(lambda ml, l, t, mu_, p, u: ml * l / t + mu_ * p / u,
                 bd.iclow, it.lam, it.t, bd.icupp, it.pi, it.u)
    return Dx, Ominv


def comp_rhs_affine(be, it: Iterate) -> CompRhs:
    """Affine (predictor) complementarity rhs: drive pair products to 0."""
    return CompRhs(
        rG=tmap(lambda m, a, b: m * a * b, be.bounds.ixlow, it.v, it.gamma),
        rP=tmap(lambda m, a, b: m * a * b, be.bounds.ixupp, it.w, it.phi),
        rLam=tmap(lambda m, a, b: m * a * b, be.bounds.iclow, it.t, it.lam),
        rPi=tmap(lambda m, a, b: m * a * b, be.bounds.icupp, it.u, it.pi),
    )


def comp_rhs_corrector(be, it: Iterate, d_aff: Iterate, sigma_mu) -> CompRhs:
    """Mehrotra corrector rhs: v*g + dv_aff*dg_aff - sigma*mu."""
    def mk(mask, val, dual, dval, ddual):
        return tmap(lambda m, a, b, da, db:
                    m * (a * b + da * db - sigma_mu), mask, val, dual, dval, ddual)
    bd = be.bounds
    return CompRhs(
        rG=mk(bd.ixlow, it.v, it.gamma, d_aff.v, d_aff.gamma),
        rP=mk(bd.ixupp, it.w, it.phi, d_aff.w, d_aff.phi),
        rLam=mk(bd.iclow, it.t, it.lam, d_aff.t, d_aff.lam),
        rPi=mk(bd.icupp, it.u, it.pi, d_aff.u, d_aff.pi),
    )


def comp_rhs_gondzio(be, it: Iterate, d: Iterate, alpha_p, alpha_d,
                     sigma_mu, beta_min, beta_max) -> CompRhs:
    """Gondzio centrality-corrector rhs (reference
    InteriorPointMethod::compute_gondzio_corrector + project_r3,
    InteriorPointMethod.cpp:236-358, Residuals::project_r3).

    Trial products p = (val + a_p*dval)*(dual + a_d*ddual) are projected onto
    the target box [beta_min*sigma_mu, beta_max*sigma_mu]; the corrector rhs
    is the (clamped) violation."""
    lo = beta_min * sigma_mu
    hi = beta_max * sigma_mu

    def mk(mask, val, dual, dval, ddual):
        def f(m, a, b, da, db):
            p = (a + alpha_p * da) * (b + alpha_d * db)
            target = jnp.clip(p, lo, hi)
            viol = p - target
            # clamp excessive positive violation (reference caps at hi)
            viol = jnp.minimum(viol, hi)
            return m * viol
        return tmap(f, mask, val, dual, dval, ddual)

    bd = be.bounds
    return CompRhs(
        rG=mk(bd.ixlow, it.v, it.gamma, d.v, d.gamma),
        rP=mk(bd.ixupp, it.w, it.phi, d.w, d.phi),
        rLam=mk(bd.iclow, it.t, it.lam, d.t, d.lam),
        rPi=mk(bd.icupp, it.u, it.pi, d.u, d.pi),
    )


@_register
@dataclass
class ReducedRhs:
    """RHS of the augmented system + cached rbar_z for ds recovery."""
    rhat_x: object
    rA: object
    rhat_z: object
    rbar_z: object


def assemble_reduced_rhs(be, it: Iterate, res: Residuals, comp: CompRhs,
                         Ominv) -> ReducedRhs:
    """Block-eliminate bound/slack rows into the compressed (x,y,z) RHS
    (reference LinearSystem::solve elimination, LinearSystem.C:327-448)."""
    bd = be.bounds
    rhat_x = tmap(lambda rl, ml, rg, g, rv, v, mu_, rp, p, rw, w:
                  rl + ml * (rg + g * rv) / v - mu_ * (rp + p * rw) / w,
                  res.rL, bd.ixlow, comp.rG, it.gamma, res.rv, it.v,
                  bd.ixupp, comp.rP, it.phi, res.rw, it.w)
    rbar_z = tmap(lambda rz, ml, rlam, l, rt, t, mu_, rpi, p, ru, u:
                  rz + ml * (rlam + l * rt) / t - mu_ * (rpi + p * ru) / u,
                  res.rz, bd.iclow, comp.rLam, it.lam, res.rt, it.t,
                  bd.icupp, comp.rPi, it.pi, res.ru, it.u)
    rhat_z = tmap(lambda rc, oi, rb: rc + rb / oi, res.rC, Ominv, rbar_z)
    return ReducedRhs(rhat_x=rhat_x, rA=res.rA, rhat_z=rhat_z, rbar_z=rbar_z)


def recover_step(be, it: Iterate, res: Residuals, comp: CompRhs, Ominv,
                 rhs: ReducedRhs, dx, dy, dz) -> Iterate:
    """Recover all 12 step components from (dx, dy, dz)."""
    bd = be.bounds
    ds = tmap(lambda oi, dz_, rb: -(dz_ + rb) / oi, Ominv, dz, rhs.rbar_z)
    dv = tmap(lambda m, a, b: m * (a + b), bd.ixlow, dx, res.rv)
    dw = tmap(lambda m, a, b: m * (b - a), bd.ixupp, dx, res.rw)
    dt = tmap(lambda m, a, b: m * (a + b), bd.iclow, ds, res.rt)
    du = tmap(lambda m, a, b: m * (b - a), bd.icupp, ds, res.ru)
    dgamma = tmap(lambda m, rg, g, dv_, v: -m * (rg + g * dv_) / v,
                  bd.ixlow, comp.rG, it.gamma, dv, it.v)
    dphi = tmap(lambda m, rp, p, dw_, w: -m * (rp + p * dw_) / w,
                bd.ixupp, comp.rP, it.phi, dw, it.w)
    dlam = tmap(lambda m, rl, l, dt_, t: -m * (rl + l * dt_) / t,
                bd.iclow, comp.rLam, it.lam, dt, it.t)
    dpi = tmap(lambda m, rp, p, du_, u: -m * (rp + p * du_) / u,
               bd.icupp, comp.rPi, it.pi, du, it.u)
    return Iterate(x=dx, s=ds, y=dy, z=dz, v=dv, w=dw, t=dt, u=du,
                   gamma=dgamma, phi=dphi, lam=dlam, pi=dpi)


# ======================================================================
# Step bounds (fraction to boundary)
# ======================================================================

def _pair_stepbound(mask, val, dval):
    """Max alpha in (0,1] keeping val + alpha*dval >= 0 where mask=1."""
    def f(m, a, da):
        safe = jnp.where((m > 0) & (da < 0), -a / jnp.where(da < 0, da, -1.0),
                         jnp.inf)
        return safe
    return tmap(f, mask, val, dval)


def step_bounds_pd(be, it: Iterate, d: Iterate):
    """Separate primal/dual max step lengths (reference
    Variables::stepbound_pd / find_blocking_pd via distributed min)."""
    bd = be.bounds
    ax = be.axis
    primal = [
        _pair_stepbound(bd.ixlow, it.v, d.v),
        _pair_stepbound(bd.ixupp, it.w, d.w),
        _pair_stepbound(bd.iclow, it.t, d.t),
        _pair_stepbound(bd.icupp, it.u, d.u),
    ]
    dual = [
        _pair_stepbound(bd.ixlow, it.gamma, d.gamma),
        _pair_stepbound(bd.ixupp, it.phi, d.phi),
        _pair_stepbound(bd.iclow, it.lam, d.lam),
        _pair_stepbound(bd.icupp, it.pi, d.pi),
    ]
    a_p = jnp.minimum(1.0, spaces.min_reduce(primal, ax))
    a_d = jnp.minimum(1.0, spaces.min_reduce(dual, ax))
    return a_p, a_d


def find_blocking(be, it: Iterate, d: Iterate, primal: bool):
    """EXACT blocking-pair extraction (reference find_blocking_pd — the
    distributed minloc pair reduction, DistributedVector.C:702-726,
    find_blocking_partial :654-699).

    Returns (a_max, val_b, dval_b, partner_b, dpartner_b, blocking) where
    a_max = min(1, min ratio), (val_b, dval_b) are the blocking entry and
    its step, (partner_b, dpartner_b) the OTHER side of that pair, and
    `blocking` is False when no pair blocks below 1 (reference
    firstOrSecond == 0).

    Implementation: per-leaf masked argmin + gather, then a leaf-chained
    select; across the mesh axis a pmin of the ratio followed by
    owner-select (lowest device index wins ties) and one psum."""
    bd = be.bounds
    pairs = [
        (bd.ixlow, it.v, d.v, it.gamma, d.gamma),
        (bd.ixupp, it.w, d.w, it.phi, d.phi),
        (bd.iclow, it.t, d.t, it.lam, d.lam),
        (bd.icupp, it.u, d.u, it.pi, d.pi),
    ]
    if not primal:
        pairs = [(m, dual, ddual, val, dval)
                 for (m, val, dval, dual, ddual) in pairs]

    INF = jnp.asarray(jnp.inf, jax.tree.leaves(it.v)[0].dtype)
    best = (INF, 0.0, 0.0, 0.0, 0.0)   # ratio, val, dval, partner, dpartner

    def leaf_candidate(m, a, da, p, dp):
        """(ratio, val, dval, partner, dpartner) at this leaf's argmin."""
        r = jnp.where((m > 0) & (da < 0),
                      -a / jnp.where(da < 0, da, -1.0), jnp.inf).ravel()
        i = jnp.argmin(r)
        return (r[i], a.ravel()[i], da.ravel()[i],
                p.ravel()[i], dp.ravel()[i])

    for (m, val, dval, par, dpar) in pairs:
        leaves = zip(*(jax.tree.leaves(t) for t in (m, val, dval, par, dpar)))
        for (ml, al, dal, pl, dpl) in leaves:
            if ml.size == 0:
                continue
            cand = leaf_candidate(ml, al, dal, pl, dpl)
            take = cand[0] < best[0]
            best = tuple(jnp.where(take, c, b) for c, b in zip(cand, best))

    ratio = best[0]
    if be.axis is not None:
        # global min ratio, then owner-select (lowest device index on ties)
        gmin = jax.lax.pmin(ratio, be.axis)
        dev = jax.lax.axis_index(be.axis)
        nd = jax.lax.psum(1, be.axis)
        is_cand = (ratio == gmin) | (~jnp.isfinite(gmin) & ~jnp.isfinite(ratio))
        owner_dev = jax.lax.pmin(jnp.where(is_cand, dev, nd), be.axis)
        own = is_cand & (dev == owner_dev)
        best = tuple(jax.lax.psum(jnp.where(own, b, 0.0), be.axis)
                     for b in best[1:])
        ratio = gmin
        best = (ratio,) + best

    a_max = jnp.minimum(1.0, ratio)
    blocking = jnp.isfinite(ratio) & (ratio < 1.0)
    return a_max, best[1], best[2], best[3], best[4], blocking


def step_bound_single(be, it: Iterate, d: Iterate):
    """One common step length (PRIMAL step mode)."""
    a_p, a_d = step_bounds_pd(be, it, d)
    a = jnp.minimum(a_p, a_d)
    return a, a


def add_weighted(d: Iterate, corr: Iterate, w_p, w_d) -> Iterate:
    """step.add(corrector, weight_primal, weight_dual): primal components
    scaled by w_p, dual components by w_d (reference Variables::add with
    separate weights, used by the Gondzio loop, InteriorPointMethod.cpp:285,
    306, 317, 331)."""
    prim = dict(x=d.x, s=d.s, v=d.v, w=d.w, t=d.t, u=d.u)
    cprim = dict(x=corr.x, s=corr.s, v=corr.v, w=corr.w, t=corr.t, u=corr.u)
    dual = dict(y=d.y, z=d.z, gamma=d.gamma, phi=d.phi, lam=d.lam, pi=d.pi)
    cdual = dict(y=corr.y, z=corr.z, gamma=corr.gamma, phi=corr.phi,
                 lam=corr.lam, pi=corr.pi)
    newp = tmap(lambda a, b: a + w_p * b, prim, cprim)
    newd = tmap(lambda a, b: a + w_d * b, dual, cdual)
    return Iterate(x=newp["x"], s=newp["s"], y=newd["y"], z=newd["z"],
                   v=newp["v"], w=newp["w"], t=newp["t"], u=newp["u"],
                   gamma=newd["gamma"], phi=newd["phi"],
                   lam=newd["lam"], pi=newd["pi"])


def take_step(it: Iterate, d: Iterate, alpha_p, alpha_d) -> Iterate:
    prim = dict(x=it.x, s=it.s, v=it.v, w=it.w, t=it.t, u=it.u)
    dprim = dict(x=d.x, s=d.s, v=d.v, w=d.w, t=d.t, u=d.u)
    dual = dict(y=it.y, z=it.z, gamma=it.gamma, phi=it.phi, lam=it.lam, pi=it.pi)
    ddual = dict(y=d.y, z=d.z, gamma=d.gamma, phi=d.phi, lam=d.lam, pi=d.pi)
    newp = tmap(lambda a, b: a + alpha_p * b, prim, dprim)
    newd = tmap(lambda a, b: a + alpha_d * b, dual, ddual)
    return Iterate(x=newp["x"], s=newp["s"], y=newd["y"], z=newd["z"],
                   v=newp["v"], w=newp["w"], t=newp["t"], u=newp["u"],
                   gamma=newd["gamma"], phi=newd["phi"],
                   lam=newd["lam"], pi=newd["pi"])


# ======================================================================
# Initial point
# ======================================================================

def initial_iterate(be, shift: float) -> Iterate:
    """Interior starting point: slacks/duals pushed to `shift` where masked,
    1/0 elsewhere (reference Variables::push_to_interior + Solver.cpp:16-31).

    x starts at the projection of 0 into [xlow+shift, xupp-shift] midpoints;
    s starts at the analogous center of the inequality-row bounds (NOT at
    Cx: the initial rC = Cx - s is absorbed by the first affine step)."""
    bd = be.bounds

    def center(mlo, lo, mup, up):
        def f(ml, l, mu_, u):
            both = (ml > 0) & (mu_ > 0)
            mid = jnp.where(both, 0.5 * (l + u),
                            jnp.where(ml > 0, l + shift,
                                      jnp.where(mu_ > 0, u - shift, 0.0)))
            return mid
        return tmap(f, mlo, lo, mup, up)

    x = center(bd.ixlow, bd.xlow, bd.ixupp, bd.xupp)
    s = center(bd.iclow, bd.clow, bd.icupp, bd.cupp)

    def gap(mask, sign_lo, val, bound):
        # max(shift, distance to bound) where masked, else 1
        def f(m, a, b):
            g = sign_lo * (a - b)
            return jnp.where(m > 0, jnp.maximum(shift, g), 1.0)
        return tmap(f, mask, val, bound)

    v = gap(bd.ixlow, +1.0, x, bd.xlow)
    w = gap(bd.ixupp, -1.0, x, bd.xupp)
    t = gap(bd.iclow, +1.0, s, bd.clow)
    u = gap(bd.icupp, -1.0, s, bd.cupp)

    def dual_init(mask):
        return tmap(lambda m: jnp.where(m > 0, shift, 0.0), mask)

    return Iterate(
        x=x, s=s,
        y=spaces.zeros_like(bd.b),
        z=spaces.zeros_like(s),
        v=v, w=w, t=t, u=u,
        gamma=dual_init(bd.ixlow), phi=dual_init(bd.ixupp),
        lam=dual_init(bd.iclow), pi=dual_init(bd.icupp),
    )


def violation(be, it: Iterate) -> jax.Array:
    """Max violation of nonnegativity over masked pairs (for bound shifting,
    reference Variables::violation)."""
    bd = be.bounds
    neg = []
    for mask, val in ((bd.ixlow, it.v), (bd.ixupp, it.w),
                      (bd.iclow, it.t), (bd.icupp, it.u),
                      (bd.ixlow, it.gamma), (bd.ixupp, it.phi),
                      (bd.iclow, it.lam), (bd.icupp, it.pi)):
        neg.append(tmap(lambda m, a: jnp.where(m > 0, a, jnp.inf), mask, val))
    worst = spaces.min_reduce(neg, be.axis)
    return jnp.maximum(0.0, -worst)


def shift_bound_variables(be, it: Iterate, amount) -> Iterate:
    """Shift all masked slack/dual pairs into the interior by `amount`
    (reference Variables::shift_bound_variables, Solver.cpp:28-30)."""
    bd = be.bounds

    def sh(mask, val):
        return tmap(lambda m, a: a + m * amount, mask, val)

    return Iterate(
        x=it.x, s=it.s, y=it.y, z=it.z,
        v=sh(bd.ixlow, it.v), w=sh(bd.ixupp, it.w),
        t=sh(bd.iclow, it.t), u=sh(bd.icupp, it.u),
        gamma=sh(bd.ixlow, it.gamma), phi=sh(bd.ixupp, it.phi),
        lam=sh(bd.iclow, it.lam), pi=sh(bd.icupp, it.pi),
    )
