"""Multi-period energy dispatch/expansion LP generator — the reference's
workload class (README.md:1-5: SIMPLE/ELMOD energy-system LPs solved on
JUWELS; "LPs with generalized arrowhead structure").

Model (economic dispatch + transmission + storage + capacity expansion):

  Blocks   = time periods t = 1..T, each a region-coupled dispatch problem
             with 10^2-10^3 rows (reference-shaped sparse blocks).
  First    = capacity-expansion variables x_g >= 0 shared by every period
  stage      (linking COLUMNS via the per-period capacity rows), plus an
             optional expansion-budget row.
  Linking  = storage energy-continuity rows e_{s,t} - e_{s,t-1} - eta c
  rows       + d/eta = 0, each supported on TWO consecutive blocks — the
             reference's 2-link structure (DistributedProblem
             ::activateLinkStructureExploitation, 2-link detection).

  Per block t:
    variables  p_g (generation), f_l (line flow), c_s/d_s (storage
               charge/discharge), e_s (storage level), u_r (load shed)
    eq rows    nodal balance per region r:
               sum_{g in r} p_g + sum_{l->r} f_l - sum_{r->l} f_l
               + d_{s(r)} - c_{s(r)} + u_r = demand_{r,t}
    ineq rows  capacity coupling per generator: p_{g,t} - x_g <= Pmax_g

  min  sum_t [ cost' p_t + penalty * sum u_t ]  +  kappa' x

Everything is feasible by construction (shed variables) and bounded.
The generator emits `make_arrowhead_lp`-style dicts so the instance flows
through the annotated structured path, `to_scipy` builds the flat sparse
LP for the HiGHS f64 oracle, and `write_mps` emits a standard MPS file to
exercise the serial reader + automatic structure discovery
(`--mps --auto-blocks`, core/dissect.py).
"""
from __future__ import annotations

import numpy as np


def dispatch_blocks(T: int = 24, R: int = 10, G: int = 30, L: int = 15,
                    S: int = 2, seed: int = 0, eta: float = 0.9,
                    budget_row: bool = True):
    """Build (blocks, first_stage, linking_eq, linking_ineq) dicts for
    `make_arrowhead_lp` / `make_bucketed_arrowhead_lp`.

    T periods, R regions, G generators, L transmission lines, S storage
    units.  Per-block: n = G+L+3S+R variables, mE = R rows, mI = G rows;
    mEl = S*T linking rows (2-link chains).  Returns the dicts plus a
    metadata dict (sizes, column layout) for oracle assembly.
    """
    rng = np.random.default_rng(seed)
    if not (1 <= S <= R and 1 <= L and 1 <= G):
        raise ValueError("need 1 <= S <= R, G >= 1, L >= 1")

    gen_region = rng.integers(0, R, size=G)
    # lines connect random distinct region pairs
    line_from = rng.integers(0, R, size=L)
    line_to = (line_from + 1 + rng.integers(0, R - 1, size=L)) % R
    stor_region = rng.permutation(R)[:S]

    pmax = 0.5 + rng.random(G) * 2.0            # nameplate capacity
    cost = 1.0 + rng.random(G) * 9.0            # marginal cost
    fmax = 0.5 + rng.random(L) * 1.5
    smax = 0.3 + rng.random(S) * 0.7            # charge/discharge rate
    emax = 2.0 + rng.random(S) * 4.0            # energy capacity
    e0 = 0.5 * emax
    kappa = 20.0 + rng.random(G) * 40.0         # expansion cost
    xmax = 0.5 * pmax
    shed_penalty = 1000.0

    # demand: daily sinusoid + noise, scaled so the system is tight but
    # feasible without shed most of the time
    base = pmax.sum() / R
    tgrid = np.arange(T)
    profile = 0.55 + 0.25 * np.sin(2 * np.pi * (tgrid[:, None] / 24.0)
                                   + rng.random(R)[None, :] * 6.28)
    demand = base * profile * (0.9 + 0.2 * rng.random((T, R)))

    n = G + L + 3 * S + R                       # per-block variables
    iP, iF, iC, iD, iE, iU = (0, G, G + L, G + L + S, G + L + 2 * S,
                              G + L + 3 * S)

    n0 = G
    mEl = S * T                                 # storage continuity rows
    # linking row index of (storage s, period t): s * T + t

    blocks = []
    for t in range(T):
        B = np.zeros((R, n))
        for g in range(G):
            B[gen_region[g], iP + g] = 1.0
        for l in range(L):
            B[line_to[l], iF + l] += 1.0
            B[line_from[l], iF + l] -= 1.0
        for s in range(S):
            r = stor_region[s]
            B[r, iD + s] = 1.0                  # discharge adds
            B[r, iC + s] = -1.0                 # charge subtracts
        for r in range(R):
            B[r, iU + r] = 1.0                  # shed closes the balance

        # capacity coupling p - x <= pmax  (border C on first-stage x)
        D = np.zeros((G, n))
        D[np.arange(G), iP + np.arange(G)] = 1.0
        Cb = np.zeros((G, n0))
        Cb[np.arange(G), np.arange(G)] = -1.0

        # storage continuity strips: row (s, t): +e_{s,t} - eta c_{s,t}
        # + d_{s,t}/eta ;  row (s, t+1) gets -e_{s,t} from THIS block
        F = np.zeros((mEl, n))
        for s in range(S):
            row = s * T + t
            F[row, iE + s] = 1.0
            F[row, iC + s] = -eta
            F[row, iD + s] = 1.0 / eta
            if t + 1 < T:
                F[s * T + t + 1, iE + s] += -1.0

        c = np.zeros(n)
        c[iP:iP + G] = cost
        c[iU:iU + R] = shed_penalty

        xupp = np.concatenate([
            pmax + xmax,          # p loose cap (tightened by the row)
            fmax,                 # |f| <= fmax
            smax, smax, emax,
            demand[t].clip(min=0.0) + 1.0])
        xlow = np.concatenate([
            np.zeros(G), -fmax, np.zeros(3 * S + R)])

        blocks.append(dict(
            c=c,
            A=np.zeros((R, n0)), B=B, b=demand[t],
            C=Cb, D=D,
            iclow=np.zeros(G), clow=np.zeros(G),
            icupp=np.ones(G), cupp=pmax,
            ixlow=np.ones(n), xlow=xlow,
            ixupp=np.ones(n), xupp=xupp,
            F=F, G=np.zeros((0, n)),
        ))

    first = dict(
        c=kappa,
        A=np.zeros((0, n0)), b=np.zeros(0),
        C=(np.ones((1, n0)) if budget_row else np.zeros((0, n0))),
        iclow=np.zeros(1 if budget_row else 0),
        clow=np.zeros(1 if budget_row else 0),
        icupp=np.ones(1 if budget_row else 0),
        cupp=(np.array([0.25 * xmax.sum()]) if budget_row
              else np.zeros(0)),
        ixlow=np.ones(n0), xlow=np.zeros(n0),
        ixupp=np.ones(n0), xupp=xmax,
        F0=np.zeros((mEl, n0)), G0=np.zeros((0, n0)),
    )

    # rhs of continuity rows: t = 0 rows carry the initial level e0
    bl = np.zeros(mEl)
    for s in range(S):
        bl[s * T + 0] = e0[s]
    linking_eq = {"b": bl}
    linking_ineq = {"iclow": np.zeros(0), "clow": np.zeros(0),
                    "icupp": np.zeros(0), "cupp": np.zeros(0)}

    meta = dict(T=T, R=R, G=G, L=L, S=S, n_block=n, n0=n0, mEl=mEl,
                layout=dict(p=iP, f=iF, c=iC, d=iD, e=iE, u=iU))
    return blocks, first, linking_eq, linking_ineq, meta


# ======================================================================
# Flat sparse assembly (HiGHS oracle + MPS writer input)
# ======================================================================

def to_scipy(blocks, first, linking_eq, linking_ineq):
    """Assemble the flat sparse LP
        min c'x  s.t.  A_eq x = b_eq, bl <= A_ub x <= bu, lo <= x <= hi
    with variable order [x0 | block 0 | block 1 | ...] and row order
    [first eq | block eq | linking eq] / [first iq | block iq | link iq].
    Returns (c, A_eq(csr), b_eq, A_ub(csr), lb_ub, ub_ub, lo, hi).
    """
    import scipy.sparse as sp

    n0 = len(first["c"])
    sizes = [len(b["c"]) for b in blocks]
    offs = np.concatenate([[n0], n0 + np.cumsum(sizes)])
    ntot = int(offs[-1])

    c = np.concatenate([first["c"]] + [b["c"] for b in blocks])

    def bound_arrays():
        lo = [np.where(first["ixlow"] > 0, first["xlow"], -np.inf)]
        hi = [np.where(first["ixupp"] > 0, first["xupp"], np.inf)]
        for b in blocks:
            lo.append(np.where(b["ixlow"] > 0, b["xlow"], -np.inf))
            hi.append(np.where(b["ixupp"] > 0, b["xupp"], np.inf))
        return np.concatenate(lo), np.concatenate(hi)

    lo, hi = bound_arrays()

    eq_rows, beq = [], []
    A0 = np.asarray(first["A"])
    if A0.shape[0]:
        eq_rows.append(sp.hstack(
            [sp.csr_matrix(A0),
             sp.csr_matrix((A0.shape[0], ntot - n0))]))
        beq.append(np.asarray(first["b"]))
    for i, b in enumerate(blocks):
        mE = np.asarray(b["B"]).shape[0]
        if not mE:
            continue
        parts = [sp.csr_matrix(np.asarray(b["A"]))]
        if offs[i] > n0:
            parts.insert(1, sp.csr_matrix((mE, int(offs[i]) - n0)))
        parts.append(sp.csr_matrix(np.asarray(b["B"])))
        tail = ntot - int(offs[i + 1])
        if tail:
            parts.append(sp.csr_matrix((mE, tail)))
        eq_rows.append(sp.hstack(parts))
        beq.append(np.asarray(b["b"]))
    mEl = len(linking_eq["b"])
    if mEl:
        parts = [sp.csr_matrix(np.asarray(first["F0"]))]
        for i, b in enumerate(blocks):
            parts.append(sp.csr_matrix(np.asarray(b["F"])))
        eq_rows.append(sp.hstack(parts))
        beq.append(np.asarray(linking_eq["b"]))
    A_eq = sp.vstack(eq_rows).tocsr() if eq_rows else \
        sp.csr_matrix((0, ntot))
    b_eq = np.concatenate(beq) if beq else np.zeros(0)

    iq_rows, lbs, ubs = [], [], []

    def push_iq(mat_parts, il, lv, iu, uv):
        iq_rows.append(sp.hstack(mat_parts))
        lbs.append(np.where(np.asarray(il) > 0, np.asarray(lv), -np.inf))
        ubs.append(np.where(np.asarray(iu) > 0, np.asarray(uv), np.inf))

    C0 = np.asarray(first["C"])
    if C0.shape[0]:
        push_iq([sp.csr_matrix(C0), sp.csr_matrix((C0.shape[0],
                                                   ntot - n0))],
                first["iclow"], first["clow"],
                first["icupp"], first["cupp"])
    for i, b in enumerate(blocks):
        mI = np.asarray(b["D"]).shape[0]
        if not mI:
            continue
        parts = [sp.csr_matrix(np.asarray(b["C"]))]
        if offs[i] > n0:
            parts.insert(1, sp.csr_matrix((mI, int(offs[i]) - n0)))
        parts.append(sp.csr_matrix(np.asarray(b["D"])))
        tail = ntot - int(offs[i + 1])
        if tail:
            parts.append(sp.csr_matrix((mI, tail)))
        push_iq(parts, b["iclow"], b["clow"], b["icupp"], b["cupp"])
    mIl = len(linking_ineq["clow"])
    if mIl:
        parts = [sp.csr_matrix(np.asarray(first["G0"]))]
        for b in blocks:
            parts.append(sp.csr_matrix(np.asarray(b["G"])))
        push_iq(parts, linking_ineq["iclow"], linking_ineq["clow"],
                linking_ineq["icupp"], linking_ineq["cupp"])
    A_ub = sp.vstack(iq_rows).tocsr() if iq_rows else \
        sp.csr_matrix((0, ntot))
    lb_ub = np.concatenate(lbs) if lbs else np.zeros(0)
    ub_ub = np.concatenate(ubs) if ubs else np.zeros(0)
    return c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi


def linprog_arrays(blocks, first, linking_eq, linking_ineq):
    """The flat LP as scipy.optimize.linprog takes it:
    (c, A_ub, b_ub, A_eq, b_eq, bounds), ranged rows split one-sided."""
    import scipy.sparse as sp

    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = to_scipy(
        blocks, first, linking_eq, linking_ineq)
    # linprog wants one-sided A_ub x <= b_ub: split ranged rows
    ub_mats, ub_rhs = [], []
    if A_ub.shape[0]:
        fin_up = np.isfinite(ub_ub)
        fin_lo = np.isfinite(lb_ub)
        if fin_up.any():
            ub_mats.append(A_ub[fin_up])
            ub_rhs.append(ub_ub[fin_up])
        if fin_lo.any():
            ub_mats.append(-A_ub[fin_lo])
            ub_rhs.append(-lb_ub[fin_lo])
    A1 = sp.vstack(ub_mats).tocsr() if ub_mats else None
    b1 = np.concatenate(ub_rhs) if ub_mats else None
    return (c, A1, b1, A_eq if A_eq.shape[0] else None,
            b_eq if A_eq.shape[0] else None, np.stack([lo, hi], axis=1))


def highs_oracle(blocks, first, linking_eq, linking_ineq):
    """Solve the flat LP with scipy HiGHS (trusted f64 oracle).
    Returns (objective, x)."""
    from scipy.optimize import linprog

    c, A_ub, b_ub, A_eq, b_eq, bounds = linprog_arrays(
        blocks, first, linking_eq, linking_ineq)
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"HiGHS oracle failed: {res.message}")
    return float(res.fun), res.x


# ======================================================================
# MPS writer (free format; round-trips through io/mps.read_mps)
# ======================================================================

def write_mps(path: str, blocks, first, linking_eq, linking_ineq,
              name: str = "ENERGY"):
    """Write the flat LP as a free-format MPS file (reference MpsReader
    conventions: N/E/L/G rows, RANGES unused, BOUNDS UP/LO/FX)."""
    import scipy.sparse as sp

    c, A_eq, b_eq, A_ub, lb_ub, ub_ub, lo, hi = to_scipy(
        blocks, first, linking_eq, linking_ineq)
    ntot = c.size

    cols = [f"X{j}" for j in range(ntot)]
    erows = [f"E{i}" for i in range(A_eq.shape[0])]
    irows = [f"I{i}" for i in range(A_ub.shape[0])]

    def num(v):
        return repr(float(v))

    with open(path, "w") as f:
        f.write(f"NAME {name}\nROWS\n N COST\n")
        for r in erows:
            f.write(f" E {r}\n")
        for i, r in enumerate(irows):
            up, lb = np.isfinite(ub_ub[i]), np.isfinite(lb_ub[i])
            f.write(f" {'L' if up else 'G'} {r}\n")
        f.write("COLUMNS\n")
        Aeq_csc = A_eq.tocsc()
        Aub_csc = A_ub.tocsc()
        for j in range(ntot):
            if c[j] != 0.0:
                f.write(f" {cols[j]} COST {num(c[j])}\n")
            s, e = Aeq_csc.indptr[j], Aeq_csc.indptr[j + 1]
            for k in range(s, e):
                f.write(f" {cols[j]} {erows[Aeq_csc.indices[k]]} "
                        f"{num(Aeq_csc.data[k])}\n")
            s, e = Aub_csc.indptr[j], Aub_csc.indptr[j + 1]
            for k in range(s, e):
                f.write(f" {cols[j]} {irows[Aub_csc.indices[k]]} "
                        f"{num(Aub_csc.data[k])}\n")
        f.write("RHS\n")
        for i, v in enumerate(b_eq):
            if v != 0.0:
                f.write(f" RHS {erows[i]} {num(v)}\n")
        for i in range(A_ub.shape[0]):
            v = ub_ub[i] if np.isfinite(ub_ub[i]) else lb_ub[i]
            if v != 0.0:
                f.write(f" RHS {irows[i]} {num(v)}\n")
        # ranged ineq rows (both sides finite) are not emitted by the
        # generator; assert to keep the writer honest
        assert not np.any(np.isfinite(ub_ub) & np.isfinite(lb_ub)), \
            "ranged rows need a RANGES section"
        f.write("BOUNDS\n")
        for j in range(ntot):
            if np.isfinite(lo[j]) and lo[j] == hi[j]:
                f.write(f" FX BND {cols[j]} {num(lo[j])}\n")
                continue
            if np.isfinite(lo[j]) and lo[j] != 0.0:
                f.write(f" LO BND {cols[j]} {num(lo[j])}\n")
            elif not np.isfinite(lo[j]):
                f.write(f" MI BND {cols[j]}\n")
            if np.isfinite(hi[j]):
                f.write(f" UP BND {cols[j]} {num(hi[j])}\n")
        f.write("ENDATA\n")
