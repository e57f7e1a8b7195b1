"""Automatic structure detection (core/dissect.py): an unstructured
sparse LP is reblocked onto the arrowhead path and must solve to the
same objective as the flat dense path (the dissection is an exact
permutation reformulation).  Batched replacement for the supernodal
sparse leaf factorization (reference PardisoSchurSolver.C:84-252) —
separator elimination lifted to the problem level."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from pips_ipmpp_tpu.core.dissect import auto_structure, structure_report
from pips_ipmpp_tpu.core.lp import DenseLP
from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface


def banded_sparse_lp(seed, n=240, band=6, m_frac=0.6):
    """Feasible banded LP: eq rows couple a few nearby columns (band
    structure so RCM chunking gives a small separator), box bounds,
    a strip of inequality rows."""
    rng = np.random.default_rng(seed)
    mE = int(n * m_frac * 0.5)
    mI = int(n * m_frac * 0.25)
    xstar = rng.uniform(0.5, 1.5, n)

    A = np.zeros((mE, n))
    for r in range(mE):
        j0 = rng.integers(0, n - band)
        idx = j0 + rng.permutation(band)[:3]
        A[r, idx] = rng.normal(size=3)
    b = A @ xstar

    C = np.zeros((mI, n))
    for r in range(mI):
        j0 = rng.integers(0, n - band)
        idx = j0 + rng.permutation(band)[:3]
        C[r, idx] = rng.normal(size=3)
    act = C @ xstar
    f = lambda v: np.asarray(v, np.float64)
    return DenseLP(
        c=f(rng.normal(size=n)),
        A=f(A), b=f(b), C=f(C),
        iclow=f(np.ones(mI)), clow=f(act - rng.uniform(0.5, 1.0, mI)),
        icupp=f(np.ones(mI)), cupp=f(act + rng.uniform(0.5, 1.0, mI)),
        ixlow=f(np.ones(n)), xlow=f(np.zeros(n)),
        ixupp=f(np.ones(n)), xupp=f(np.full(n, 4.0)))


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8), (2, 6)])
def test_dissected_matches_dense(seed, k):
    lp = banded_sparse_lp(seed)
    iface_d = PIPSIPMppTPUInterface(lp, Options(print_level=0))
    assert iface_d.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    obj_dense = float(iface_d.getObjective())

    alp, dmap = auto_structure(lp, num_blocks=k)
    iface_a = PIPSIPMppTPUInterface(alp, Options(print_level=0))
    assert iface_a.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert float(iface_a.getObjective()) == pytest.approx(
        obj_dense, rel=1e-5, abs=1e-4)

    # recovered primal is feasible for the ORIGINAL flat problem
    xflat = np.asarray(iface_a.gatherPrimalSolution())
    x = dmap.recover_x(xflat[:alp.n0],
                       xflat[alp.n0:].reshape(alp.N, alp.n))
    assert np.max(np.abs(np.asarray(lp.A) @ x - np.asarray(lp.b))) < 1e-6
    assert float(np.asarray(lp.c) @ x) == pytest.approx(obj_dense, rel=1e-5, abs=1e-4)


def test_dissection_is_actually_blocked():
    """Structural payoff: leaf storage must be far below the dense KKT
    and the separator/linking small relative to n."""
    lp = banded_sparse_lp(3, n=480, band=5)
    alp, dmap = auto_structure(lp, num_blocks=8)
    rep = structure_report(dmap, alp)
    assert rep["num_blocks"] == 8
    assert rep["arrow_leaf_entries"] < 0.25 * rep["dense_kkt_entries"]
    assert rep["first_vars"] + rep["linking_eq"] + rep["linking_ineq"] \
        < 0.35 * 480


def test_every_row_and_column_is_placed():
    lp = banded_sparse_lp(4, n=120, band=4)
    alp, dmap = auto_structure(lp, num_blocks=4)
    assert all(p is not None for p in dmap.col_place)
    assert all(p is not None for p in dmap.eq_place)
    assert all(p is not None for p in dmap.ineq_place)


def banded_block(rng, n, band=5, mE_frac=0.5, mI=4, n0=4):
    """Block dict with banded local structure (so splitting has a small
    separator) and a dense border to the first stage."""
    mE = int(n * mE_frac)
    B = np.zeros((mE, n))
    for r in range(mE):
        j0 = rng.integers(0, n - band)
        idx = j0 + rng.permutation(band)[:3]
        B[r, idx] = rng.normal(size=3)
    A = rng.normal(size=(mE, n0)) * 0.1
    xs = rng.uniform(0.5, 1.5, n)
    x0s = rng.uniform(0.5, 1.5, n0)
    D = np.zeros((mI, n))
    for r in range(mI):
        j0 = rng.integers(0, n - band)
        D[r, j0:j0 + 3] = rng.normal(size=3)
    act = D @ xs
    return dict(
        c=rng.normal(size=n), A=A, B=B, b=A @ x0s + B @ xs,
        C=np.zeros((mI, n0)), D=D,
        iclow=np.ones(mI), clow=act - 1.0,
        icupp=np.ones(mI), cupp=act + 1.0,
        ixlow=np.ones(n), xlow=np.zeros(n),
        ixupp=np.ones(n), xupp=np.full(n, 4.0),
        F=np.zeros((0, n)), G=np.zeros((0, n))), x0s


def test_refine_blocks_matches_unrefined():
    """Two oversized banded blocks are split into sub-blocks; the refined
    problem must reach the same objective, and the sub-block variable
    count must respect the budget (modulo the promoted separator)."""
    from pips_ipmpp_tpu.core.dissect import refine_blocks
    from pips_ipmpp_tpu.core.lp import make_arrowhead_lp

    rng = np.random.default_rng(7)
    n0 = 4
    b1, x0s = banded_block(rng, 96, n0=n0)
    b2, _ = banded_block(rng, 120, n0=n0)
    A0 = rng.normal(size=(2, n0))
    first = dict(c=rng.normal(size=n0), A=A0, b=A0 @ x0s,
                 C=np.zeros((0, n0)), iclow=np.zeros(0), clow=np.zeros(0),
                 icupp=np.zeros(0), cupp=np.zeros(0),
                 ixlow=np.ones(n0), xlow=np.zeros(n0),
                 ixupp=np.ones(n0), xupp=np.full(n0, 4.0),
                 F0=np.zeros((0, n0)), G0=np.zeros((0, n0)))

    lp_ref = make_arrowhead_lp([b1, b2], first)
    i_ref = PIPSIPMppTPUInterface(lp_ref, Options(print_level=0))
    assert i_ref.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    obj_ref = float(i_ref.getObjective())

    nb, nf, placement = refine_blocks([b1, b2], first, max_block_vars=40)
    assert len(nb) >= 4, "both oversized blocks must split"
    assert max(len(x["c"]) for x in nb) <= 40
    # the separator must stay small for banded structure
    assert len(nf["c"]) - n0 < 0.35 * (96 + 120)

    lp_new = make_arrowhead_lp(nb, nf)
    i_new = PIPSIPMppTPUInterface(lp_new, Options(print_level=0))
    assert i_new.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert float(i_new.getObjective()) == pytest.approx(
        obj_ref, rel=1e-5, abs=1e-4)

    # placement covers every original variable exactly once
    seen = set()
    for place in placement:
        for p in place:
            assert p is not None
            seen.add(p)
    assert len(seen) == 96 + 120


def test_refine_blocks_keeps_small_blocks():
    from pips_ipmpp_tpu.core.dissect import refine_blocks

    rng = np.random.default_rng(8)
    n0 = 4
    b1, x0s = banded_block(rng, 24, n0=n0)
    first = dict(c=rng.normal(size=n0), A=np.zeros((0, n0)), b=np.zeros(0),
                 C=np.zeros((0, n0)), iclow=np.zeros(0), clow=np.zeros(0),
                 icupp=np.zeros(0), cupp=np.zeros(0),
                 ixlow=np.ones(n0), xlow=np.zeros(n0),
                 ixupp=np.ones(n0), xupp=np.full(n0, 4.0),
                 F0=np.zeros((0, n0)), G0=np.zeros((0, n0)))
    nb, nf, placement = refine_blocks([b1], first, max_block_vars=64)
    assert len(nb) == 1 and len(nf["c"]) == n0
    assert placement[0] == [(0, j) for j in range(24)]
