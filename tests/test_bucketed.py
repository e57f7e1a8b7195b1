"""Bucketed heterogeneous block sizes (core/bucketed.py,
linalg/bucket_backend.py): per-bucket batched padding instead of global
max-shape padding, one shared root — the batched analog of the reference's
per-node arbitrary block sizes (DistributedMatrix.h:44-48)."""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from pips_ipmpp_tpu.core.bucketed import (BucketedArrowheadLP,
                                          bucket_blocks,
                                          make_bucketed_arrowhead_lp)
from pips_ipmpp_tpu.core.lp import make_arrowhead_lp
from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.ipm.solver import IPMSolver
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu.linalg.bucket_backend import (BucketedArrowBackend,
                                                  gather_from_buckets)


def rand_sparse(rng, m, n, density=0.4):
    return rng.normal(size=(m, n)) * (rng.random((m, n)) < density)


def _problem(rng, sizes, n0=5, m0E=2, m0I=2, mEl=3, mIl=2):
    """Heterogeneous blocks: sizes = [(n, mE, mI), ...]."""
    def bounds(k):
        return dict(iclow=np.ones(k), clow=-rng.random(k) - 1.0,
                    icupp=np.ones(k), cupp=rng.random(k) + 1.0)

    blocks = []
    for (n, mE, mI) in sizes:
        b = dict(
            c=rng.normal(size=n),
            A=rand_sparse(rng, mE, n0),
            B=rand_sparse(rng, mE, n, 0.5) + np.eye(mE, n),
            b=rng.normal(size=mE) * 0.1,
            C=rand_sparse(rng, mI, n0),
            D=rand_sparse(rng, mI, n, 0.5),
            F=rand_sparse(rng, mEl, n, 0.4),
            G=rand_sparse(rng, mIl, n, 0.4),
            ixlow=np.ones(n), xlow=-np.ones(n) * 5,
            ixupp=np.ones(n), xupp=np.ones(n) * 5,
        )
        b.update(bounds(mI))
        blocks.append(b)
    first = dict(
        c=rng.normal(size=n0),
        A=rand_sparse(rng, m0E, n0, 0.6) + np.eye(m0E, n0),
        b=rng.normal(size=m0E) * 0.1,
        C=rand_sparse(rng, m0I, n0, 0.6),
        F0=rand_sparse(rng, mEl, n0, 0.6),
        G0=rand_sparse(rng, mIl, n0, 0.6),
        ixlow=np.ones(n0), xlow=-np.ones(n0) * 5,
        ixupp=np.ones(n0), xupp=np.ones(n0) * 5,
    )
    first.update(bounds(m0I))
    le = {"b": rng.normal(size=mEl) * 0.1}
    li = bounds(mIl)
    return blocks, first, le, {k: li[k] for k in
                               ("iclow", "clow", "icupp", "cupp")}


SIZES = [(14, 7, 5), (30, 12, 9), (13, 6, 5), (31, 13, 8), (7, 3, 3)]


def test_bucketing_groups_by_quantum():
    keys = bucket_blocks(SIZES, quantum=16)
    # 14->16, 30->32, 13->16, 31->32, 7->16 on n
    assert keys[0][0] == 16 and keys[1][0] == 32 and keys[4][0] == 16


def test_bucketed_builder_and_placement():
    rng = np.random.default_rng(1)
    blocks, first, le, li = _problem(rng, SIZES)
    blp = make_bucketed_arrowhead_lp(blocks, first, le, li, quantum=16)
    assert isinstance(blp, BucketedArrowheadLP)
    assert blp.N == len(SIZES)
    assert sum(b.N for b in blp.buckets) == len(SIZES)
    # every original block is placed exactly once
    seen = set(blp.placement)
    assert len(seen) == len(SIZES)
    # padding waste is bounded: no bucket pads beyond its quantized key
    for b in blp.buckets:
        assert b.n <= 32 and b.mE <= 16

    # placement round trip
    vals = [np.full((1,), i) for i in range(len(SIZES))]
    from pips_ipmpp_tpu.linalg.bucket_backend import scatter_to_buckets
    per_bucket = scatter_to_buckets(blp, vals)
    back = gather_from_buckets(blp, per_bucket)
    assert [int(v[0]) for v in back] == list(range(len(SIZES)))


@pytest.fixture(scope="module")
def hetero_pair():
    rng = np.random.default_rng(2)
    blocks, first, le, li = _problem(rng, SIZES)
    blp = make_bucketed_arrowhead_lp(blocks, first, le, li, quantum=16)
    lp_flat = make_arrowhead_lp(blocks, first, le, li)   # global max pad
    return blp, lp_flat


def test_bucketed_solve_matches_global_pad(hetero_pair):
    blp, lp_flat = hetero_pair
    assert blp.n_buckets >= 2
    opts = Options(max_iterations=80)
    r_flat = IPMSolver(ArrowBackend, opts).solve(lp_flat)
    r_bkt = IPMSolver(BucketedArrowBackend, opts).solve(blp)
    assert r_flat.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert r_bkt.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert r_bkt.objective == pytest.approx(r_flat.objective,
                                            abs=1e-6, rel=1e-6)
    # same iteration count: identical math, different layout
    assert abs(r_bkt.iterations - r_flat.iterations) <= 1


def test_bucketed_fused_device_loop(hetero_pair):
    blp, lp_flat = hetero_pair
    opts = Options(max_iterations=80)
    r_host = IPMSolver(BucketedArrowBackend, opts).solve(blp)
    r_fused = IPMSolver(BucketedArrowBackend, opts).solve_fused(blp)
    assert r_fused.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert r_fused.objective == pytest.approx(r_host.objective,
                                              abs=1e-6, rel=1e-6)
    assert r_fused.iterations == r_host.iterations


def test_bucketed_outer_bicgstab(hetero_pair):
    blp, lp_flat = hetero_pair
    opts = Options(max_iterations=80, outer_bicgstab=True)
    r = IPMSolver(BucketedArrowBackend, opts).solve(blp)
    assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION
    r_flat = IPMSolver(ArrowBackend, Options(max_iterations=80)).solve(
        lp_flat)
    assert r.objective == pytest.approx(r_flat.objective,
                                        abs=1e-6, rel=1e-6)


def test_bucketed_f32_kernel_path(hetero_pair):
    """The f32 production leaf modes (explicit inverse / LDL kernel via
    interpret on CPU) compose with buckets."""
    blp, lp_flat = hetero_pair
    blp32 = blp.astype(jnp.float32)
    opts = Options(max_iterations=80)
    r = IPMSolver(partial(BucketedArrowBackend, factor_dtype=jnp.float32),
                  opts).solve(blp32)
    assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION
    r_flat = IPMSolver(ArrowBackend, opts).solve(lp_flat)
    assert r.objective == pytest.approx(r_flat.objective,
                                        abs=1e-3, rel=1e-3)


def test_bucketed_rejects_special_roots(hetero_pair):
    blp, _ = hetero_pair
    with pytest.raises(ValueError):
        BucketedArrowBackend(blp, dist_root=True)
    with pytest.raises(ValueError):
        BucketedArrowBackend(blp, blockwise_sc=32)


def test_bucketed_through_interface(hetero_pair):
    """Facade parity: PIPSIPMppTPUInterface accepts a BucketedArrowheadLP
    (run/getObjective/gatherPrimalSolution)."""
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
    blp, lp_flat = hetero_pair
    iface = PIPSIPMppTPUInterface(blp, Options(max_iterations=80))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    r_flat = IPMSolver(ArrowBackend, Options(max_iterations=80)).solve(
        lp_flat)
    assert iface.getObjective() == pytest.approx(float(r_flat.objective),
                                                 abs=1e-6, rel=1e-6)
    x = iface.gatherPrimalSolution()
    assert x.shape[0] == blp.n0 + sum(b.N * b.n for b in blp.buckets)


def test_bucketed_gather_api(hetero_pair):
    """All facade gathers work on bucketed LPs and satisfy the KKT
    conditions of the original heterogeneous problem (the ADVICE round-3
    crash: _split_x/_arrow_Ax assumed uniform ArrowheadLP fields)."""
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
    blp, lp_flat = hetero_pair
    iface = PIPSIPMppTPUInterface(blp, Options(max_iterations=80))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION

    flat = PIPSIPMppTPUInterface(lp_flat, Options(max_iterations=80))
    assert flat.run() == TerminationStatus.SUCCESSFUL_TERMINATION

    # first stage matches the uniform-padded solve
    np.testing.assert_allclose(iface.getFirstStagePrimalColSolution(),
                               flat.getFirstStagePrimalColSolution(),
                               atol=1e-4)
    assert iface.getFirstStageObjective() == pytest.approx(
        flat.getFirstStageObjective(), abs=1e-6)
    # per-scenario solutions match on the TRUE (unpadded) entries
    for scen, (n, _, _) in enumerate(SIZES):
        xs_b = iface.getSecondStagePrimalColSolution(scen)[:n]
        xs_f = flat.getSecondStagePrimalColSolution(scen)[:n]
        np.testing.assert_allclose(xs_b, xs_f, atol=1e-4)

    # primal feasibility in the original space
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-6
    assert np.max(np.abs(iface.gatherPrimalResidsIneqLow())) < 1e-6
    assert np.max(np.abs(iface.gatherPrimalResidsIneqUp())) < 1e-6
    # dual feasibility: Lagrangian gradient ~ 0
    assert np.max(np.abs(iface.gatherDualResids())) < 1e-5
    # complementarity products ~ mu
    norms = iface.printComplementarityResiduals()
    assert all(v < 1e-5 for v in norms.values())
    # cons-value gathers have consistent shapes
    lp0 = blp.buckets[0]
    mE_tot = (lp0.b0.shape[0] + sum(b.N * b.mE for b in blp.buckets)
              + lp0.bl.shape[0])
    assert iface.gatherEqualityConsValues().shape[0] == mE_tot
    assert iface.gatherDualSolutionEq().shape[0] == mE_tot
    # slack/bound-dual gathers
    x = iface.gatherPrimalSolution()
    assert iface.gatherSlacksVarsLow().shape == x.shape
    assert iface.gatherDualSolutionVarBounds().shape == x.shape
