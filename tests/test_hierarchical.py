"""Hierarchical two-level Schur tests: locality analysis, layout transform
equivalence, Newton-oracle accuracy of the three-level solve, and
end-to-end IPM equality with the flat backend."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.ipm import formulation as F
from pips_ipmpp_tpu.ipm.solver import IPMSolver
from pips_ipmpp_tpu.io.synthetic import random_hier_arrowhead_lp
from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
from pips_ipmpp_tpu.linalg.hier_backend import (HierArrowBackend,
                                                analyze_link_locality,
                                                build_hierarchical_lp)

from tests.helpers import interior_iterate, max_newton_error, newton_residuals


def test_locality_analysis():
    F_ = np.zeros((4, 3, 2))
    F_[0, 0, 0] = 1.0              # row 0: block 0 only -> group 0
    F_[2, 1, 1] = 1.0
    F_[3, 1, 0] = 2.0              # row 1: blocks 2,3 -> group 1
    F_[0, 2, 0] = 1.0
    F_[3, 2, 1] = 1.0              # row 2: blocks 0 and 3 -> global
    owner = analyze_link_locality(F_, 2)
    np.testing.assert_array_equal(owner, [0, 1, -1])


def test_layout_transform_preserves_solution():
    lp = random_hier_arrowhead_lp(0, N=8, n_groups=2)
    hlp, meta = build_hierarchical_lp(lp, 2)
    assert meta.mElG >= 1
    r_flat = IPMSolver(ArrowBackend, Options()).solve(lp)
    r_perm = IPMSolver(ArrowBackend, Options()).solve(hlp)
    assert r_perm.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r_perm.objective - r_flat.objective) < 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hier_solve_matches_newton_oracle(seed):
    lp = random_hier_arrowhead_lp(seed, N=6, n_groups=3, n=4, mE=2, mI=2,
                                  loc_eq=1, loc_iq=1, glob_eq=1, glob_iq=1)
    hlp, meta = build_hierarchical_lp(lp, 3)
    be = HierArrowBackend(hlp, meta)
    it = interior_iterate(be, jax.random.PRNGKey(seed + 11))

    res = F.compute_residuals(be, it)
    Dx, Ominv = F.kkt_diagonals(be, it)
    fac = be.factorize(Dx, Ominv, 0.0, 0.0)
    assert bool(be.factorization_ok(fac))
    comp = F.comp_rhs_affine(be, it)
    rhs = F.assemble_reduced_rhs(be, it, res, comp, Ominv)
    dx, dy, dz = be.solve_reduced(fac, rhs, refinement_steps=2)
    d = F.recover_step(be, it, res, comp, Ominv, rhs, dx, dy, dz)
    errs = max_newton_error(newton_residuals(be, it, d, res, comp))
    for name, err in errs.items():
        assert err < 1e-8, f"{name}: {err} (all {errs})"


@pytest.mark.parametrize("seed", [0, 1])
def test_hier_ipm_matches_flat(seed):
    lp = random_hier_arrowhead_lp(seed, N=8, n_groups=4)
    hlp, meta = build_hierarchical_lp(lp, 4)
    r_flat = IPMSolver(ArrowBackend, Options()).solve(lp)
    r_hier = IPMSolver(partial(HierArrowBackend, meta=meta),
                       Options()).solve(hlp)
    assert r_flat.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert r_hier.status == TerminationStatus.SUCCESSFUL_TERMINATION, \
        f"hier: mu={r_hier.mu} resid={r_hier.residual_norm}"
    assert abs(r_hier.objective - r_flat.objective) < 1e-6 * max(
        1.0, abs(r_flat.objective))


def test_hier_cache_is_smaller():
    """The whole point: cached border solves shrink when links are local."""
    lp = random_hier_arrowhead_lp(3, N=8, n_groups=4, loc_eq=4, loc_iq=4,
                                  glob_eq=1, glob_iq=1)
    hlp, meta = build_hierarchical_lp(lp, 4)
    be_f = ArrowBackend(hlp)
    be_h = HierArrowBackend(hlp, meta)
    it = interior_iterate(be_h, jax.random.PRNGKey(0))
    Dx, Ominv = F.kkt_diagonals(be_h, it)
    fac_f = be_f.factorize(Dx, Ominv, 1e-10, 1e-10)
    fac_h = be_h.factorize(Dx, Ominv, 1e-10, 1e-10)
    flat_cache = fac_f.Ux.size + fac_f.Um.size
    hier_cache = fac_h.WoutB.size + fac_h.WoutL.size + fac_h.Win.size
    assert hier_cache < flat_cache


def test_interface_hierarchical():
    from pips_ipmpp_tpu.core.options import ScalerType
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
    lp = random_hier_arrowhead_lp(7, N=8, n_groups=2)
    base = PIPSIPMppTPUInterface(lp, Options())
    base.run()
    iface = PIPSIPMppTPUInterface(
        lp, Options(hierarchical=True, scaler=ScalerType.GEOMETRIC_MEAN))
    st = iface.run()
    assert st == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(iface.getObjective() - base.getObjective()) < 1e-5
    # dual gathers come back in ORIGINAL (unpermuted) link order and match
    y_b = base.gatherDualSolutionEq()
    y_h = iface.gatherDualSolutionEq()
    assert y_b.shape == y_h.shape
    np.testing.assert_allclose(y_h, y_b, atol=2e-4)


def test_hier_f32_factor_dtype():
    """f32 factors on the hier backend must work —
    regression: the inherited explicit-inverse path crashed on HierFactors."""
    lp = random_hier_arrowhead_lp(4, N=8, n_groups=2)
    hlp, meta = build_hierarchical_lp(lp, 2)
    r = IPMSolver(partial(HierArrowBackend, meta=meta,
                          factor_dtype=jnp.float32),
                  Options(refinement_steps=6)).solve(hlp)
    assert r.status == TerminationStatus.SUCCESSFUL_TERMINATION
    ref = IPMSolver(ArrowBackend, Options()).solve(lp)
    assert abs(r.objective - ref.objective) < 1e-4 * max(1, abs(ref.objective))


def test_three_layer_hierarchy():
    """hierarchical_layers=3: rows local to a COARSE group of fine groups
    are eliminated by a batched per-coarse-group Schur stage at the top
    (the reference's recursive splitTree).  Must reproduce the flat
    solve exactly; the facade wires layers=3."""
    from functools import partial

    from pips_ipmpp_tpu.core.options import Options
    from pips_ipmpp_tpu.core.status import TerminationStatus
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
    from pips_ipmpp_tpu.io.synthetic import random_hier_arrowhead_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.linalg.hier_backend import (HierArrowBackend,
                                                    build_hierarchical_lp)

    # generator locality at 4-group granularity; solving with 8 fine
    # groups makes the 4-group-local rows COARSE-local (they span two
    # fine groups) — a genuine third layer
    lp = random_hier_arrowhead_lp(11, N=16, n_groups=4, loc_eq=3,
                                  loc_iq=2, glob_eq=2, glob_iq=1)
    ref = IPMSolver(ArrowBackend, Options()).solve(lp)
    assert ref.status == TerminationStatus.SUCCESSFUL_TERMINATION

    hlp, meta = build_hierarchical_lp(lp, 8, n_coarse=4)
    assert meta.n_coarse == 4
    assert meta.mEl2 > 0 or meta.mIl2 > 0   # the third layer is non-empty
    r3 = IPMSolver(partial(HierArrowBackend, meta=meta),
                   Options()).solve(hlp)
    assert r3.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r3.objective - ref.objective) < 1e-6 * max(
        1.0, abs(ref.objective))
    assert abs(r3.iterations - ref.iterations) <= 2

    # facade: layers=3 end to end, gathers in original row order
    iface = PIPSIPMppTPUInterface(lp, Options(
        hierarchical=True, hierarchical_layers=3,
        hierarchical_num_groups=8))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(iface.getObjective() - float(ref.objective)) < 1e-5
    import numpy as np
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-6


def test_four_layer_hierarchy():
    """hierarchical_layers=4 (depth-parametric chain, round-5): rows at
    THREE linking granularities — fine-group-local, level-2-local and
    level-3-local — plus globals.  Each coarse level is eliminated by
    its own batched Schur stage; the solve must reproduce the flat
    backend exactly (reference splitTree recursion,
    DistributedTreeCallbacks.C:1123,1194-1217)."""
    import dataclasses
    from functools import partial

    import numpy as np

    from pips_ipmpp_tpu.core.options import Options
    from pips_ipmpp_tpu.core.status import TerminationStatus
    from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.linalg.hier_backend import (HierArrowBackend,
                                                    build_hierarchical_lp)

    base = random_arrowhead_lp(21, N=16, n=6, mE=3, mI=3, n0=3, m0E=2,
                               m0I=2, mEl=9, mIl=8)
    # hand-crafted locality over 16 blocks: fine groups of 2 (8 groups),
    # level-2 groups of 4 (C=4), level-3 groups of 8 (C=2)
    F = np.asarray(base.F).copy()
    G = np.asarray(base.G).copy()

    def mask_row(M, r, blocks):
        keep = np.zeros(M.shape[0], bool)
        keep[list(blocks)] = True
        M[~keep, r, :] = 0.0

    # eq rows: 0-3 fine-local, 4-5 level-2-local, 6-7 level-3-local, 8 glob
    for r, blocks in enumerate([(0, 1), (2, 3), (8, 9), (14, 15),
                                (0, 1, 2, 3), (4, 6, 7),
                                (0, 3, 5, 7), (8, 11, 15)]):
        mask_row(F, r, blocks)
    # ineq rows: 0-2 fine, 3-4 level-2, 5-6 level-3, 7 global
    for r, blocks in enumerate([(4, 5), (6, 7), (10, 11),
                                (12, 14), (9, 10),
                                (1, 2, 6), (8, 9, 13)]):
        mask_row(G, r, blocks)
    from pips_ipmpp_tpu.io.synthetic import refit_feasible
    lp = refit_feasible(base, F, G, np.random.default_rng(22))
    del dataclasses

    ref = IPMSolver(ArrowBackend, Options()).solve(lp)
    assert ref.status == TerminationStatus.SUCCESSFUL_TERMINATION

    hlp, meta = build_hierarchical_lp(lp, 8, coarse_levels=(4, 2))
    assert len(meta.levels) == 2
    (c2, e2, i2), (c3, e3, i3) = meta.levels
    assert c2 == 4 and c3 == 2
    assert e2 + i2 > 0 and e3 + i3 > 0      # both coarse levels populated
    r4 = IPMSolver(partial(HierArrowBackend, meta=meta),
                   Options()).solve(hlp)
    assert r4.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(r4.objective - ref.objective) < 1e-6 * max(
        1.0, abs(ref.objective))
    assert abs(r4.iterations - ref.iterations) <= 2

    # facade: layers=4 end to end, gathers in original row order
    iface = PIPSIPMppTPUInterface(lp, Options(
        hierarchical=True, hierarchical_layers=4,
        hierarchical_num_groups=8))
    assert iface.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(iface.getObjective() - float(ref.objective)) < 1e-5
    assert np.max(np.abs(iface.gatherPrimalResidsEQ())) < 1e-6

    # depth beyond the useful chain degrades gracefully (chain stops
    # when grouping hits 1) instead of raising
    iface6 = PIPSIPMppTPUInterface(lp, Options(
        hierarchical=True, hierarchical_layers=6,
        hierarchical_num_groups=8))
    assert iface6.run() == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(iface6.getObjective() - float(ref.objective)) < 1e-5
