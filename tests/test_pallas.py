"""f32 factor path: XLA batched Cholesky + explicit inverses, converging
to the f64 objective through iterative refinement."""
import jax.numpy as jnp


def test_xla_cholesky_fallback_matches_f64():
    """ArrowBackend f32 path: plain XLA cholesky + explicit inverse must
    converge to the f64 objective."""
    from functools import partial
    from pips_ipmpp_tpu.core.options import Options, ScalerType
    from pips_ipmpp_tpu.core.status import TerminationStatus
    from pips_ipmpp_tpu.ipm.solver import IPMSolver
    from pips_ipmpp_tpu.linalg.arrow_backend import ArrowBackend
    from pips_ipmpp_tpu.io.synthetic import random_arrowhead_lp
    from pips_ipmpp_tpu.scale import make_scaler

    lp = random_arrowhead_lp(0, N=2, n=48, mE=32, mI=32, n0=4, m0E=2,
                             m0I=2, mEl=2, mIl=2, dtype=jnp.float32)
    solver = IPMSolver(partial(ArrowBackend, factor_dtype=jnp.float32),
                       Options())
    ref = IPMSolver(ArrowBackend, Options()).solve(lp.astype(jnp.float64))
    res = solver.solve(make_scaler(ScalerType.EQUILIBRIUM).scale(lp))
    assert res.status == TerminationStatus.SUCCESSFUL_TERMINATION
    assert abs(res.objective - ref.objective) < 1e-3
