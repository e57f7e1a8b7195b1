r"""Regularization strategies (reference RegularizationStrategy.h:15-38,
FriedlanderOrbanRegularization.cpp, IpoptRegularization.cpp).

The reference corrects wrong inertia by re-factorizing with primal/dual
shifts chosen by a pluggable strategy.  The batched Cholesky factors give
no inertia oracle (no Bunch-Kaufman pivoting); the failure signal is
`factorization_ok` (non-finite factors), which
plays the role of the reference's inertia test — the escalation schedules
themselves are kept verbatim.

Strategies are PURE and jittable: state is a `(delta_p, delta_d, aux)`
scalar triple, transitions are jnp ops, so the same object drives both the
host outer loop (ipm/solver.py) and the fused on-device `lax.while_loop`
(ipm/device_loop.py).

API (all methods trace-safe):
  init_state(dtype)             -> state
  new_step(state)               -> state   # at the start of a fresh IPM
                                           # iteration (NOT on retries)
  on_failure(state, mu, attempt)-> state   # after a failed factorization
  deltas(state)                 -> (delta_p, delta_d)
  give_up(state)                -> bool    # escalation exhausted
"""
from __future__ import annotations

import jax.numpy as jnp


class GrowthLadder:
    """The always-on inertia-free ladder: constant base shifts, multiplied
    by `growth` on every failed factorization (the framework's historical
    default; within the spirit of the reference's
    factorize_with_correct_inertia loop, LinearSystem.C:296-325)."""

    def __init__(self, base_p: float = 1e-10, base_d: float = 1e-10,
                 growth: float = 100.0, max_delta: float = 1e2,
                 f32_jump_floor: float = 1e-2):
        self.base_p, self.base_d = base_p, base_d
        self.growth = growth
        self.max_delta = max_delta
        # In f32, the condensation loses quasidefiniteness whenever the
        # deltas are orders of magnitude below the f32 roundoff scale of
        # the (equilibrated) KKT diagonals — growth rungs below ~1e-4
        # NEVER rescue a failed f32 factorization, and every wasted rung
        # costs a full re-factorization turn (measured on the flagship
        # bench: 3 rungs burned on the first failure event, and the
        # first sufficient level was ~1e-2).  On failure the first
        # escalation therefore jumps straight to f32_jump_floor in f32;
        # f64 states keep the exact gentle ladder (its small rungs do
        # rescue f64 failures, e.g. structurally singular golden LPs).
        self.f32_jump_floor = f32_jump_floor

    def init_state(self, dtype):
        z = jnp.zeros((), dtype)
        floor = (self.f32_jump_floor
                 if jnp.dtype(dtype) == jnp.float32 else 0.0)
        return (z + self.base_p, z + self.base_d, z + floor)

    def new_step(self, state):
        return state  # sticky: keep the escalated level

    def on_failure(self, state, mu, attempt):
        dp, dd, floor = state
        return (jnp.maximum(dp * self.growth, floor) + 1e-12,
                jnp.maximum(dd * self.growth, floor) + 1e-12, floor)

    def deltas(self, state):
        return state[0], state[1]

    def give_up(self, state):
        return state[0] > self.max_delta


class FriedlanderOrban:
    """Friedlander-Orban scheme (FriedlanderOrbanRegularization.cpp):
    both shifts start at `initial`, DECAY by 10x at every new step down to
    `minimum`, and grow 100x on failure.  Regularizes heavily while mu is
    large and vanishes near convergence.  (The reference reads the dual
    minimum from the PRIMAL_MIN option key — same floor for both here.)"""

    def __init__(self, initial: float = 1.0, minimum: float = 1e-10,
                 increase: float = 100.0, decrease: float = 0.1,
                 max_delta: float = 1e12):
        self.initial, self.minimum = initial, minimum
        self.increase, self.decrease = increase, decrease
        self.max_delta = max_delta

    def init_state(self, dtype):
        z = jnp.zeros((), dtype)
        # ctor pre-divides by the decrease factor so the first new_step
        # lands exactly on `initial` (FriedlanderOrbanRegularization.cpp:21)
        v = self.initial / self.decrease
        return (z + v, z + v, z)

    def new_step(self, state):
        dp, dd, aux = state
        return (jnp.maximum(dp * self.decrease, self.minimum),
                jnp.maximum(dd * self.decrease, self.minimum), aux)

    def on_failure(self, state, mu, attempt):
        dp, dd, aux = state
        return (dp * self.increase, dd * self.increase, aux)

    def deltas(self, state):
        return state[0], state[1]

    def give_up(self, state):
        return state[0] > self.max_delta


class Ipopt:
    """Ipopt-style escalation (IpoptRegularization.cpp): no shift while
    factorizations succeed; on the first failure of a new matrix the dual
    shift is mu^0.25 (the singular-KKT branch — without an inertia oracle
    every failure is treated as potentially singular) and the primal shift
    restarts at `initial` (first ever) or last_success/3; further failures
    multiply by 100 (no prior success) / 8.  aux carries the last
    successful primal shift."""

    barrier_exponent_dual = 0.25
    initial = 1e-4
    decrease = 1.0 / 3.0
    increase_initial = 100.0
    increase = 8.0
    minimum = 1e-20
    maximum = 1e40

    def init_state(self, dtype):
        z = jnp.zeros((), dtype)
        return (z, z, z)   # aux = primal_regularization_last

    def new_step(self, state):
        dp, dd, aux = state
        # remember the shift that produced the accepted factorization and
        # drop back to zero regularization for the fresh matrix
        aux2 = jnp.where(dp > 0.0, dp, aux)
        z = jnp.zeros_like(dp)
        return (z, z, aux2)

    def on_failure(self, state, mu, attempt):
        dp, dd, aux = state
        mu = jnp.asarray(mu, dp.dtype)
        first = attempt == 0
        never_succeeded = aux == 0.0
        dd2 = jnp.where(first, mu ** self.barrier_exponent_dual, dd)
        dp_first = jnp.where(never_succeeded, self.initial,
                             jnp.maximum(self.minimum, self.decrease * aux))
        dp_nth = dp * jnp.where(never_succeeded, self.increase_initial,
                                self.increase)
        return (jnp.where(first, dp_first, dp_nth), dd2, aux)

    def deltas(self, state):
        return state[0], state[1]

    def give_up(self, state):
        return state[0] > self.maximum


def make_regularization(opts):
    """Strategy factory from Options (reference PreprocessFactory-style
    enum dispatch; defaults preserve the historical ladder)."""
    kind = getattr(opts, "regularization_strategy", "ladder")
    if kind == "ladder":
        return GrowthLadder(opts.primal_regularization,
                            opts.dual_regularization,
                            opts.regularization_growth)
    if kind == "friedlander_orban":
        return FriedlanderOrban()
    if kind == "ipopt":
        return Ipopt()
    raise ValueError(f"unknown regularization strategy {kind!r}")
