"""Timing/observability: per-phase wall-clock monitor + iteration statistics.

The analogs of the reference's StochNodeResourcesMonitor (per-node
fact/Lsolve/Dsolve/Ltsolve timers, Core/Problems/StochResourcesMonitor.hpp:
35-60), the TIMING build-flag phase prints (PIPSIPMppInterface.cpp:29-124),
and Statistics (rank-0 per-iteration log lines, Core/InteriorPointMethod/
Statistics.cpp).  On the device, intra-step phase granularity comes from
the JAX profiler (`with jax.profiler.trace(...)`) — the monitor exposes a
helper to wrap a solve in a trace; wall-clock phases are tracked
host-side.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


class ResourceMonitor:
    """Accumulating named phase timers (thread-unsafe by design: one per
    solve, like the per-node monitors in the reference)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 6),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name]
                                        / max(self.counts[name], 1), 3)}
                for name in sorted(self.totals)}

    def pretty(self) -> str:
        lines = ["phase                 total[s]   count   mean[ms]"]
        for name, d in self.report().items():
            lines.append(f"{name:<20} {d['total_s']:>9.3f} {d['count']:>7} "
                         f"{d['mean_ms']:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Wrap a region in a JAX profiler trace (TensorBoard-compatible) —
    the replacement for the reference's -DWITH_TIMING spans."""
    import jax
    with jax.profiler.trace(logdir):
        yield


@dataclass
class Statistics:
    """Per-iteration convergence log (reference Statistics.cpp format:
    objective, residual norms, mu, step lengths at print_level >= 10)."""
    print_level: int = 0
    rows: list = field(default_factory=list)

    def record(self, iteration: int, objective: float, mu: float,
               residual_norm: float, duality_gap: float,
               alpha_primal: float = float("nan"),
               alpha_dual: float = float("nan"),
               n_gondzio: int = 0) -> None:
        row = dict(iteration=iteration, objective=objective, mu=mu,
                   residual_norm=residual_norm, duality_gap=duality_gap,
                   alpha_primal=alpha_primal, alpha_dual=alpha_dual,
                   n_gondzio=n_gondzio)
        self.rows.append(row)
        if self.print_level >= 10:
            print(f"iter {iteration:4d}  obj {objective: .8e}  "
                  f"mu {mu:.3e}  resid {residual_norm:.3e}  "
                  f"gap {duality_gap:.3e}  "
                  f"a_p {alpha_primal:.3f}  a_d {alpha_dual:.3f}  "
                  f"gondzio {n_gondzio}")

    def summary(self) -> dict:
        if not self.rows:
            return {}
        last = self.rows[-1]
        return dict(iterations=len(self.rows), final_mu=last["mu"],
                    final_residual=last["residual_norm"],
                    final_objective=last["objective"])
