"""pips_ipmpp_tpu — structured interior-point solver in JAX.

A JAX/XLA framework with the capabilities of PIPS-IPM++
(reference: NCKempke/PIPS-IPMpp): a massively parallel Mehrotra/Gondzio
interior-point solver for doubly bordered block-diagonal ("generalized
arrowhead") linear programs.

Architecture (batched device linear algebra, not a port):
  - Scenario/region blocks are stored as *batched dense padded* arrays and
    sharded over a `jax.sharding.Mesh` axis ("blocks"); linking/first-stage
    data is replicated.  (Reference: blocks->MPI-ranks contiguous map,
    Core/Readers/Distributed/DistributedTree.C:35-90.)
  - Each IPM iteration condenses every block KKT to an SPD normal-equations
    matrix and factorizes all of them with one batched Cholesky
    (the role PARDISO's Schur feature plays in the reference,
    PIPS-IPM/Core/LinearSolvers/PardisoSolver/PardisoSchurSolver.C).
  - The Schur complement over linking variables + linking rows is assembled
    with `psum`/`reduce_scatter` collectives between devices (the role of
    chunked MPI_Allreduce, Core/KKTFormulation/LinearSystems/DistributedRootLinearSystem.C:860-975).
  - Precision: factorization in the working dtype (or f32 on request) +
    f64 residuals and iterative refinement (the role iterative refinement
    + outer BiCGStab play in the reference, Core/KKTFormulation/LinearSystems/LinearSystem.C:449-515).
"""

__version__ = "0.1.0"

from pips_ipmpp_tpu.core.lp import ArrowheadLP, DenseLP
from pips_ipmpp_tpu.core.options import Options
from pips_ipmpp_tpu.core.status import TerminationStatus
from pips_ipmpp_tpu.interface import PIPSIPMppTPUInterface

__all__ = [
    "ArrowheadLP",
    "DenseLP",
    "Options",
    "TerminationStatus",
    "PIPSIPMppTPUInterface",
]
