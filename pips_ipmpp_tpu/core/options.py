"""Solver options.

The reference uses a three-tier singleton of string->{bool,int,double} maps
with `.opt`-file parsing of `NAME VALUE TYPE` lines (Core/Options/
AbstractOptions.C:73, PIPSIPMppOptions.C:194-400, README.md:100-106).
Here: one typed frozen dataclass; `.opt` files in the same line format are
accepted for compatibility and override fields by (case-insensitive) name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum


class ScalerType(Enum):
    """Reference Core/Preprocessing/PreprocessType.h:8."""
    NONE = 0
    EQUILIBRIUM = 1
    GEOMETRIC_MEAN = 2
    GEOMETRIC_MEAN_EQUILIBRIUM = 3
    CURTIS_REID = 4


class PresolverType(Enum):
    NONE = 0
    PRESOLVE = 1


class StepMode(Enum):
    """Reference InteriorPointMethodType.hpp:8 (PRIMAL vs PRIMAL_DUAL step rule)."""
    PRIMAL = 0       # one common step length for primal+dual
    PRIMAL_DUAL = 1  # separate primal/dual step lengths ("stepLp" in gmspips)


_ENUM_FIELDS = {"scaler": ScalerType, "presolve": PresolverType,
                "step_mode": StepMode}


@dataclass(frozen=True)
class Options:
    # ---- IPM termination (reference PIPSIPMppSolver.hpp:56-57, .cpp:13-26) ----
    max_iterations: int = 300
    mu_tolerance: float = 1e-6
    residual_tolerance: float = 1e-4       # relative to data norm
    reduced_accuracy: bool = False         # mu 1e-5 / resid 1e-3
    # divergence / slow progress detection (PIPSIPMppSolver.cpp:164-185)
    divergence_mu: float = 1e8

    # ---- step rule & correctors (reference InteriorPointMethod.cpp) ----
    step_mode: StepMode = StepMode.PRIMAL_DUAL
    max_gondzio_correctors: int = 3        # GONDZIO_MAX_CORRECTORS
    n_linesearch_points: int = 8           # weighted PC line search resolution
    steplength_factor: float = 0.99995     # final step damping (reference
                                           # steplength_factor, IPM.hpp:104)
    gamma_f: float = 0.99                  # blocking-pair safeguard floor
    # (reference gamma_f, InteriorPointMethod.hpp:101); gamma_a = 1/(1-gf)
    # divides mu(alpha_max) in the Mehrotra step-length target

    @property
    def gamma_a(self) -> float:
        return 1.0 / (1.0 - self.gamma_f)
    beta_min: float = 0.1                  # Gondzio target box [σμ βmin, σμ βmax]
    beta_max: float = 10.0
    acceptance_tolerance: float = 0.01     # corrector acceptance fraction
    step_factor0: float = 0.3              # Gondzio trial-step enlargement:
    step_factor1: float = 1.5              # alpha_t = min(1, f1*alpha + f0)
                                           # (InteriorPointMethod.cpp:29,253)
    centering_retry: bool = True           # pure-centering retry on tiny
                                           # steps (numerical-troubles path)
    small_step_threshold: float = 0.01     # combined-step trouble trigger

    # ---- numerical-troubles machinery (InteriorPointMethod.cpp:528-669) --
    # small-complementarity-pair correctors: when a normal Gondzio corrector
    # is rejected with alpha below max_alpha_small_correctors (and the IPM
    # iteration is late enough), retry with the upper projection bound at
    # +inf so only tiny pairs are pushed (GONDZIO_STOCH_ADDITIONAL_
    # CORRECTORS_SMALL_VARS, compute_gondzio_corrector :446-457)
    small_pair_correctors: bool = True
    max_additional_correctors: int = 1     # GONDZIO_STOCH_ADDITIONAL_..._MAX
    first_iter_small_correctors: int = 10  # GONDZIO_STOCH_FIRST_ITER_...
    max_alpha_small_correctors: float = 0.95
    # probing: damp the accepted step so residual norm and mu grow at most
    # 10x when the step looks troubled (compute_probing_factor :528-627)
    probing: bool = True
    probing_trigger: float = 0.05          # min(alpha) below this => probe
    # iteration-adaptive outer-BiCGStab tolerance (:655-669)
    dynamic_bicg_tol: bool = True
    outer_bicg_tol: float = 1e-10

    # ---- linear algebra ----
    factor_dtype: str = "auto"             # "float32" | "float64" | "auto"
    # process-global precision of f32 matmuls (jax_default_matmul_precision):
    # "highest" = full f32, the default; on the GPU "high" and "default"
    # mean TF32 (10-bit mantissa), too coarse for f32 factors.  f64
    # matmuls are unaffected.
    matmul_precision: str = "highest"
    primal_regularization: float = 1e-10   # delta_p (Friedlander-Orban style)
    dual_regularization: float = 1e-10     # delta_d
    regularization_growth: float = 100.0   # escalation on factorization failure
    max_regularization_retries: int = 6
    # escalation schedule on factorization failure (reference
    # RegularizationStrategy.h:15-38): "ladder" (historical default),
    # "friedlander_orban" (decay 10x per step, grow 100x on failure),
    # "ipopt" (zero until failure, mu^0.25 dual, last/3 restart)
    regularization_strategy: str = "ladder"
    # linear residual updates in the fused device loop: the Newton
    # directions satisfy the eliminated KKT rows exactly by construction
    # (formulation.recover_step), and every solve's residual rows are
    # -res, so stepping scales primal rows by (1-alpha_p) and dual rows
    # by (1-alpha_d) EXACTLY up to reduced-solve error.  k > 0 carries
    # residuals and re-evaluates the matvecs only every k iterations
    # (and whenever mu nears tolerance, so termination decisions always
    # use exact residuals).  0 = evaluate every iteration (reference
    # behavior, Residuals::evaluate per iteration).
    residual_update_every: int = 0
    refinement_steps: int = 4              # max adaptive refinement sweeps
                                           # (early exit on small residual;
                                           # the exit threshold is relative,
                                           # 1e-11 * ||rhs|| in the backends)
    outer_bicgstab: bool = False           # OUTER_SOLVE=2 analog
    outer_max_iters: int = 8
    sc_blockwise: int = 0                  # >0: stream the Schur computation
                                           # in column chunks of this size
                                           # (SC_COMPUTE_BLOCKWISE analog)
    # iterative root with sparsified block-Jacobi preconditioner (reference
    # PRECONDITION_SPARSE + SCsparsifier, SCsparsifier.h:18-58): >0 sets
    # the preconditioner panel size; the dual Schur complement is solved
    # by preconditioned CG instead of a dense Cholesky — O(nD*pb^2) factor
    # work when the linking dimension nD gets large
    iterative_root_panel: int = 0
    # densify SparseArrowheadLPs whose dense B/D twin fits this budget
    # (MB) and run them on the batched-dense path (the SURVEY's "decide
    # empirically per block size" sizing rule).  The 256 MB default was
    # chosen on the earlier accelerator and is unmeasured on the GPU;
    # 0 = never densify (always the ELL leaf).
    sparse_densify_max_mb: float = 256.0
    sc_diag_dom_bound: float = 0.001       # diagDomBounds[0]
    it_root_tol: float = 1e-9
    it_root_maxiter: int = 200
    # structure exploitation (the reference's sparse leaf solver and
    # 2-link sparse-SC machinery): banded_leaf factors each block's
    # condensed normal equations block-tridiagonally after a host-side
    # RCM ordering (linalg/band_backend.py); banded_root orders linking
    # rows by block-support window and factors the dual Schur complement
    # banded (linalg/band_root.py).  Both plan from the LP handed to the
    # interface (patterns only shrink under presolve/scaling).
    banded_leaf: bool = False
    banded_root: bool = False

    # ---- preprocessing ----
    scaler: ScalerType = ScalerType.NONE
    presolve: PresolverType = PresolverType.NONE
    presolve_max_rounds: int = 2           # PRESOLVE_MAX_ROUNDS

    # ---- parallel ----
    hierarchical: bool = False
    hierarchical_layers: int = 2
    hierarchical_num_groups: int = 0   # 0 = auto (divisor of N near sqrt(N),
                                       # the reference's splitTree policy)

    # ---- observability ----
    print_level: int = 0
    record_history: bool = True

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @staticmethod
    def from_opt_file(path: str, base: "Options | None" = None) -> "Options":
        """Parse reference-style `.opt` file: lines `NAME VALUE TYPE` where
        TYPE in {bool,int,double} (AbstractOptions.C:73; README.md:100-106).
        Unknown names are ignored (reference warns); names are matched
        case-insensitively against field names, and the REFERENCE's own
        option names (PIPSIPMppOptions.C) are accepted via the alias
        table below so a PIPS-IPM++ user's .opt file keeps working."""
        # reference option name -> (our field, value transform)
        ref_aliases = {
            "gondzio_max_correctors": ("max_gondzio_correctors", None),
            "gondzio_stoch_n_linesearch": ("n_linesearch_points", None),
            "hierarchical": ("hierarchical", lambda v: bool(v)),
            "hierarchical_approach_n_layers": ("hierarchical_layers", None),
            "outer_solve": ("outer_bicgstab", lambda v: int(v) == 2),
            "outer_bicg_max_iter": ("outer_max_iters", None),
            "presolve": ("presolve",
                         lambda v: PresolverType.PRESOLVE if int(v)
                         else PresolverType.NONE),
            "presolve_max_rounds": ("presolve_max_rounds", None),
            "scaler": ("scaler", lambda v: ScalerType(int(v))),
            "sc_compute_blockwise": (
                "sc_blockwise", lambda v: 64 if bool(v) else 0),
            "precondition_sparse": (
                "iterative_root_panel", lambda v: 64 if bool(v) else 0),
            "regularization_strategy": (
                "regularization_strategy",
                lambda v: {0: "ladder", 1: "friedlander_orban",
                           2: "ipopt"}.get(int(v), "ladder")),
        }
        opts = base or Options()
        fields = {f.name.lower(): f.name for f in dataclasses.fields(Options)}
        overrides = {}
        with open(path) as fh:
            for line in fh:
                parts = line.split("#")[0].split()
                if len(parts) != 3:
                    continue
                name, value, typ = parts
                if typ == "bool":
                    val = value.lower() in ("true", "1", "yes")
                elif typ == "int":
                    val = int(value)
                elif typ == "double":
                    val = float(value)
                else:
                    continue
                key = fields.get(name.lower())
                if key is not None:
                    # enum-typed fields take the reference's int encoding
                    # (orderings match PreprocessType.h et al.)
                    enum_cls = _ENUM_FIELDS.get(key)
                    overrides[key] = enum_cls(int(val)) if enum_cls else val
                    continue
                alias = ref_aliases.get(name.lower())
                if alias is not None:
                    key, transform = alias
                    overrides[key] = transform(val) if transform else val
        return opts.replace(**overrides)

    def tolerances(self) -> tuple[float, float]:
        if self.reduced_accuracy:
            return 1e-5, 1e-3
        return self.mu_tolerance, self.residual_tolerance
