"""Runtime configuration for the FMM executor and the Krylov solvers.

Option objects, after the reference's:
- ``FMMConfig``   mirrors include/FMMOptions.hpp (MAC theta, NCRIT,
  FMM-vs-treecode evaluator choice) plus array-framework knobs (dtype,
  tile sizes) the reference has no equivalent of.
- ``SolverConfig`` mirrors examples/BEM/SolverOptions.hpp:11-39 including
  the paper's relaxation-order predictor ``predict_p``
  (SolverOptions.hpp:25-38).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class Evaluator(enum.Enum):
    """FMM (M2L + downward pass) or treecode (M2P at targets).

    Ref: include/FMMOptions.hpp:17-18 (EvalType {FMM, TREECODE}).
    """

    FMM = "fmm"
    TREECODE = "treecode"


class RelaxType(enum.Enum):
    """Relaxation strategy for the GMRES truncation-order schedule.

    Ref: examples/BEM/SolverOptions.hpp:13 (SIMONCINI / BOURAS).
    """

    SIMONCINI = "simoncini"
    BOURAS = "bouras"


@dataclasses.dataclass
class FMMConfig:
    """Options controlling tree build, traversal and evaluation.

    The MAC accepts a box pair for far-field interaction when
    ``|c1 - c2|^2 > ((r1 + r2) / theta)^2`` with ``r`` the box half-side
    (ref: include/FMMOptions.hpp:21-31 DefaultMAC). Defaults match the
    reference: theta = 0.5, ncrit = 64, FMM evaluator
    (FMMOptions.hpp:39-48).
    """

    theta: float = 0.5
    ncrit: int = 64
    #: dump the ASCII box hierarchy at plan build (ref FMMOptions
    #: printTree / Octree.hpp:736-753)
    print_tree: bool = False
    #: rebuild the tree once with a smaller ncrit when the max/mean
    #: leaf-occupancy ratio exceeds 2 (leaf tiles pad to the MAX, so
    #: one full leaf against a low mean taxes every near tile).  The
    #: reference ships tests/ncrit_search.cpp for manual tuning instead.
    auto_ncrit: bool = True
    evaluator: Evaluator = Evaluator.FMM
    #: maximum octree depth (ref MortonCoder: 10 levels, Octree.hpp:87-89)
    max_level: int = 10
    #: expansion order the device buffers are allocated at; ``set_p``-style
    #: relaxation selects p <= max_p per matvec (ref LaplaceSpherical.hpp:119-128)
    max_p: int = 16
    #: element dtype for device arrays ("float32" on the GPU, "float64"
    #: for CPU-based accuracy tests)
    dtype: str = "float32"
    #: pad M2L translation-class segments to multiples of this many pairs
    #: so each tile is a single dense matmul.  32 balances per-class
    #: padding waste (most classes are small) against matmul row
    #: occupancy (ncomp folds into rows, so a BEM tile is still [64, W])
    m2l_tile: int = 32
    #: group same-level M2L pairs by (source-parent, target-parent)
    #: FAMILY: one dense [8W, 8W] class operator per quantised parent
    #: offset serves all the family's child pairs, the expansion gather
    #: moves 8x-wider rows (sibling-contiguous family tiles) and far
    #: fewer of them.  See
    #: executor/plan._build_m2l_families.
    m2l_family: bool = True
    #: chunk sizes bounding transient memory of gather-heavy ops
    p2p_chunk: int = 1024
    #: evaluate the precomputed near field as bucketed dense leaf
    #: panels (the hand-written near_panel kernel on the GPU) instead
    #: of a COO gather/scatter — the dense-tile form of the
    #: reference's cached CSR
    #: (EvalInteractionLazySparse.hpp:112)
    near_panel: bool = True
    #: BEM near-field storage: "cached" streams the precomputed panel
    #: store (p-independent, the reference's EvalInteractionLazySparse
    #: default — fastest, but the store grows linearly with N and
    #: bounds the single-device problem size); "otf" recomputes the
    #: regular K-point quadrature
    #: inside the matvec (the reference's plain lazy evaluator,
    #: EvalInteractionLazy.hpp:239-252) and caches only the O(N)
    #: near-singular corrections as deltas (not ported yet: the plan
    #: raises NotImplementedError for it)
    near_mode: str = "cached"
    #: pairs per on-the-fly near chunk (bounds the transient geometry
    #: bytes: ~chunk * KT*KS*K * 16 B)
    near_otf_chunk: int = 1024
    #: near-field-only evaluation (no far field) — the preconditioner
    #: operator mode (ref FMMOptions local_evaluation + EvalLocal/
    #: EvalLocalSparse)
    local_evaluation: bool = False
    #: restrict the near field to leaf self-interaction blocks — the
    #: block-Jacobi operator (ref FMMOptions block_diagonal +
    #: EvalDiagonalSparse)
    block_diagonal: bool = False
    #: pin the leaf-tile width (must be >= the max leaf occupancy,
    #: which ncrit bounds).  Keeps P2P/near block shapes constant
    #: across problem sizes — scaling sweeps use it to eliminate
    #: tree-shape artifacts from weak-scaling comparisons
    leaf_pad: Optional[int] = None
    #: drop-tolerance for the precomputed sparse near field: entries
    #: with |value| <= droptol are dropped at plan build — the paper's
    #: inexact-matvec knob the reference carries in
    #: SparseMatrix::dot(x, droptol) (include/SparseMatrix.hpp:51-74)
    droptol: float = 0.0

    def mac_accept(self, c1, r1, c2, r2):
        """Vectorised multipole-acceptance criterion (numpy arrays)."""
        import numpy as np

        d2 = ((c1 - c2) ** 2).sum(axis=-1)
        rhs = (r1 + r2) / self.theta
        # tie-consistent (ties pass) — must match traversal/lists.py
        return d2 > rhs * rhs * (1.0 - 1e-12)


@dataclasses.dataclass
class SolverConfig:
    """GMRES/FGMRES options + the inexact-Krylov relaxation schedule.

    Defaults per examples/BEM/SolverOptions.hpp:17-23: tol 1e-5,
    500 iterations, restart 500, max_p 16, p_min 5, variable_p on,
    Bouras-Fraysse relaxation.
    """

    residual: float = 1e-5
    max_iters: int = 500
    restart: int = 500
    max_p: int = 16
    p_min: int = 5
    variable_p: bool = True
    relax_type: RelaxType = RelaxType.BOURAS
    #: calibrated matvec-error model eps(p) = eps_c * eps_gamma**p.
    #: The reference hardcodes eps ~ 2^-p — its own TODO flags this as
    #: Laplace-sphere-specific ("predict p for Spherical Laplace kernel
    #: -- abstract out", SolverOptions.hpp:32).  FmmPlan.calibrate_eps
    #: measures the actual per-kernel/per-geometry decay and
    #: ``calibrated()`` installs it here; None keeps the 2^-p default.
    eps_c: Optional[float] = None
    eps_gamma: Optional[float] = None
    #: quantise the relaxed schedule UP to these orders (e.g. (3, 5,
    #: 10)).  The cached near field is p-independent, so the matvec
    #: cost grows slowly with p and paying one or two extra orders
    #: costs little, while every distinct order needs its own set of
    #: device tables.  None keeps the reference's fully continuous
    #: schedule (SolverOptions.hpp:25-38).
    p_tiers: Optional[tuple] = None
    #: smallest order the calibration actually probed.  The fitted
    #: gamma is only evidence INSIDE the probed range — a fit over
    #: p >= 4 underestimates the true p=1 truncation error, and
    #: extrapolating it below stalls the solve.  Calibrated
    #: predictions are clamped to >= this order; None (uncalibrated
    #: 2^-p model) keeps the reference's unfloored schedule.
    eps_p_lo: Optional[int] = None

    def _p_for_nu(self, nu: float) -> int:
        """Smallest order whose matvec error model is below ``nu``."""
        if nu <= 0.0:
            return self.max_p
        if self.eps_c is not None and self.eps_gamma is not None:
            lo = self.eps_p_lo or 1
            if nu >= self.eps_c:
                return min(lo, self.max_p)
            # eps_c * gamma^p <= nu  (0 < gamma < 1)
            p = math.ceil(
                math.log(nu / self.eps_c) / math.log(self.eps_gamma)
            )
            return min(max(int(p), 1, lo), self.max_p)
        if nu >= 1.0:
            return 1
        return min(int(math.ceil(-math.log2(nu))), self.max_p)

    def predict_p(self, eps: float) -> int:
        """Multipole order needed for an inexact matvec at residual ``eps``.

        Bouras-Fraysse: nu = min(alpha * tol, 1), alpha = 1 / min(eps, 1).
        Simoncini: nu = eps.  The order is the smallest p whose error
        model eps(p) is below nu — eps(p) = 2^-p by default (the
        reference's model, SolverOptions.hpp:25-38) or the calibrated
        ``eps_c * eps_gamma**p`` when installed.
        """
        if self.relax_type is RelaxType.BOURAS:
            alpha = 1.0 / min(eps, 1.0)
            nu = min(alpha * self.residual, 1.0)
        else:
            nu = min(eps, 1.0) if eps > 0.0 else 0.0
        return self._p_for_nu(nu)

    def calibrated(self, plan, q=None, ps=None) -> "SolverConfig":
        """Copy of this config with the eps(p) model measured on ``plan``
        (FmmPlan.calibrate_eps).  If truncation is indistinguishable on
        the plan (calibrate_eps returns (None, None)) the 2^-p default
        is kept.  The smallest probed order becomes ``eps_p_lo`` — the
        model is never extrapolated below its evidence."""
        c, gamma = plan.calibrate_eps(q=q, ps=ps)
        lo = None
        if c is not None and getattr(plan, "eps_samples", None):
            lo = min(plan.eps_samples)
        return dataclasses.replace(
            self, eps_c=c, eps_gamma=gamma, eps_p_lo=lo
        )

    def schedule_p(
        self,
        resid: float,
        p_fixed: Optional[int] = None,
        boost: int = 0,
    ) -> int:
        """The per-iteration order: fixed, or relaxed from the residual.

        The relaxed order is floored at ``p_min`` — the reference's
        Stokes solver floor (GMRES_Stokes.hpp:229
        ``max(opts.p_min, predict_p(resid)-1)``; FGMRES :373) — so a
        relaxed solve can never drop to orders where the matvec is too
        inexact to keep the Krylov recurrence meaningful.  Callers that
        want the reference scalar-GMRES behaviour (``max(1, predict_p)``,
        GMRES.hpp:195) pass ``p_min=1``.

        ``boost`` is the solver's stall-guard increment.  It is applied
        BEFORE tier quantisation so a boosted order still lands on a
        configured ``p_tiers`` entry — a boost minting an order outside
        the tier set would build an unplanned set of tables mid-solve.
        """
        if p_fixed is not None or not self.variable_p:
            return p_fixed if p_fixed is not None else self.max_p
        p = max(1, self.p_min, self.predict_p(resid))
        p = min(p + boost, self.max_p)
        return self.quantize_p(p)

    def quantize_p(self, p: int) -> int:
        """Round ``p`` up to the nearest entry of ``p_tiers``; above the
        largest tier, clamp to it (the tier list defines the available
        solver tiers).  No-op when unset."""
        if not self.p_tiers:
            return p
        for t in sorted(self.p_tiers):
            if p <= t:
                return min(t, self.max_p)
        return min(max(self.p_tiers), self.max_p)


def default_p_tiers(max_p: int) -> tuple:
    """Recommended relaxed-schedule quantisation.

    The cached near field is p-independent, so paying an order or two
    extra costs little, while every distinct order needs its own
    device tables.  Three tiers ending at ``max_p`` cover the whole
    Bouras schedule.
    """
    return tuple(sorted({t for t in (3, 5) if t < max_p} | {max_p}))
