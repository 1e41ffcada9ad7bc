"""Nested solver configuration with dotted-key overrides.

The subset of ``fenapack_tpu/solvers/config.py`` (plain dataclasses) that
the port reads: every field here changes what a solve does.  The JAX
package's other options (lumped and Chebyshev velocity subsolves,
mixed-precision IR rounds, split assembly, ``hi_matvec``) come back with
the code that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Geometric multigrid V-cycles (the velocity block; the pressure Ap
    when its method is ``gmg``, smoothed by damped Jacobi)."""
    smooth_iters: int = 2
    cycles: int = 1


@dataclasses.dataclass(frozen=True)
class VelocityConfig(MultigridConfig):
    """The velocity-block subsolve.

    methods:
      ``gmg`` — geometric multigrid V-cycles (needs a velocity hierarchy)
      ``lu``  — exact dense inverse (validation scale)

    smoothers of the multigrid levels:
      ``jacobi`` — damped Jacobi
      ``minres`` — minimal residual over the Jacobi-preconditioned Krylov
                   directions (nonsymmetric, convection-dominated levels)
    """
    method: str = "gmg"
    smoother: str = "jacobi"


@dataclasses.dataclass(frozen=True)
class SubsolveConfig(MultigridConfig):
    """One SPD pressure solve (Ap or Mp).

    methods:
      ``chebyshev`` — fixed-iteration Jacobi-Chebyshev
      ``gmg``       — geometric multigrid V-cycles (needs a mesh hierarchy)
      ``lu``        — exact dense inverse (validation scale)
    """
    method: str = "gmg"
    iters: int = 10                      # chebyshev iterations
    bounds: Optional[Tuple[float, float]] = None   # spectral bounds override


@dataclasses.dataclass(frozen=True)
class KrylovConfig:
    """The outer FGMRES solve around the compute-dtype preconditioner.
    ``rtol`` is the relative tolerance of :meth:`OseenSolver.solve`; the
    high-precision solve of :meth:`OseenSolver.make_ir_solve` takes its own
    ``rtol``."""
    rtol: float = 1e-8
    maxiter: int = 100
    # selective reorthogonalization threshold (0.0 = unconditional CGS2).
    # eta > 0 runs the second Gram-Schmidt pass only when the first
    # projection shrank |w| below eta * |w_pre| (Kahan-Parlett "twice is
    # enough"); each skipped pass saves the two O(m n) projection/update
    # ops.  Default 0.707 (1/sqrt 2, the classic safe threshold), which the
    # JAX package adopted after an A/B on its TPU at identical iteration
    # counts (results/r4_bench_eta{0,707}.json).
    reorth_eta: float = 0.707
    # compute the PER-STEP convection integrals of the high-precision
    # operator in f32 and cast up, as the JAX package does: a 1e-7-perturbed
    # integral is still a consistent discrete operator (matvec, true
    # residual and preconditioner all read the same values).  Constant
    # integrals (nu L, mass) remain exact f64.
    hi_ops_f32: bool = True
    # ALSO run the nonlinear true residual's convection integrals in f32
    # (fem.assemble.NSAssembler.residual compute32).  The residual sets the
    # attainable nonlinear floor (~1e-7 relative with f32 integrals), so
    # keep False when converging past 1e-8.
    hi_res_f32: bool = False
    # GCRO-DR recycle-space dimension (0 = off): the high-precision solve
    # of OseenSolver.make_ir_solve deflates the slowest Krylov directions
    # of the previous solve (previous Picard or time step: a nearby
    # operator), re-bound to the new operator by refresh_recycle
    recycle: int = 0


@dataclasses.dataclass(frozen=True)
class PCDConfig:
    variant: str = "BRM2"                # BRM1 | BRM2
    ap: SubsolveConfig = SubsolveConfig(method="gmg")
    # Jacobi-scaled P1 mass spectrum is mesh-uniform (Wathen's bounds):
    # [1/2, 2] on triangles.  4 iterations at these bounds (min-max residual
    # 4.3e-2) reproduce-or-beat oracle outer counts in the JAX package
    # (step2d l0 BRM2 304@4 == oracle, l1 301@4 vs 302@6).
    mp: SubsolveConfig = SubsolveConfig(method="chebyshev", iters=4,
                                        bounds=(0.5, 2.5))


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    krylov: KrylovConfig = KrylovConfig()
    pcd: PCDConfig = PCDConfig()
    velocity: VelocityConfig = VelocityConfig()
    dtype: str = "float64"               # the preconditioner's compute dtype
    # add SUPG streamline diffusion to the preconditioner's velocity
    # operator only (the reference demo's separate J_pc form); the system
    # operator stays unstabilized
    jpc_supg: bool = False
    # SUPG-stabilize the system (residual and Picard operator), BASELINE
    # config 5 (Re 2000-5000): the Galerkin system is oscillatory at cell
    # Peclet >> 1.  Implies the stabilized preconditioner operators too.
    system_supg: bool = False


def override(cfg: Any, key: str, value: Any) -> Any:
    """Return a copy of ``cfg`` with dotted ``key`` replaced, e.g.
    ``override(cfg, "pcd.ap.cycles", 2)``.  An unknown key raises."""
    head, _, rest = key.partition(".")
    if rest:
        sub = override(getattr(cfg, head), rest, value)
        return dataclasses.replace(cfg, **{head: sub})
    return dataclasses.replace(cfg, **{head: value})


def overrides(cfg: Any, mapping: dict) -> Any:
    for k, v in mapping.items():
        cfg = override(cfg, k, v)
    return cfg
