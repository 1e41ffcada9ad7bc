"""The lid-driven cavity slice of the port: its configuration and solver.

BASELINE config 2 at the resolution of Ghia, Ghia & Shin (J. Comput. Phys.
48:387-411, 1982; 129 x 129 points): ``cavity_mesh(0)`` refined four times,
128 x 128 cells, 148,739 dofs, five multigrid levels.  Newton with PCD-BRM2
(enclosed flow: no PCD Dirichlet rows, constant pressure nullspace), ELL
operators in f64, velocity multigrid with 3 Jacobi sweeps and 2 cycles,
pressure multigrid, FGMRES to 1e-8 with at most 200 iterations, Reynolds
continuation 100 -> 200 -> 400 -> 500, each stage warm from the last and
converged to a nonlinear relative residual of 1e-5.
"""
from __future__ import annotations

from .models import LidDrivenCavity
from .solvers import gmg

LEVEL = 4
RE = (100.0, 200.0, 400.0, 500.0)
CFG = {"velocity.smooth_iters": 3, "velocity.cycles": 2,
       "krylov.maxiter": 200, "krylov.rtol": 1e-8}
RTOL, MAX_STEPS = 1e-5, 30


def build(level: int, Re: float, *, device, hier=None):
    """The slice's solver through the model entry point, at ``level`` and
    Reynolds number ``Re``.  ``hier`` (the multigrid hierarchy of the same
    level) is reused across the stages of a continuation when given."""
    p = LidDrivenCavity(level=level, nu=1.0 / Re, device=str(device))
    asm = p.assembler(hier.fine) if hier is not None else None
    return p.solver("BRM2", linearization="newton", gmg_subsolves=True,
                    asm=asm, hier=hier, **CFG)


def ell_operators(nl):
    """``(name, pattern, values)`` of every ELL operator the slice applies,
    with the values of its first Newton state: A1 and the four Newton
    blocks R_ab on every velocity level, D and B^T, Ap on every pressure
    level, Mp and Kp."""
    o, asm = nl.oseen, nl.asm
    wind = nl.initial_state()[:nl.n_u]
    vh, ph = o.velocity_hierarchy, o.ap_hierarchy
    levels = gmg.velocity_gmg_values(
        vh, wind, o.bc_mask_u, o.dtype, newton=True,
        fine_values=o._operator_values(wind))["levels"]
    ops = []
    for l, (lasm, (A1, R)) in enumerate(zip(vh.asms, levels)):
        ops.append((f"A1 velocity level {l}", lasm.pat_p2, A1))
        ops += [(f"R{a}{b} velocity level {l}", lasm.pat_p2, R[a, b])
                for a in range(2) for b in range(2)]
    ops += [(f"D{a}", asm.pat_div, asm.const.D[a].vals) for a in range(2)]
    ops += [(f"Bt{a}", asm.pat_divT, asm.const.DT[a].vals)
            for a in range(2)]
    ops += [(f"Ap pressure level {l}", lev.asm.pat_p1, lev.Ap.vals)
            for l, lev in enumerate(ph.levels)]
    ops += [("Mp", asm.pat_p1, asm.const.Mp.vals),
            ("Kp", asm.pat_p1, asm.kp_values(wind, surface=True))]
    return ops
