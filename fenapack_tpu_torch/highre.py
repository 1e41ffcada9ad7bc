"""The high-Reynolds slice of the port (BASELINE config 5): the
SUPG-stabilized backward-facing step under damped Picard, its configuration
and command line.

    python -m fenapack_tpu_torch.highre -l 2 --nu 1e-3 --max-steps 40
    python -m fenapack_tpu_torch.highre -l 2 --nu 4e-4 --smoother minres \\
        --recycle 16

BASELINE config 5, "High-Re (Re=2000-5000) SUPG-stabilized Oseen": the 2D
backward-facing step of the step benchmark (inflow parabola of peak 1,
Re = 2 / nu), Taylor-Hood P2/P1 on ``backward_step_mesh(0)`` refined
``level`` times (level 2: 25,987 dofs), the streamline diffusion of Elman,
Silvester & Wathen in the residual and the Picard operator
(``system_supg``), Picard steps damped by 0.7.  Each step is one f64 FGMRES
solve to 1e-8 around PCD-BRM2 (pressure multigrid with the outflow rows,
Mp by Chebyshev) and velocity multigrid (3 Jacobi or minres smoothing steps,
2 cycles), ELL operators in f64, at most 1000 iterations.  This is the JAX
demo's ``--ls iterative --supg --supg-system`` path
(``demos/demo_navier_stokes_pcd.py``); ``--recycle k`` threads a GCRO-DR
space of ``k`` directions from step to step.
"""
from __future__ import annotations

import argparse
import time

import torch

from .models import StepFlow2D
from .solvers import gmg

NU = 1e-3                        # Re 2000
DAMPING = 0.7
RTOL = 1e-5                      # nonlinear relative residual
RTOL_LIN = 1e-8
# the JAX package's f64 CPU run needed up to 346 iterations for 1e-8 at
# level 1, Re 2000, and 435 for 1e-6 at Re 5000: 500 is too tight at level 2
CFG = {"system_supg": True, "velocity.smooth_iters": 3,
       "velocity.cycles": 2, "krylov.maxiter": 1000}


def build(level: int, nu: float = NU, *, device, smoother: str = "jacobi",
          recycle: int = 0, hier=None):
    """The slice's Picard solver through the model entry point at
    ``level`` and viscosity ``nu`` (Re = 2 / nu), with the velocity
    multigrid's ``smoother`` ("jacobi" or "minres") and a GCRO-DR space of
    ``recycle`` directions (0: none).  ``hier`` (the hierarchy of the same
    level) is reused when given."""
    p = StepFlow2D(level=level, nu=nu, device=str(device))
    asm = p.assembler(hier.fine) if hier is not None else None
    return p.solver("BRM2", linearization="picard", gmg_subsolves=True,
                    asm=asm, hier=hier, **CFG,
                    **{"velocity.smoother": smoother,
                       "krylov.recycle": recycle})


def velocity_levels(nl, wind: torch.Tensor):
    """``(pattern, A1)`` of every P2 velocity multigrid level, coarse to
    fine, at ``wind``: the stabilized Picard operators the V-cycle
    applies (no reaction blocks)."""
    o = nl.oseen
    vh = o.velocity_hierarchy
    vals = gmg.velocity_gmg_values(
        vh, wind, o.bc_mask_u, o.dtype, fine_values=o._operator_values(wind),
        supg=True)
    return [(lasm.pat_p2, A1) for lasm, (A1, _) in zip(vh.asms,
                                                       vals["levels"])]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="BASELINE config 5: SUPG-stabilized damped Picard on "
                    "the backward-facing step at Re = 2 / nu")
    ap.add_argument("-l", "--level", type=int, default=2,
                    help="refinements of the level-0 step mesh")
    ap.add_argument("--nu", type=float, default=NU)
    ap.add_argument("--damping", type=float, default=DAMPING)
    ap.add_argument("--max-steps", type=int, default=40)
    ap.add_argument("--rtol", type=float, default=RTOL)
    ap.add_argument("--rtol-lin", type=float, default=RTOL_LIN)
    ap.add_argument("--recycle", type=int, default=0,
                    help="GCRO-DR recycle-space dimension (0: off)")
    ap.add_argument("--smoother", choices=("jacobi", "minres"),
                    default="jacobi")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device.startswith("cuda")
    if cuda:
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    nl = build(args.level, args.nu, device=args.device,
               smoother=args.smoother, recycle=args.recycle)
    print(f"backward-facing step  l={args.level}  nu={args.nu:g}  "
          f"Re={2 / args.nu:.0f}  dofs={nl.n}  damping={args.damping}  "
          f"recycle={args.recycle}  smoother={args.smoother}", flush=True)
    print("step,|F|,iters,lin_rel,seconds", flush=True)
    last = [time.perf_counter()]

    def report(k, rn, iters, lin_rel, *_):
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"{k},{rn:.10e},{iters},{lin_rel:.3e},{now - last[0]:.4f}",
              flush=True)
        last[0] = now

    r = nl.solve_fused(rtol=args.rtol, rtol_lin=args.rtol_lin,
                       max_steps=args.max_steps, damping=args.damping,
                       callback=report)
    n = len(r.linear_iters)
    print(f"\nconverged: {r.converged}  steps: {n}  final |F| "
          f"{r.nonlinear_res[-1]:.6e} (|F_0| {r.nonlinear_res[0]:.6e})")
    print(f"iters per step: {r.linear_iters} (total {sum(r.linear_iters)}, "
          f"cap {CFG['krylov.maxiter']}); max linear true rel res "
          f"{max(r.lin_rel) if r.lin_rel else 0.0:.3e}")
    print(f"|F| per step: {[float(f'{x:.6e}') for x in r.nonlinear_res]}")
    print(f"{r.wall_time:.3f} s, {r.wall_time / max(n, 1):.4f} s per step, "
          f"{r.wall_time / max(sum(r.linear_iters), 1) * 1e3:.2f} ms per "
          f"FGMRES iteration")


if __name__ == "__main__":
    main()
