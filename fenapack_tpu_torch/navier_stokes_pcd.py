"""Steady 2D backward-facing step with PCD-preconditioned FGMRES: the
port's counterpart of ``demos/demo_navier_stokes_pcd.py`` (upstream
fenapack's flagship demo), with its flags.

    python -m fenapack_tpu_torch.navier_stokes_pcd -l 1 --nu 0.02 \\
        --pcd BRM2 --nls picard --ls direct

Taylor-Hood P2/P1 on ``backward_step_mesh(level)`` (``--ls iterative``: the
level-0 step refined ``level`` times, with its multigrid hierarchy),
parabolic inflow, natural outflow, ELL operators.

``--ls direct``    dense LU velocity and Ap subsolves (validation scale);
``--ls iterative`` velocity and pressure multigrid (3 smoothing steps, 2
                   cycles).

``--dtype`` (default ``mixed`` on a CUDA device, ``float64`` on the CPU, as
the JAX demo picks by backend): ``mixed`` keeps the assembler and the
residual in f64 with the preconditioner's constants in f32 and runs
``solve_fused`` (each step one high-precision solve to ``--krylov-rtol``);
``float64`` and ``float32`` run ``solve`` (FGMRES in that dtype).
``FENAPACK_CFG`` overrides are applied last.  ``--vtk`` writes the
solution, ``--trace DIR`` a profiler trace of the solve.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import measure
from .fem import mesh as meshmod
from .fem.assemble import NSAssembler
from .fem.dofmap import DirichletBC
from .solvers import gmg
from .solvers.config import SolverConfig, env_overrides, overrides
from .solvers.nonlinear import NonlinearSolver
from .utils import default_dtype
from .utils.io import save_vtk
from .utils.timing import Timings, device_trace


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="steady 2D backward-facing step, PCD-preconditioned "
                    "FGMRES")
    ap.add_argument("-l", "--level", type=int, default=1,
                    help="refinement level (h = 1/4 / 2**l)")
    ap.add_argument("--nu", type=float, default=0.02,
                    help="kinematic viscosity (Re ~ 2/nu)")
    ap.add_argument("--pcd", choices=["BRM1", "BRM2"], default="BRM2")
    ap.add_argument("--nls", choices=["picard", "newton"], default="picard")
    ap.add_argument("--ls", choices=["direct", "iterative"], default="direct")
    ap.add_argument("--supg", action="store_true",
                    help="SUPG-stabilized velocity block of the "
                         "preconditioner")
    ap.add_argument("--supg-system", action="store_true",
                    help="SUPG-stabilize the system (residual and operator),"
                         " needed beyond Re ~ 1000")
    ap.add_argument("--rtol", type=float, default=1e-5,
                    help="nonlinear relative tolerance")
    ap.add_argument("--krylov-rtol", type=float, default=1e-8)
    ap.add_argument("--damping", type=float, default=1.0,
                    help="nonlinear update damping (~0.7 at Re >= 2000)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="cap on nonlinear steps (default: the solver's)")
    ap.add_argument("--dtype", choices=["float32", "float64", "mixed"],
                    default=None,
                    help="default: mixed on a CUDA device, float64 on the "
                         "CPU")
    ap.add_argument("--vtk", default=None, help="write the solution as VTK")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the solve to DIR")
    ap.add_argument("--device", default="cuda")
    return ap


def build(args, device):
    """``(solver, asm, dtype)`` for the parsed flags on ``device``."""
    dtype = args.dtype or default_dtype(device)
    ap_h = v_h = None
    if args.ls == "iterative":
        hier = gmg.build_hierarchy(meshmod.backward_step_mesh(0), args.level)
        mesh = hier.fine
    else:
        mesh = meshmod.backward_step_mesh(args.level)
    # mixed: f64 assembler (residual, outer matvec) and f32 constants for
    # the preconditioner
    adtype = torch.float32 if dtype == "float32" else torch.float64
    sdtype = "float64" if dtype == "float64" else "float32"
    asm = NSAssembler(mesh, args.nu, device=device, dtype=adtype,
                      block_dtype=torch.float32 if dtype == "mixed"
                      else None)

    def inflow(x):
        v = np.zeros((x.shape[0], 2))
        v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
        return v

    bcs = [DirichletBC.velocity(asm.W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [meshmod.INFLOW], inflow)]
    marker = meshmod.INFLOW if args.pcd == "BRM1" else meshmod.OUTFLOW
    over = {"pcd.variant": args.pcd, "dtype": sdtype,
            "krylov.rtol": args.krylov_rtol, "jpc_supg": args.supg,
            "system_supg": args.supg_system,
            "velocity.method": "lu", "pcd.ap.method": "lu"}
    if args.ls == "iterative":
        over.update({"velocity.method": "gmg", "velocity.smooth_iters": 3,
                     "velocity.cycles": 2, "pcd.ap.method": "gmg"})
        hdt = {"float32": torch.float32, "float64": torch.float64}[sdtype]
        ap_h = gmg.PressureHierarchy(hier, hdt, device=device,
                                     pcd_markers=[marker])
        v_h = gmg.VelocityHierarchy(
            hier, args.nu, hdt, device=device,
            bc_markers=[meshmod.WALL, meshmod.INFLOW], fine_asm=asm)
    cfg = env_overrides(overrides(SolverConfig(), over))
    solver = NonlinearSolver(asm, bcs, cfg, pcd_marker=marker,
                             linearization=args.nls, ap_hierarchy=ap_h,
                             velocity_hierarchy=v_h)
    return solver, asm, dtype


def main(argv=None):
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    timings = Timings(device)
    with timings("mesh+assembly"):
        solver, asm, dtype = build(args, device)

    print(f"backward-facing step  l={args.level}  nu={args.nu}  "
          f"Re~{2 / args.nu:.0f}")
    print(f"dofs: velocity {2 * asm.n2}, pressure {asm.n1}, total "
          f"{2 * asm.n2 + asm.n1}")
    print(f"solver: {args.nls} + PCD-{args.pcd} FGMRES ({args.ls} subsolves,"
          f" dtype {dtype}, device {device})", flush=True)

    ms = {} if args.max_steps is None else {"max_steps": args.max_steps}
    with timings("nonlinear solve"), device_trace(args.trace):
        if dtype == "mixed":
            res = solver.solve_fused(rtol=args.rtol,
                                     rtol_lin=args.krylov_rtol,
                                     damping=args.damping, **ms)
        else:
            res = solver.solve(rtol=args.rtol, damping=args.damping, **ms)

    print(f"\nconverged: {res.converged}  "
          f"nonlinear steps: {len(res.linear_iters)}")
    print(f"FGMRES iters per step: {res.linear_iters} "
          f"(total {res.total_linear_iters})")
    print(f"wall time: {res.wall_time:.2f} s\n")
    print(timings.report(), flush=True)
    print("kernel launches " + json.dumps(measure.launch_counts()),
          flush=True)
    if args.vtk:
        save_vtk(args.vtk, asm, res.w)
        print(f"wrote {args.vtk}")


if __name__ == "__main__":
    main()
