"""The lid-driven cavity slice of the port: its configuration, solver and
command line, the counterpart of ``demos/demo_cavity.py``.

    python -m fenapack_tpu_torch.cavity -l 2 --Re 500 --nls newton
    python -m fenapack_tpu_torch.cavity -l 2 --Re 400 --continuation

BASELINE config 2.  The command line is the JAX demo's: enclosed flow on
``cavity_mesh(level)``, Picard (or ``--nls newton``) with PCD-BRM2 (no PCD
Dirichlet rows, constant pressure nullspace) or BRM1 (the lid's rows),
dense LU velocity and Ap subsolves (the configuration's defaults), FGMRES
to 1e-8; ``--continuation`` doubles Re from 100 up to ``--Re``, each stage
warm from the last.  ``--dtype`` (default ``float32`` on a CUDA device,
``float64`` on the CPU, as the JAX demo picks by backend) is the dtype of
the assembler and of the solver; ``--vtk`` writes the last state.

:func:`build` is the slice at the resolution of Ghia, Ghia & Shin (J.
Comput. Phys. 48:387-411, 1982; 129 x 129 points): ``cavity_mesh(0)``
refined four times, 128 x 128 cells, 148,739 dofs, five multigrid levels.
Newton with PCD-BRM2, ELL operators in f64, velocity multigrid with 3
Jacobi sweeps and 2 cycles, pressure multigrid, FGMRES to 1e-8 with at
most 200 iterations, Reynolds continuation 100 -> 200 -> 400 -> 500, each
stage warm from the last and converged to a nonlinear relative residual
of 1e-5.
"""
from __future__ import annotations

import argparse

import torch

from .fem.mesh import cavity_mesh
from .models import LidDrivenCavity
from .solvers import gmg
from .utils import default_dtype
from .utils.io import save_vtk

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


def velocity_levels(nl):
    """``(pattern, A1, R)`` of every velocity multigrid level, coarse to
    fine, with the values of the slice's first Newton state: the Picard
    operator and the (2, 2, n, K) Newton reaction blocks."""
    o = nl.oseen
    wind = nl.initial_state()[:nl.n_u]
    vh = o.velocity_hierarchy
    levels = gmg.velocity_gmg_values(
        vh, wind, o.bc_mask_u, o.dtype, newton=True,
        fine_values=o._operator_values(wind))["levels"]
    return [(lasm.pat_p2, A1, R) for lasm, (A1, R) in zip(vh.asms, levels)]


def ell_operators(nl):
    """``(name, pattern, values)`` of every ELL operator the slice applies,
    with the values of its first Newton state: A1 and the four Newton
    blocks R_ab on every velocity level, D and B^T, Ap on every pressure
    level, Mp and Kp."""
    o, asm = nl.oseen, nl.asm
    wind = nl.initial_state()[:nl.n_u]
    ph = o.ap_hierarchy
    ops = []
    for l, (pat, A1, R) in enumerate(velocity_levels(nl)):
        ops.append((f"A1 velocity level {l}", pat, A1))
        ops += [(f"R{a}{b} velocity level {l}", pat, R[a, b])
                for a in range(2) for b in range(2)]
    ops += [(f"D{a}", asm.pat_div, asm.const.D[a].vals) for a in range(2)]
    ops += [(f"Bt{a}", asm.pat_divT, asm.const.DT[a].vals)
            for a in range(2)]
    ops += [(f"Ap pressure level {l}", lev.asm.pat_p1, lev.Ap.vals)
            for l, lev in enumerate(ph.levels)]
    ops += [("Mp", asm.pat_p1, asm.const.Mp.vals),
            ("Kp", asm.pat_p1, asm.kp_values(wind, surface=True))]
    return ops


def reynolds_stages(Re: float, continuation: bool) -> list:
    """The stages of the command line: ``[Re]``, or with ``continuation``
    100, 200, 400, ... below ``Re`` and then ``Re``."""
    if not continuation:
        return [Re]
    out, r = [], 100.0
    while r < Re:
        out.append(r)
        r *= 2
    return out + [Re]


def main(argv=None):
    """Run the command line; returns ``{"solver": ..., "results": [...]}``
    (the last stage's solver, every stage's result)."""
    ap = argparse.ArgumentParser(
        description="lid-driven cavity: enclosed flow, Newton or Picard, "
                    "BRM1 or BRM2, dense LU subsolves")
    ap.add_argument("-l", "--level", type=int, default=1)
    ap.add_argument("--Re", type=float, default=500.0)
    ap.add_argument("--pcd", choices=["BRM1", "BRM2"], default="BRM2")
    ap.add_argument("--nls", choices=["picard", "newton"], default="picard")
    ap.add_argument("--rtol", type=float, default=1e-5)
    ap.add_argument("--damping", type=float, default=1.0)
    ap.add_argument("--continuation", action="store_true",
                    help="ramp Re in 2x steps from 100 (helps Newton at "
                         "high Re)")
    ap.add_argument("--dtype", choices=["float64", "float32"], default=None,
                    help="default: float32 on a CUDA device, float64 on "
                         "the CPU")
    ap.add_argument("--vtk", default=None, help="write the last state")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dtype = args.dtype or default_dtype(args.device, cuda="float32")
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    mesh = cavity_mesh(args.level)
    w, results = None, []
    for Re in reynolds_stages(args.Re, args.continuation):
        p = LidDrivenCavity(level=args.level, nu=1.0 / Re, dtype=dtype,
                            device=args.device)
        nl = p.solver(args.pcd, linearization=args.nls,
                      asm=p.assembler(mesh))
        print(f"\n=== cavity l={args.level} Re={Re:.0f} "
              f"{args.nls}+PCD-{args.pcd} (dofs {nl.n}, {dtype}) ===",
              flush=True)
        r = nl.solve(w, rtol=args.rtol, damping=args.damping)
        w = r.w
        results.append(r)
        print(f"converged: {r.converged}  steps: {len(r.linear_iters)}  "
              f"iters: {r.linear_iters}")
        print(f"wall: {r.wall_time:.2f} s", flush=True)
    if args.vtk:
        save_vtk(args.vtk, nl.asm, w)
        print(f"wrote {args.vtk}")
    return {"solver": nl, "results": results}


if __name__ == "__main__":
    main()
