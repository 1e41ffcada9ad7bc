"""The 3D slice of the port (BASELINE config 4): the 3D backward-facing
step under Picard, its configuration and command line.

    python -m fenapack_tpu_torch.step3d -l 3               # 760,852 dofs
    python -m fenapack_tpu_torch.step3d -l 3 --length 9    # 2,050,228 dofs

BASELINE config 4, "3D backward-facing step, ~2M DoF": the channel
``([-1,0]x[0,1] U [0,L]x[-1,1]) x [0,1]`` with the inflow ``16 y(1-y)
z(1-z)`` (peak 1) at x = -1 and the outflow at x = L (``StepFlow3D``),
Taylor-Hood P2/P1 on ``backward_step_mesh3d(0, length=L)`` refined
``level`` times 1:8 (level 3, length 9: 2,050,228 dofs), nu 0.05.  Each
Picard step is one f64 FGMRES solve to a true relative residual of 1e-8
(at most 120 iterations) around PCD-BRM2 (Ap by pressure multigrid with the
outflow rows, Mp by Chebyshev) and the velocity multigrid over the full
depth (3 Jacobi sweeps, 2 cycles, dense inverse on level 0); operators in
the ELL layout in f64; Picard to a nonlinear relative residual of 1e-5.
This is the GMG path of the JAX package's ``demos/demo_step3d.py`` without
its TPU memory workarounds (split programs, f32 residual integrals) and
without its block layout, which needs an RCM ordering on every level.
``--velocity jacobi|chebyshev|lu`` selects the demo's factorization-free
velocity sweeps (30 per apply) or the dense inverse instead of multigrid.
"""
from __future__ import annotations

import argparse
import time

import torch

from .models import StepFlow3D
from .solvers import gmg

NU = 0.05
LENGTH = 3.0
RTOL = 1e-5                      # nonlinear relative residual
RTOL_LIN = 1e-8
MAX_STEPS = 20
CFG = {"velocity.smooth_iters": 3, "velocity.cycles": 2,
       "velocity.iters": 30, "krylov.maxiter": 120}
# the demo's settings for the other velocity subsolves
OTHER = {"lu": {"pcd.ap.method": "lu", "krylov.maxiter": 100},
         "jacobi": {"pcd.ap.method": "chebyshev", "pcd.ap.iters": 25,
                    "krylov.maxiter": 300},
         "chebyshev": {"pcd.ap.method": "chebyshev", "pcd.ap.iters": 25,
                       "krylov.maxiter": 300}}


def build(level: int, *, length: float = LENGTH, nu: float = NU, device,
          pcd: str = "BRM2", nls: str = "picard", velocity: str = "gmg"):
    """The config-4 solver at ``level`` refinements of the length-``length``
    step, through the model entry point.  ``nl.setup_seconds`` holds the
    host seconds of each setup stage."""
    p = StepFlow3D(level=level, nu=nu, length=length, device=str(device))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stages, t0 = {}, time.perf_counter()
    if velocity == "gmg":
        hier = p.mesh(gmg_levels=level)
        mesh = hier.fine
    else:
        hier, mesh = None, p.mesh()
    stages["mesh"] = time.perf_counter() - t0
    asm = p.assembler(mesh)
    stages.update(asm.setup_seconds)
    t0 = time.perf_counter()
    over = dict(CFG)
    if velocity != "gmg":
        over.update(OTHER[velocity])
        over["velocity.method"] = velocity
    nl = p.solver(pcd, linearization=nls, gmg_subsolves=velocity == "gmg",
                  asm=asm, hier=hier, **over)
    sync()
    stages["hierarchies and solver"] = time.perf_counter() - t0
    nl.setup_seconds = stages
    return nl


def velocity_levels(nl, wind: torch.Tensor, newton: bool = False):
    """``(pattern, A1, R)`` of every P2 velocity multigrid level, coarse to
    fine, at ``wind``: the Picard operators the V-cycle applies, and with
    ``newton`` the reaction blocks of each level (else None)."""
    o = nl.oseen
    vals = gmg.velocity_gmg_values(o.velocity_hierarchy, wind, o.bc_mask_u,
                                   o.dtype, newton=newton)
    return [(lasm.pat_p2, A1, R) for lasm, (A1, R) in
            zip(o.velocity_hierarchy.asms, vals["levels"])]


def divergence(nl, w: torch.Tensor) -> float:
    """max |D u| of the state ``w`` (the discrete mass balance)."""
    asm = nl.asm
    comps = asm.split_u(w[:nl.n_u].to(asm.dtype))
    return float(torch.max(torch.abs(sum(
        asm.const_hi.D[a].mv(comps[a]) for a in range(asm.dim)))))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="BASELINE config 4: Picard on the 3D backward-facing "
                    "step")
    ap.add_argument("-l", "--level", type=int, default=3,
                    help="refinements of the level-0 step mesh")
    ap.add_argument("--length", type=float, default=LENGTH,
                    help="channel length (9 at level 3: 2,050,228 dofs)")
    ap.add_argument("--nu", type=float, default=NU)
    ap.add_argument("--pcd", choices=("BRM1", "BRM2"), default="BRM2")
    ap.add_argument("--nls", choices=("picard", "newton"), default="picard")
    ap.add_argument("--velocity", choices=("gmg", "jacobi", "chebyshev",
                                           "lu"), default="gmg")
    ap.add_argument("--max-steps", type=int, default=MAX_STEPS)
    ap.add_argument("--rtol", type=float, default=RTOL)
    ap.add_argument("--rtol-lin", type=float, default=RTOL_LIN)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device.startswith("cuda")
    if cuda:
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
        torch.cuda.reset_peak_memory_stats()
    nl = build(args.level, length=args.length, nu=args.nu,
               device=args.device, pcd=args.pcd, nls=args.nls,
               velocity=args.velocity)
    mesh = nl.asm.mesh
    print(f"3D backward-facing step  l={args.level}  length={args.length:g}"
          f"  nu={args.nu:g}  cells={mesh.num_cells}  dofs={nl.n}  "
          f"pcd={args.pcd}  nls={args.nls}  velocity={args.velocity}",
          flush=True)
    print("setup seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in nl.setup_seconds.items()), flush=True)
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
                       max_steps=args.max_steps, callback=report)
    n = len(r.linear_iters)
    umax = float(torch.max(torch.abs(r.w[:nl.n_u])))
    print(f"\nconverged: {r.converged}  steps: {n}  final |F| "
          f"{r.nonlinear_res[-1]:.6e} (|F_0| {r.nonlinear_res[0]:.6e})")
    print(f"iters per step: {r.linear_iters} (total {sum(r.linear_iters)}, "
          f"cap {nl.oseen.config.krylov.maxiter}); max linear true rel res "
          f"{max(r.lin_rel) if r.lin_rel else 0.0:.3e}")
    print(f"max |D u| {divergence(nl, r.w):.3e}  max |u| {umax:.6f}")
    print(f"{r.wall_time:.3f} s, {r.wall_time / max(n, 1):.4f} s per step, "
          f"{r.wall_time / max(sum(r.linear_iters), 1) * 1e3:.2f} ms per "
          f"FGMRES iteration")
    if cuda:
        print(f"peak device memory {torch.cuda.max_memory_allocated()} B "
              f"({torch.cuda.max_memory_allocated() / 2**30:.3f} GiB)")


if __name__ == "__main__":
    main()
