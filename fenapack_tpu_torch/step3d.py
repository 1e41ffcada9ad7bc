"""The 3D slice of the port (BASELINE config 4): the 3D backward-facing
step under Picard, its configuration and command line, the counterpart of
``demos/demo_step3d.py``.

    python -m fenapack_tpu_torch.step3d -l 3               # 760,852 dofs
    python -m fenapack_tpu_torch.step3d -l 3 --length 9    # 2,050,228 dofs
    python -m fenapack_tpu_torch.step3d -l 2 --supg --nu 2e-3

BASELINE config 4, "3D backward-facing step, ~2M DoF": the channel
``([-1,0]x[0,1] U [0,L]x[-1,1]) x [0,1]`` with the inflow ``16 y(1-y)
z(1-z)`` (peak 1) at x = -1 and the outflow at x = L (``StepFlow3D``),
Taylor-Hood P2/P1 on ``backward_step_mesh3d(0, length=L)`` refined
``level`` times 1:8 (level 3, length 9: 2,050,228 dofs), nu 0.05.  Each
Picard step is one high-precision FGMRES solve to a true relative residual
of ``--rtol-lin`` (default the JAX demo's ``max(rtol / 100, 1e-8)``, at
most 120 iterations) around PCD-BRM2 (Ap by pressure multigrid with the
outflow rows, Mp by Chebyshev) and the velocity multigrid over
``--gmg-levels`` (default: the full depth; 3 Jacobi sweeps, 2 cycles,
dense inverse on the coarsest level); ELL operators; Picard to a nonlinear
relative residual of 1e-5.

``--dtype`` (default ``float32`` on a CUDA device, ``float64`` on the CPU,
as the JAX demo picks by backend): ``float32`` keeps the assembler and the
residual in f64 with the preconditioner's constants and hierarchies in f32
and the JAX demo's ``krylov.rtol`` of 2e-6.  ``--supg`` SUPG-stabilizes
the system (config 5 at 3D scale, with a small ``--nu`` such as 2e-3).
``--velocity jacobi|chebyshev|lu`` selects the demo's factorization-free
velocity sweeps (``--velocity-iters`` per apply) or the dense inverse
instead of multigrid.  This is the JAX demo without its TPU memory
workarounds (split programs, f32 residual integrals: ``--hi-res-f32``) and
without its block layout (``--block``), which needs an RCM ordering on
every level.
"""
from __future__ import annotations

import argparse
import time

import torch

from .fem import mesh3d
from .models import StepFlow3D
from .solvers import gmg
from .utils import default_dtype

NU = 0.05
LENGTH = 3.0
RTOL = 1e-5                      # nonlinear relative residual
RTOL_LIN = 1e-8                  # the linear tolerance of the recorded runs
MAX_STEPS = 20
CFG = {"velocity.smooth_iters": 3, "velocity.cycles": 2}
# the demo's settings for the other velocity subsolves
OTHER = {"lu": {"pcd.ap.method": "lu", "krylov.maxiter": 100},
         "jacobi": {"pcd.ap.method": "chebyshev", "pcd.ap.iters": 25},
         "chebyshev": {"pcd.ap.method": "chebyshev", "pcd.ap.iters": 25}}


def build(level: int, *, length: float = LENGTH, nu: float = NU, device,
          pcd: str = "BRM2", nls: str = "picard", velocity: str = "gmg",
          supg: bool = False, dtype: str = "float64",
          velocity_iters: int = 30, gmg_levels: int = None,
          maxiter: int = 300):
    """The config-4 solver at ``level`` refinements of the length-``length``
    step, through the model entry point.  ``supg``: the SUPG-stabilized
    system; ``dtype`` ``float32``: the preconditioner's constants and
    hierarchies in f32 around the f64 assembler, FGMRES's ``krylov.rtol``
    2e-6; ``gmg_levels``: the depth of the velocity hierarchy (default
    ``level``: its coarsest mesh is ``backward_step_mesh3d(level -
    gmg_levels)``); ``maxiter``: the FGMRES cap (at most 120 with
    multigrid, 100 with ``lu``).  ``nl.setup_seconds`` holds the host
    seconds of each setup stage."""
    p = StepFlow3D(level=level, nu=nu, length=length, device=str(device))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stages, t0 = {}, time.perf_counter()
    if velocity == "gmg":
        depth = level if gmg_levels is None else gmg_levels
        hier = gmg.build_hierarchy(
            mesh3d.backward_step_mesh3d(level - depth, length=length), depth)
        mesh = hier.fine
    else:
        hier, mesh = None, p.mesh()
    stages["mesh"] = time.perf_counter() - t0
    f32 = dtype == "float32"
    asm = p.assembler(mesh, **({"block_dtype": torch.float32} if f32
                               else {}))
    stages.update(asm.setup_seconds)
    t0 = time.perf_counter()
    over = dict(CFG, **{"velocity.iters": velocity_iters,
                        "krylov.maxiter": min(maxiter, 120),
                        "system_supg": supg})
    if f32:
        over.update({"dtype": "float32", "krylov.rtol": 2e-6})
    if velocity != "gmg":
        over.update(OTHER[velocity])
        over["velocity.method"] = velocity
        if velocity != "lu":
            over["krylov.maxiter"] = maxiter
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
    """Run the command line; returns ``{"solver": ..., "result": ...}``."""
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
    ap.add_argument("--supg", action="store_true",
                    help="SUPG-stabilized system (config 5 at 3D scale): "
                         "use with a small --nu, e.g. 2e-3")
    ap.add_argument("--velocity", choices=("gmg", "jacobi", "chebyshev",
                                           "lu"), default="gmg")
    ap.add_argument("--velocity-iters", type=int, default=30,
                    help="sweeps per apply of jacobi / chebyshev")
    ap.add_argument("--gmg-levels", type=int, default=None,
                    help="depth of the velocity hierarchy (default: level, "
                         "so that the coarsest mesh is level 0)")
    ap.add_argument("--dtype", choices=("float64", "float32"), default=None,
                    help="the preconditioner's dtype (default: float32 on "
                         "a CUDA device, float64 on the CPU)")
    ap.add_argument("--maxiter", type=int, default=300,
                    help="FGMRES cap (at most 120 with gmg, 100 with lu)")
    ap.add_argument("--max-steps", type=int, default=MAX_STEPS)
    ap.add_argument("--rtol", type=float, default=RTOL)
    ap.add_argument("--rtol-lin", type=float, default=None,
                    help="linear tolerance of each step (default: the JAX "
                         "demo's max(rtol / 100, 1e-8); given, it wins)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device.startswith("cuda")
    dtype = args.dtype or default_dtype(args.device, cuda="float32")
    rtol_lin = (max(args.rtol * 1e-2, 1e-8) if args.rtol_lin is None
                else args.rtol_lin)
    if cuda:
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
        torch.cuda.reset_peak_memory_stats()
    nl = build(args.level, length=args.length, nu=args.nu,
               device=args.device, pcd=args.pcd, nls=args.nls,
               velocity=args.velocity, supg=args.supg, dtype=dtype,
               velocity_iters=args.velocity_iters,
               gmg_levels=args.gmg_levels, maxiter=args.maxiter)
    mesh = nl.asm.mesh
    print(f"3D backward-facing step  l={args.level}  length={args.length:g}"
          f"  nu={args.nu:g}  cells={mesh.num_cells}  dofs={nl.n}  "
          f"pcd={args.pcd}  nls={args.nls}  velocity={args.velocity}  "
          f"supg={args.supg}  dtype={dtype}  rtol_lin={rtol_lin:g}",
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

    r = nl.solve_fused(rtol=args.rtol, rtol_lin=rtol_lin,
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
    return {"solver": nl, "result": r}


if __name__ == "__main__":
    main()
