"""The custom-form slice of the port: the backward-facing step written the
way a FENaPack user writes it, its problem definition and command line.

    python -m fenapack_tpu_torch.custom_forms -l 2 --pcd BRM2
    python -m fenapack_tpu_torch.custom_forms -l 0 --rtol 1e-3 --device cpu

The counterpart of ``demos/demo_custom_forms.py``, which reproduces the code
shape of the reference's ``demo/navier-stokes-pcd/demo_navier-stokes-pcd.py``
with the user-supplied-forms API (:mod:`fenapack_tpu_torch.fem.forms` and
:mod:`fenapack_tpu_torch.solvers.custom`): the variational forms of J, F and
the PCD operators mp/ap/kp are written out, handed to ``PCDAssembler(J, F,
bcs, mp=..., ap=..., kp=..., bcs_pcd=...)`` and solved with
``PCDKrylovSolver`` and ``PCDNewtonSolver``.  The problem: the 2D
backward-facing step (inflow parabola of peak 1), Taylor-Hood P2/P1 on
``backward_step_mesh(level)`` (level 2: 25,987 dofs), nu = 0.02 (Re 100),
Picard to ``--rtol``, each step one FGMRES solve to 1e-8 with a dense
velocity inverse, a dense Ap inverse and Chebyshev-4 Mp.  :func:`build`
also writes the PCD operator as the full form ``fp = ap + kp`` (BRM1's
non-factored apply) or adds the pressure-gradient form ``gp`` (B^T from a
form).

The command prints the demo's lines, one CSV line per Picard step (|F| at
the step's start, FGMRES iterations, the true relative residual of the
linear solve, seconds, seconds of the step's dense velocity inverse), then
the dense-inverse seconds, the peak device memory and the K3 launches of
the solve.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

NU = 0.02
RTOL = 1e-5                      # nonlinear relative residual
RTOL_LIN = 1e-8
MAX_STEPS = 25


def problem(F, meshmod, DirichletBC, TaylorHood, level: int,
            nu: float = NU, variant: str = "BRM2", use_fp: bool = False,
            gp_scale: Optional[float] = None) -> dict:
    """The demo's forms and boundary conditions, written in the mini-UFL
    whose modules are passed in (``F`` the forms module, ``meshmod`` the
    mesh module, the ``DirichletBC`` and ``TaylorHood`` classes): the
    keyword arguments of ``PCDAssembler``.  ``use_fp`` replaces kp by the
    full form ``fp = ap + kp``; ``gp_scale`` adds ``gp_scale`` times the
    pressure-gradient form of J's up-block."""
    mesh = meshmod.backward_step_mesh(level)
    W = TaylorHood(mesh)
    (u, p) = F.TrialFunctions(W)
    (v, q) = F.TestFunctions(W)
    w = F.Coefficient(W, "w")          # current nonlinear iterate
    u_, p_ = F.split(w)
    n = F.FacetNormal(mesh)

    # nonlinear residual F(w) and the Picard (Oseen) Jacobian J
    L = (nu * F.inner(F.grad(u_), F.grad(v)) * F.dx
         + F.inner(F.dot(F.grad(u_), u_), v) * F.dx
         - p_ * F.div(v) * F.dx
         - q * F.div(u_) * F.dx)
    J = (nu * F.inner(F.grad(u), F.grad(v)) * F.dx
         + F.inner(F.dot(F.grad(u), u_), v) * F.dx
         - p * F.div(v) * F.dx
         - q * F.div(u) * F.dx)

    # PCD operators (the 1/nu scaling folded into mp and kp)
    mp = (1.0 / nu) * p * q * F.dx
    ap = F.inner(F.grad(p), F.grad(q)) * F.dx
    kp = (1.0 / nu) * F.dot(F.grad(p), u_) * q * F.dx
    if variant == "BRM2":
        # BRM2 inflow surface correction (Olshanskii-Vassilevski)
        kp = kp - (1.0 / nu) * F.dot(u_, n) * p * q * F.ds(meshmod.INFLOW)
    fp = None
    if use_fp:
        fp, kp = ap + kp, None
    gp = None
    if gp_scale is not None:
        gp = gp_scale * (-1.0) * p * F.div(v) * F.dx

    def inflow(x):
        val = np.zeros((x.shape[0], 2))
        val[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
        return val

    bcs = [DirichletBC.velocity(W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(W, [meshmod.INFLOW], inflow)]
    marker = meshmod.INFLOW if variant == "BRM1" else meshmod.OUTFLOW
    bcs_pcd = [DirichletBC.pressure(W, [marker])]
    return dict(a=J, L=L, bcs=bcs, mp=mp, ap=ap, kp=kp, fp=fp, gp=gp,
                bcs_pcd=bcs_pcd, w=w)


def build(level: int, nu: float = NU, variant: str = "BRM2", *, device,
          use_fp: bool = False, gp_scale: Optional[float] = None,
          **config_overrides):
    """The port's ``PCDKrylovSolver`` for :func:`problem` on ``device``,
    FGMRES to 1e-8 with the custom solver's default (dense) subsolves and
    the dotted ``config_overrides``."""
    from .fem import forms as F
    from .fem import mesh as meshmod
    from .fem.dofmap import DirichletBC, TaylorHood
    from .solvers.config import overrides
    from .solvers.custom import DEFAULT_CONFIG, PCDAssembler, PCDKrylovSolver
    asm = PCDAssembler(**problem(F, meshmod, DirichletBC, TaylorHood, level,
                                 nu, variant, use_fp, gp_scale),
                       device=device)
    cfg = overrides(DEFAULT_CONFIG, {"pcd.variant": variant,
                                     "krylov.rtol": RTOL_LIN,
                                     **config_overrides})
    return PCDKrylovSolver(asm, cfg)


def run(solver, rtol: float = RTOL, max_steps: int = MAX_STEPS,
        out=None) -> dict:
    """Picard through ``PCDNewtonSolver`` from the BC-lifted zero state;
    ``out`` receives one CSV line per step.  Returns the state, the
    per-step records (|F|, iterations, true relative residual, seconds),
    the dense-inverse seconds, the peak device memory of the solve and the
    memory allocated when it began (None on the CPU), and the K3 launches
    of the solve."""
    from .ops import ell_spmv
    from .solvers.custom import PCDNewtonSolver
    newton = PCDNewtonSolver(solver)
    cuda = solver.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(solver.device)
        torch.cuda.reset_peak_memory_stats(solver.device)
    start_bytes = (torch.cuda.memory_allocated(solver.device) if cuda
                   else None)
    n_inv = len(solver.inverse_seconds)
    lin_rel, seconds = [], []
    ell_spmv.reset_launches()
    t0 = last = time.perf_counter()

    def step(k, fnorm, result, rel, x):
        nonlocal last
        if cuda:
            torch.cuda.synchronize(solver.device)
        now = time.perf_counter()
        lin_rel.append(rel)
        seconds.append(now - last)
        last = now
        if out is not None:
            inv = solver.inverse_seconds[n_inv:]
            out(f"{k},{fnorm:.10e},{int(result.iters)},{rel:.3e},"
                f"{seconds[-1]:.4f},{inv[-1] if inv else 0.0:.4f}")

    x, res, iters, converged = newton.solve(rtol=rtol, max_steps=max_steps,
                                            callback=step)
    if cuda:
        torch.cuda.synchronize(solver.device)
    wall = time.perf_counter() - t0
    return dict(x=x, nonlinear_res=res, iters=iters, converged=converged,
                lin_rel=lin_rel, seconds=seconds, wall=wall,
                inverse_seconds=solver.inverse_seconds[n_inv:],
                peak_bytes=(torch.cuda.max_memory_allocated(solver.device)
                            if cuda else None),
                start_bytes=start_bytes,
                k3_launches=ell_spmv.launches["f64"]
                + ell_spmv.launches["f32"])


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The backward-facing step written as custom forms "
                    "(PCDAssembler, PCDKrylovSolver, PCDNewtonSolver)")
    ap.add_argument("-l", "--level", type=int, default=1)
    ap.add_argument("--nu", type=float, default=NU)
    ap.add_argument("--pcd", choices=["BRM1", "BRM2"], default="BRM2")
    ap.add_argument("--rtol", type=float, default=RTOL)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    t0 = time.perf_counter()
    solver = build(args.level, args.nu, args.pcd, device=dev)
    W = solver.W
    print(f"backward-facing step (custom forms)  l={args.level}  "
          f"nu={args.nu}")
    print(f"dofs: velocity {W.dim_u}, pressure {W.dim_p}, total {W.dim}")
    print(f"solver: Picard-linearized J + PCD-{args.pcd} FGMRES; setup "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    print("step,|F|,iters,lin_rel,seconds,inverse_seconds", flush=True)
    r = run(solver, rtol=args.rtol,
            out=lambda line: print(line, flush=True))
    iters = r["iters"]
    print(f"\nconverged: {r['converged']}  nonlinear steps: {len(iters)}")
    print(f"FGMRES iters per step: {iters} (total {sum(iters)}); final |F| "
          f"{r['nonlinear_res'][-1]:.6e} (|F_0| {r['nonlinear_res'][0]:.6e})"
          f"; max linear true rel res "
          f"{max(r['lin_rel']) if r['lin_rel'] else 0.0:.3e}")
    print(f"wall time: {r['wall']:.2f} s, "
          f"{r['wall'] / max(len(iters), 1):.4f} s per step")
    inv = r["inverse_seconds"]
    print(f"dense velocity inverse ({W.dim_u}^2): seconds "
          f"{[round(s, 4) for s in inv]} (mean "
          f"{sum(inv) / max(len(inv), 1):.4f}); peak device memory "
          f"{r['peak_bytes']} B ({r['start_bytes']} B allocated at the "
          f"start); K3 launches {r['k3_launches']}")


if __name__ == "__main__":
    main()
