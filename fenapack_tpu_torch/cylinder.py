"""The DFG cylinder slice of the port: its configuration, functionals and
command line, the counterpart of ``demos/demo_cylinder.py``.

    python -m fenapack_tpu_torch.cylinder -l 2
    python -m fenapack_tpu_torch.cylinder --unsteady -l 2 --t-end 8

BASELINE config 3, the Schafer-Turek "flow around a cylinder" benchmark
(Schafer & Turek 1996): channel [0, 2.2] x [0, 0.41], cylinder of diameter
0.1 at (0.2, 0.2), nu = 1e-3, parabolic inflow, Taylor-Hood P2/P1 on the
snapped graded mesh ``cylinder_channel_mesh(0)`` refined ``level`` times
(level 2: 328,004 dofs).  PCD-BRM2 with the outflow pressure rows, ELL
operators, FGMRES to 1e-8.  ``--ls iterative`` (the default): velocity
multigrid with 3 minimal-residual smoothing steps and 2 cycles over the
meshes and the P1 bottom level, pressure multigrid; ``--ls direct``: dense
LU velocity and Ap subsolves.

``--dtype`` (default ``mixed`` on a CUDA device, ``float64`` on the CPU,
as the JAX demo picks by backend): ``mixed`` is the f64 assembler with the
preconditioner's constants and hierarchies in f32 and high-precision
solves (2D-1 ``solve_fused``, 2D-2 the semi-implicit stepper);
``float64`` and ``float32`` run assembler and solver in that dtype (2D-1
``solve`` with ``--nls``, 2D-2 the exact loop).

  * DFG 2D-1: Re = 20 (mean inflow 0.2), steady, Newton (or ``--nls
    picard``) to a nonlinear relative residual of 1e-6.  Published: c_D in
    [5.5700, 5.5900], c_L in [0.0104, 0.0110], dP in [0.1172, 0.1176].
  * DFG 2D-2: Re = 100 (mean inflow 1.0), BDF2 from the impulsive start,
    time step 0.0125.  ``mixed``: one linearized solve per step
    (semi-implicit), drag, lift and the pressure difference evaluated on
    the device after every step.  ``float64`` / ``float32``: the exact
    loop, three Picard iterations per step, the functionals recomputed on
    the host after every step with the backward difference ``(u -
    u_prev) / dt`` as du/dt (none at the first step), as the JAX demo
    records them.  Published: c_Dmax in [3.2200, 3.2400], c_Lmax in
    [0.9900, 1.0100], St in [0.2950, 0.3050].  The ``(t, c_D, c_L, dP)``
    rows stream to ``--hist``.

Drag and lift are the boundary reaction on the cylinder times
``2 / (Ubar^2 D)``; dP is the pressure at (0.15, 0.2) less that at
(0.25, 0.2).  Not ported from the JAX demo: ``--chunk``, ``--ckpt``,
``--no-resume``, ``--warm-from``, ``--block``, ``--split-programs``
(device-program sizing and restarts for the TPU).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .fem.mesh import CYLINDER
from .models import CylinderChannel2D
from .solvers import gmg
from .utils import default_dtype
from .utils.functionals import (boundary_reaction, eval_p1,
                                make_device_functional)

D = 0.1                          # cylinder diameter
NU = 1e-3
UBAR = {20: 0.2, 100: 1.0}       # mean inflow velocity per benchmark Re
PROBES = ((0.15, 0.2), (0.25, 0.2))
CFG = {"velocity.smooth_iters": 3, "velocity.cycles": 2,
       "velocity.smoother": "minres"}
RTOL = 1e-6                      # nonlinear relative residual of 2D-1


def default_dt(level: int) -> float:
    """The time step of :func:`build`'s 2D-2 stepper when none is given,
    halved with the mesh: 0.00625 at level 2 (the command line's default
    is the JAX demo's 0.0125)."""
    return 0.025 / 2 ** level


def build(level: int, re: int, *, device, unsteady: bool = False,
          dt: float = None, hier=None, recycle: int = 0,
          nls: str = "newton", ls: str = "iterative",
          dtype: str = "float64", maxiter: int = None):
    """The slice's solver through the model entry point at ``level`` and
    benchmark Reynolds number ``re`` (20 or 100): the steady solver of
    2D-1 with linearization ``nls``, or with ``unsteady`` the BDF2 stepper
    of 2D-2 (Picard) with time step ``dt``.  ``ls``: ``iterative`` (both
    multigrids) or ``direct`` (dense LU subsolves, no hierarchies).
    ``dtype``: ``float64`` or ``float32`` (assembler and solver), or
    ``mixed`` (f64 assembler, f32 constants, hierarchies and
    preconditioner).  ``hier`` (the hierarchy of the same level) is reused
    when given; ``recycle`` is the GCRO-DR space of ``solve_fused`` (0:
    none); ``maxiter`` caps FGMRES (default the configuration's 100)."""
    p = CylinderChannel2D(level=level, nu=NU, u_mean=UBAR[re],
                          dtype="float32" if dtype == "float32"
                          else "float64", device=str(device))
    iterative = ls == "iterative"
    if hier is None:
        hier = p.mesh(gmg_levels=level)
    asm = (p.assembler(hier.fine, block_dtype=torch.float32)
           if dtype == "mixed" else p.assembler(hier.fine))
    cfg = {"krylov.recycle": recycle, **(CFG if iterative else {})}
    if dtype == "mixed":
        cfg["dtype"] = "float32"
    if maxiter is not None:
        cfg["krylov.maxiter"] = maxiter
    kw = dict(gmg_subsolves=iterative, asm=asm,
              hier=hier if iterative else None, **cfg)
    if unsteady:
        return p.solver("BRM2", linearization="picard", scheme="bdf2",
                        unsteady=default_dt(level) if dt is None else dt,
                        **kw)
    return p.solver("BRM2", linearization=nls, **kw)


def coeff(re: int) -> float:
    """Force to coefficient: ``2 / (Ubar^2 D)``."""
    return 2.0 / (UBAR[re] ** 2 * D)


def coefficients(asm, w: torch.Tensor, re: int = 20,
                 du_dt: torch.Tensor = None):
    """``(c_D, c_L, dP)`` of the state ``w``, recomputed on the host from
    the boundary reaction and the P1 point values (unsteady states:
    pass ``du_dt``)."""
    n_u = asm.dim * asm.n2
    F = boundary_reaction(asm, w[:n_u], w[n_u:], [CYLINDER], du_dt=du_dt)
    p = eval_p1(asm, w[n_u:].cpu().numpy(), PROBES)
    return coeff(re) * F[0], coeff(re) * F[1], p[0] - p[1]


def functional(asm, dt: float):
    """The per-step device functional of 2D-2: ``(F_x, F_y, p_front,
    p_back)`` with BDF2's own du/dt."""
    return make_device_functional(asm, [CYLINDER], points=PROBES,
                                  scheme="bdf2", dt=dt)


def history(values: torch.Tensor, dt: float, re: int = 100) -> np.ndarray:
    """``(t, c_D, c_L, dP)`` rows from the stacked per-step functional
    values."""
    v = values.cpu().numpy()
    t = dt * (1 + np.arange(v.shape[0]))
    return np.stack([t, coeff(re) * v[:, 0], coeff(re) * v[:, 1],
                     v[:, 2] - v[:, 3]], axis=1)


def summarize(hist: np.ndarray, re: int = 100) -> dict:
    """Strouhal number from the mean zero-upcrossing period of the lift
    over the second half of the history (None before two upcrossings), and
    the maxima of c_D and c_L there."""
    t, cl = hist[:, 0], hist[:, 2]
    half = t > 0.5 * t[-1]
    s = cl[half] - cl[half].mean()
    up = np.where((s[:-1] < 0) & (s[1:] >= 0))[0]
    st = None
    if up.size >= 2:
        period = (t[half][up[-1]] - t[half][up[0]]) / (up.size - 1)
        st = D / (period * UBAR[re])
    return {"St": st, "c_Dmax": float(hist[half, 1].max()),
            "c_Lmax": float(hist[half, 2].max())}


def velocity_levels(nl):
    """``(pattern, A1, R)`` of every P2 velocity multigrid level, coarse to
    fine, at the slice's first state (``R`` the Newton reaction blocks, None
    for the BDF2 stepper's Picard operator), and the pattern and values of
    the P1 bottom level."""
    o = nl.oseen
    wind = nl.initial_state()[:nl.n_u]
    vh = o.velocity_hierarchy
    vals = gmg.velocity_gmg_values(
        vh, wind, o.bc_mask_u, o.dtype, newton=o.linearization == "newton",
        fine_values=o._operator_values(wind), theta=o.theta,
        inv_dt=o.inv_dt)
    levels = [(lasm.pat_p2, A1, R)
              for lasm, (A1, R) in zip(vh.asms, vals["levels"])]
    return levels, (vh.asms[0].pat_p1, vals["p1_vals"])


def ell_operators(nl):
    """``(name, pattern, values)`` of every ELL operator of the slice, with
    the values of its first state: A1 (and the four R_ab of the Newton
    solver) on every velocity level, the P1 bottom operator, D and B^T, Ap
    on every pressure level, Mp, Kp and the P2 mass."""
    o, asm = nl.oseen, nl.asm
    wind = nl.initial_state()[:nl.n_u]
    levels, (pat1, p1_vals) = velocity_levels(nl)
    ops = [("P1 bottom operator", pat1, p1_vals)]
    for l, (pat, A1, R) in enumerate(levels):
        ops.append((f"A1 velocity level {l}", pat, A1))
        if R is not None:
            ops += [(f"R{a}{b} velocity level {l}", pat, R[a, b])
                    for a in range(2) for b in range(2)]
    ops += [(f"D{a}", asm.pat_div, asm.const.D[a].vals) for a in range(2)]
    ops += [(f"Bt{a}", asm.pat_divT, asm.const.DT[a].vals)
            for a in range(2)]
    ops += [(f"Ap pressure level {l}", lev.asm.pat_p1, lev.Ap.vals)
            for l, lev in enumerate(o.ap_hierarchy.levels)]
    ops += [("Mp", asm.pat_p1, asm.const.Mp.vals),
            ("Kp", asm.pat_p1, asm.kp_values(wind, surface=True)),
            ("M2", asm.pat_p2, asm.const.M2.vals)]
    return ops


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="DFG 2D-1 (steady, Re 20) or 2D-2 (--unsteady, Re 100) "
                    "on the Schafer-Turek cylinder")
    ap.add_argument("-l", "--level", type=int, default=1,
                    help="refinements of the level-0 cylinder mesh")
    ap.add_argument("--nls", choices=["picard", "newton"], default="newton",
                    help="linearization of 2D-1 (2D-2 steps by Picard)")
    ap.add_argument("--ls", choices=["direct", "iterative"],
                    default="iterative",
                    help="dense LU subsolves, or both multigrids")
    ap.add_argument("--dtype", choices=["float64", "mixed", "float32"],
                    default=None,
                    help="default: mixed on a CUDA device, float64 on the "
                         "CPU")
    ap.add_argument("--rtol", type=float, default=RTOL,
                    help="nonlinear relative tolerance of 2D-1")
    ap.add_argument("--unsteady", action="store_true",
                    help="DFG 2D-2: Re = 100 vortex shedding and Strouhal")
    ap.add_argument("--t-end", type=float, default=8.0)
    ap.add_argument("--dt", type=float, default=0.0125)
    ap.add_argument("--hist", default="cylinder_2d2_hist.csv",
                    help="2D-2: the (t, cD, cL, dP) history, one CSV row "
                         "per step")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="FGMRES iteration cap (default 100)")
    ap.add_argument("--device", default="cuda")
    return ap


def _print_2d2(hist: np.ndarray, r) -> dict:
    """Print the 2D-2 summary of the history and the run ``r``; returns
    :func:`summarize`'s dict."""
    n = len(r.linear_iters)
    s = summarize(hist)
    print(f"\n{n} steps in {r.wall_time:.3f} s ({r.wall_time / n:.4f} s per "
          f"step), iters/step mean {np.mean(r.linear_iters):.1f} max "
          f"{max(r.linear_iters)}, max linear true rel res {max(r.lin_rel)}")
    st = "not established" if s["St"] is None else f"{s['St']:.4f}"
    print(f"DFG 2D-2:  St     = {st}   (ref 0.2950-0.3050)")
    print(f"           c_Dmax = {s['c_Dmax']:.4f}   (ref 3.2200-3.2400)")
    print(f"           c_Lmax = {s['c_Lmax']:.4f}   (ref 0.9900-1.0100)",
          flush=True)
    return s


def main(argv=None):
    """Run the command line; returns a dict: ``solver`` and ``result``,
    and ``coefficients`` (c_D, c_L, dP) of 2D-1 or ``hist`` (the ``(t,
    c_D, c_L, dP)`` rows) and ``summary`` of 2D-2."""
    args = parser().parse_args(argv)
    re = 100 if args.unsteady else 20
    dtype = args.dtype or default_dtype(args.device)
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    kw = dict(device=args.device, nls=args.nls, ls=args.ls, dtype=dtype,
              maxiter=args.maxiter)

    if not args.unsteady:
        nl = build(args.level, re, **kw)
        print(f"cylinder channel  l={args.level}  Re={re}  nu={NU:g}  "
              f"dofs={nl.n}  {args.nls}  {args.ls}  {dtype}", flush=True)
        r = (nl.solve_fused(rtol=args.rtol) if dtype == "mixed"
             else nl.solve(rtol=args.rtol))
        print(f"converged: {r.converged}  iters/step: {r.linear_iters}  "
              f"solve {r.wall_time:.3f} s")
        cd, cl, dp = coefficients(nl.asm, r.w, re)
        print(f"\nDFG 2D-1:  c_D = {cd:.4f}   (ref 5.5700-5.5900)")
        print(f"           c_L = {cl:.4f}   (ref 0.0104-0.0110)")
        print(f"           dP  = {dp:.4f}   (ref 0.1172-0.1176)")
        return {"solver": nl, "result": r, "coefficients": (cd, cl, dp)}

    dt = args.dt
    us = build(args.level, re, unsteady=True, dt=dt, **kw)
    n_steps = int(round(args.t_end / dt))
    print(f"cylinder channel  l={args.level}  Re={re}  nu={NU:g}  "
          f"dofs={us.n}  dt={dt:g}  steps={n_steps}  {args.ls}  {dtype}",
          flush=True)

    def write(f, row):
        f.write(",".join(f"{v:.10g}" for v in row) + "\n")

    with open(args.hist, "w") as f:
        f.write("t,cD,cL,dP\n")
        if dtype == "mixed":
            # semi-implicit BDF2, the functionals on the device
            r = us.solve_fused(args.t_end, functional=functional(us.asm, dt))
            hist = history(r.functionals, dt, re)
            for row in hist:
                write(f, row)
            print("t,cD,cL,dP,iters")
            for row, it in list(zip(hist, r.linear_iters))[79::80]:
                print(",".join(f"{v:.10g}" for v in row) + f",{it}")
            s = _print_2d2(hist, r)
            return {"solver": us, "result": r, "hist": hist, "summary": s}

        # the exact loop: three Picard iterations per BDF2 step, the
        # functionals recorded on the host after every step
        rows, prev = [], {"u": None}

        def record(k, t, w):
            u = w[:us.n_u]
            du_dt = None if prev["u"] is None else (u - prev["u"]) / dt
            prev["u"] = u
            rows.append((t, *coefficients(us.asm, w, re, du_dt=du_dt)))
            write(f, rows[-1])
            f.flush()
            if (k + 1) % 80 == 0:
                print(f"t={t:7.3f}  cD={rows[-1][1]:.4f}  "
                      f"cL={rows[-1][2]:+.4f}", flush=True)

        r = us.solve(args.t_end, picard_iters=3, callback=record)
    hist = np.array(rows)
    s = _print_2d2(hist, r)
    return {"solver": us, "result": r, "hist": hist, "summary": s}


if __name__ == "__main__":
    main()
