"""Unsteady channel flow, theta scheme or BDF2 with per-step PCD Oseen
solves: the port's counterpart of ``demos/demo_unsteady_channel.py``, with
its flags.

    python -m fenapack_tpu_torch.unsteady_channel --dt 0.1 --t-end 2.0 \\
        --theta 1.0

The channel [0, 4] x [0, 1] (``channel_mesh(level, length=4)``), parabolic
inflow, natural outflow, Taylor-Hood P2/P1 in ELL, dense LU velocity and Ap
subsolves, PCD with ``Mp/dt`` in Fp.  ``--fused`` runs the semi-implicit
loop on high-precision solves (``UnsteadySolver.solve_fused``), otherwise
``--picard-iters`` Picard iterations per step (``solve``).
``--checkpoint PATH`` resumes from PATH when it exists and saves the final
state there; ``--vtk-every N`` writes ``channel_<step>.vtk`` into the
working directory every N steps.  ``--dtype`` defaults to float64: FP64 is
native on the card (the JAX demo's float32 default on its TPU is not
taken).  ``--scan`` (the JAX demo's whole-horizon device program) is not
ported and is refused.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import measure
from .fem import mesh as meshmod
from .fem.assemble import NSAssembler
from .fem.dofmap import DirichletBC
from .solvers.config import SolverConfig, env_overrides, overrides
from .solvers.unsteady import UnsteadySolver
from .utils.io import load_checkpoint, save_checkpoint, save_vtk

SCAN_REFUSED = ("--scan is not ported: the whole-horizon device program "
                "(solve_scan) is a TPU workaround; use --fused for the "
                "semi-implicit loop")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="unsteady channel flow, theta scheme or BDF2 with PCD "
                    "Oseen solves")
    ap.add_argument("-l", "--level", type=int, default=1)
    ap.add_argument("--nu", type=float, default=0.02)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--t-end", type=float, default=2.0)
    ap.add_argument("--theta", type=float, default=1.0,
                    help="1 = implicit Euler, 0.5 = Crank-Nicolson")
    ap.add_argument("--scheme", choices=["theta", "bdf2"], default="theta",
                    help="bdf2 = second-order BDF (implicit-Euler startup)")
    ap.add_argument("--pcd", choices=["BRM1", "BRM2"], default="BRM2")
    ap.add_argument("--picard-iters", type=int, default=2)
    ap.add_argument("--fused", action="store_true",
                    help="semi-implicit loop on high-precision solves "
                         "(ignores --picard-iters)")
    ap.add_argument("--scan", action="store_true",
                    help="not ported (refused)")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float64")
    ap.add_argument("--checkpoint", default=None,
                    help="npz path: resume if it exists, save at the end")
    ap.add_argument("--vtk-every", type=int, default=0,
                    help="write the solution as VTK every N steps")
    ap.add_argument("--device", default="cuda")
    return ap


def build(args, device):
    """``(solver, asm)`` for the parsed flags on ``device``."""
    adtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    mesh = meshmod.channel_mesh(args.level, length=4.0)
    asm = NSAssembler(mesh, args.nu, device=device, dtype=adtype)

    def inflow(x):
        v = np.zeros((x.shape[0], 2))
        v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
        return v

    bcs = [DirichletBC.velocity(asm.W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [meshmod.INFLOW], inflow)]
    cfg = env_overrides(overrides(SolverConfig(), {
        "pcd.variant": args.pcd, "dtype": args.dtype,
        "velocity.method": "lu", "pcd.ap.method": "lu"}))
    marker = meshmod.INFLOW if args.pcd == "BRM1" else meshmod.OUTFLOW
    solver = UnsteadySolver(asm, bcs, cfg, dt=args.dt, theta=args.theta,
                            scheme=args.scheme, pcd_marker=marker)
    return solver, asm


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.scan:
        ap.error(SCAN_REFUSED)
    device = torch.device(args.device)
    solver, asm = build(args, device)

    w0, t0 = None, 0.0
    if args.checkpoint and os.path.exists(args.checkpoint):
        wnp, t0, _ = load_checkpoint(args.checkpoint)
        w0 = torch.as_tensor(wnp, device=device)
        print(f"resumed from {args.checkpoint} at t={t0}")

    print(f"unsteady channel l={args.level} nu={args.nu} dt={args.dt} "
          f"scheme={args.scheme} theta={args.theta}  dofs {solver.n}  "
          f"device {device}", flush=True)

    def cb(k, t, w):
        if args.vtk_every and (k + 1) % args.vtk_every == 0:
            save_vtk(f"channel_{k + 1:04d}.vtk", asm, w)

    if int(round((args.t_end - t0) / args.dt)) <= 0:
        print(f"nothing to do: checkpoint already at t={t0} >= "
              f"t_end={args.t_end}")
        return
    if args.fused:
        res = solver.solve_fused(args.t_end - t0, w0=w0, callback=cb)
    else:
        res = solver.solve(args.t_end - t0, w0=w0,
                           picard_iters=args.picard_iters, callback=cb)
    for t, it, rn in zip(res.times, res.linear_iters, res.step_res):
        print(f"  t={t0 + t:6.3f}  fgmres iters {it:3d}  |F| {rn:.3e}")
    print(f"wall: {res.wall_time:.2f} s  "
          f"({res.wall_time / max(len(res.times), 1):.3f} s/step)",
          flush=True)
    print("kernel launches " + json.dumps(measure.launch_counts()),
          flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, res.w.cpu().numpy(),
                        t0 + res.times[-1], {"nu": args.nu, "dt": args.dt})
        print(f"checkpointed to {args.checkpoint}")


if __name__ == "__main__":
    main()
