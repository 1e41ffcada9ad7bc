"""Repeat a recycled Picard run and find where the repeats part.

    python -m fenapack_tpu_torch.determinism -l 2 --nu 1e-3 --max-steps 16 \\
        --recycle 16 [--deterministic-algorithms]

Runs the damped Picard loop of BASELINE config 5 (``highre.build``,
``NonlinearSolver.solve_fused``) twice from the same initial state.  After
each step it prints the step's outer count, |F| and a digest of the state
and of the GCRO-DR recycle space; then the first step at which the runs
differ.  At the state before that step (or after the last
step when the runs agree) it repeats each piece of a step twice on the same
inputs and prints whether the two results are bit for bit equal: the
assembled operator values (fine convection with and without the
streamline diffusion, Kp with its surface term, every velocity multigrid
level), the restrictions, the system matvec, one preconditioner apply on a
fixed vector, and one recycled solve (the Hessenberg columns and the
harvest).  ``--deterministic-algorithms`` runs everything under
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``: the quick test of whether the parting
comes from a CUDA operation at all.  The last line is one JSON object with
the counts and the first parting step.

    python -m fenapack_tpu_torch.determinism --cost

prints instead what a step's assembly and one velocity V-cycle apply take
(milliseconds, host clock around work that ends in a synchronisation,
median of 7 after a warm-up) on config 5 at level 2 and on the level-2 DFG
cylinder's BDF2 operator (2D-2), at the initial state: the cost of the
fixed-order sums, run on two checkouts in turns.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch


def digest(t) -> str:
    """A short digest of a tensor's bytes (None for None)."""
    if t is None:
        return "-"
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def run(nl, steps: int):
    """``steps`` damped Picard steps (``solve_fused``, config 5's settings);
    per step (count, |F|, state digest, recycle digest), and the state
    before every step."""
    from . import highre
    rows, states = [], [nl.initial_state().to(nl.asm.dtype)]

    def record(k, rn, iters, lin_rel, w, rec):
        states.append(w)
        rows.append((iters, rn, digest(w),
                     digest(None if rec is None else rec.U)))
    nl.solve_fused(rtol=0.0, rtol_lin=highre.RTOL_LIN, max_steps=steps,
                   damping=highre.DAMPING, callback=record)
    return rows, states


def op_checks(nl, w: torch.Tensor, rtol_lin: float):
    """Each piece of a Picard step at state ``w``, twice on the same
    inputs: name -> bit-for-bit equal."""
    from .solvers import gmg
    o, asm = nl.oseen, nl.asm
    vh, ph = o.velocity_hierarchy, o.ap_hierarchy
    wind = w[:nl.n_u]
    g = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn(nl.n, generator=g, dtype=torch.float64).to(w.device)
    checks = {
        "A1 hi (convection, f32 integrals)": lambda: asm.picard_matrix_values(
            wind, hi=True, compute32=True),
        "A1 (convection)": lambda: asm.picard_matrix_values(wind),
        "SUPG": lambda: asm.supg_values(wind),
        "Kp with surface": lambda: asm.kp_values(wind, surface=True),
        "velocity levels": lambda: torch.cat([
            a.reshape(-1) for a, _ in gmg.velocity_gmg_values(
                vh, wind.to(o.dtype), o.bc_mask_u, o.dtype,
                fine_values=o._operator_values(wind),
                supg=True)["levels"]]),
        "P2 restriction": lambda: vh.transfers[-1].restrict(
            v[:vh.transfers[-1].n_fine].to(o.dtype)),
        "P1 restriction": lambda: ph.transfers[-1].restrict(
            v[:ph.transfers[-1].n_fine].to(o.dtype)),
        "system matvec": lambda: o._matvec_factory(
            *o._operator_values_raw(wind, hi=True), hi=True)(v),
        "preconditioner apply": lambda: o._pipeline(wind.to(o.dtype))(
            v.to(o.dtype)),
    }
    out = {}
    for name, fn in checks.items():
        a, b = fn(), fn()
        out[name] = bool(torch.equal(a, b))
    ir = o.make_ir_solve(rtol_lin)
    F, _ = nl.residual_of(w)
    rec = None
    if o.config.krylov.recycle:
        rec = ir(wind, -F, None)[4]          # a space to deflate with
    r1, r2 = ir(wind, -F, rec), ir(wind, -F, rec)
    out["recycled solve: iterate"] = bool(torch.equal(r1[0], r2[0]))
    out["recycled solve: count"] = r1[1] == r2[1]
    if rec is not None:
        out["recycled solve: harvested space"] = bool(
            torch.equal(r1[4].U, r2[4].U))
    return out


def _ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cost(device) -> dict:
    """Milliseconds of a step's assembly and of one velocity V-cycle apply
    on config 5 (level 2) and the DFG cylinder 2D-2 (level 2)."""
    from . import cylinder, highre
    out = {}
    for name, solver in (
            ("config 5 l2", lambda: highre.build(2, highre.NU,
                                                 device=device)),
            ("cylinder 2D-2 l2", lambda: cylinder.build(
                2, 100, device=device, unsteady=True))):
        s = solver()
        o, asm = s.oseen, s.asm
        vh = o.velocity_hierarchy
        wind = s.initial_state()[:s.n_u].to(asm.dtype)

        def assembly():
            o._operator_values_raw(wind, hi=True)
            o._operator_values(wind)
            asm.kp_values(wind, surface=True)
            for lasm in vh.asms[:-1]:
                n2 = lasm.n2
                lasm.picard_matrix_values(torch.cat(
                    [wind[a * asm.n2:a * asm.n2 + n2]
                     for a in range(asm.dim)]))
        A1, R = o._operator_values(wind)
        vcycle = o._velocity_solver(A1, wind, R)
        g = torch.Generator(device="cpu").manual_seed(0)
        v = torch.randn(s.n_u, generator=g, dtype=o.dtype).to(device)
        out[name] = {"assembly_ms": _ms(assembly),
                     "vcycle_ms": _ms(lambda: vcycle(v))}
        print(f"{name}: {out[name]}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="repeat config 5's recycled Picard run and find the "
                    "first step and operation at which the repeats differ")
    ap.add_argument("-l", "--level", type=int, default=2)
    ap.add_argument("--nu", type=float, default=1e-3)
    ap.add_argument("--max-steps", type=int, default=16)
    ap.add_argument("--recycle", type=int, default=16)
    ap.add_argument("--deterministic-algorithms", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cost", action="store_true",
                    help="time a step's assembly and a V-cycle instead")
    args = ap.parse_args(argv)
    if args.cost:
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
        print(json.dumps({"cost": cost(args.device)}), flush=True)
        return
    if args.deterministic_algorithms:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
    from . import highre
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    runs = []
    for r in range(2):
        t0 = time.perf_counter()
        nl = highre.build(args.level, args.nu, device=args.device,
                          recycle=args.recycle)
        rows, states = run(nl, args.max_steps)
        runs.append((rows, states))
        print(f"run {r}: {time.perf_counter() - t0:.3f} s", flush=True)
        for k, (it, rn, dw, dr) in enumerate(rows):
            print(f"  step {k + 1}: iters {it} |F| {rn:.17e} state {dw} "
                  f"space {dr}", flush=True)
    first = None
    for k in range(args.max_steps):
        if runs[1][0][k] != runs[0][0][k]:
            first = k
            break
    print(f"first step at which the runs differ: "
          f"{'none' if first is None else first + 1}", flush=True)
    at = first if first is not None else args.max_steps
    checks = op_checks(nl, runs[0][1][at], highre.RTOL_LIN)
    for name, equal in checks.items():
        print(f"  {name}: {'equal' if equal else 'DIFFERS'}", flush=True)
    print(json.dumps({
        "level": args.level, "recycle": args.recycle,
        "deterministic_algorithms": args.deterministic_algorithms,
        "counts": [[row[0] for row in rr[0]] for rr in runs],
        "first_differing_step": None if first is None else first + 1,
        "ops_checked_at_state_before_step": at + 1,
        "ops_equal": checks}), flush=True)


if __name__ == "__main__":
    main()
