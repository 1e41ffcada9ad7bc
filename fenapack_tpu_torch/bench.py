"""Headline benchmark of the port: 2D backward-facing step, Re = 100,
Picard with Anderson(6) mixing and PCD-BRM2, on a CUDA device.

The counterpart of the repository's ``bench.py`` (``build`` and ``main``)
in the main-path configuration: level-2 mesh by uniform refinement of the
level-0 step, Taylor-Hood P2/P1, BSR operators with b = 32 on every
multigrid level, each level's dofs in its own RCM order (the block
layout's default, ``NSAssembler(reorder=None)``), each linear solve by f64
FGMRES (f64 BSR system matvec) to a true relative residual of 1e-8 around
an f32 upper Schur fieldsplit (velocity multigrid, PCD-BRM2 with pressure
multigrid for Ap and Chebyshev-4 for Mp), nonlinear relative residual
1e-5.

    python -m fenapack_tpu_torch.bench [--level 2]

prints one JSON line with the fields and metric name of ``bench.py``,
``detail.stage_breakdown`` included (:func:`stage_breakdown`: the time per
outer iteration split into the outer matvec, the preconditioner and its
parts, and the Krylov remainder).  It needs a CUDA device: the wall time is
a device measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .fem import mesh as meshmod
from .fem.assemble import NSAssembler
from .fem.dofmap import DirichletBC
from .ops import bsr_spmv
from .solvers import gmg
from .solvers.config import SolverConfig, overrides
from .solvers.nonlinear import NonlinearSolver

METRIC = "step2d_re100_picard_pcd_nl1e-5_lin1e-8_wall_s"
RTOL_NL, RTOL_LIN, MAX_STEPS, ANDERSON = 1e-5, 1e-8, 25, 6
MAXITER = 48                      # FGMRES Krylov dimension per linear solve
BLOCK = 32
NU = 0.02
VARIANT = "BRM2"
# the multi-round refinement of the JAX package's bench in its BENCH_HIK=0
# mode (its ``bench.py:177-199``, ``:212``): f32 rounds to 2e-6 on the f64
# true residual, GCRO-DR of 16, cap 120; the A/B's two modes
IR_ROUNDS = {"krylov.hi_krylov": False, "krylov.rtol": 2e-6,
             "krylov.recycle": 16, "krylov.maxiter": 120}
IR_MODES = (("hi_krylov", None), ("rounds", IR_ROUNDS))
# applies per chain of the stage breakdown in ``run`` (the slowest stage,
# the whole preconditioner, ~8 ms an apply at level 2 on the card)
BREAKDOWN_APPLIES = 20
_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden_counts.json")


def build(level: int, *, device, dtype: str = "float32",
          over: dict = None) -> NonlinearSolver:
    """The main-path solver at ``level`` on ``device``; ``dtype`` is the
    preconditioner's compute dtype (the outer Krylov solve is f64 under the
    default ``krylov.hi_krylov``).  ``over``: dotted config overrides
    applied last (e.g. the multi-round refinement of the JAX package's
    ``BENCH_HIK=0`` mode)."""
    pdt = {"float32": torch.float32, "float64": torch.float64}[dtype]
    hier = gmg.build_hierarchy(meshmod.backward_step_mesh(0), level)
    asm = NSAssembler(hier.fine, NU, device=device, dtype=torch.float64,
                      block_size=BLOCK, hi_block=True,
                      block_dtype=pdt if pdt != torch.float64 else None)

    def inflow(x):
        v = np.zeros((x.shape[0], 2))
        v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
        return v

    bcs = [DirichletBC.velocity(asm.W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [meshmod.INFLOW], inflow)]
    cfg = overrides(SolverConfig(), {
        "dtype": dtype,
        "pcd.variant": VARIANT,
        "krylov.maxiter": MAXITER,
        "velocity.method": "gmg", "velocity.smooth_iters": 3,
        "velocity.cycles": 2, "pcd.ap.method": "gmg",
        **(over or {}),
    })
    ap_h = gmg.PressureHierarchy(hier, pdt, device=device,
                                 pcd_markers=[meshmod.OUTFLOW],
                                 block_size=BLOCK,
                                 fine_asm=asm)
    v_h = gmg.VelocityHierarchy(hier, NU, pdt, device=device,
                                bc_markers=[meshmod.WALL, meshmod.INFLOW],
                                fine_asm=asm, block_size=BLOCK)
    return NonlinearSolver(asm, bcs, cfg, pcd_marker=meshmod.OUTFLOW,
                           ap_hierarchy=ap_h, velocity_hierarchy=v_h)


def ir_modes(level: int, *, device, warmup_steps: int = MAX_STEPS) -> dict:
    """``{mode: (solver, full_solve, w0)}`` for the two modes of
    :data:`IR_MODES` at ``level``: the benchmark's solver as it is (one f64
    FGMRES round per linear solve) and in the multi-round mode, each full
    Picard + Anderson solve warmed up by ``warmup_steps`` Picard steps."""
    out = {}
    for mode, over in IR_MODES:
        nl = build(level, device=device, over=over)
        kw = dict(rtol=RTOL_NL, rtol_lin=RTOL_LIN, anderson=ANDERSON)
        w0 = nl.initial_state().to(torch.float64)
        nl.make_full_solve(max_steps=warmup_steps, **kw)(w0)
        out[mode] = (nl, nl.make_full_solve(max_steps=MAX_STEPS, **kw), w0)
    return out


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_chain(fn, x0: torch.Tensor, n_apply: int = 100,
                reps: int = 5) -> float:
    """Median per-apply latency (ms) of ``fn`` over ``n_apply`` chained
    applies (the output normalized before it feeds the next apply), after
    one warm-up chain.  The clock follows the vector's device: CUDA events
    around the chain on a CUDA device, the host clock on the CPU."""
    def chain(x):
        for _ in range(n_apply):
            y = fn(x)
            x = y / torch.linalg.norm(y)
        return x

    chain(x0)
    cuda = x0.device.type == "cuda"
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(x0)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            chain(x0)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)) / n_apply


def time_pcd_apply(nl: NonlinearSolver, w: torch.Tensor, n_apply: int = 200,
                   reps: int = 5) -> float:
    """Median per-apply latency (ms) of the PCD apply at state ``w``, over
    ``n_apply`` chained applies (normalized each step)."""
    oseen, asm = nl.oseen, nl.asm
    kp = asm.pat_p1.matrix(asm.kp_values(
        w[:nl.n_u].to(oseen.dtype),
        surface=oseen.config.pcd.variant == "BRM2").to(oseen.dtype))
    pcd = oseen.pcd_apply()
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(asm.n1),
                        dtype=oseen.dtype, device=asm.device)
    return _time_chain(lambda x: pcd(kp, x), r / torch.linalg.norm(r),
                       n_apply, reps)


def stage_breakdown(nl: NonlinearSolver, w: torch.Tensor, wall_s: float,
                    total_iters: int, n_apply: int = 100) -> dict:
    """The time per outer FGMRES iteration of a solve that took ``wall_s``
    for ``total_iters`` iterations, and its stages at state ``w``, each a
    chain of ``n_apply`` applies (:func:`_time_chain`): the outer matvec the
    solve uses (f64, K1 in the BSR layout, under ``krylov.hi_krylov`` or
    ``hi_matvec``; else the compute-dtype one), the whole preconditioner,
    its velocity solve, its PCD apply and B^T (the carry kept in p-space).
    ``krylov_algebra_and_loop_ms`` is the remainder of the iteration: the
    Krylov algebra, the host loop and the nonlinear step's residual and
    assembly amortized over its iterations.  The keys of the JAX
    package's ``bench.py::stage_breakdown``."""
    oseen, asm = nl.oseen, nl.asm
    kcfg, cfg = oseen.config.krylov, oseen.config
    rng = np.random.default_rng(1)
    dev, dt = asm.device, oseen.dtype
    wind = w[:nl.n_u].to(dt)
    vec = lambda n, dtype: torch.as_tensor(rng.standard_normal(n),
                                           dtype=dtype, device=dev)
    hi = kcfg.hi_krylov or kcfg.hi_matvec
    mv = (oseen._hi_matvec(w[:nl.n_u]) if hi
          else oseen._compute_pipeline(wind)[0])
    mv_ms = _time_chain(mv, vec(oseen.n, asm.dtype if hi else dt), n_apply)
    pc_ms = _time_chain(oseen._pipeline(wind), vec(oseen.n, dt), n_apply)
    A1vals, R = oseen._operator_values(wind)
    if cfg.jpc_supg and not cfg.system_supg:
        A1vals = A1vals + asm.supg_values(wind).to(dt)
    vel_ms = _time_chain(oseen._velocity_solver(A1vals, wind, R=R),
                         vec(nl.n_u, dt), n_apply)
    pcd_ms = time_pcd_apply(nl, w, n_apply)
    DT = asm.const.DT
    bt = lambda p: torch.cat([DT[a].mv(p) for a in range(oseen.d)])
    bt_ms = _time_chain(lambda p: p * (1.0 + torch.linalg.norm(bt(p))),
                        vec(asm.n1, dt), n_apply)
    per_iter_ms = wall_s * 1e3 / max(total_iters, 1)
    return {
        "per_outer_iter_ms": per_iter_ms,
        "outer_matvec_ms": mv_ms,
        "pc_apply_ms": pc_ms,
        "pc_velocity_solve_ms": vel_ms,
        "pc_pcd_apply_ms": pcd_ms,
        "pc_bt_mv_ms": bt_ms,
        "krylov_algebra_and_loop_ms": per_iter_ms - mv_ms - pc_ms,
    }


def run(level: int = 2, *, device):
    """Build, warm up with one full solve, then time one full solve and
    break its iteration down (:func:`stage_breakdown`).  Returns ``(record,
    result, launches)``: the JSON record of ``bench.py``, the timed solve's
    :class:`FullSolveResult` and the kernel launches of the timed solve
    alone (the counters are set to 0 just before it and read just after
    it)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the benchmark measures a CUDA device, not "
                           f"{device}")
    nl = build(level, device=device)
    full = nl.make_full_solve(rtol=RTOL_NL, rtol_lin=RTOL_LIN,
                              max_steps=MAX_STEPS, anderson=ANDERSON)
    w0 = nl.initial_state().to(torch.float64)
    full(w0)                                         # warm-up
    _sync(device)
    bsr_spmv.reset_launches()
    t0 = time.perf_counter()
    result = full(w0)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(bsr_spmv.launches)
    total = int(sum(result.iters))
    breakdown = stage_breakdown(nl, result.w, wall, total,
                                n_apply=BREAKDOWN_APPLIES)

    golden_total = None
    if os.path.exists(_GOLDEN):
        with open(_GOLDEN) as f:
            entry = json.load(f).get(f"step2d/l{level}/{VARIANT}/picard")
        golden_total = entry["total"] if entry else None
    record = {
        "metric": METRIC,
        "value": wall,
        "unit": "s",
        "vs_baseline": (golden_total / max(total, 1)
                        if golden_total else None),
        "detail": {
            "backend": device.type,
            "rtol_nl": RTOL_NL,
            "rtol_lin": RTOL_LIN,
            "level": level,
            "variant": VARIANT,
            "subsolves": "iterative",
            "block_size": BLOCK,
            "n_dof": int(nl.n),
            "nonlinear_steps": len(result.iters),
            "inner_iters_per_step": result.iters,
            "total_inner_iters": total,
            "oracle_total_iters": golden_total,
            "final_nonlinear_res_rel": (result.res[-1] / result.res[0]
                                        if result.res else None),
            "pcd_apply_ms": breakdown["pc_pcd_apply_ms"],
            "stage_breakdown": breakdown,
        },
    }
    return record, result, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", type=int, default=2)
    args = ap.parse_args(argv)
    record, _, _ = run(args.level, device="cuda")
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
