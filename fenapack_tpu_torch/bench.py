"""Headline benchmark of the port: 2D backward-facing step, Re = 100,
Picard with Anderson(6) mixing and PCD-BRM2, on a CUDA device.

The counterpart of the repository's ``bench.py`` (``build`` and ``main``)
in the main-path configuration: level-2 mesh by uniform refinement of the
level-0 step, Taylor-Hood P2/P1 in natural ordering, BSR operators with
b = 32, each linear solve by f64 FGMRES (f64 BSR system matvec) to a true
relative residual of 1e-8 around an f32 upper Schur fieldsplit (velocity
multigrid, PCD-BRM2 with pressure multigrid for Ap and Chebyshev-4 for Mp),
nonlinear relative residual 1e-5.

    python -m fenapack_tpu_torch.bench [--level 2]

prints one JSON line with the fields and metric name of ``bench.py``.  It
needs a CUDA device: the wall time is a device measurement.
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
_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden_counts.json")


def build(level: int, *, device, dtype: str = "float32") -> NonlinearSolver:
    """The main-path solver at ``level`` on ``device``; ``dtype`` is the
    preconditioner's compute dtype (the outer Krylov solve is always f64)."""
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
        "velocity.smooth_iters": 3, "velocity.cycles": 2,
        "pcd.ap.method": "gmg",
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


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_pcd_apply(nl: NonlinearSolver, w: torch.Tensor, n_apply: int = 200,
                   reps: int = 5) -> float:
    """Median per-apply latency (ms) of the PCD apply at state ``w``, over
    ``n_apply`` chained applies (normalized each step), timed with CUDA
    events."""
    oseen, asm = nl.oseen, nl.asm
    kp = asm.pat_p1.matrix(asm.kp_values(
        w[:nl.n_u].to(oseen.dtype),
        surface=True).to(oseen.dtype))
    pcd = oseen.pcd_apply()
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(asm.n1),
                        dtype=oseen.dtype, device=asm.device)
    r = r / torch.linalg.norm(r)

    def chain(x):
        for _ in range(n_apply):
            y = pcd(kp, x)
            x = y / torch.linalg.norm(y)
        return x

    chain(r)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(r)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n_apply)
    return float(np.median(times))


def run(level: int = 2, *, device):
    """Build, warm up with one full solve, then time one full solve.
    Returns ``(record, result, launches)``: the JSON record of ``bench.py``,
    the timed solve's :class:`FullSolveResult` and the kernel launches of
    the timed solve alone (the counters are set to 0 just before it and
    read just after it)."""
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
    pcd_ms = time_pcd_apply(nl, result.w)

    golden_total = None
    if os.path.exists(_GOLDEN):
        with open(_GOLDEN) as f:
            entry = json.load(f).get(f"step2d/l{level}/{VARIANT}/picard")
        golden_total = entry["total"] if entry else None
    total = int(sum(result.iters))
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
            "pcd_apply_ms": pcd_ms,
            "stage_breakdown": None,
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
