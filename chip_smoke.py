#!/usr/bin/env python3
"""Smoke run of fenapack_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Drives the port's main path (the headline benchmark: 2D backward-facing
step at level 2, 25,987 dofs, Re = 100, Picard + Anderson(6), PCD-BRM2,
FGMRES to 1e-8) on the card, in phases that each print one line:

  1. device  - require CUDA; print ``nvidia-smi`` name and power limit.
  2. build   - compile the BSR SpMV kernel library from csrc/ (nvcc).
  3. kernels - every BSR operator of the level-2 path, through the kernel
               (float64: K1, float32: K2) against the plain PyTorch version
               on the same inputs, single and two right-hand sides.
  4. slice   - the benchmark's timed solve; asserts convergence, outer
               iterations within the oracle's 10% band, every linear solve
               at true relative residual <= 1e-8 and kernel launches > 0.
  5. reference - the level-1 solve on the card against the same solve on
               the CPU (the plain versions): per-step counts within 1 and
               states within the nonlinear tolerance.

Then one JSON line with the kernels' records, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
result line).  Imports nothing of JAX.
"""
import json
import subprocess

import numpy as np
import torch

F64_TOL, F32_TOL = 1e-12, 1e-5      # max relative error, kernel vs plain
OUTER_CAP = 301                      # oracle total 271 / 0.9 (BASELINE band)
SOURCE = "fenapack_tpu_torch/csrc/bsr_spmv.cu"
REPLACES = {"f64": "fenapack_tpu/ops/pallas_spmv.py:526",
            "f32": "fenapack_tpu/ops/pallas_spmv.py:269"}
HEADLINE = {"f64": "A1 fine (f64)", "f32": "A1 velocity level 2"}


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _cuda_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median milliseconds per call of ``fn`` from CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def path_operators(nl):
    """Every BSR operator the main path applies, with the values it
    applies at the initial state."""
    from fenapack_tpu_torch.solvers import gmg
    o, asm = nl.oseen, nl.asm
    w0 = nl.initial_state().to(torch.float64)
    wind = w0[:nl.n_u]
    A1h = o._operator_values_raw(wind, hi=True)
    A1 = o._operator_values(wind.to(o.dtype))
    kp = asm.kp_values(wind.to(o.dtype), surface=True).to(o.dtype)
    vh, ph = o.velocity_hierarchy, o.ap_hierarchy
    lv = gmg.velocity_gmg_values(vh, wind.to(o.dtype), o.bc_mask_u, o.dtype,
                                 fine_values=A1)["levels"]
    ops = [("A1 fine (f64)", asm.pat_p2_hi.matrix(A1h)),
           ("DT fine (f64)", asm.const_hi.DT[0]),
           ("D fine (f64)", asm.const_hi.D[0]),
           ("Bt (f32)", asm.const.DT[0]), ("D (f32)", asm.const.D[0]),
           ("Mp", asm.const.Mp), ("Kp", asm.pat_p1.matrix(kp))]
    ops += [(f"A1 velocity level {l}", a.pat_p2.matrix(v))
            for l, (a, v) in enumerate(zip(vh.asms, lv))]
    ops += [(f"Ap pressure level {l}", lev.Ap)
            for l, lev in enumerate(ph.levels)]
    for name, transfers in (("P2", vh.transfers), ("P1", ph.transfers)):
        for l, t in enumerate(transfers):
            ops += [(f"{name} prolong {l}->{l + 1}", t._P),
                    (f"{name} restrict {l + 1}->{l}", t._PT)]
    return ops


def main():
    # ---- 1. device ------------------------------------------------------ #
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from fenapack_tpu_torch import bench
    from fenapack_tpu_torch.ops import bsr_spmv

    # ---- 2. build ------------------------------------------------------- #
    secs = bsr_spmv.build_library()
    print(f"[build] {bsr_spmv.library_path()} compiled in {secs:.3f} s",
          flush=True)

    # ---- 3. kernels against the plain version at the l2 shapes ---------- #
    nl = bench.build(2, device=dev)
    rng = np.random.default_rng(0)
    rec = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
           for k in ("f64", "f32")}
    for name, op in path_operators(nl):
        kind = bsr_spmv._NAMES[op.tiles.dtype]
        tol = F64_TOL if kind == "f64" else F32_TOL
        args = (op.nbr, op.tiles)
        for k in (1, 2):
            shape = (op.n_cols,) if k == 1 else (op.n_cols, k)
            x = torch.as_tensor(rng.standard_normal(shape),
                                dtype=op.tiles.dtype, device=dev)
            y = bsr_spmv.bsr_spmv(*args, x, op.n_rows, op.n_cols)
            yp = bsr_spmv.bsr_spmv_plain(*args, x, op.n_rows, op.n_cols)
            torch.cuda.synchronize()
            abs_err = float((y - yp).abs().max())
            rel = abs_err / max(float(yp.abs().max()), 1e-300)
            ms = _cuda_ms(lambda: bsr_spmv.bsr_spmv(*args, x, op.n_rows,
                                                    op.n_cols))
            pms = _cuda_ms(lambda: bsr_spmv.bsr_spmv_plain(
                *args, x, op.n_rows, op.n_cols))
            print(f"[kernels] {name:24s} bsr_spmv_{kind} tiles "
                  f"{tuple(op.tiles.shape)} nrhs {k}: max rel err {rel} "
                  f"(tol {tol}), kernel {ms} ms, plain {pms} ms",
                  flush=True)
            _require(rel <= tol, f"{name}: kernel disagrees with plain "
                     f"({rel} > {tol})")
            r = rec[kind]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            if name == HEADLINE[kind] and k == 1:
                r["ms"], r["plain_ms"] = ms, pms
    del nl

    # ---- 4. the slice: the benchmark's timed solve ---------------------- #
    # ``timed``: the launches of the timed solve alone (bench.run sets the
    # counters to 0 just before it and reads them just after it)
    record, result, timed = bench.run(2, device=dev)
    print(json.dumps(record), flush=True)
    d = record["detail"]
    w = result.w
    print(f"[slice] steps {d['nonlinear_steps']} iters "
          f"{d['inner_iters_per_step']} total {d['total_inner_iters']} "
          f"(oracle {d['oracle_total_iters']}, cap {OUTER_CAP}); wall "
          f"{record['value']} s; final nonlinear rel res "
          f"{d['final_nonlinear_res_rel']}; max linear true rel res "
          f"{max(result.lin_rel)}; host syncs {result.host_syncs}; "
          f"kernel launches in the timed solve {timed}", flush=True)
    _require(result.converged, "the Picard solve did not converge")
    _require(d["total_inner_iters"] <= OUTER_CAP,
             f"{d['total_inner_iters']} outer iterations > {OUTER_CAP}")
    _require(all(i <= bench.MAXITER for i in result.iters),
             f"a linear solve hit the Krylov cap: {result.iters}")
    _require(max(result.lin_rel) <= bench.RTOL_LIN,
             f"linear true relative residuals {result.lin_rel}")
    _require(d["final_nonlinear_res_rel"] <= bench.RTOL_NL,
             f"final nonlinear residual {d['final_nonlinear_res_rel']}")
    _require(w.shape == (d["n_dof"],) and bool(torch.isfinite(w).all()),
             "the state is not a finite vector of n_dof values")
    _require(timed["f64"] > 0 and timed["f32"] > 0,
             f"kernel launches in the timed solve: {timed}")

    # ---- 5. reference: level 1 on the card vs the CPU ------------------- #
    runs = {}
    for where in (dev, torch.device("cpu")):
        nl1 = bench.build(1, device=where)
        full = nl1.make_full_solve(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN,
                                   max_steps=bench.MAX_STEPS,
                                   anderson=bench.ANDERSON)
        runs[where.type] = full(nl1.initial_state().to(torch.float64))
    g, c = runs["cuda"], runs["cpu"]
    diff = float(torch.linalg.norm(g.w.cpu() - c.w) / torch.linalg.norm(c.w))
    print(f"[reference] level 1 iters cuda {g.iters} cpu {c.iters}; "
          f"relative state difference {diff}", flush=True)
    _require(g.converged and c.converged and len(g.iters) == len(c.iters)
             and all(abs(a - b) <= 1 for a, b in zip(g.iters, c.iters)),
             f"level-1 counts differ: cuda {g.iters}, cpu {c.iters}")
    _require(diff <= bench.RTOL_NL, f"level-1 states differ by {diff}")

    kernels = [{"name": f"bsr_spmv_{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": timed[k],
                **rec[k]} for k in ("f64", "f32")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
