#!/usr/bin/env python3
"""Smoke run of fenapack_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Drives the port's six paths on the card (the step benchmark, the
lid-driven cavity, the DFG cylinder, the SUPG-stabilized step at high
Reynolds number, the 3D backward-facing step, the custom-form API), in
phases that each print one or more lines:

  1. device  - require CUDA; print ``nvidia-smi`` name and power limit.
  2. build   - compile every kernel library from csrc/ (one nvcc per source,
               started together); print each kernel's registers and spills
               (``-Xptxas -v``).
  3. kernels - every BSR operator of the step path (2D backward-facing
               step, level 2, 25,987 dofs) through the kernel (float64: K1,
               float32: K2) against the plain PyTorch version on the same
               inputs, single and two right-hand sides; the headline
               operators' time beside the HBM bound and a cuSPARSE BSR
               product of the same blocks.
  4. slice   - the step benchmark's timed solve (Re = 100, Picard +
               Anderson(6), PCD-BRM2, f64 FGMRES to 1e-8); asserts
               convergence, outer iterations within the oracle's 10% band,
               every linear solve at true relative residual <= 1e-8 and BSR
               kernel launches > 0.
  5. reference - the level-1 step solve on the card against the same solve
               on the CPU (the plain versions): per-step counts within 1 and
               states within the nonlinear tolerance.
  6. ell-kernels - every ELL operator of the cavity path at level 4 (A1 and
               the four Newton blocks R_ab on every velocity level, D, B^T,
               Ap on every pressure level, Mp, Kp) with the values of the
               first Newton state of the Re-100 stage, through the K3 kernel
               against the plain version in f64 and f32, 1 and 2 RHS; per
               operator the kernel, plain and cuSPARSE CSR times and the HBM
               bound.  Then the block product (A1 on both components plus
               the four R_ab in one pass) against its plain version on every
               velocity level in f64 and f32, with R, with R and a y0 term,
               and without R; for level 4 its times beside the bound of the
               whole product and six cuSPARSE CSR products.
  7. cavity  - the lid-driven cavity through the model entry point
               ``LidDrivenCavity(level=4).solver("BRM2", linearization=
               "newton", gmg_subsolves=True)``: 148,739 dofs, ELL in f64,
               Reynolds continuation 100 -> 200 -> 400 -> 500; asserts every
               stage converged, every linear solve under the Krylov cap at
               true relative residual <= 1e-8, K3 f64 launches > 0 of the
               single and of the block product and no BSR launch, |u| <= 1
               and mass conservation.
  8. cavity-reference - the same schedule at level 1 on the card and on the
               CPU: per-step counts within 1, states within 1e-5.
  9. cylinder-kernels - every ELL operator of the DFG cylinder path at level
               2 (328,004 dofs: A1 and the four R_ab of the first Newton
               state on every velocity level, the P1 bottom operator, D, B^T,
               Ap on every pressure level, Mp, Kp, the P2 mass) through K3
               against the plain version in f64 and f32; the block product
               with R, with R and y0, and without R (the BDF2 stepper's
               ``A1 + 1.5/dt M``) on every P2 level; the times of A1 at level
               2 and of both block products beside their bounds, and of the
               bottom level's dense inverse.
 10. cylinder-2d1 - DFG 2D-1 through ``cylinder.build(2, 20)``: Newton to
               1e-6; asserts convergence, every linear solve under the Krylov
               cap at true relative residual <= 1e-8, K3 single and block
               launches > 0 and no BSR launch, max |D u| <= 1e-9, c_D and dP
               inside the published intervals of Schafer & Turek (1996) and
               c_L at the level-2 value.
 11. cylinder-2d2 - DFG 2D-2 through ``cylinder.build(2, 100, unsteady=True,
               dt=0.00625)``: 40 semi-implicit BDF2 steps from the impulsive
               start with the device functional; asserts every step's solve
               under the cap at <= 1e-8, the functional's last row equal to
               its recomputation on the host from the last three states,
               mass conservation, c_D > 0 and block launches > 0.
 12. cylinder-reference - card against CPU: 5 BDF2 steps on the level-1
               obstacle channel, and on the level-0 cylinder the first two
               Newton steps of 2D-1 and 3 BDF2 steps of 2D-2: per-step counts
               within 1, states within 1e-6.
 13. highre-kernels - BASELINE config 5 at level 2 (25,987 dofs, Re 2000):
               the wind after the first damped Picard step, the block
               product without R on the SUPG-stabilized A1 of every velocity
               level (with and without y0) and the single product on D, B^T
               and Kp, through K3 against the plain version (f64, 1e-12);
               the times of the level-2 block product beside its bound.
 14. highre  - ``highre.build(2, nu)`` for nu = 1e-3 (Re 2000, Jacobi
               smoother, FGMRES to 1e-8) and 4e-4 (Re 5000, minres, 1e-6):
               two damped (0.7) Picard steps, then one Oseen solve at that
               wind; asserts every solve under the cap of 1000 at a true
               relative residual within its tolerance, |F| after two steps
               below |F_0|, K3 single and block launches > 0 and no BSR
               launch.
 15. highre-recycle - GCRO-DR against none: 4 damped Picard steps at Re
               2000, level 2, with spaces of 0 and 16 (|F| histories equal
               to 1e-6, fewer iterations in steps 2-4), and 10 BDF2 steps of
               the level-1 cylinder 2D-2 with spaces of 0 and 8 (states
               within 1e-6, fewer iterations in steps 2-10).
 16. highre-reference - level 1, card against CPU: 3 damped Picard steps at
               Re 2000 with and without recycling; per-step counts within 1,
               states within 1e-6.
 17. step3d-kernels - BASELINE config 4 at level 3, length 3 (760,852
               dofs; velocity levels of 685 / 4,473 / 32,113 / 242,913
               rows, tet P2 rows up to 65 wide): the wind after one Picard step; on every
               velocity level the block product at d = 3 without R and with
               the Newton R (and y0), and the single product on D, B^T, Ap
               of every pressure level, Mp and Kp, through K3 against the
               plain version (f64, 1e-12); for the fine A1 the times of the
               kernel, the plain version and three (twelve with R) cuSPARSE
               CSR products beside two bounds: the padded ELL bytes and the
               bytes of the pattern's own entries, over 3.35 TB/s.
 18. step3d  - config 4 through ``step3d.build(3)``: setup seconds by
               stage, two Picard steps each solved to a true 1e-8 under the
               cap of 120; counts, ``lin_rel``, seconds per step, K3
               launches per FGMRES iteration (none of BSR), peak device
               memory, max |D u| <= 1e-9 and max |u| <= 1.05.
 19. step3d-reference - level 1 (14,104 dofs), card against CPU, two
               Picard steps: equal counts, states within 1e-7.
 20. determinism - on the card, each twice and bit for bit equal: the
               assembly of A1, Kp and the Newton R at one wind on the 3D
               level-3 step, one 3D velocity V-cycle apply on a fixed
               vector, and three recycled (16) damped Picard steps of config
               5 at level 1 (the states).

 21. custom-forms - the custom-form API (``custom_forms.build(2)``: the
               step at level 2, 25,987 dofs, written as mini-UFL forms,
               PCDAssembler / PCDKrylovSolver / PCDNewtonSolver, BRM2 with
               dense velocity and Ap inverses and Chebyshev-4 Mp) to 1e-5:
               one line per Picard step (|F|, count, true relative
               residual, seconds, dense-inverse seconds); asserts 9 or 10
               steps, every solve at <= 1e-8, a total <= 1.1 x the oracle's
               271, K3 single launches > 0 and no other kernel; prints the
               peak device memory.
 22. custom-kernels - K3 against the plain version on the path's blocks at
               the converged state (the vector uu block, 23,042 x 38, and
               up, pu, Kp; f64, 1e-13); for uu the times of the kernel, the
               plain version and a cuSPARSE CSR product beside the bound.
 23. custom-determinism - two assemblies of J, Kp and the residual at that
               state, bit for bit equal.
 24. custom-reference - level 1, BRM1 with the fp form and with gp, three
               Picard steps on the card and on the CPU: equal counts,
               states within 1e-8.
 25. custom-3d - the 3D step at level 1: the custom Mp, Ap, Kp with the
               inflow face term and the uu block against the factored 3D
               assembler (1e-12).

Then one JSON line with the kernels' records, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit, no
result line).  Imports nothing of JAX.

Kernel times are medians of CUDA-event timings: per call over back-to-back
calls from Python (host-bound for the small operators; an operator that
fits in the 50 MB L2 stays there), and for the headline operators also on
the device alone with the L2 flushed before each call.
"""
import json
import re
import subprocess
import time

import numpy as np
import torch

F64_TOL, F32_TOL = 1e-12, 1e-5      # max relative error, kernel vs plain
OUTER_CAP = 301                      # oracle total 271 / 0.9 (BASELINE band)
SOURCE = "fenapack_tpu_torch/csrc/bsr_spmv.cu"
REPLACES = {"f64": "fenapack_tpu/ops/pallas_spmv.py:526",
            "f32": "fenapack_tpu/ops/pallas_spmv.py:269"}
HEADLINE = {"f64": "A1 fine (f64)", "f32": "A1 velocity level 2"}
ELL_SOURCE = "fenapack_tpu_torch/csrc/ell_spmv.cu"
ELL_REPLACES = "fenapack_tpu/ops/pallas_spmv.py:60"
ELL_HEADLINE = "A1 velocity level 4"
CYL_LEVEL, CYL_DT, CYL_STEPS = 2, 0.00625, 40
CYL_HEADLINE = f"A1 velocity level {CYL_LEVEL}"
# the JAX package's per-step counts of DFG 2D-1 at level 2 (CPU, f64)
CYL_JAX_ITERS = [49, 50, 53, 50, 49]
# Schafer & Turek (1996), DFG 2D-1; c_L: the level-2 discretisation value
# (the published interval [0.0104, 0.0110] is reached at level 3)
CD_REF, DP_REF, CL_L2 = (5.5700, 5.5900), (0.1172, 0.1176), (0.0101, 0.0005)
HR_LEVEL = 2
# (nu, velocity smoother, linear tolerance): Re 2000 and Re 5000 (the JAX
# package's test solves Re 5000 to 1e-6; no count at 1e-8 is known)
HR_RUNS = ((1e-3, "jacobi", 1e-8), (4e-4, "minres", 1e-6))
HR_RECYCLE = 16
# the cylinder's BDF2 operator is mass-dominated (~28 iterations a step): a
# space of 16 costs iterations there (level 1 on the CPU, both packages'
# algorithm: 255 -> 266 in steps 2-10), 8 saves a few (249)
CYL_RECYCLE = 8
# BASELINE config 4 at the size of the JAX package's largest completed TPU
# solve (760,852 dofs: level 3, length 3; the 2,050,228-dof length 9 runs
# through ``python -m fenapack_tpu_torch.step3d -l 3 --length 9``)
S3_LEVEL, S3_LENGTH, S3_STEPS = 3, 3.0, 2
S3_HEADLINE = f"A1 velocity level {S3_LEVEL}"
# the custom-form API at the step benchmark's mesh: the scipy oracle's
# total at level 2 (tests/golden_counts.json, step2d/l2/BRM2/picard) and a
# cap of 1.1 times it; K3 against its plain version on the path's blocks
CF_LEVEL, CF_ORACLE, CF_K3_TOL, CF_REF_STEPS = 2, 271, 1e-13, 3
CF_CAP = int(1.1 * CF_ORACLE)
PTXAS = re.compile(r"Compiling entry function '(\w+)'|(\d+) bytes spill "
                   r"stores, (\d+) bytes spill loads|Used (\d+) registers")


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def path_operators(nl):
    """Every BSR operator the main path applies, with the values it
    applies at the initial state."""
    from fenapack_tpu_torch.solvers import gmg
    o, asm = nl.oseen, nl.asm
    w0 = nl.initial_state().to(torch.float64)
    wind = w0[:nl.n_u]
    A1h, _ = o._operator_values_raw(wind, hi=True)
    A1, _ = o._operator_values(wind.to(o.dtype))
    kp = asm.kp_values(wind.to(o.dtype), surface=True).to(o.dtype)
    vh, ph = o.velocity_hierarchy, o.ap_hierarchy
    lv = [v for v, _ in gmg.velocity_gmg_values(
        vh, wind.to(o.dtype), o.bc_mask_u, o.dtype,
        fine_values=(A1, None))["levels"]]
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
    t_start = time.perf_counter()
    phase_s = {}

    def done(phase, t0):
        phase_s[phase] = time.perf_counter() - t0
        print(f"[time] {phase} {phase_s[phase]:.3f} s", flush=True)

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

    from fenapack_tpu_torch import (INFLOW, backward_step_mesh, bench,
                                    cavity, cavity_mesh, custom_forms,
                                    cylinder, cylinder_channel_mesh, forms,
                                    highre, measure, snap_to_circle, step3d)
    from fenapack_tpu_torch.models import ObstacleChannel2D, StepFlow3D
    from fenapack_tpu_torch.ops import bsr_spmv, ell_spmv, kernels
    from fenapack_tpu_torch.solvers import gmg

    def yardsticks(kernel, plain, lib, nbytes, flops, dtype):
        """Times of one product, for the kernel, its plain version and the
        library call, beside the bound: per call from the host (CUDA events
        around back-to-back calls) and on the device alone with the L2
        flushed before each call (``measure.device_ms``), as on the paths,
        whose working sets exceed the L2."""
        bms, by = measure.bound(nbytes, flops, dtype)
        call, why = lib
        r = {"ms": measure.cuda_ms(kernel),
             "plain_ms": measure.cuda_ms(plain),
             "library_ms": measure.cuda_ms(call) if call else None,
             "bound_ms": bms, "bound_by": by}
        for pre, fn in (("", kernel), ("plain_", plain), ("library_", call)):
            r[pre + "device_ms"] = measure.device_ms(fn) if fn else None
        return r, why

    # ---- 2. build ------------------------------------------------------- #
    t0 = time.perf_counter()
    secs = kernels.build()
    for name, sec in secs.items():
        print(f"[build] {kernels.library_path(name)} done after {sec:.3f} s",
              flush=True)
        entry, spills = "", (0, 0)
        for m in PTXAS.finditer(kernels.build_log.get(name, "")):
            if m.group(1):
                entry = m.group(1)
            elif m.group(2):
                spills = (int(m.group(2)), int(m.group(3)))
            else:
                kern = re.search(r"\d+((?:ell|bsr)\w*?_kernel\w+?)EvPK", entry)
                print(f"[build] ptxas {kern.group(1) if kern else entry}: "
                      f"{m.group(4)} registers, spill stores/loads "
                      f"{spills[0]}/{spills[1]} B", flush=True)
    done("build", t0)

    # ---- 3. BSR kernels against the plain version at the l2 shapes ------ #
    t0 = time.perf_counter()
    nl = bench.build(2, device=dev)
    rng = np.random.default_rng(0)
    rec = {k: {"max_abs_err": 0.0} for k in ("f64", "f32")}
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
            kernel = lambda: bsr_spmv.bsr_spmv(*args, x, op.n_rows,
                                               op.n_cols)
            plain = lambda: bsr_spmv.bsr_spmv_plain(*args, x, op.n_rows,
                                                    op.n_cols)
            line = (f"[kernels] {name:24s} bsr_spmv_{kind} tiles "
                    f"{tuple(op.tiles.shape)} nrhs {k}: max rel err {rel} "
                    f"(tol {tol}), kernel {measure.cuda_ms(kernel)} ms, "
                    f"plain {measure.cuda_ms(plain)} ms")
            r = rec[kind]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            if name == HEADLINE[kind] and k == 1:
                nbytes = measure.bsr_bytes(op.nbr, op.tiles, op.n_rows,
                                           op.n_cols)
                t, why = yardsticks(
                    kernel, plain, measure.library(measure.bsr_library(op),
                                                   x),
                    nbytes, 2 * op.tiles.numel(), op.tiles.dtype)
                r.update(t)
                line = (f"[kernels] {name} bsr_spmv_{kind} headline: "
                        f"{json.dumps(t)}; cuSPARSE BSR "
                        f"{why or 'taken'}; {nbytes} B")
            print(line, flush=True)
            _require(rel <= tol, f"{name}: kernel disagrees with plain "
                     f"({rel} > {tol})")
    del nl
    done("kernels", t0)

    # ---- 4. the step slice: the benchmark's timed solve ----------------- #
    # ``timed``: the launches of the timed solve alone (bench.run sets the
    # counters to 0 just before it and reads them just after it)
    t0 = time.perf_counter()
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
    done("slice", t0)

    # ---- 5. reference: step level 1 on the card vs the CPU -------------- #
    t0 = time.perf_counter()
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
    done("reference", t0)

    # ---- 6. ELL kernel against the plain version at the cavity shapes --- #
    t0 = time.perf_counter()
    hier = gmg.build_hierarchy(cavity_mesh(0), cavity.LEVEL)
    nl = cavity.build(cavity.LEVEL, cavity.RE[0], device=dev, hier=hier)
    print(f"[ell-kernels] cavity level {cavity.LEVEL}: {nl.n} dofs (n_u "
          f"{nl.n_u}, n1 {nl.asm.n1}), {len(hier.meshes)} multigrid levels; "
          f"setup {time.perf_counter() - t0:.3f} s", flush=True)
    erec = {k: {"max_abs_err": 0.0} for k in ("f64", "f32")}
    for name, pat, vals64 in cavity.ell_operators(nl):
        cols = pat.cols
        for dt in (torch.float64, torch.float32):
            kind = ell_spmv._NAMES[dt]
            tol = F64_TOL if kind == "f64" else F32_TOL
            vals = vals64.to(dt).contiguous()
            for k in (1, 2):
                shape = (pat.n_cols,) if k == 1 else (pat.n_cols, k)
                x = torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                                    device=dev)
                y = ell_spmv.ell_spmv(cols, vals, x, pat.n_cols)
                yp = ell_spmv.ell_spmv_plain(cols, vals, x, pat.n_cols)
                torch.cuda.synchronize()
                abs_err = float((y - yp).abs().max())
                rel = abs_err / max(float(yp.abs().max()), 1e-300)
                erec[kind]["max_abs_err"] = max(erec[kind]["max_abs_err"],
                                                abs_err)
                _require(rel <= tol, f"{name} {kind} nrhs {k}: kernel "
                         f"disagrees with plain ({rel} > {tol})")
                if k != 1:
                    print(f"[ell-kernels] {name:24s} {kind} nrhs 2: max rel "
                          f"err {rel} (tol {tol})", flush=True)
                    continue
                kernel = (lambda c=cols, v=vals, xx=x, n=pat.n_cols:
                          ell_spmv.ell_spmv(c, v, xx, n))
                plain = (lambda c=cols, v=vals, xx=x, n=pat.n_cols:
                         ell_spmv.ell_spmv_plain(c, v, xx, n))
                lib = measure.library(measure.csr_library(pat, vals), x)
                nbytes = measure.ell_bytes(vals, pat.n_cols)
                bms, by = measure.bound(nbytes, 2 * pat.nnz, dt)
                if name == ELL_HEADLINE:
                    t, why = yardsticks(kernel, plain, lib, nbytes,
                                        2 * pat.nnz, dt)
                    erec[kind].update(t)
                else:
                    why = lib[1]
                    t = {"ms": measure.cuda_ms(kernel),
                         "plain_ms": measure.cuda_ms(plain),
                         "library_ms": (measure.cuda_ms(lib[0]) if lib[0]
                                        else None), "bound_ms": bms}
                print(f"[ell-kernels] {name:24s} {kind} ELL "
                      f"{tuple(vals.shape)} nnz {pat.nnz} nrhs 1: max rel "
                      f"err {rel} (tol {tol}); {json.dumps(t)}; cuSPARSE "
                      f"CSR {why or 'taken'}; {nbytes} B ({by})",
                      flush=True)
    # the block product: A1 on both components plus the four R_ab, one pass
    levels = cavity.velocity_levels(nl)
    brec = {k: {"max_abs_err": 0.0} for k in ("f64", "f32")}
    top = len(levels) - 1
    for l, (pat, A1v, Rv) in enumerate(levels):
        for dt in (torch.float64, torch.float32):
            kind = ell_spmv._NAMES[dt]
            tol = F64_TOL if kind == "f64" else F32_TOL
            A1, R = A1v.to(dt).contiguous(), Rv.to(dt).contiguous()
            x = torch.as_tensor(rng.standard_normal((2, pat.n_cols)),
                                dtype=dt, device=dev)
            y0 = torch.as_tensor(rng.standard_normal((2, pat.n_rows)),
                                 dtype=dt, device=dev)
            rels = []
            for RR, yy in ((R, None), (R, y0), (None, None)):
                y = ell_spmv.ell_block_spmv(pat.cols, A1, RR, x, pat.n_cols,
                                            yy)
                yp = ell_spmv.ell_block_spmv_plain(pat.cols, A1, RR, x,
                                                   pat.n_cols, yy)
                torch.cuda.synchronize()
                abs_err = float((y - yp).abs().max())
                rels.append(abs_err / max(float(yp.abs().max()), 1e-300))
                brec[kind]["max_abs_err"] = max(brec[kind]["max_abs_err"],
                                                abs_err)
            line = (f"[ell-kernels] block product velocity level {l} {kind} "
                    f"ELL {tuple(A1.shape)}: max rel err with R {rels[0]}, "
                    f"with R and y0 {rels[1]}, without R {rels[2]} (tol "
                    f"{tol})")
            if l == top:
                kernel = lambda: ell_spmv.ell_block_spmv(pat.cols, A1, R, x,
                                                         pat.n_cols)
                plain = lambda: ell_spmv.ell_block_spmv_plain(
                    pat.cols, A1, R, x, pat.n_cols)
                # yardstick: the six cuSPARSE CSR products it replaces
                # (A1 on either component, the four R_ab), without the sums
                six = [measure.library(measure.csr_library(pat, v), x[b])
                       for v, b in ((A1, 0), (A1, 1), (R[0, 0], 0),
                                    (R[0, 1], 1), (R[1, 0], 0), (R[1, 1], 1))]
                calls = [c for c, _ in six]
                lib = ((lambda: [c() for c in calls]) if all(calls)
                       else None, "; ".join(w for _, w in six if w))
                nbytes = measure.ell_block_bytes(A1, R, 2, pat.n_cols)
                t, why = yardsticks(kernel, plain, lib, nbytes,
                                    measure.ell_block_flops(A1, R, 2), dt)
                brec[kind].update(t)
                line += (f"; {json.dumps(t)}; six cuSPARSE CSR products "
                         f"{why or 'taken'}; {nbytes} B")
            print(line, flush=True)
            _require(max(rels) <= tol, f"block product level {l} {kind}: "
                     f"kernel disagrees with plain ({rels} > {tol})")
    done("ell-kernels", t0)

    # ---- 7. the cavity slice at level 4 on the card --------------------- #
    t0 = time.perf_counter()
    bsr_spmv.reset_launches()
    ell_spmv.reset_launches()
    w, stages = None, []
    for Re in cavity.RE:
        ts = time.perf_counter()
        if Re != cavity.RE[0]:
            nl = cavity.build(cavity.LEVEL, Re, device=dev, hier=hier)
        before = (ell_spmv.launches["f64"], ell_spmv.block_launches["f64"])
        r = nl.solve(w, rtol=cavity.RTOL, max_steps=cavity.MAX_STEPS)
        torch.cuda.synchronize()
        w = r.w
        k3 = (ell_spmv.launches["f64"] - before[0],
              ell_spmv.block_launches["f64"] - before[1])
        stages.append(r)
        print(f"[cavity] Re {Re:g}: steps {len(r.linear_iters)} iters "
              f"{r.linear_iters} (cap {cavity.CFG['krylov.maxiter']}); "
              f"nonlinear res {r.nonlinear_res}; max linear true rel res "
              f"{max(r.lin_rel)}; solve {r.wall_time:.3f} s, stage "
              f"{time.perf_counter() - ts:.3f} s; K3 f64 launches: single "
              f"product {k3[0]}, block product {k3[1]} "
              f"({sum(k3) / r.total_linear_iters:.1f} per FGMRES iteration)",
              flush=True)
        _require(r.converged, f"Re {Re}: the Newton solve did not converge "
                 f"({r.nonlinear_res})")
        _require(max(r.linear_iters) < cavity.CFG["krylov.maxiter"],
                 f"Re {Re}: a linear solve hit the Krylov cap "
                 f"{r.linear_iters}")
        _require(max(r.lin_rel) <= cavity.CFG["krylov.rtol"],
                 f"Re {Re}: linear true relative residuals {r.lin_rel}")
    cavity_launches = {"ell_f64": ell_spmv.launches["f64"],
                       "ell_f32": ell_spmv.launches["f32"],
                       "ell_block_f64": ell_spmv.block_launches["f64"],
                       "ell_block_f32": ell_spmv.block_launches["f32"],
                       "bsr": dict(bsr_spmv.launches)}
    n2 = nl.asm.n2
    umax = float(w[:2 * n2].abs().max())
    div = float(sum(nl.asm.const.D[a].mv(w[a * n2:(a + 1) * n2])
                    for a in range(2)).abs().max())
    total = sum(r.total_linear_iters for r in stages)
    print(f"[cavity] level {cavity.LEVEL}, {nl.n} dofs: total outer "
          f"iterations {total}; max |u| {umax}; max |D u| {div}; launches "
          f"{cavity_launches}", flush=True)
    _require(cavity_launches["ell_f64"] > 0
             and cavity_launches["ell_block_f64"] > 0
             and sum(cavity_launches["bsr"].values()) == 0,
             f"cavity launches {cavity_launches}")
    _require(w.shape == (nl.n,) and bool(torch.isfinite(w).all()),
             "the cavity state is not a finite vector of n dofs")
    _require(umax <= 1.0 + 1e-6, f"max |u| {umax} exceeds the lid speed")
    _require(div <= 1e-9, f"mass conservation max |D u| = {div}")
    del nl
    done("cavity", t0)

    # ---- 8. cavity reference: level 1 on the card vs the CPU ------------ #
    t0 = time.perf_counter()
    runs = {}
    for where in (dev, torch.device("cpu")):
        w, its = None, []
        for Re in cavity.RE:
            r = cavity.build(1, Re, device=where).solve(
                w, rtol=cavity.RTOL, max_steps=cavity.MAX_STEPS)
            _require(r.converged, f"level 1 {where.type} Re {Re} did not "
                     "converge")
            w = r.w
            its.append(r.linear_iters)
        runs[where.type] = (w.cpu(), its)
    (gw, gi), (cw, ci) = runs["cuda"], runs["cpu"]
    diff = float(torch.linalg.norm(gw - cw) / torch.linalg.norm(cw))
    print(f"[cavity-reference] level 1 iters cuda {gi} cpu {ci}; relative "
          f"state difference {diff}", flush=True)
    _require(all(len(a) == len(b) and all(abs(p - q) <= 1
                                          for p, q in zip(a, b))
                 for a, b in zip(gi, ci)),
             f"level-1 cavity counts differ: cuda {gi}, cpu {ci}")
    _require(diff <= 1e-5, f"level-1 cavity states differ by {diff}")
    done("cavity-reference", t0)

    def rel_err(y, yp):
        torch.cuda.synchronize()
        abs_err = float((y - yp).abs().max())
        return abs_err, abs_err / max(float(yp.abs().max()), 1e-300)

    # ---- 9. K3 against the plain version at the cylinder's shapes ------- #
    t0 = time.perf_counter()
    chier = gmg.build_hierarchy(cylinder_channel_mesh(0), CYL_LEVEL,
                                snap=snap_to_circle)
    cnl = cylinder.build(CYL_LEVEL, 20, device=dev, hier=chier)
    cus = cylinder.build(CYL_LEVEL, 100, device=dev, unsteady=True,
                         dt=CYL_DT, hier=chier)
    torch.cuda.synchronize()
    print(f"[cylinder-kernels] level {CYL_LEVEL}: {cnl.n} dofs (n_u "
          f"{cnl.n_u}, n1 {cnl.asm.n1}), velocity levels "
          f"{[a.n2 for a in cnl.oseen.velocity_hierarchy.asms]} over the P1 "
          f"bottom of {cnl.oseen.velocity_hierarchy.asms[0].n1}; setup of "
          f"both solvers {time.perf_counter() - t0:.3f} s", flush=True)
    crec = {k: {} for k in ("f64", "f32")}
    n_ops = 0
    for name, pat, vals64 in cylinder.ell_operators(cnl):
        n_ops += 1
        for dt in (torch.float64, torch.float32):
            kind = ell_spmv._NAMES[dt]
            tol = F64_TOL if kind == "f64" else F32_TOL
            vals = vals64.to(dt).contiguous()
            x = torch.as_tensor(rng.standard_normal(pat.n_cols), dtype=dt,
                                device=dev)
            abs_err, rel = rel_err(
                ell_spmv.ell_spmv(pat.cols, vals, x, pat.n_cols),
                ell_spmv.ell_spmv_plain(pat.cols, vals, x, pat.n_cols))
            erec[kind]["max_abs_err"] = max(erec[kind]["max_abs_err"],
                                            abs_err)
            _require(rel <= tol, f"cylinder {name} {kind}: kernel disagrees "
                     f"with plain ({rel} > {tol})")
            line = (f"[cylinder-kernels] {name:24s} {kind} ELL "
                    f"{tuple(vals.shape)} nnz {pat.nnz}: max rel err {rel} "
                    f"(tol {tol})")
            if name == CYL_HEADLINE:
                kernel = lambda: ell_spmv.ell_spmv(pat.cols, vals, x,
                                                   pat.n_cols)
                plain = lambda: ell_spmv.ell_spmv_plain(pat.cols, vals, x,
                                                        pat.n_cols)
                nbytes = measure.ell_bytes(vals, pat.n_cols)
                t, why = yardsticks(
                    kernel, plain,
                    measure.library(measure.csr_library(pat, vals), x),
                    nbytes, 2 * pat.nnz, dt)
                crec[kind]["single"] = t
                line += (f"; {json.dumps(t)}; cuSPARSE CSR "
                         f"{why or 'taken'}; {nbytes} B")
            print(line, flush=True)
    # the block product on every P2 level: the Newton operator (with R, with
    # R and y0) and the BDF2 stepper's Picard operator (without R)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    newton_levels, _ = cylinder.velocity_levels(cnl)
    torch.cuda.synchronize()
    values_s = time.perf_counter() - ts
    picard_levels, _ = cylinder.velocity_levels(cus)
    # the bottom solve's setup, once per linear solve: the inverse of the
    # masked stacked P1 block (timed on a well-conditioned matrix of its
    # size)
    nb = 2 * cnl.oseen.velocity_hierarchy.asms[0].n1
    B = torch.eye(nb, dtype=torch.float64, device=dev) * 4.0 + torch.as_tensor(
        rng.standard_normal((nb, nb)), device=dev) / nb
    inv_ms = measure.cuda_ms(lambda: torch.linalg.inv(B), reps=3, inner=2)
    print(f"[cylinder-kernels] per linear solve: the level operators, the "
          f"P1 bottom operator and its inverse (velocity_gmg_values) "
          f"{values_s:.4f} s; torch.linalg.inv of a ({nb}, {nb}) f64 matrix "
          f"{inv_ms:.3f} ms", flush=True)
    del B
    top = len(newton_levels) - 1
    for l, ((pat, A1n, Rn), (_, A1p, Rp)) in enumerate(zip(newton_levels,
                                                           picard_levels)):
        _require(Rp is None, "the BDF2 stepper's operator has no R")
        for dt in (torch.float64, torch.float32):
            kind = ell_spmv._NAMES[dt]
            tol = F64_TOL if kind == "f64" else F32_TOL
            A1, R = A1n.to(dt).contiguous(), Rn.to(dt).contiguous()
            A1b = A1p.to(dt).contiguous()
            x = torch.as_tensor(rng.standard_normal((2, pat.n_cols)),
                                dtype=dt, device=dev)
            y0 = torch.as_tensor(rng.standard_normal((2, pat.n_rows)),
                                 dtype=dt, device=dev)
            rels = []
            for AA, RR, yy in ((A1, R, None), (A1, R, y0), (A1b, None, None),
                               (A1b, None, y0)):
                abs_err, rel = rel_err(
                    ell_spmv.ell_block_spmv(pat.cols, AA, RR, x, pat.n_cols,
                                            yy),
                    ell_spmv.ell_block_spmv_plain(pat.cols, AA, RR, x,
                                                  pat.n_cols, yy))
                rels.append(rel)
                brec[kind]["max_abs_err"] = max(brec[kind]["max_abs_err"],
                                                abs_err)
            line = (f"[cylinder-kernels] block product velocity level {l} "
                    f"{kind} ELL {tuple(A1.shape)}: max rel err with R "
                    f"{rels[0]}, with R and y0 {rels[1]}, without R "
                    f"{rels[2]}, without R with y0 {rels[3]} (tol {tol})")
            if l == top:
                for tag, AA, RR in (("with_R", A1, R),
                                    ("without_R", A1b, None)):
                    kernel = (lambda AA=AA, RR=RR: ell_spmv.ell_block_spmv(
                        pat.cols, AA, RR, x, pat.n_cols))
                    plain = (lambda AA=AA, RR=RR:
                             ell_spmv.ell_block_spmv_plain(
                                 pat.cols, AA, RR, x, pat.n_cols))
                    # yardstick: the cuSPARSE CSR products it replaces
                    parts = [(AA, 0), (AA, 1)] + (
                        [] if RR is None else
                        [(RR[0, 0], 0), (RR[0, 1], 1), (RR[1, 0], 0),
                         (RR[1, 1], 1)])
                    libs = [measure.library(measure.csr_library(pat, v),
                                            x[b]) for v, b in parts]
                    calls = [c for c, _ in libs]
                    lib = ((lambda calls=calls: [c() for c in calls])
                           if all(calls) else None,
                           "; ".join(w for _, w in libs if w))
                    nbytes = measure.ell_block_bytes(AA, RR, 2, pat.n_cols)
                    t, why = yardsticks(kernel, plain, lib, nbytes,
                                        measure.ell_block_flops(AA, RR, 2),
                                        dt)
                    crec[kind]["block_" + tag] = t
                    line += (f"; {tag} {json.dumps(t)}; {len(parts)} "
                             f"cuSPARSE CSR products {why or 'taken'}; "
                             f"{nbytes} B")
            print(line, flush=True)
            _require(max(rels) <= tol, f"cylinder block product level {l} "
                     f"{kind}: kernel disagrees with plain ({rels} > {tol})")
    print(f"[cylinder-kernels] {n_ops} operators and {top + 1} block levels "
          "agree with the plain version", flush=True)
    del newton_levels, picard_levels
    done("cylinder-kernels", t0)

    def k3_counts():
        return (ell_spmv.launches["f64"], ell_spmv.block_launches["f64"],
                ell_spmv.launches["f32"], ell_spmv.block_launches["f32"],
                sum(bsr_spmv.launches.values()))

    def max_div(asm, w):
        n2 = asm.n2
        return float(sum(asm.const.D[a].mv(w[a * n2:(a + 1) * n2])
                         for a in range(2)).abs().max())

    # ---- 10. DFG 2D-1 at level 2 on the card ---------------------------- #
    t0 = time.perf_counter()
    bsr_spmv.reset_launches()
    ell_spmv.reset_launches()
    maxiter = cnl.oseen.config.krylov.maxiter
    r = cnl.solve(rtol=cylinder.RTOL)
    torch.cuda.synchronize()
    d1 = k3_counts()
    cd, cl, dp = cylinder.coefficients(cnl.asm, r.w, 20)
    div = max_div(cnl.asm, r.w)
    far = [(i, a, b) for i, (a, b) in enumerate(zip(r.linear_iters,
                                                    CYL_JAX_ITERS))
           if abs(a - b) > 0.1 * b]
    print(f"[cylinder-2d1] level {CYL_LEVEL}, {cnl.n} dofs: steps "
          f"{len(r.linear_iters)} iters {r.linear_iters} (JAX CPU f64 record "
          f"{CYL_JAX_ITERS}; more than 10% away: {far or 'none'}; cap "
          f"{maxiter}); nonlinear res {r.nonlinear_res}; max linear true rel "
          f"res {max(r.lin_rel)}; solve {r.wall_time:.3f} s "
          f"({r.wall_time / len(r.linear_iters):.3f} s per Newton step, "
          f"{r.wall_time / r.total_linear_iters * 1e3:.2f} ms per FGMRES "
          f"iteration); K3 f64 launches: single {d1[0]}, block {d1[1]} "
          f"({(d1[0] + d1[1]) / r.total_linear_iters:.1f} per FGMRES "
          f"iteration), f32 {d1[2] + d1[3]}, BSR {d1[4]}", flush=True)
    print(f"[cylinder-2d1] c_D {cd:.6f} (published {CD_REF}), c_L {cl:.6f} "
          f"(level-2 value {CL_L2[0]} +- {CL_L2[1]}; published 0.0104-"
          f"0.0110), dP {dp:.6f} (published {DP_REF}); max |D u| {div}",
          flush=True)
    _require(r.converged, f"2D-1 did not converge ({r.nonlinear_res})")
    _require(max(r.linear_iters) < maxiter,
             f"2D-1: a linear solve hit the Krylov cap {r.linear_iters}")
    _require(max(r.lin_rel) <= 1e-8,
             f"2D-1: linear true relative residuals {r.lin_rel}")
    _require(d1[0] > 0 and d1[1] > 0 and d1[4] == 0,
             f"2D-1 launches (single, block, f32, f32 block, BSR) {d1}")
    _require(r.w.shape == (cnl.n,) and bool(torch.isfinite(r.w).all()),
             "the 2D-1 state is not a finite vector of n dofs")
    _require(div <= 1e-9, f"2D-1 mass conservation max |D u| = {div}")
    _require(CD_REF[0] <= cd <= CD_REF[1], f"c_D {cd} outside {CD_REF}")
    _require(DP_REF[0] <= dp <= DP_REF[1], f"dP {dp} outside {DP_REF}")
    _require(abs(cl - CL_L2[0]) <= CL_L2[1], f"c_L {cl} not {CL_L2}")
    del cnl, r
    done("cylinder-2d1", t0)

    # ---- 11. DFG 2D-2 at level 2: 40 BDF2 steps on the card ------------- #
    t0 = time.perf_counter()
    bsr_spmv.reset_launches()
    ell_spmv.reset_launches()
    marks = [(time.perf_counter(),) + k3_counts()]
    r = cus.solve_fused(
        CYL_STEPS * CYL_DT, functional=cylinder.functional(cus.asm, CYL_DT),
        keep_history=True,
        callback=lambda k, t, w: marks.append((time.perf_counter(),)
                                              + k3_counts()))
    torch.cuda.synchronize()
    d2 = k3_counts()
    per_step = [(b[0] - a[0], b[1] - a[1], b[2] - a[2])
                for a, b in zip(marks, marks[1:])]
    hist = cylinder.history(r.functionals, CYL_DT)
    h = [torch.as_tensor(x, device=dev) for x in r.history[-3:]]
    n_u = cus.n_u
    du_dt = (1.5 * h[2][:n_u] - 2.0 * h[1][:n_u] + 0.5 * h[0][:n_u]) / CYL_DT
    host_row = cylinder.coefficients(cus.asm, h[2], 100, du_dt=du_dt)
    gap = max(abs(a - b) / max(1.0, abs(b))
              for a, b in zip(hist[-1, 1:], host_row))
    div = max_div(cus.asm, r.w)
    secs = [p[0] for p in per_step]
    print(f"[cylinder-2d2] level {CYL_LEVEL}, {cus.n} dofs, dt {CYL_DT}: "
          f"{len(r.linear_iters)} BDF2 steps, iters per step "
          f"{r.linear_iters} (cap {maxiter}); max linear true rel res "
          f"{max(r.lin_rel)}; {r.wall_time:.3f} s, seconds per step median "
          f"{float(np.median(secs)):.4f} min {min(secs):.4f} max "
          f"{max(secs):.4f} ({r.wall_time / sum(r.linear_iters) * 1e3:.2f} "
          f"ms per FGMRES iteration); K3 f64 launches per step: single "
          f"{[p[1] for p in per_step]}, block {[p[2] for p in per_step]} "
          f"({(d2[0] + d2[1]) / sum(r.linear_iters):.1f} per FGMRES "
          f"iteration); f32 {d2[2] + d2[3]}, BSR {d2[4]}", flush=True)
    print(f"[cylinder-2d2] t {hist[-1, 0]:.5f}: c_D {hist[-1, 1]:.8f} c_L "
          f"{hist[-1, 2]:.8f} dP {hist[-1, 3]:.8f} on the device; recomputed "
          f"on the host {host_row}; largest difference {gap}; max |D u| "
          f"{div}; c_D per step {[round(float(v), 4) for v in hist[:, 1]]}",
          flush=True)
    _require(len(r.linear_iters) == CYL_STEPS
             and max(r.linear_iters) < maxiter,
             f"2D-2: a step's solve hit the Krylov cap {r.linear_iters}")
    _require(max(r.lin_rel) <= 1e-8,
             f"2D-2: linear true relative residuals {r.lin_rel}")
    _require(gap <= 1e-8, f"2D-2: device functional {hist[-1]} against the "
             f"host's {host_row}")
    _require(div <= 1e-9, f"2D-2 mass conservation max |D u| = {div}")
    _require(bool(np.isfinite(hist).all()) and hist[-1, 1] > 0,
             f"2D-2: c_D {hist[-1, 1]}")
    _require(bool(torch.isfinite(r.w).all()), "the 2D-2 state is not finite")
    _require(d2[0] > 0 and d2[1] > 0 and d2[4] == 0,
             f"2D-2 launches (single, block, f32, f32 block, BSR) {d2}")
    del cus, r, h
    done("cylinder-2d2", t0)

    # ---- 12. cylinder reference: card against CPU ----------------------- #
    t0 = time.perf_counter()

    def obstacle(where):
        us = ObstacleChannel2D(level=1, device=str(where)).solver(
            "BRM2", gmg_subsolves=True, unsteady=0.05, scheme="bdf2",
            **cylinder.CFG)
        rr = us.solve_fused(5 * 0.05)
        return rr.w, rr.linear_iters

    def newton_l0(where):
        rr = cylinder.build(0, 20, device=where).solve(rtol=cylinder.RTOL,
                                                       max_steps=2)
        return rr.w, rr.linear_iters

    def bdf2_l0(where):
        us = cylinder.build(0, 100, device=where, unsteady=True)
        rr = us.solve_fused(3 * us.dt)
        return rr.w, rr.linear_iters

    for what, run in (("obstacle channel level 1, 5 BDF2 steps", obstacle),
                      ("cylinder level 0, 2 Newton steps of 2D-1", newton_l0),
                      ("cylinder level 0, 3 BDF2 steps of 2D-2", bdf2_l0)):
        (gw, gi), (cw, ci) = run(dev), run(torch.device("cpu"))
        diff = float(torch.linalg.norm(gw.cpu() - cw) / torch.linalg.norm(cw))
        print(f"[cylinder-reference] {what}: iters cuda {gi} cpu {ci}; "
              f"relative state difference {diff}", flush=True)
        _require(len(gi) == len(ci)
                 and all(abs(a - b) <= 1 for a, b in zip(gi, ci)),
                 f"{what}: counts differ: cuda {gi}, cpu {ci}")
        _require(diff <= 1e-6, f"{what}: states differ by {diff}")
    done("cylinder-reference", t0)

    def rel_diff(a, b):
        return float(torch.linalg.norm(a.cpu() - b.cpu())
                     / torch.linalg.norm(b.cpu()))

    # ---- 13. K3 against the plain version at the config-5 shapes -------- #
    t0 = time.perf_counter()
    hhier = gmg.build_hierarchy(backward_step_mesh(0), HR_LEVEL)
    hnl = highre.build(HR_LEVEL, highre.NU, device=dev, hier=hhier)
    r = hnl.solve_fused(rtol=highre.RTOL, rtol_lin=highre.RTOL_LIN,
                        max_steps=1, damping=highre.DAMPING)
    wind = r.w[:hnl.n_u]
    hlevels = highre.velocity_levels(hnl, wind)
    torch.cuda.synchronize()
    print(f"[highre-kernels] level {HR_LEVEL}, Re {2 / highre.NU:g}: "
          f"{hnl.n} dofs, velocity levels {[p.n_rows for p, _ in hlevels]}; "
          f"wind after one damped Picard step ({r.linear_iters} iterations); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    hrec = {}
    ops = [(f"D{a}", hnl.asm.pat_div, hnl.asm.const.D[a].vals)
           for a in range(2)]
    ops += [(f"Bt{a}", hnl.asm.pat_divT, hnl.asm.const.DT[a].vals)
            for a in range(2)]
    ops.append(("Kp", hnl.asm.pat_p1, hnl.asm.kp_values(wind, surface=True)))
    for name, pat, vals in ops:
        x = torch.as_tensor(rng.standard_normal(pat.n_cols),
                            dtype=torch.float64, device=dev)
        abs_err, rel = rel_err(
            ell_spmv.ell_spmv(pat.cols, vals, x, pat.n_cols),
            ell_spmv.ell_spmv_plain(pat.cols, vals, x, pat.n_cols))
        erec["f64"]["max_abs_err"] = max(erec["f64"]["max_abs_err"], abs_err)
        print(f"[highre-kernels] {name:4s} f64 ELL {tuple(vals.shape)}: max "
              f"rel err {rel} (tol {F64_TOL})", flush=True)
        _require(rel <= F64_TOL, f"config 5 {name}: kernel disagrees with "
                 f"plain ({rel} > {F64_TOL})")
    top = len(hlevels) - 1
    for l, (pat, A1) in enumerate(hlevels):
        x = torch.as_tensor(rng.standard_normal((2, pat.n_cols)),
                            dtype=torch.float64, device=dev)
        y0 = torch.as_tensor(rng.standard_normal((2, pat.n_rows)),
                             dtype=torch.float64, device=dev)
        rels = []
        for yy in (None, y0):
            abs_err, rel = rel_err(
                ell_spmv.ell_block_spmv(pat.cols, A1, None, x, pat.n_cols,
                                        yy),
                ell_spmv.ell_block_spmv_plain(pat.cols, A1, None, x,
                                              pat.n_cols, yy))
            rels.append(rel)
            brec["f64"]["max_abs_err"] = max(brec["f64"]["max_abs_err"],
                                             abs_err)
        line = (f"[highre-kernels] block product velocity level {l} f64 ELL "
                f"{tuple(A1.shape)} (SUPG-stabilized A1, without R): max rel "
                f"err {rels[0]}, with y0 {rels[1]} (tol {F64_TOL})")
        if l == top:
            kernel = lambda: ell_spmv.ell_block_spmv(pat.cols, A1, None, x,
                                                     pat.n_cols)
            plain = lambda: ell_spmv.ell_block_spmv_plain(pat.cols, A1, None,
                                                          x, pat.n_cols)
            libs = [measure.library(measure.csr_library(pat, A1), x[b])
                    for b in (0, 1)]
            calls = [c for c, _ in libs]
            lib = ((lambda: [c() for c in calls]) if all(calls) else None,
                   "; ".join(w for _, w in libs if w))
            nbytes = measure.ell_block_bytes(A1, None, 2, pat.n_cols)
            hrec, why = yardsticks(kernel, plain, lib, nbytes,
                                   measure.ell_block_flops(A1, None, 2),
                                   torch.float64)
            line += (f"; {json.dumps(hrec)}; two cuSPARSE CSR products "
                     f"{why or 'taken'}; {nbytes} B")
        print(line, flush=True)
        _require(max(rels) <= F64_TOL, f"config 5 block product level {l}: "
                 f"kernel disagrees with plain ({rels} > {F64_TOL})")
    del hlevels
    done("highre-kernels", t0)

    # ---- 14. config 5 at level 2: Re 2000 and Re 5000 on the card ------- #
    t0 = time.perf_counter()
    bsr_spmv.reset_launches()
    ell_spmv.reset_launches()
    cap = highre.CFG["krylov.maxiter"]
    for nu, smoother, rtol_lin in HR_RUNS:
        ts = time.perf_counter()
        nl = (hnl if nu == highre.NU and smoother == "jacobi" else
              highre.build(HR_LEVEL, nu, device=dev, smoother=smoother,
                           hier=hhier))
        r = nl.solve_fused(rtol=highre.RTOL, rtol_lin=rtol_lin, max_steps=2,
                           damping=highre.DAMPING)
        F, rn = nl.residual_of(r.w)
        tos = time.perf_counter()
        x, it, rn_lin, lin, _ = nl.oseen.make_ir_solve(rtol_lin)(
            r.w[:nl.n_u], -F)
        torch.cuda.synchronize()
        oseen_s = time.perf_counter() - tos
        iters = r.linear_iters + [it]
        lin_rel = r.lin_rel + [float(rn_lin) / lin.bnorm]
        print(f"[highre] level {HR_LEVEL}, Re {2 / nu:g} ({smoother}, rtol "
              f"{rtol_lin:g}): two damped Picard steps {r.linear_iters} "
              f"({r.wall_time:.3f} s), |F| {r.nonlinear_res} -> "
              f"{float(rn)}; Oseen solve at that wind {it} iterations "
              f"({oseen_s:.3f} s, converged {lin.converged}); true rel res "
              f"{lin_rel}; {(r.wall_time + oseen_s) / sum(iters) * 1e3:.2f} "
              f"ms per FGMRES iteration; phase so far "
              f"{time.perf_counter() - ts:.3f} s", flush=True)
        _require(max(iters) < cap and lin.converged,
                 f"Re {2 / nu:g}: a solve hit the cap of {cap}: {iters}")
        _require(max(lin_rel) <= rtol_lin,
                 f"Re {2 / nu:g}: true relative residuals {lin_rel}")
        _require(float(rn) < r.nonlinear_res[0],
                 f"Re {2 / nu:g}: |F| {float(rn)} after two steps, |F_0| "
                 f"{r.nonlinear_res[0]}")
        _require(bool(torch.isfinite(r.w).all()) and r.w.shape == (nl.n,),
                 f"Re {2 / nu:g}: the state is not a finite vector")
    torch.cuda.synchronize()
    d14 = k3_counts()
    print(f"[highre] K3 f64 launches: single {d14[0]}, block {d14[1]}; f32 "
          f"{d14[2] + d14[3]}, BSR {d14[4]}", flush=True)
    _require(d14[0] > 0 and d14[1] > 0 and d14[4] == 0,
             f"config 5 launches (single, block, f32, f32 block, BSR) {d14}")
    done("highre", t0)

    # ---- 15. GCRO-DR recycling against none ----------------------------- #
    t0 = time.perf_counter()
    runs = {}
    for rc in (0, HR_RECYCLE):
        nl = highre.build(HR_LEVEL, highre.NU, device=dev, recycle=rc,
                          hier=hhier)
        r = nl.solve_fused(rtol=highre.RTOL, rtol_lin=highre.RTOL_LIN,
                           max_steps=4, damping=highre.DAMPING)
        runs[rc] = (r, float(nl.residual_of(r.w)[1]))
        print(f"[highre-recycle] level {HR_LEVEL}, Re 2000, recycle {rc}: "
              f"iters {r.linear_iters} (steps 2-4: {sum(r.linear_iters[1:])})"
              f"; |F| {r.nonlinear_res + [runs[rc][1]]}; max true rel res "
              f"{max(r.lin_rel)}; {r.wall_time:.3f} s", flush=True)
    (a, fa), (b, fb) = runs[0], runs[HR_RECYCLE]
    gap = max(abs(x - y) / y for x, y in zip(b.nonlinear_res + [fb],
                                             a.nonlinear_res + [fa]))
    _require(gap <= 1e-6, f"recycled |F| history differs by {gap}")
    _require(sum(b.linear_iters[1:]) < sum(a.linear_iters[1:]),
             f"recycling did not cut steps 2-4: {a.linear_iters} -> "
             f"{b.linear_iters}")
    _require(max(b.lin_rel) <= highre.RTOL_LIN,
             f"recycled true relative residuals {b.lin_rel}")
    cruns = {}
    for rc in (0, CYL_RECYCLE):
        us = cylinder.build(1, 100, device=dev, unsteady=True, recycle=rc)
        cruns[rc] = us.solve_fused(10 * us.dt)
        print(f"[highre-recycle] cylinder level 1, 10 BDF2 steps, recycle "
              f"{rc}: iters {cruns[rc].linear_iters} (steps 2-10: "
              f"{sum(cruns[rc].linear_iters[1:])}); "
              f"{cruns[rc].wall_time:.3f} s", flush=True)
    a, b = cruns[0], cruns[CYL_RECYCLE]
    diff = rel_diff(b.w, a.w)
    print(f"[highre-recycle] cylinder relative state difference {diff}",
          flush=True)
    _require(diff <= 1e-6, f"recycled cylinder states differ by {diff}")
    _require(sum(b.linear_iters[1:]) < sum(a.linear_iters[1:]),
             f"recycling did not cut BDF2 steps 2-10: {a.linear_iters} -> "
             f"{b.linear_iters}")
    _require(max(b.lin_rel) <= 1e-8,
             f"recycled BDF2 true relative residuals {b.lin_rel}")
    del hnl, runs, cruns
    done("highre-recycle", t0)

    # ---- 16. config 5 reference: level 1 on the card vs the CPU --------- #
    t0 = time.perf_counter()
    for rc in (0, HR_RECYCLE):
        res = {}
        for where in (dev, torch.device("cpu")):
            r = highre.build(1, highre.NU, device=where, recycle=rc
                             ).solve_fused(rtol=highre.RTOL,
                                           rtol_lin=highre.RTOL_LIN,
                                           max_steps=3,
                                           damping=highre.DAMPING)
            res[where.type] = r
        g, c = res["cuda"], res["cpu"]
        diff = rel_diff(g.w, c.w)
        print(f"[highre-reference] level 1, Re 2000, 3 damped Picard steps, "
              f"recycle {rc}: iters cuda {g.linear_iters} cpu "
              f"{c.linear_iters}; relative state difference {diff}",
              flush=True)
        _require(len(g.linear_iters) == len(c.linear_iters)
                 and all(abs(x - y) <= 1 for x, y in zip(g.linear_iters,
                                                         c.linear_iters)),
                 f"config 5 level 1 recycle {rc}: counts differ: cuda "
                 f"{g.linear_iters}, cpu {c.linear_iters}")
        _require(diff <= 1e-6, f"config 5 level 1 recycle {rc}: states "
                 f"differ by {diff}")
    done("highre-reference", t0)

    # ---- 17. K3 at d = 3 against the plain version at config 4 -------- #
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    s3 = step3d.build(S3_LEVEL, length=S3_LENGTH, device=dev)
    setup_s = time.perf_counter() - t0
    r = s3.solve_fused(rtol=step3d.RTOL, rtol_lin=step3d.RTOL_LIN,
                       max_steps=1)
    wind3 = r.w[:s3.n_u]
    s3levels = step3d.velocity_levels(s3, wind3, newton=True)
    torch.cuda.synchronize()
    print(f"[step3d-kernels] level {S3_LEVEL}, length {S3_LENGTH:g}: "
          f"{s3.n} dofs ({s3.asm.mesh.num_cells} cells), velocity levels "
          f"{[p.n_rows for p, _, _ in s3levels]} rows of width "
          f"{[p.K for p, _, _ in s3levels]}; setup {setup_s:.3f} s "
          f"({json.dumps(s3.setup_seconds)}); wind after one Picard step "
          f"({r.linear_iters} iterations)", flush=True)
    s3rec = {"single": {}, "block": {}, "block_with_R": {}}
    a3, o3 = s3.asm, s3.oseen
    ops = [(f"D{a}", a3.pat_div, a3.const.D[a].vals) for a in range(3)]
    ops += [(f"Bt{a}", a3.pat_divT, a3.const.DT[a].vals) for a in range(3)]
    ops += [("Mp", a3.pat_p1, a3.const.Mp.vals),
            ("Kp", a3.pat_p1, a3.kp_values(wind3, surface=True))]
    ops += [(f"Ap pressure level {l}", lev.asm.pat_p1, lev.Ap.vals)
            for l, lev in enumerate(o3.ap_hierarchy.levels)]
    for name, pat, vals in ops:
        x = torch.as_tensor(rng.standard_normal(pat.n_cols),
                            dtype=torch.float64, device=dev)
        abs_err, rel = rel_err(
            ell_spmv.ell_spmv(pat.cols, vals, x, pat.n_cols),
            ell_spmv.ell_spmv_plain(pat.cols, vals, x, pat.n_cols))
        erec["f64"]["max_abs_err"] = max(erec["f64"]["max_abs_err"], abs_err)
        line = (f"[step3d-kernels] {name:20s} f64 ELL {tuple(vals.shape)}: "
                f"max rel err {rel} (tol {F64_TOL})")
        if name == "D0":
            kernel = lambda: ell_spmv.ell_spmv(pat.cols, vals, x, pat.n_cols)
            plain = lambda: ell_spmv.ell_spmv_plain(pat.cols, vals, x,
                                                    pat.n_cols)
            lib = measure.library(measure.csr_library(pat, vals), x)
            nbytes = measure.ell_bytes(vals, pat.n_cols)
            s3rec["single"], why = yardsticks(kernel, plain, lib, nbytes,
                                              2 * pat.nnz, torch.float64)
            line += (f"; {json.dumps(s3rec['single'])}; cuSPARSE CSR "
                     f"{why or 'taken'}; {nbytes} B")
        print(line, flush=True)
        _require(rel <= F64_TOL, f"config 4 {name}: kernel disagrees with "
                 f"plain ({rel} > {F64_TOL})")
    top = len(s3levels) - 1
    for l, (pat, A1, R) in enumerate(s3levels):
        x = torch.as_tensor(rng.standard_normal((3, pat.n_cols)),
                            dtype=torch.float64, device=dev)
        y0 = torch.as_tensor(rng.standard_normal((3, pat.n_rows)),
                             dtype=torch.float64, device=dev)
        rels = []
        for RR, yy in ((None, None), (None, y0), (R, None), (R, y0)):
            abs_err, rel = rel_err(
                ell_spmv.ell_block_spmv(pat.cols, A1, RR, x, pat.n_cols, yy),
                ell_spmv.ell_block_spmv_plain(pat.cols, A1, RR, x,
                                              pat.n_cols, yy))
            rels.append(rel)
            brec["f64"]["max_abs_err"] = max(brec["f64"]["max_abs_err"],
                                             abs_err)
        print(f"[step3d-kernels] block product d = 3 velocity level {l} f64 "
              f"ELL {tuple(A1.shape)}: max rel err without R {rels[0]}, "
              f"with y0 {rels[1]}, with R {rels[2]}, with R and y0 "
              f"{rels[3]} (tol {F64_TOL})", flush=True)
        _require(max(rels) <= F64_TOL, f"config 4 block product level {l}: "
                 f"kernel disagrees with plain ({rels} > {F64_TOL})")
        if l != top:
            continue
        for key, RR in (("block", None), ("block_with_R", R)):
            kernel = lambda: ell_spmv.ell_block_spmv(pat.cols, A1, RR, x,
                                                     pat.n_cols)
            plain = lambda: ell_spmv.ell_block_spmv_plain(pat.cols, A1, RR,
                                                          x, pat.n_cols)
            parts = [(A1, b) for b in range(3)]
            if RR is not None:
                parts += [(RR[a, b], b) for a in range(3) for b in range(3)]
            libs = [measure.library(measure.csr_library(pat, v), x[b])
                    for v, b in parts]
            calls = [c for c, _ in libs]
            lib = ((lambda: [c() for c in calls]) if all(calls) else None,
                   "; ".join(w for _, w in libs if w))
            nbytes = measure.ell_block_bytes(A1, RR, 3, pat.n_cols)
            t, why = yardsticks(kernel, plain, lib, nbytes,
                                measure.ell_block_flops(A1, RR, 3),
                                torch.float64)
            nnz_bytes = measure.ell_block_nnz_bytes(pat, A1, RR, 3)
            t["bound_nnz_ms"] = measure.bound(nnz_bytes, 0,
                                              torch.float64)[0]
            s3rec[key] = t
            print(f"[step3d-kernels] {S3_HEADLINE} block product d = 3 "
                  f"{'with' if RR is not None else 'without'} R: "
                  f"{json.dumps(t)}; {len(parts)} cuSPARSE CSR products "
                  f"{why or 'taken'}; {nbytes} B padded ELL, {nnz_bytes} B "
                  f"entries alone (nnz {pat.nnz}, {pat.n_rows} x {pat.K})",
                  flush=True)
    del s3levels
    done("step3d-kernels", t0)

    # ---- 18. config 4 at level 3 (760,852 dofs) on the card ------------- #
    t0 = time.perf_counter()
    bsr_spmv.reset_launches()
    ell_spmv.reset_launches()
    step_s = []
    last = [time.perf_counter()]

    def lap(*_):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now
    r3 = s3.solve_fused(rtol=step3d.RTOL, rtol_lin=step3d.RTOL_LIN,
                        max_steps=S3_STEPS, callback=lap)
    torch.cuda.synchronize()
    d18 = k3_counts()
    peak = torch.cuda.max_memory_allocated()
    div3 = step3d.divergence(s3, r3.w)
    umax3 = float(r3.w[:s3.n_u].abs().max())
    cap3 = s3.oseen.config.krylov.maxiter
    print(f"[step3d] level {S3_LEVEL}, length {S3_LENGTH:g}, {s3.n} dofs: "
          f"Picard steps {r3.linear_iters} (cap {cap3}); true rel res "
          f"{r3.lin_rel}; |F| {r3.nonlinear_res}; seconds per step "
          f"{step_s}; {r3.wall_time:.3f} s, "
          f"{r3.wall_time / sum(r3.linear_iters) * 1e3:.2f} ms per FGMRES "
          f"iteration; K3 f64 launches single {d18[0]}, block {d18[1]} "
          f"({(d18[0] + d18[1]) / sum(r3.linear_iters):.1f} per FGMRES "
          f"iteration), f32 {d18[2] + d18[3]}, BSR {d18[4]}; peak device "
          f"memory {peak} B; max |D u| {div3}; max |u| {umax3}",
          flush=True)
    _require(max(r3.linear_iters) < cap3 and max(r3.lin_rel) <= 1e-8,
             f"config 4: counts {r3.linear_iters}, true relative residuals "
             f"{r3.lin_rel}")
    _require(r3.nonlinear_res[-1] < r3.nonlinear_res[0],
             f"config 4: |F| {r3.nonlinear_res}")
    _require(d18[0] > 0 and d18[1] > 0 and d18[4] == 0,
             f"config 4 launches (single, block, f32, f32 block, BSR) {d18}")
    _require(r3.w.shape == (s3.n,) and bool(torch.isfinite(r3.w).all()),
             "config 4: the state is not a finite vector of n dofs")
    _require(div3 <= 1e-9 and umax3 <= 1.05,
             f"config 4: max |D u| {div3}, max |u| {umax3}")
    done("step3d", t0)

    # ---- 19. config 4 reference: level 1 on the card vs the CPU --------- #
    t0 = time.perf_counter()
    res = {}
    for where in (dev, torch.device("cpu")):
        res[where.type] = step3d.build(1, device=where).solve_fused(
            rtol=step3d.RTOL, rtol_lin=step3d.RTOL_LIN, max_steps=2)
    g, c = res["cuda"], res["cpu"]
    diff = rel_diff(g.w, c.w)
    print(f"[step3d-reference] level 1, two Picard steps: iters cuda "
          f"{g.linear_iters} cpu {c.linear_iters}; relative state difference "
          f"{diff}", flush=True)
    _require(g.linear_iters == c.linear_iters, f"config 4 level 1: counts "
             f"differ: cuda {g.linear_iters}, cpu {c.linear_iters}")
    _require(diff <= 1e-7, f"config 4 level 1: states differ by {diff}")
    done("step3d-reference", t0)

    # ---- 20. repeats are bit for bit equal on the card ------------------ #
    t0 = time.perf_counter()
    wind3 = r3.w[:s3.n_u]
    a3 = s3.asm
    same = {}
    for name, fn in (
            ("3D A1", lambda: a3.picard_matrix_values(wind3)),
            ("3D Kp", lambda: a3.kp_values(wind3, surface=True)),
            ("3D Newton R", lambda: a3.newton_reaction_values(wind3))):
        same[name] = bool(torch.equal(fn(), fn()))
    A1v, Rv = o3._operator_values(wind3)
    vcycle = o3._velocity_solver(A1v, wind3, Rv)
    v = torch.as_tensor(rng.standard_normal(s3.n_u), dtype=o3.dtype,
                        device=dev)
    same["3D V-cycle apply"] = bool(torch.equal(vcycle(v), vcycle(v)))
    del s3, r3, wind3, vcycle, A1v, Rv
    runs = [highre.build(1, highre.NU, device=dev, recycle=HR_RECYCLE
                         ).solve_fused(rtol=highre.RTOL,
                                       rtol_lin=highre.RTOL_LIN, max_steps=3,
                                       damping=highre.DAMPING)
            for _ in range(2)]
    same["config 5 l1, 3 recycled Picard steps: states"] = bool(
        torch.equal(runs[0].w, runs[1].w))
    print(f"[determinism] {json.dumps(same)}; config 5 counts "
          f"{[r.linear_iters for r in runs]}", flush=True)
    _require(all(same.values()), f"a repeat differs on the card: {same}")
    _require(runs[0].linear_iters == runs[1].linear_iters,
             f"config 5 recycled counts differ: {runs[0].linear_iters}, "
             f"{runs[1].linear_iters}")
    done("determinism", t0)

    # ---- 21. the custom-form API at step level 2 on the card ---------- #
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cs = custom_forms.build(CF_LEVEL, variant="BRM2", device=dev)
    torch.cuda.synchronize()
    cf_setup = time.perf_counter() - t0
    print(f"[custom-forms] step level {CF_LEVEL}, {cs.n} dofs, BRM2 with "
          f"dense velocity and Ap inverses, Chebyshev-4 Mp: setup "
          f"{cf_setup:.3f} s; step,|F|,iters,lin_rel,seconds,"
          f"inverse_seconds:", flush=True)
    bsr_spmv.reset_launches()        # ``run`` sets the K3 counts to 0
    cf = custom_forms.run(cs, rtol=custom_forms.RTOL,
                          out=lambda l: print(f"[custom-forms] {l}",
                                              flush=True))
    d21 = k3_counts()
    xcf = cf["x"]
    cf_total = sum(cf["iters"])
    print(f"[custom-forms] Picard steps {len(cf['iters'])} iters "
          f"{cf['iters']} total {cf_total} (oracle {CF_ORACLE}, cap "
          f"{CF_CAP}); converged {cf['converged']}; true rel res "
          f"{cf['lin_rel']}; |F| {cf['nonlinear_res']}; seconds per step "
          f"{cf['seconds']}; dense velocity inverse ({cs.n_u}^2 f64) "
          f"seconds {cf['inverse_seconds']}; peak device memory "
          f"{cf['peak_bytes']} B ({cf['start_bytes']} B allocated at the "
          f"start); {cf['wall']:.3f} s; K3 f64 launches "
          f"single {d21[0]}, block {d21[1]}, f32 {d21[2] + d21[3]}, BSR "
          f"{d21[4]}", flush=True)
    _require(cf["converged"] and len(cf["iters"]) in (9, 10),
             f"custom forms level {CF_LEVEL}: converged {cf['converged']} "
             f"in {len(cf['iters'])} steps")
    _require(max(cf["lin_rel"]) <= 1e-8, f"custom forms: true relative "
             f"residuals {cf['lin_rel']}")
    _require(cf_total <= CF_CAP, f"custom forms: {cf_total} iterations > "
             f"{CF_CAP}")
    _require(d21[0] > 0 and d21[1] + d21[2] + d21[3] + d21[4] == 0,
             f"custom forms launches (single, block, f32, f32 block, BSR) "
             f"{d21}")
    _require(xcf.shape == (cs.n,) and bool(torch.isfinite(xcf).all()),
             "custom forms: the state is not a finite vector of n dofs")
    done("custom-forms", t0)

    # ---- 22. K3 on the custom path's blocks against the plain version -- #
    t0 = time.perf_counter()
    casm = cs.asm
    coeffs = casm._coeffs(xcf)
    cfrec = {}
    for name, test, trial, vals in (
            ("uu", "u", "u", casm.fc.assemble_block(casm._a, "u", "u",
                                                    coeffs=coeffs)),
            ("up", "u", "p", casm.fc.assemble_block(casm._a, "u", "p",
                                                    coeffs=coeffs)),
            ("pu", "p", "u", casm.fc.assemble_block(casm._a, "p", "u",
                                                    coeffs=coeffs)),
            ("kp", "p", "p", casm.kp(xcf))):
        pat = casm.fc.pattern(test, trial)
        x = torch.as_tensor(rng.standard_normal(pat.n_cols),
                            dtype=torch.float64, device=dev)
        abs_err, rel = rel_err(
            ell_spmv.ell_spmv(pat.cols, vals, x, pat.n_cols),
            ell_spmv.ell_spmv_plain(pat.cols, vals, x, pat.n_cols))
        erec["f64"]["max_abs_err"] = max(erec["f64"]["max_abs_err"], abs_err)
        line = (f"[custom-kernels] {name} f64 ELL {tuple(vals.shape)} "
                f"(nnz {pat.nnz}): max rel err {rel} (tol {CF_K3_TOL})")
        if name == "uu":
            kernel = lambda: ell_spmv.ell_spmv(pat.cols, vals, x, pat.n_cols)
            plain = lambda: ell_spmv.ell_spmv_plain(pat.cols, vals, x,
                                                    pat.n_cols)
            lib = measure.library(measure.csr_library(pat, vals), x)
            nbytes = measure.ell_bytes(vals, pat.n_cols)
            cfrec, why = yardsticks(kernel, plain, lib, nbytes, 2 * pat.nnz,
                                    torch.float64)
            line += (f"; {json.dumps(cfrec)}; cuSPARSE CSR {why or 'taken'}"
                     f"; {nbytes} B")
        print(line, flush=True)
        _require(rel <= CF_K3_TOL, f"custom {name}: kernel disagrees with "
                 f"plain ({rel} > {CF_K3_TOL})")
    done("custom-kernels", t0)

    # ---- 23. repeated custom-form assemblies are bit for bit equal ----- #
    t0 = time.perf_counter()
    same = {}
    for name, fn in (("J", lambda: casm.system_matrix(xcf)),
                     ("kp", lambda: {"kp": casm.kp(xcf)}),
                     ("residual", lambda: {"F": casm.rhs_vector(xcf)})):
        a, b = fn(), fn()
        same[name] = all(torch.equal(a[k], b[k]) for k in a)
    print(f"[custom-determinism] level {CF_LEVEL}, two assemblies at the "
          f"converged state: {json.dumps(same)}", flush=True)
    _require(all(same.values()), f"a custom assembly differs: {same}")
    del cs, casm, coeffs, xcf
    done("custom-determinism", t0)

    # ---- 24. custom forms at level 1: the card against the CPU --------- #
    t0 = time.perf_counter()
    for label, kw in (("BRM1 fp form", dict(use_fp=True)),
                      ("BRM1 gp form", dict(gp_scale=1.0))):
        res = {}
        for where in (dev, torch.device("cpu")):
            res[where.type] = custom_forms.run(
                custom_forms.build(1, variant="BRM1", device=where, **kw),
                max_steps=CF_REF_STEPS)
        g, c = res["cuda"], res["cpu"]
        diff = rel_diff(g["x"], c["x"])
        print(f"[custom-reference] level 1, {label}, {CF_REF_STEPS} Picard "
              f"steps: iters cuda {g['iters']} cpu {c['iters']}; true rel "
              f"res cuda {g['lin_rel']}; relative state difference {diff}",
              flush=True)
        _require(g["iters"] == c["iters"], f"custom level 1 {label}: counts "
                 f"differ: cuda {g['iters']}, cpu {c['iters']}")
        _require(diff <= 1e-8, f"custom level 1 {label}: states differ by "
                 f"{diff}")
    done("custom-reference", t0)

    # ---- 25. 3D custom forms against the factored 3D assembler --------- #
    t0 = time.perf_counter()
    a3 = StepFlow3D(level=1, device=str(dev)).assembler()
    fc3 = forms.FormCompiler(a3.W, quad_degree=4, device=dev)
    w3 = torch.as_tensor(rng.standard_normal(a3.W.dim), dtype=torch.float64,
                         device=dev)
    (u, p), (v, q) = forms.TrialFunctions(a3.W), forms.TestFunctions(a3.W)
    wc = forms.Coefficient(a3.W, "w")
    u_, _ = forms.split(wc)
    nrm = forms.FacetNormal(a3.mesh)
    nu3 = a3.nu
    checks = (
        ("Mp", (1.0 / nu3) * p * q * forms.dx, a3.const.Mp.vals),
        ("Ap", forms.inner(forms.grad(p), forms.grad(q)) * forms.dx,
         a3.const.Ap.vals),
        ("Kp with the face term",
         (1.0 / nu3) * forms.dot(forms.grad(p), u_) * q * forms.dx
         - (1.0 / nu3) * forms.dot(u_, nrm) * p * q * forms.ds(INFLOW),
         a3.kp_values(w3[:a3.W.dim_u], surface=True)))
    rels = {}
    for name, form, ref in checks:
        got = fc3.assemble_block(form, "p", "p", coeffs={"w": w3})
        rels[name] = rel_err(fc3.pattern("p", "p").to_dense(got),
                             a3.pat_p1.to_dense(ref))[1]
    J3 = (nu3 * forms.inner(forms.grad(u), forms.grad(v)) * forms.dx
          + forms.inner(forms.dot(forms.grad(u), u_), v) * forms.dx)
    uu = fc3.pattern("u", "u").to_dense(
        fc3.assemble_block(J3, "u", "u", coeffs={"w": w3}))
    A1 = a3.pat_p2.to_dense(a3.picard_matrix_values(w3[:a3.W.dim_u]))
    n2 = a3.n2
    ref = torch.zeros_like(uu)
    for c in range(3):
        ref[c * n2:(c + 1) * n2, c * n2:(c + 1) * n2] = A1
    rels["uu"] = rel_err(uu, ref)[1]
    print(f"[custom-3d] 3D step level 1 ({a3.W.dim} dofs, "
          f"{a3.mesh.num_cells} tets, {a3.n_inflow_facets} inflow faces): "
          f"max rel err against the factored assembler {json.dumps(rels)} "
          f"(tol {F64_TOL})", flush=True)
    _require(max(rels.values()) <= F64_TOL, f"3D custom forms differ from "
             f"the factored assembler: {rels}")
    del uu, A1, ref
    done("custom-3d", t0)

    # ``launches``: counts of the paths' own runs, each read just after a
    # run that began with the counts at 0 (``paths`` splits them).  The ELL
    # paths are f64 throughout: each ELL record is its f64 instantiation with
    # the times of the cavity's headline operator, and the f32 one, checked
    # in phases 6 and 9 but launched by no path, is nested in it; the times
    # at the cylinder's level-2 shapes are nested under ``cylinder``
    cyl_paths = (f"cylinder l{CYL_LEVEL} 2D-1",
                 f"cylinder l{CYL_LEVEL} 2D-2 {CYL_STEPS} steps")
    hr_path = f"step l{HR_LEVEL} config 5, Re 2000 and 5000"
    s3_path = (f"3D step l{S3_LEVEL} length {S3_LENGTH:g} config 4, "
               f"{S3_STEPS} Picard steps")
    cf_path = f"custom forms step l{CF_LEVEL} BRM2"
    kernels_line = [{"name": f"bsr_spmv_{k}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[k],
                     "launches": timed[k], "path": "step l2 timed solve",
                     **rec[k]} for k in ("f64", "f32")]
    kernels_line.append({
        "name": "ell_spmv", "route": "cuda", "source": ELL_SOURCE,
        "replaces": ELL_REPLACES,
        "launches": cavity_launches["ell_f64"] + d1[0] + d2[0] + d14[0]
        + d18[0] + d21[0],
        "paths": {f"cavity l{cavity.LEVEL} continuation":
                  cavity_launches["ell_f64"],
                  cyl_paths[0]: d1[0], cyl_paths[1]: d2[0],
                  hr_path: d14[0], s3_path: d18[0], cf_path: d21[0]},
        "dtype": "f64", **erec["f64"],
        "cylinder": crec["f64"]["single"], "step3d": s3rec["single"],
        "custom_uu": cfrec,
        "f32": {"launches": cavity_launches["ell_f32"] + d1[2] + d2[2]
                + d14[2] + d18[2] + d21[2],
                **erec["f32"], "cylinder": crec["f32"]["single"]}})
    kernels_line.append({
        "name": "ell_block_spmv", "route": "cuda", "source": ELL_SOURCE,
        "replaces": ELL_REPLACES,
        "launches": cavity_launches["ell_block_f64"] + d1[1] + d2[1]
        + d14[1] + d18[1],
        "paths": {f"cavity l{cavity.LEVEL} continuation":
                  cavity_launches["ell_block_f64"],
                  cyl_paths[0]: d1[1], cyl_paths[1]: d2[1], hr_path: d14[1],
                  s3_path: d18[1]},
        "dtype": "f64", **brec["f64"],
        "cylinder": {k: v for k, v in crec["f64"].items() if k != "single"},
        "highre": hrec,
        "step3d": {k: s3rec[k] for k in ("block", "block_with_R")},
        "f32": {"launches": cavity_launches["ell_block_f32"] + d1[3] + d2[3]
                + d14[3] + d18[3],
                **brec["f32"],
                "cylinder": {k: v for k, v in crec["f32"].items()
                             if k != "single"}}})
    print(f"[time] total {time.perf_counter() - t_start:.3f} s; phases "
          f"{json.dumps(phase_s)}", flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
