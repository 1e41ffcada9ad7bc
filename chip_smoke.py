#!/usr/bin/env python3
"""Smoke run of fenapack_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Drives the port's two paths on the card, in phases that each print one or
more lines:

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

    from fenapack_tpu_torch import bench, cavity, cavity_mesh, measure
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

    # ``launches``: counts of the path's own run ("path").  The cavity path
    # is f64 throughout: each ELL record is its f64 instantiation, and the
    # f32 one, checked in phase 6 but launched by no path, is nested in it
    kernels_line = [{"name": f"bsr_spmv_{k}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[k],
                     "launches": timed[k], "path": "step l2 timed solve",
                     **rec[k]} for k in ("f64", "f32")]
    kernels_line.append({
        "name": "ell_spmv", "route": "cuda", "source": ELL_SOURCE,
        "replaces": ELL_REPLACES, "launches": cavity_launches["ell_f64"],
        "path": f"cavity l{cavity.LEVEL} continuation", "dtype": "f64",
        **erec["f64"], "f32": {"launches": cavity_launches["ell_f32"],
                               **erec["f32"]}})
    kernels_line.append({
        "name": "ell_block_spmv", "route": "cuda", "source": ELL_SOURCE,
        "replaces": ELL_REPLACES,
        "launches": cavity_launches["ell_block_f64"],
        "path": f"cavity l{cavity.LEVEL} continuation", "dtype": "f64",
        **brec["f64"], "f32": {"launches": cavity_launches["ell_block_f32"],
                               **brec["f32"]}})
    print(f"[time] total {time.perf_counter() - t_start:.3f} s; phases "
          f"{json.dumps(phase_s)}", flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
