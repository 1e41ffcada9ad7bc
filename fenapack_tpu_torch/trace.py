"""Where the time of a path goes on one CUDA GPU, and how far each SpMV
kernel stays above its bound.

    python -m fenapack_tpu_torch.trace [--problem cavity] [--steps 2]
    python -m fenapack_tpu_torch.trace --problem step [--level 2]
    python -m fenapack_tpu_torch.trace --problem cylinder [--steps 2]
    python -m fenapack_tpu_torch.trace --problem highre [--steps 2]
    python -m fenapack_tpu_torch.trace --problem step3d [--level 3]

``cavity``: the slice's Re-100 solver (``fenapack_tpu_torch.cavity``), its
first ``--steps`` Newton steps.  ``step``: the step benchmark's full solve
(``fenapack_tpu_torch.bench``).  ``cylinder``: DFG 2D-2 at level 2
(``fenapack_tpu_torch.cylinder``), its first ``--steps`` semi-implicit BDF2
steps from the impulsive start; ``cylinder-2d1``: the first ``--steps``
Newton steps of DFG 2D-1.  ``highre``: BASELINE config 5 at Re 2000
(``fenapack_tpu_torch.highre``, level 2), its first ``--steps`` damped
Picard steps on the stabilized system.  ``step3d``: BASELINE config 4
(``fenapack_tpu_torch.step3d``, level 3, length 3: 760,852 dofs), its
first ``--steps`` Picard steps.  The solve runs once as a warm-up, once
unprofiled (wall time, peak device memory) and once under
``torch.profiler``, and one JSON line is printed: the FGMRES iterations,
the wall time with and without the profiler, the device busy time (the sum
of the device events, one stream), the busy and idle shares, the device
events per FGMRES iteration, the device time of the heaviest kernels by
name, and per SpMV kernel (``ell_f64``, ``ell_block_f64``, ``bsr_f32``,
...) the launches in the profiled solve, their device time, their bound
(the bytes each launch must move over the HBM rate, or its operations over
the peak rate if that is longer, summed over the launches) and the device
time above that bound, also split by the operator's row count
(``by_rows``: the i-th launch the operators made is paired with the i-th
device event of that kernel; one stream keeps the order).  It needs a CUDA
device: every time is a device measurement.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import time

import torch

from . import bench, cavity, cylinder, highre, measure, step3d
from .ops import sparse

# the kernels' device events, e.g.
# "void (anonymous namespace)::ell_spmv_kernel<double, 1>(int const*, ...)"
_SPMV_EVENT = re.compile(
    r"\b(ell_block|ell|bsr)_spmv_kernel<(double|float)\b")


class _Tally(collections.defaultdict):
    """``{kernel: [launches, bound_s]}``; ``each[kernel]`` lists every
    launch in order as ``(n_rows, bound_s)``."""

    def __init__(self):
        super().__init__(lambda: [0, 0.0])
        self.each = collections.defaultdict(list)

    def add(self, kind, a, n_rows, nbytes, flops):
        name = f"{kind}_{'f64' if a.dtype == torch.float64 else 'f32'}"
        bound_s = measure.bound(nbytes, flops, a.dtype)[0] * 1e-3
        self[name][0] += 1
        self[name][1] += bound_s
        self.each[name].append((n_rows, bound_s))


@contextlib.contextmanager
def _bounds():
    """Yield the :class:`_Tally` of every product that ``ops.sparse``
    makes inside the block."""
    tally = _Tally()
    ell, blk, bsr = (sparse.ell_spmv, sparse.ell_block_spmv,
                     sparse.bsr_spmv)

    def ell_tallied(cols, vals, x, n_cols):
        k = 1 if x.dim() == 1 else x.shape[1]
        tally.add("ell", vals, vals.shape[0],
                  measure.ell_bytes(vals, n_cols, k), 2 * vals.numel() * k)
        return ell(cols, vals, x, n_cols)

    def blk_tallied(cols, A1, R, x, n_cols, y0=None):
        d = x.shape[0]
        tally.add("ell_block", A1, A1.shape[0],
                  measure.ell_block_bytes(A1, R, d, n_cols, y0 is not None),
                  measure.ell_block_flops(A1, R, d))
        return blk(cols, A1, R, x, n_cols, y0)

    def bsr_tallied(nbr, tiles, x, n_rows, n_cols):
        k = 1 if x.dim() == 1 else x.shape[1]
        tally.add("bsr", tiles, n_rows,
                  measure.bsr_bytes(nbr, tiles, n_rows, n_cols, k),
                  2 * tiles.numel() * k)
        return bsr(nbr, tiles, x, n_rows, n_cols)

    sparse.ell_spmv, sparse.ell_block_spmv, sparse.bsr_spmv = (
        ell_tallied, blk_tallied, bsr_tallied)
    try:
        yield tally
    finally:
        sparse.ell_spmv, sparse.ell_block_spmv, sparse.bsr_spmv = (
            ell, blk, bsr)


def _by_rows(launched, event_us):
    """``{n_rows: {launches, device_s, bound_s}}`` from the launches of one
    kernel, ``(n_rows, bound_s)`` in order, and the microseconds of its
    device events in order; None when the two lists differ in length (the
    profiler dropped or added events) and no pairing can be trusted."""
    if len(launched) != len(event_us):
        return None
    split = collections.defaultdict(lambda: [0, 0.0, 0.0])
    for (n_rows, bound_s), us in zip(launched, event_us):
        s = split[n_rows]
        s[0] += 1
        s[1] += us * 1e-6
        s[2] += bound_s
    return {str(n): {"launches": s[0], "device_s": s[1], "bound_s": s[2]}
            for n, s in sorted(split.items())}


def _kernel_of(event_name: str):
    """``ell_f64`` etc. for an SpMV kernel's device event, else None."""
    m = _SPMV_EVENT.search(event_name)
    if m is None:
        return None
    return f"{m.group(1)}_{'f64' if m.group(2) == 'double' else 'f32'}"


def _solver(problem: str, level: int, steps: int, dev):
    """``(solve, iters_of, dofs)`` for one traced solve of ``problem``."""
    if problem == "cavity":
        nl = cavity.build(level, cavity.RE[0], device=dev)
        return (lambda: nl.solve(rtol=cavity.RTOL, max_steps=steps),
                lambda r: r.linear_iters, nl.n)
    if problem == "cylinder":
        us = cylinder.build(level, 100, device=dev, unsteady=True)
        return (lambda: us.solve_fused(steps * us.dt),
                lambda r: r.linear_iters, us.n)
    if problem == "highre":
        nl = highre.build(level, device=dev)
        return (lambda: nl.solve_fused(rtol=highre.RTOL,
                                       rtol_lin=highre.RTOL_LIN,
                                       max_steps=steps,
                                       damping=highre.DAMPING),
                lambda r: r.linear_iters, nl.n)
    if problem == "step3d":
        nl = step3d.build(level, device=dev)
        return (lambda: nl.solve_fused(rtol=step3d.RTOL,
                                       rtol_lin=step3d.RTOL_LIN,
                                       max_steps=steps),
                lambda r: r.linear_iters, nl.n)
    if problem == "cylinder-2d1":
        nl = cylinder.build(level, 20, device=dev)
        return (lambda: nl.solve(rtol=cylinder.RTOL, max_steps=steps),
                lambda r: r.linear_iters, nl.n)
    nl = bench.build(level, device=dev)
    full = nl.make_full_solve(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN,
                              max_steps=bench.MAX_STEPS,
                              anderson=bench.ANDERSON)
    w0 = nl.initial_state().to(torch.float64)
    return lambda: full(w0), lambda r: r.iters, nl.n


def run(problem: str = "cavity", level: int = None, steps: int = 2) -> dict:
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise RuntimeError("the trace measures a CUDA device")
    if level is None:
        level = {"cavity": cavity.LEVEL, "step3d": 3}.get(problem, 2)
    dev = torch.device("cuda")
    solve, iters_of, dofs = _solver(problem, level, steps, dev)
    solve()                                             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with _bounds() as bounds, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rp = solve()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    events = sorted(measure.device_events(prof),
                    key=lambda e: e.time_range.start)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    spmv = collections.defaultdict(lambda: [0, 0.0])
    spmv_us = collections.defaultdict(list)
    for e in events:
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += 1
        by_name[e.name][1] += us
        kind = _kernel_of(e.name)
        if kind:
            spmv[kind][0] += 1
            spmv[kind][1] += us
            spmv_us[kind].append(us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    iters = iters_of(rp)
    kernels = {}
    for kind in sorted(set(spmv) | set(bounds)):
        n, bound_s = bounds[kind]
        dev_s = spmv[kind][1] * 1e-6
        kernels[kind] = {"launches": n, "device_events": spmv[kind][0],
                         "device_s": dev_s, "bound_s": bound_s,
                         "above_bound_s": dev_s - bound_s,
                         "by_rows": _by_rows(bounds.each[kind],
                                             spmv_us[kind])}
    return {
        "problem": problem, "level": level, "dofs": int(dofs),
        "fgmres_iters": iters, "same_iters": iters_of(r) == iters,
        "wall_s": wall, "wall_profiled_s": wall_prof,
        "ms_per_fgmres_iter": wall / max(sum(iters_of(r)), 1) * 1e3,
        "device_busy_s": busy_us * 1e-6,
        "busy_share_profiled": busy_us * 1e-6 / wall_prof,
        "idle_share_profiled": 1.0 - busy_us * 1e-6 / wall_prof,
        "busy_share_of_unprofiled_wall": busy_us * 1e-6 / wall,
        "device_events": len(events),
        "device_events_per_iter": len(events) / max(sum(iters), 1),
        "spmv_kernels": kernels,
        "spmv_launches_per_iter": sum(k["launches"] for k in kernels.values())
        / max(sum(iters), 1),
        "peak_device_memory_bytes": peak,
        "top_kernels": [{"name": k[:90], "count": v[0],
                         "device_ms": v[1] * 1e-3} for k, v in top],
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problem", choices=("cavity", "step", "cylinder",
                                          "cylinder-2d1", "highre",
                                          "step3d"),
                    default="cavity")
    ap.add_argument("--level", type=int, default=None)
    ap.add_argument("--steps", type=int, default=2,
                    help="Newton steps of the cavity and of cylinder-2d1, "
                         "BDF2 steps of the cylinder, damped Picard steps "
                         "of highre and step3d (the step runs its full "
                         "solve)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.problem, args.level, args.steps)), flush=True)


if __name__ == "__main__":
    main()
