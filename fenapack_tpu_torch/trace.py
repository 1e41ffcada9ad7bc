"""Where the time of a path goes, by the program's spans
(:mod:`fenapack_tpu_torch.utils.timing`).

    python -m fenapack_tpu_torch.trace [--problem cavity] [--steps 2]
    python -m fenapack_tpu_torch.trace --problem step [--level 2]
    python -m fenapack_tpu_torch.trace --problem cylinder [--steps 2]
    python -m fenapack_tpu_torch.trace --problem highre [--steps 2]
    python -m fenapack_tpu_torch.trace --problem step3d [--level 3]
    python -m fenapack_tpu_torch.trace --problem step --level 1 \
        --device cpu --no-profile

``cavity``: the slice's Re-100 solver (``fenapack_tpu_torch.cavity``), its
first ``--steps`` Newton steps.  ``step``: the step benchmark's full solve
(``fenapack_tpu_torch.bench``).  ``cylinder``: DFG 2D-2 at level 2
(``fenapack_tpu_torch.cylinder``), its first ``--steps`` semi-implicit BDF2
steps from the impulsive start; ``cylinder-2d1``: the first ``--steps``
Newton steps of DFG 2D-1.  ``highre``: BASELINE config 5 at Re 2000
(``fenapack_tpu_torch.highre``, level 2), its first ``--steps`` damped
Picard steps on the stabilized system.  ``step3d``: BASELINE config 4
(``fenapack_tpu_torch.step3d``, level 3, length 3: 760,852 dofs), its
first ``--steps`` Picard steps.

The solve runs once as a warm-up, once with spans off (wall time, peak
device memory, the host-sync and true-residual counts), once with spans on
and the profiler off (each span's count, host seconds and self seconds:
its seconds less its child spans'), ``--pairs`` times more with spans off
and on in turn (the spans' cost when on: the median ratio of the two
walls), and, unless ``--no-profile``, once with the spans inside
``torch.profiler``.  From that profile: the device busy time (the union of
the device events), the busy and idle shares, the device events per FGMRES
iteration, the heaviest device operations by name, and per span the device
seconds and events whose launch ran with that span innermost on the host
(the launch call and the event share the profiler's correlation id), the
device seconds under it (``under_s``: its own and those of the spans
inside it), and the idle gaps whose middle falls in it.  One JSON line is
printed, the table under ``spans`` as ``columns`` and rows.  Spans,
counts and the ``--no-profile`` table run on the CPU too (``--device
cpu``).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import time

import torch

from . import bench, cavity, cylinder, highre, measure, step3d
from .utils import timing

_PREFIX = "fenapack."


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


def _profiled(solve, cuda: bool):
    """``(result, wall_s, spans, launches, device)`` of one solve with the
    spans inside the profiler: the spans ``(start_us, end_us, name)`` on
    the thread that holds most of them, ``{correlation id: start_us}`` of
    the CUDA API calls, the device events ``(start_us, end_us, name,
    correlation id)`` without the spans' device-side annotations."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with timing.tracing(profile=True), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = solve()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_type = torch.autograd.DeviceType.CUDA
    spans, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == dev_type:
            if not e.is_user_annotation():
                device.append((s, t, name, e.correlation_id()))
        elif name.startswith(_PREFIX):
            spans.append((s, t, name[len(_PREFIX):], e.start_thread_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = s
    main = collections.Counter(h[3] for h in spans).most_common(1)
    spans = sorted((h[:3] for h in spans if h[3] == main[0][0]),
                   key=lambda h: (h[0], -h[1])) if main else []
    return r, wall, spans, launches, sorted(device)


def _innermost(spans):
    """``at(t)``: the names of the innermost of the nested spans (sorted by
    start, longest first) open at host time ``t`` and of the spans around
    it, innermost first, each once."""
    parent, stack = [], []
    for i, (s, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    starts = [h[0] for h in spans]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] < t:
            i = parent[i]
        names = []
        while i >= 0:
            if spans[i][2] not in names:
                names.append(spans[i][2])
            i = parent[i]
        return names
    return at


def _device_by_span(spans, launches, device):
    """``(busy_us, {span: [device_s, under_s, events, idle_s]},
    unattributed_s)``: each device event under the innermost span open at
    its launch (``under_s``: the union of the events under the span or a
    span inside it), each idle gap under the innermost span open at its
    middle."""
    at = _innermost(spans)
    table = collections.defaultdict(lambda: [0.0, 0.0, 0, 0.0])
    merged, last_end, unattributed = [], {}, 0.0
    for s, e, _, corr in device:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
        t = launches.get(corr)
        names = [] if t is None else at(t)
        if not names:
            unattributed += (e - s) * 1e-6
            continue
        table[names[0]][0] += (e - s) * 1e-6
        table[names[0]][2] += 1
        for n in names:
            table[n][1] += max(0.0, e - max(s, last_end.get(n, s))) * 1e-6
            last_end[n] = max(last_end.get(n, e), e)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        name = (at(0.5 * (a + b)) or ["outside"])[0]
        table[name][3] += (b - a) * 1e-6
    return sum(e - s for s, e in merged), table, unattributed


def run(problem: str = "cavity", level: int = None, steps: int = 2, *,
        device: str = "cuda", profile: bool = True, pairs: int = 0) -> dict:
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run with --device cpu")
    if level is None:
        level = {"cavity": cavity.LEVEL, "step3d": 3}.get(problem, 2)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    solve, iters_of, dofs = _solver(problem, level, steps, dev)

    def timed(spans_on: bool):
        sync()
        t0 = time.perf_counter()
        if spans_on:
            with timing.tracing() as rec:
                r = solve()
                sync()
        else:
            rec, r = None, solve()
            sync()
        return r, time.perf_counter() - t0, rec

    solve()                                             # warm-up
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    c0 = measure.host_counts()
    r, wall, _ = timed(False)
    c1 = measure.host_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rs, wall_spans, rec = timed(True)
    ratios = []
    for _ in range(pairs):
        off, on = timed(False)[1], timed(True)[1]
        ratios.append(on / off)
    table = {n: v + [0.0, 0.0, 0, 0.0]
             for n, v in timing.span_table(rec.spans).items()}
    iters = iters_of(r)
    n_it = max(sum(iters), 1)
    out = {
        "problem": problem, "level": level, "dofs": int(dofs),
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "fgmres_iters": iters, "same_iters": iters_of(rs) == iters,
        "wall_s": wall, "wall_spans_s": wall_spans,
        "spans_on_ratios": ratios,
        "spans_on_cost": statistics.median(ratios) if ratios else None,
        "ms_per_fgmres_iter": wall / n_it * 1e3,
        "counts": {k: c1[k] - c0[k] for k in c1},
        "host_syncs_per_iter": (c1["host_syncs"] - c0["host_syncs"]) / n_it,
        "peak_device_memory_bytes": peak,
    }
    if profile:
        rp, wall_prof, spans, launches, dev_ev = _profiled(solve, cuda)
        busy_us, by_span, unattributed = _device_by_span(spans, launches,
                                                         dev_ev)
        for n, v in by_span.items():
            table.setdefault(n, [0, 0.0, 0.0] + [0.0, 0.0, 0, 0.0])[3:] = v
        by_name = collections.Counter()
        for s, e, name, _ in dev_ev:
            by_name[name] += (e - s) * 1e-3
        out.update({
            "wall_profiled_s": wall_prof,
            "device_busy_s": busy_us * 1e-6,
            "busy_share_profiled": busy_us * 1e-6 / wall_prof,
            "busy_share_of_unprofiled_wall": busy_us * 1e-6 / wall,
            "device_events": len(dev_ev),
            "device_events_per_iter": len(dev_ev) / max(sum(iters_of(rp)),
                                                        1),
            "unattributed_device_s": unattributed,
            "top_kernels": [{"name": k[:90], "device_ms": v}
                            for k, v in by_name.most_common(12)],
        })
    out["spans"] = {
        "columns": ["count", "host_s", "self_s", "device_s", "under_s",
                    "device_events", "idle_s"],
        "rows": dict(sorted(table.items(), key=lambda kv: -kv[1][1]))}
    return out


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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-profile", action="store_true",
                    help="the spans' host table only, no profiler")
    ap.add_argument("--pairs", type=int, default=0,
                    help="solves with spans off and on in turn, for the "
                         "spans' cost when on")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.problem, args.level, args.steps,
                         device=args.device, profile=not args.no_profile,
                         pairs=args.pairs)), flush=True)


if __name__ == "__main__":
    main()
