"""The program's spans and counters inside a ``--trace 1`` run: two more
passes of whole requests after the profiled one, and their reduction by
span.

A metric reader gets only the run's ``ctx``, so :func:`passes` (called by
each reader that needs it, run once per ctx) finds the run's target, seed
and traffic among the locals of :func:`pcdbench.run.run`, which is on the
stack while the readers run.  The window's state is freed by then
(``target.free()``), so it builds the target again, installs the same
seeded data, warms up as set-up does, and then runs ``profile_requests``
requests twice, after a collection each time:

(b) first, spans on inside ``torch.profiler``
    (``timing.tracing(profile=True)``: each span is a
    ``record_function("fenapack.<name>")`` in the trace, on the profiler's
    clock), without the SpMV scopes of :mod:`.trace`; it also refills the
    allocator's cache that ``target.free()`` emptied;
(a) then spans on, the profiler off (``timing.tracing()``): the host
    seconds and self seconds (duration less the child spans' cover:
    ``timing.span_table``) of every span, the counters over the pass, and
    its wall time, whose ratio to the untraced window's wall per request
    is the spans' cost when on (``on_cost``).

In pass (b) each device event goes to the innermost ``fenapack.`` span
that was open on the host when its launch call ran (the launch and the
event share the profiler's correlation id); an event with no launch found
goes to the innermost span's device-side annotation that holds it.  Each
idle gap between the merged device intervals is named by the innermost
span open at its middle (``outside`` where none is).

Where the program has no spans or counters (a checkout without
``timing.tracing``), or the run was not traced, :func:`passes` returns
None without building anything, and the readers report nothing.
"""
from __future__ import annotations

import bisect
import collections
import gc
import json
import os
import sys
import time

PREFIX = "fenapack."
OUTSIDE = "outside"


def _run_locals():
    """The locals of the running ``pcdbench/run.py::run``, or None."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if (code.co_name == "run" and os.path.basename(code.co_filename)
                == "run.py" and "target" in f.f_locals):
            return f.f_locals
        f = f.f_back
    return None


def passes(ctx: dict):
    """The two passes' results for this run (see the module's docstring),
    computed at the first call and kept in ``ctx``; None where there is
    nothing to read."""
    if "spans" not in ctx:
        ctx["spans"] = _passes(ctx)
    return ctx["spans"]


def _passes(ctx):
    if not ctx.get("profile"):
        return None
    try:
        from fenapack_tpu_torch import measure
        from fenapack_tpu_torch.utils import timing
    except ImportError:
        return None
    if not (hasattr(timing, "tracing") and hasattr(measure, "host_counts")):
        return None
    run = _run_locals()
    if run is None:
        return None
    import torch
    target, traffic = run["target"], run["traffic"]
    cuda = bool(run["cuda"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n = int(traffic.get("profile_requests", 1))
    t0 = time.perf_counter()
    target.build()
    target.prepare(run["seed"])
    target.warmup(int(traffic.get("warmup_steps", 1)))
    sync()
    rebuild_s = time.perf_counter() - t0
    try:
        gc.collect()
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with timing.tracing(profile=True), \
                torch.profiler.profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            recs_b = [target.solve() for _ in range(n)]
            sync()
            wall_b = time.perf_counter() - t0
        ev = kineto_events(prof)
        del prof

        gc.collect()
        sync()
        c0 = measure.host_counts()
        t0 = time.perf_counter()
        with timing.tracing() as rec_a:
            recs_a = [target.solve() for _ in range(n)]
            sync()
        wall_a = time.perf_counter() - t0
        c1 = measure.host_counts()
    finally:
        target.free()
    w = ctx["window"]
    out = {
        "requests": n, "rebuild_s": rebuild_s,
        "iters_a": sum(r.iters for r in recs_a),
        "steps_a": sum(r.steps for r in recs_a),
        "iters_b": sum(r.iters for r in recs_b),
        "wall_a_s": wall_a, "wall_b_s": wall_b,
        "on_cost": ((wall_a / n) / (w.wall_s / len(w.records))
                    if w.records else None),
        "counts": {k: c1[k] - c0.get(k, 0) for k in c1},
        "host": timing.span_table(rec_a.spans),
    }
    out.update(attribute(*ev))
    print("spans: " + json.dumps(_line(out)), flush=True)
    return out


def kineto_events(prof):
    """``(spans, launches, device, annotations)`` of a profile, times in
    microseconds: the host's ``fenapack.`` spans ``(start, end, name)``
    on the thread that holds most of them; ``{correlation id: start}`` of
    the host's CUDA API calls (launches, copies, sets);
    the device events ``(start, end, name, correlation id)`` (kernels,
    copies, sets; not annotations); the device-side annotations of the
    spans ``(start, end, name)``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, launches, device, ann = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_hidden_event():
            continue
        name = e.name()
        s, t = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == cuda:
            if e.is_user_annotation():
                if name.startswith(PREFIX):
                    ann.append((s, t, name[len(PREFIX):]))
            else:
                device.append((s, t, name, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((s, t, name[len(PREFIX):], e.start_thread_id()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = s
    main = collections.Counter(h[3] for h in spans).most_common(1)
    spans = [h[:3] for h in spans if main and h[3] == main[0][0]]
    return spans, launches, device, ann


class _Tree:
    """Nested intervals ``(start, end, name)``: the innermost one open at a
    time, and its enclosing ones."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda h: (h[0], -h[1]))
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.starts = [h[0] for h in self.spans]

    def at(self, t) -> int:
        """The index of the innermost interval holding ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return i

    def names(self, i):
        """The names of interval ``i`` and its enclosing ones, once each."""
        out = []
        while i >= 0:
            n = self.spans[i][2]
            if n not in out:
                out.append(n)
            i = self.parent[i]
        return out


def attribute(spans, launches, device, annotations) -> dict:
    """Device time, events and idle time by span.

    ``table[name]``: ``device_s`` and ``events``, the device events whose
    innermost span is ``name``; ``under_s`` and ``under_events``, those
    with ``name`` anywhere among their spans (``under_s`` the union of
    their intervals); ``idle_s``, the idle gaps named by ``name``.  Also
    ``busy_s`` (the union of every device interval), ``unattributed_s``
    and ``unattributed_events`` (no span found), ``by_annotation`` (events
    placed by an annotation, their launch not found), ``gaps_s`` (the sum
    of the idle gaps) and ``idle_by_span`` (every name by its idle
    seconds, ``[name, s]``, most first)."""
    host, dev_ann = _Tree(spans), _Tree(annotations)
    table = collections.defaultdict(lambda: {
        "device_s": 0.0, "events": 0, "under_s": 0.0, "under_events": 0,
        "idle_s": 0.0})
    last_end = {}
    unattributed = 0.0
    n_un = n_ann = 0
    merged = []
    for s, e, _, corr in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
        t = launches.get(corr) if corr else None
        if t is not None:
            names = host.names(host.at(t))
        else:
            names = dev_ann.names(dev_ann.at(s))
            n_ann += bool(names)
        if not names:
            unattributed += e - s
            n_un += 1
            continue
        row = table[names[0]]
        row["device_s"] += (e - s) * 1e-6
        row["events"] += 1
        for n in names:
            r = table[n]
            r["under_s"] += max(0.0, e - max(s, last_end.get(n, s))) * 1e-6
            r["under_events"] += 1
            last_end[n] = max(last_end.get(n, e), e)
    busy = sum(e - s for s, e in merged)
    gaps = 0.0
    idle = collections.Counter()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        i = host.at(0.5 * (a + b))
        name = host.spans[i][2] if i >= 0 else OUTSIDE
        idle[name] += (b - a) * 1e-6
        gaps += (b - a) * 1e-6
        if i >= 0:
            table[name]["idle_s"] += (b - a) * 1e-6
    return {"table": {k: dict(v) for k, v in table.items()},
            "busy_s": busy * 1e-6, "device_events": len(device),
            "unattributed_s": unattributed * 1e-6,
            "unattributed_events": n_un, "by_annotation": n_ann,
            "gaps_s": gaps,
            "idle_by_span": [[n, s] for n, s in idle.most_common()]}


def _line(out: dict) -> dict:
    """The ``spans:`` line: per span name ``[count, host_s, self_s]`` of
    pass (a) and ``[device_s, under_s, events, idle_s]`` of pass (b), then
    the passes' totals."""
    names = sorted(set(out["host"]) | set(out["table"]),
                   key=lambda n: -out["host"].get(n, [0, 0.0])[1])
    z = {"device_s": 0.0, "under_s": 0.0, "events": 0, "idle_s": 0.0}
    cols = ["count", "host_s", "self_s", "device_s", "under_s",
            "device_events", "idle_s"]
    rows = {n: out["host"].get(n, [0, 0.0, 0.0])
            + [out["table"].get(n, z)[k] for k in z] for n in names}
    return {"columns": cols, "spans": rows,
            **{k: out[k] for k in (
                "requests", "iters_a", "iters_b", "steps_a", "wall_a_s",
                "wall_b_s", "on_cost", "rebuild_s", "counts", "busy_s",
                "unattributed_s", "unattributed_events", "by_annotation",
                "device_events", "gaps_s", "idle_by_span")}}


def device_ms_per_iter(ctx, name: str):
    """Milliseconds per outer FGMRES iteration of the device events under
    span ``name`` in pass (b), or None where none were found."""
    p = passes(ctx)
    row = (p or {}).get("table", {}).get(name)
    if not row or not row["under_s"] or not p["iters_b"]:
        return None
    return row["under_s"] / p["iters_b"] * 1e3
