"""Stage timers and a profiler trace, the port of
``fenapack_tpu/utils/timing.py``.

:class:`Timings` accumulates wall seconds per named stage and prints them
as a table (DOLFIN's ``list_timings``).  A timer built for a CUDA device
synchronizes that device when a stage stops, so stage times are device
times; on the CPU it reads the host clock alone.  :func:`device_trace`
records a ``torch.profiler`` trace of a region (CPU and CUDA activities)
as a Chrome trace file.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class Timings:
    """Named stage timers: ``with timings("assembly"): ...``.

    ``device`` (given explicitly) decides the clock: for a CUDA device
    each stage ends with ``torch.cuda.synchronize(device)``, so queued
    kernels count toward the stage that launched them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        """The table of stages: calls, total seconds, mean milliseconds."""
        lines = [f"{'stage':<32} {'calls':>6} {'total s':>10} {'avg ms':>10}"]
        for name in sorted(self.total):
            t, c = self.total[name], self.count[name]
            lines.append(f"{name:<32} {c:>6} {t:>10.3f} {1e3 * t / c:>10.2f}")
        return "\n".join(lines)


# the process-wide table of host-side stages (the JAX package's name)
GLOBAL_TIMINGS = Timings("cpu")


@contextmanager
def device_trace(trace_dir: Optional[str]):
    """Record a ``torch.profiler`` trace (CPU and, where a card is
    present, CUDA activities) around a region and write it into
    ``trace_dir`` as ``trace.json`` (Chrome trace format, viewable in
    Perfetto).  Does nothing when ``trace_dir`` is falsy, so a command-line
    flag can be passed straight through::

        with device_trace(args.trace):
            solver.solve(...)
    """
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
