"""Stage timers, spans, counters and a profiler trace; the stage timers
are the port of ``fenapack_tpu/utils/timing.py``.

:class:`Timings` accumulates wall seconds per named stage and prints them
as a table (DOLFIN's ``list_timings``).  A timer built for a CUDA device
synchronizes that device when a stage stops, so stage times are device
times; on the CPU it reads the host clock alone.  :func:`device_trace`
records a ``torch.profiler`` trace of a region (CPU and CUDA activities)
as a Chrome trace file, with the spans in it.

Spans mark the solve path's layers: ``with span("pc"): ...`` in the
solver code.  They are off unless a :func:`tracing` block is open; off, a
span is one test of a module global and returns a shared no-op object (no
clock read, no allocation, no host sync).  On, each span keeps ``(name,
start_ns, end_ns, parent, request)`` on ``time.perf_counter_ns`` in memory
(``parent`` the index of the enclosing span, -1 at the top; ``request``
the count of full solves begun in this process, :func:`request`), and with
``profile=True`` also enters ``torch.profiler.record_function("fenapack."
+ name)``, so the span stands in the profiler's trace beside the kernels
its host code launched, on the profiler's clock.

:data:`counts` holds every work counter of the process, all always on:
``host_syncs`` is added to at every point of the solve path where the host
waits for the device (a read of a device value to the host, a copy of host
values to the device, the implicit check of ``torch.linalg.inv``), counted
where it is written whatever the device; ``true_residuals`` at every true
(f64) residual evaluation of a linear solve.  At every BSR product
(:func:`bsr_read`), ``bsr_slots`` the tile slots it streams (``nb * m * b *
b``, zero fill included) and ``bsr_nnz`` its operator's own nonzeros, whose
ratio is the zero fill per nonzero that the products read; by the tiles'
dtype (``f32``, ``f64``), ``bsr_nnz_<dtype>`` the same nonzeros and
``bsr_vec_<dtype>`` the entries of its input and output vectors
(``(n_rows + n_cols) * k``), from which a reader reckons the least bytes
the products move.  At every ELL product (:func:`ell_read`: the single
product K3 and the block product), by the values' dtype,
``ell_nnz_<dtype>`` the entries its operator stores (the pattern's own
entries, ``sum(row_len)``, not the padding slots; the block product counts
A1's entries once for its d components, and each of the d*d reaction
planes' entries once more) and ``ell_vec_<dtype>`` the entries of its input
and output vectors (``y0`` too where given).  ``unsteady_steps`` and
``unsteady_picard_iters`` count the time steps and the Picard iterations
(Oseen solves) of :mod:`..solvers.unsteady`.  ``pc_applies`` counts every
apply of a fieldsplit pipeline and ``pc_graph_replays`` those served by
replaying its CUDA graphs (:mod:`..solvers.fieldsplit`).
``launch.<kernel>.<dtype>`` counts the launches of each kernel wrapper
(:func:`launched`; the plain versions count nothing).  A CUDA graph's capture takes back what its Python counted and
every replay adds it (:class:`..solvers.fieldsplit.PCGraphs`).
``fenapack_tpu_torch.measure`` reads them: ``launch_counts`` the launches,
``host_counts`` the rest.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

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
    with tracing(profile=True), profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


# ---- counters ---------------------------------------------------------- #

# the kernel wrappers whose launches are counted, by dtype
KERNELS = ("bsr_spmv", "ell_spmv", "ell_block_spmv")
LAUNCH = "launch."

# since the process started: host waits for the device and true residuals
# of the solve path; the BSR products' tile slots, nonzeros and vector
# entries; the ELL products' entries and vector entries; the time steps
# and Picard iterations of the unsteady solvers; the fieldsplit applies and
# those served by graph replay; the kernel launches
counts = {"host_syncs": 0, "true_residuals": 0, "bsr_slots": 0,
          "bsr_nnz": 0, "bsr_nnz_f32": 0, "bsr_vec_f32": 0,
          "bsr_nnz_f64": 0, "bsr_vec_f64": 0, "ell_nnz_f32": 0,
          "ell_vec_f32": 0, "ell_nnz_f64": 0, "ell_vec_f64": 0,
          "unsteady_steps": 0, "unsteady_picard_iters": 0, "pc_applies": 0,
          "pc_graph_replays": 0,
          **{f"{LAUNCH}{k}.{t}": 0 for k in KERNELS for t in ("f32", "f64")}}


def host_sync(n: int = 1) -> None:
    """Count ``n`` host waits for the device, at the site that waits."""
    counts["host_syncs"] += n


def bsr_read(**reads: int) -> None:
    """Add one BSR product's reads to the counters ``bsr_<name>``."""
    for name, n in reads.items():
        counts["bsr_" + name] += n


def ell_read(dtype: torch.dtype, nnz: int, vec: int) -> None:
    """Add one ELL product's stored entries and vector entries to the
    counters ``ell_nnz_<dtype>``, ``ell_vec_<dtype>``."""
    t = "f64" if dtype == torch.float64 else "f32"
    counts["ell_nnz_" + t] += nnz
    counts["ell_vec_" + t] += vec


def launched(kernel: str, dtype: str) -> None:
    """Count one launch of ``kernel`` (one of :data:`KERNELS`) in
    ``dtype`` (``f32``, ``f64``), where the wrapper launches it."""
    counts[f"{LAUNCH}{kernel}.{dtype}"] += 1


# ---- spans ------------------------------------------------------------- #

class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int                 # index of the enclosing span, -1: none
    request: int                # full solves begun when it opened


class _Off:
    """The span of a run with spans off: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_perf_ns = time.perf_counter_ns
_recorder: Optional["SpanRecorder"] = None
_request = 0


class SpanRecorder:
    """The spans of one :func:`tracing` block, on ``time.perf_counter_ns``.
    ``spans`` lists them in the order they opened once the block has
    closed; while it runs, a span costs list appends and no allocation of
    its own."""

    def __init__(self, profile: bool):
        self.profile = profile
        self._names, self._starts, self._ends = [], [], []
        self._parents, self._requests = [], []
        self._stack, self._rfs = [], {}
        self._name = None
        self._spans: Optional[List[Span]] = None

    @property
    def spans(self) -> List[Span]:
        if self._spans is None:
            self._spans = [Span(*r) for r in zip(
                self._names, self._starts, self._ends, self._parents,
                self._requests)]
        return self._spans

    def _open(self, name: str) -> "SpanRecorder":
        self._name = name
        return self

    def __enter__(self):
        i = len(self._names)
        if self.profile:
            rf = self._rfs[i] = torch.profiler.record_function(
                "fenapack." + self._name)
            rf.__enter__()
        stack = self._stack
        self._names.append(self._name)
        self._parents.append(stack[-1] if stack else -1)
        self._requests.append(_request)
        self._ends.append(0)
        stack.append(i)
        self._starts.append(_perf_ns())
        return None

    def __exit__(self, *exc):
        end = _perf_ns()
        i = self._stack.pop()
        self._ends[i] = end
        if self.profile:
            self._rfs.pop(i).__exit__(*exc)
        return False


def span(name: str):
    """``with span(name): ...``: a span of the solve path (a no-op unless a
    :func:`tracing` block is open).  Enter what it returns at once: the
    recorder holds the name until then."""
    if _recorder is None:
        return _OFF
    return _recorder._open(name)


def request(name: str = "solve"):
    """The span ``name`` of one full solve (``solve``: a steady solve;
    ``unsteady.solve``: a time integration): counts the request (the spans
    inside it carry the count), then as :func:`span`."""
    global _request
    _request += 1
    return span(name)


@contextmanager
def tracing(profile: bool = False):
    """Spans on inside the block; yields the :class:`SpanRecorder`, whose
    ``spans`` hold the block's spans once it closes.  ``profile`` also
    places each span in the profiler's trace (``record_function``)."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are on already")
    rec = _recorder = SpanRecorder(profile)
    try:
        yield rec
    finally:
        _recorder = None


def span_table(spans) -> Dict[str, list]:
    """``{name: [count, host_s, self_s]}``: each name's spans, their
    seconds, and their seconds less the seconds of their child spans (a
    span's children do not overlap: they run one after another on the
    host)."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    table: Dict[str, list] = {}
    for s, c in zip(spans, child_ns):
        t = table.setdefault(s.name, [0, 0.0, 0.0])
        t[0] += 1
        t[1] += (s.end_ns - s.start_ns) * 1e-9
        t[2] += (s.end_ns - s.start_ns - c) * 1e-9
    return table
