"""Upper-triangular Schur fieldsplit preconditioner as function composition.

The port of ``fenapack_tpu/solvers/fieldsplit.py``:

    P = [ A   B^T ]      P^{-1} r :  z_p = S_hat^{-1} r_p
        [ 0    S  ]                  z_u = A_hat^{-1} (r_u - B^T z_p)

with ``S_hat^{-1}`` the PCD apply and ``A_hat^{-1}`` the velocity subsolve.
The monolithic vector is ``[u_x; u_y; p]``, so the splits are slices.
Velocity Dirichlet dofs carry an identity block: ``z_u = r_u`` there.

An apply is three parts, each inside its span: the PCD apply (``pc.pcd``),
``B^T`` (``pc.bt``) and the velocity subsolve with the concatenation
(``pc.velocity``).  Given a :class:`PCGraphs`, the parts run as CUDA graphs:
each part is captured once per pipeline, input shape and dtype, then replayed,
so an apply costs the host three graph launches instead of the Python and
the launches of some hundreds of kernels.  The kernels, their order and
their operands are those of the eager apply, so a replay gives the eager
apply's result bit for bit.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch

from ..utils import timing
from ..utils.timing import span


class _CudaCapturer:
    """Captures on a side stream into one memory pool (torch's
    ``CUDAGraph`` API without ``torch.cuda.graph``'s device synchronize and
    cache flush at every capture).  A pool is given up when the last graph
    captured into it is reset, and cannot be shared after that, so the
    capturer keeps one graph of its own in the pool (a one-element fill,
    never replayed)."""

    def __init__(self):
        self.stream = self.pool = self._holder = None

    def _side(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        return self.stream

    def warm(self, fn):
        """Run ``fn`` eagerly on the capture stream: it loads the kernels
        and creates the library handles and workspaces that a capture
        must not create."""
        s, cur = self._side(), torch.cuda.current_stream()
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = fn()
        cur.wait_stream(s)
        return out

    def capture(self, fn):
        """``(graph, out)``: ``fn``'s launches captured, nothing run;
        ``out`` is the tensor that every replay rewrites."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._holder = torch.cuda.CUDAGraph()
            self._record(self._holder, lambda: torch.zeros(
                1, device=torch.cuda.current_device()))
        g = torch.cuda.CUDAGraph()
        return g, self._record(g, fn)

    def _record(self, g, fn):
        with torch.cuda.stream(self._side()):
            g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                return fn()
            finally:
                g.capture_end()


class _Captured:
    """One pipeline's graphs for one input shape and dtype: the static
    input, the three parts as ``(span, graph, counter deltas)``, the static
    output and the tensors that pass between the parts (held, so that no
    later capture into the pool takes their memory)."""
    __slots__ = ("x", "parts", "out", "between")

    def __init__(self, x):
        self.x, self.parts, self.out, self.between = x, [], None, ()


class PCGraphs:
    """The CUDA graphs of one solver's fieldsplit pipelines.

    The first apply on the solver runs eagerly on the capture stream (the
    warm-up that capture needs, once).  After it, the first apply of a
    pipeline for an input shape and dtype captures the three parts, and
    every apply replays them.  Capturing for a new pipeline first releases
    the previous pipeline's graphs and static buffers (``reset()``), so one
    pipeline holds graphs at a time and every capture shares one memory
    pool; an apply of a released pipeline captures again.

    The counters stay those of the work done: capture runs no kernel, so
    what its Python adds to :data:`..utils.timing.counts` (launches, BSR
    reads) is taken back and kept as the part's delta, and every replay
    adds it.
    :meth:`for_layout` decides who gets graphs.  ``capturer`` is for tests:
    an object with ``warm(fn)`` and ``capture(fn) -> (graph, out)``, the
    graph with ``replay()`` and ``reset()``."""

    def __init__(self, capturer=None):
        self.capturer = capturer if capturer is not None else _CudaCapturer()
        self.warmed = False
        self._live = None           # weak reference to the capturing pipeline

    @classmethod
    def for_layout(cls, device: torch.device,
                   ranks: int) -> Optional["PCGraphs"]:
        """Graphs for a solver whose pipelines run on ``device`` over
        ``ranks`` row-sharded ranks: on a CUDA device and one rank; None
        (eager pipelines) on the CPU and in the row-sharded layouts."""
        return cls() if device.type == "cuda" and ranks == 1 else None

    def release(self):
        """Reset the graphs of the pipeline that holds them."""
        pipe = self._live() if self._live is not None else None
        self._live = None
        if pipe is not None:
            for c in pipe._graphs.values():
                for _, g, _ in c.parts:
                    g.reset()
            pipe._graphs.clear()

    def _capture(self, pipe, r) -> _Captured:
        if self._live is None or self._live() is not pipe:
            self.release()
            self._live = weakref.ref(pipe)
        c = _Captured(torch.empty(r.shape, dtype=pipe.dtype, device=r.device))
        z_p = self._part(c, "pc.pcd", lambda: pipe.pcd(c.x))
        rhs = self._part(c, "pc.bt", lambda: pipe.bt(c.x, z_p))
        c.out = self._part(c, "pc.velocity",
                           lambda: pipe.velocity(c.x, rhs, z_p))
        c.between = (z_p, rhs)
        return c

    def _part(self, c: _Captured, name: str, fn):
        """Capture one part into ``c``; returns its static output."""
        counts = timing.counts
        with span(name):
            before = dict(counts)
            g, out = self.capturer.capture(fn)
            delta = {k: n - before[k] for k, n in counts.items()
                     if n != before[k]}
            counts.update(before)
        c.parts.append((name, g, delta))
        return out

    def apply(self, pipe: "_FieldsplitUpper", r: torch.Tensor):
        if not self.warmed:
            self.warmed = True
            return self.capturer.warm(
                lambda: pipe.eager(r.to(pipe.dtype)).to(r.dtype))
        key = (tuple(r.shape), r.dtype)
        c = pipe._graphs.get(key)
        if c is None:
            c = pipe._graphs[key] = self._capture(pipe, r)
        else:
            timing.counts["pc_graph_replays"] += 1
        c.x.copy_(r)
        counts = timing.counts
        for name, g, delta in c.parts:
            with span(name):
                g.replay()
            for k, n in delta.items():
                counts[k] += n
        return c.out.to(r.dtype) if r.dtype != pipe.dtype else c.out.clone()


class _FieldsplitUpper:
    """The fieldsplit apply ``pc(r) -> z``: see :func:`make_fieldsplit_upper`.
    Its parts are the methods :meth:`pcd`, :meth:`bt` and :meth:`velocity`
    on an input of the compute dtype (``free_u``'s)."""

    def __init__(self, n_u: int, a_solve: Callable, schur_solve: Callable,
                 bt_mv: Callable, free_u: torch.Tensor,
                 graphs: Optional[PCGraphs] = None):
        self.n_u, self.a_solve, self.schur_solve = n_u, a_solve, schur_solve
        self.bt_mv, self.free_u, self.graphs = bt_mv, free_u, graphs
        self.dtype = free_u.dtype
        self._graphs = {}

    def pcd(self, r):
        return self.schur_solve(r[self.n_u:])

    def bt(self, r, z_p):
        return self.free_u * (r[:self.n_u] - self.bt_mv(z_p))

    def velocity(self, r, rhs, z_p):
        free_u = self.free_u
        z_u = free_u * self.a_solve(rhs) + (1.0 - free_u) * r[:self.n_u]
        return torch.cat([z_u, z_p])

    def eager(self, r: torch.Tensor) -> torch.Tensor:
        with span("pc.pcd"):
            z_p = self.pcd(r)
        with span("pc.bt"):
            rhs = self.bt(r, z_p)
        with span("pc.velocity"):
            return self.velocity(r, rhs, z_p)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """``z`` in ``r``'s dtype; the parts run in the compute dtype."""
        timing.counts["pc_applies"] += 1
        if self.graphs is not None:
            return self.graphs.apply(self, r)
        return self.eager(r.to(self.dtype)).to(r.dtype)


def make_fieldsplit_upper(n_u: int, a_solve: Callable, schur_solve: Callable,
                          bt_mv: Callable, free_u: torch.Tensor,
                          graphs: Optional[PCGraphs] = None
                          ) -> _FieldsplitUpper:
    """``a_solve(r_u)`` approximates the bc-masked velocity block inverse,
    ``schur_solve(r_p)`` is the PCD apply (wind bound), ``bt_mv(p)`` applies
    B^T, ``free_u`` masks free velocity dofs (0 at Dirichlet dofs) and sets
    the compute dtype.  ``graphs``: replay the parts as CUDA graphs (see
    :class:`PCGraphs`); None runs them eagerly."""
    return _FieldsplitUpper(n_u, a_solve, schur_solve, bt_mv, free_u, graphs)
