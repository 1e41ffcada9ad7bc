"""The traced part of a ``--trace 1`` run: whole requests under
``torch.profiler``, with a ``record_function`` scope around each of the
program's sparse-product dispatch points.

:class:`SpmvScopes` replaces ``ops.sparse.{ell_spmv, ell_block_spmv,
bsr_spmv}`` for the profiled requests: each call runs inside the scope
``pcdbench.spmv.<kind>`` and adds its least time (:mod:`.roofline`) from
the entries of its operator.  The entries come from the program's
sparsity patterns, found by type among the live objects when the scopes
open and keyed by their column (or block-neighbour) tensor, and for an
operator that outlived its pattern from its row lengths or its nonzero
values; a call on an operator found neither way adds no least time (it
can only lower the share) and is counted.

:func:`summarize` reduces the profile: the union of the device events'
intervals (busy), their count, the device time under the scopes (the
device events inside each scope's device-side annotation: the kernels are
launched through ``ctypes``, outside any op that the profiler correlates
them with), the heaviest device operations by name, and the idle gaps
named by the innermost host op open at their middle ("python" where none
is).
"""
from __future__ import annotations

import collections
import gc
import time
import warnings

import torch

from . import roofline

SCOPE = "pcdbench.spmv."


class SpmvScopes:
    """Context manager: the program's three dispatch points wrapped."""

    def __init__(self):
        self.least_s = 0.0
        self.calls = collections.Counter()
        self.unknown = 0

    def _entries(self):
        """``{index tensor's data_ptr: entries}``: a pattern's unique
        (row, column) pairs; for an operator whose pattern is gone (the
        multigrid transfers keep only the matrix), its row lengths or its
        nonzero values."""
        from fenapack_tpu_torch.ops.sparse import (ELL, BlockELL,
                                                   SparsityPattern)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            live = [o for o in gc.get_objects()
                    if isinstance(o, (SparsityPattern, ELL, BlockELL))]
        nnz = {}
        for o in live:
            if isinstance(o, SparsityPattern):
                key = getattr(o, "nbr", None)
                key = o.cols if key is None else key
                nnz[key.data_ptr()] = int(o.nnz)
        for o in live:
            if isinstance(o, BlockELL) and o.nbr.data_ptr() not in nnz:
                nnz[o.nbr.data_ptr()] = int(torch.count_nonzero(o.tiles))
            elif isinstance(o, ELL) and o.cols.data_ptr() not in nnz:
                nnz[o.cols.data_ptr()] = int(
                    torch.count_nonzero(o.vals) if o.row_len is None
                    else torch.sum(o.row_len))
        return nnz

    def __enter__(self):
        from fenapack_tpu_torch.ops import sparse
        self._sparse = sparse
        self._orig = (sparse.ell_spmv, sparse.ell_block_spmv,
                      sparse.bsr_spmv)
        ell, blk, bsr = self._orig
        nnz = self._entries()

        least = {}

        def add(kind, key, count, value_bytes):
            """``key`` starts with the index tensor's data_ptr."""
            self.calls[kind] += 1
            t = least.get(key)
            if t is None:
                n = nnz.get(key[0])
                t = least[key] = (None if n is None else roofline.least_s(
                    *count(n), value_bytes))
            if t is None:
                self.unknown += 1
            else:
                self.least_s += t

        def ell_scoped(cols, vals, x, n_cols):
            k = 1 if x.dim() == 1 else x.shape[1]
            add("ell", (cols.data_ptr(), k, n_cols, vals.dtype, x.dtype),
                lambda n: roofline.single(
                    n, cols.shape[0], n_cols, k, vals.element_size(),
                    x.element_size()), vals.element_size())
            with torch.profiler.record_function(SCOPE + "ell"):
                return ell(cols, vals, x, n_cols)

        def blk_scoped(cols, A1, R, x, n_cols, y0=None, row_len=None):
            add("ell_block", (cols.data_ptr(), x.shape[0], n_cols,
                              R is None, y0 is None, A1.dtype, x.dtype),
                lambda n: roofline.block(
                    n, cols.shape[0], n_cols, x.shape[0], R is not None,
                    y0 is not None, A1.element_size(), x.element_size()),
                A1.element_size())
            with torch.profiler.record_function(SCOPE + "ell_block"):
                return blk(cols, A1, R, x, n_cols, y0, row_len=row_len)

        def bsr_scoped(nbr, tiles, x, n_rows, n_cols):
            k = 1 if x.dim() == 1 else x.shape[1]
            add("bsr", (nbr.data_ptr(), k, n_rows, n_cols, tiles.dtype,
                        x.dtype),
                lambda n: roofline.single(
                    n, n_rows, n_cols, k, tiles.element_size(),
                    x.element_size()), tiles.element_size())
            with torch.profiler.record_function(SCOPE + "bsr"):
                return bsr(nbr, tiles, x, n_rows, n_cols)

        sparse.ell_spmv, sparse.ell_block_spmv, sparse.bsr_spmv = (
            ell_scoped, blk_scoped, bsr_scoped)
        return self

    def __exit__(self, *exc):
        s = self._sparse
        s.ell_spmv, s.ell_block_spmv, s.bsr_spmv = self._orig
        return False


def profile(target, n: int):
    """Run ``n`` whole requests under the profiler and the scopes.
    Returns ``(records, wall_s, events, scopes)``, the events as
    ``(start_us, end_us, name, on_device, thread, is_async)``."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with SpmvScopes() as scopes, torch.profiler.profile(activities=acts) \
            as prof:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = [target.solve() for _ in range(n)]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return records, wall, _events(prof), scopes


def _events(prof) -> list:
    """The profile's raw events (not the tree that ``prof.events()``
    builds, which takes minutes at a 3D solve's million events)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        dev = e.device_type() == cuda
        if dev and (name.startswith(SCOPE)
                    or getattr(e, "is_user_annotation", lambda: False)()):
            # a scope's device-side annotation: kept apart by its name
            name = name if name.startswith(SCOPE) else SCOPE + name
        out.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3, name, dev,
                    e.start_thread_id(), e.is_async()))
    return out


def union_us(intervals) -> tuple:
    """``(busy_us, merged)``: the length of the union of (start, end)
    intervals and the merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _gap_names(gaps, host):
    """Seconds of the gaps (start, end), in order, by the innermost host
    event open at each gap's middle: ``host`` are (start, end, name)
    intervals, nested or apart."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out = collections.Counter()
    stack, j = [], 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "python"] += (e - s) * 1e-6
    return out


def summarize(events, wall_s: float, top: int = 10) -> dict:
    """The numbers of a profile from :func:`_events`."""
    dev = sorted((e for e in events if e[3] and not e[2].startswith(SCOPE)),
                 key=lambda e: e[0])
    busy_us, merged = union_us((e[0], e[1]) for e in dev)
    by_name = collections.Counter()
    for e in dev:
        by_name[e[2]] += (e[1] - e[0]) * 1e-6
    # device events inside the scopes' device-side annotations: one stream
    # keeps the kernels that a scope launched together, and in its span
    ann = sorted((e[0], e[1]) for e in events
                 if e[3] and e[2].startswith(SCOPE))
    scoped_us, i = 0.0, 0
    for e in dev:
        while i < len(ann) and ann[i][1] < e[0]:
            i += 1
        if i < len(ann) and ann[i][0] <= e[0] and e[1] <= ann[i][1]:
            scoped_us += e[1] - e[0]
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    threads = collections.Counter(e[4] for e in events if not e[3])
    main = threads.most_common(1)[0][0] if threads else None
    host = [(e[0], e[1], e[2]) for e in events
            if not e[3] and e[4] == main and not e[5]]
    idle = _gap_names(gaps, host)
    return {
        "wall_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "device_events": len(dev),
        "spmv_device_s": scoped_us * 1e-6,
        "device_ops": [[n[:160], s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[n[:160], s] for n, s in idle.most_common(top)],
    }
