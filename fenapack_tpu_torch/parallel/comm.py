"""Ranks and their collectives on ``torch.distributed``'s gloo backend.

The port's replacement for the JAX package's device mesh
(``jax.sharding.Mesh``) and for the collectives its ring path pins by hand
(``psum``, ``ppermute``, ``all_gather``).  One rank is one gloo
participant.  Every rank holds the whole problem; only the Oseen solve is
distributed, over contiguous row blocks (:mod:`.spmd`).

  * :class:`Comm` wraps one gloo group: ``allreduce_sum`` (sums of scalars
    and short vectors), ``ring_exchange`` (the one-hop halos of the ring
    products, zeros at the ring's ends), ``all_gather`` and
    ``reduce_scatter`` (each rank's block of a sum of per-rank partials:
    the sharded assembly of :mod:`.sharding`).  Gloo does not
    send CUDA tensors, so every collective stages its payload through host
    memory here, and nowhere else: a copy to the host (which waits for the
    device's queued work), the gloo call, a copy back.  Each call adds one
    to its entry of ``Comm.counts``, so a run can report exchanges and
    all-reduces per FGMRES iteration.
  * :func:`run_ranks` runs ``fn(comm, *args)`` on ``size`` ranks and
    returns their results in rank order: threads of this process (the CPU
    tests; each thread owns a ``ProcessGroupGloo`` on a shared
    ``HashStore``) or processes (:class:`RankPool`, spawned, joined through
    a ``TCPStore`` on the loopback address).  A rank that raises makes the
    launcher raise; a run that outlasts ``timeout`` raises too.

Every group is created on the loopback device (no hostname resolution) with
a timeout of at most 60 s, so a rank that waits for a failed peer gives up
instead of hanging.  Inside a rank, :func:`current` returns its
:class:`Comm`.  No NCCL: it needs one GPU per rank, and the ranks of
this port may share one card.
"""
from __future__ import annotations

import datetime
import gc
import queue
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch

MAX_TIMEOUT = 60.0            # seconds: the longest wait of any collective

_local = threading.local()


def current() -> Optional["Comm"]:
    """The :class:`Comm` of the rank this thread runs (None outside the
    launchers of this module)."""
    return getattr(_local, "comm", None)


def _gloo_group(store, rank: int, size: int, timeout: float):
    import torch.distributed as dist
    from torch.distributed import ProcessGroupGloo
    opts = ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=min(timeout, MAX_TIMEOUT))
    opts._devices = [ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    return ProcessGroupGloo(dist.PrefixStore("fenapack", store), rank, size,
                            opts)


class Comm:
    """The collectives of one rank of a gloo group of ``size`` ranks.
    ``device`` is where the rank computes: the card (every rank on device 0
    unless told otherwise) or the CPU.  With ``size == 1`` there is no
    group and nothing is communicated (or counted)."""

    def __init__(self, group, rank: int, size: int, device):
        self.group, self.rank, self.size = group, int(rank), int(size)
        self.device = torch.device(device)
        self.counts = {"exchange": 0, "allreduce": 0, "allgather": 0,
                       "reducescatter": 0}

    def reset_counts(self):
        for key in self.counts:
            self.counts[key] = 0

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """A contiguous host copy of ``t``; from the card one copy into
        pinned memory, which waits for the device's queued work."""
        if t.device.type != "cuda":
            return t.detach().contiguous()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    @staticmethod
    def _to_device(host: torch.Tensor, device) -> torch.Tensor:
        """``host`` on ``device``: from pinned memory without waiting (the
        caching host allocator keeps the buffer until the copy is done)."""
        if torch.device(device).type != "cuda":
            return host
        return host.to(device, non_blocking=True)

    # -------------------------------------------------------------- #
    def allreduce_sum_host(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` on the host (the Hessenberg
        column that FGMRES's host Givens algebra reads); a new tensor except
        with one rank and ``t`` on the host.

        The payloads are short, so the sum is an all-gather followed by
        additions in rank order on the host: every rank adds the same
        numbers in the same order and gets the same bits, run after run,
        whatever gloo's reduction algorithm does."""
        host = self._to_host(t)
        if self.size == 1:
            return host
        outs = self._gather_host(host)
        self.counts["allreduce"] += 1
        acc = torch.empty(outs.shape[1:], dtype=outs.dtype,
                          pin_memory=outs.is_pinned())
        acc.copy_(outs[0])
        for o in outs[1:]:
            acc += o
        return acc

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t``, on ``t``'s device."""
        if self.size == 1:
            return t
        return self._to_device(self.allreduce_sum_host(t), t.device)

    def _gather_host(self, host: torch.Tensor) -> torch.Tensor:
        """Every rank's host tensor, stacked in rank order: one send to and
        one receive from every other rank, all posted at once (one round;
        gloo's ring all-gather takes size - 1 rounds in turn)."""
        out = torch.empty((self.size,) + tuple(host.shape), dtype=host.dtype,
                          pin_memory=host.is_pinned())
        out[self.rank] = host
        peers = [p for p in range(self.size) if p != self.rank]
        works = [self.group.recv([out[p]], p, 1) for p in peers]
        works += [self.group.send([host], p, 1) for p in peers]
        for w in works:
            w.wait()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``(size, *x.shape)``
        on ``x``'s device."""
        if self.size == 1:
            return x[None]
        out = self._gather_host(self._to_host(x))
        self.counts["allgather"] += 1
        return self._to_device(out, x.device)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sum over the ranks of ``t`` (``(size,
        ...)``: block q goes to rank q), on ``t``'s device.  Every rank
        sends block q to rank q and adds the blocks it receives in rank
        order on the host, so the sum takes the same order on every run."""
        if self.size == 1:
            return t[0]
        host = self._to_host(t)
        recv = torch.empty_like(host)
        recv[self.rank] = host[self.rank]
        peers = [p for p in range(self.size) if p != self.rank]
        works = [self.group.recv([recv[p]], p, 2) for p in peers]
        works += [self.group.send([host[p].contiguous()], p, 2)
                  for p in peers]
        for w in works:
            w.wait()
        acc = recv[0].clone()
        for o in recv[1:]:
            acc += o
        self.counts["reducescatter"] += 1
        return self._to_device(acc, t.device)

    def ring_exchange(self, parts: Sequence[Tuple[torch.Tensor, int]]
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """One-hop halo exchange of several vectors at once.

        ``parts`` holds ``(x, h)`` pairs, ``x`` of shape ``(..., n_loc)``,
        the rank's block of a row-partitioned vector (components in the
        leading dimensions).  Returns per part ``(left, right)`` of shape
        ``(..., h)``: the last ``h`` entries of the left neighbour's block
        and the first ``h`` of the right neighbour's, zeros at the ends of
        the ring.  All parts travel in one message each way; the send
        buffers stay referenced until their sends complete."""
        hs = [int(h) for _, h in parts]
        zeros = lambda x, h: x.new_zeros(tuple(x.shape[:-1]) + (h,))
        if self.size == 1 or not any(hs):
            return [(zeros(x, h), zeros(x, h)) for x, h in parts]
        dt = parts[0][0].dtype
        if any(x.dtype != dt for x, _ in parts):
            raise TypeError("ring_exchange parts must share one dtype")
        # one payload: the heads go to the left neighbour, the tails to the
        # right one; one copy to the host, one back
        dev = parts[0][0].device
        payload = self._to_host(torch.cat(
            [x[..., :h].reshape(-1) for (x, _), h in zip(parts, hs)]
            + [x[..., x.shape[-1] - h:].reshape(-1)
               for (x, _), h in zip(parts, hs)]))
        n = payload.numel() // 2
        heads, tails = payload[:n], payload[n:]
        recv = torch.zeros(2 * n, dtype=dt, pin_memory=payload.is_pinned())
        from_left, from_right = recv[:n], recv[n:]
        r, works = self.rank, []
        if r > 0:
            works.append(self.group.recv([from_left], r - 1, 0))
        if r < self.size - 1:
            works.append(self.group.recv([from_right], r + 1, 0))
        if r > 0:
            works.append(self.group.send([heads], r - 1, 0))
        if r < self.size - 1:
            works.append(self.group.send([tails], r + 1, 0))
        for w in works:
            w.wait()
        self.counts["exchange"] += 1
        recv = self._to_device(recv, dev)
        out, pos = [], 0
        for (x, _), h in zip(parts, hs):
            shape = tuple(x.shape[:-1]) + (h,)
            m = int(torch.Size(shape).numel())
            out.append((recv[pos:pos + m].view(shape),
                        recv[n + pos:n + pos + m].view(shape)))
            pos += m
        return out


# --------------------------------------------------------------------- #
# launchers
# --------------------------------------------------------------------- #

def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a rank asked for the card, and CUDA is not "
                           "available here")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def _release(comm: Optional[Comm]):
    """Drop a rank's group in the rank's own thread or process: a gloo
    group left to the interpreter's shutdown (it sits in a reference
    cycle) aborts the process there."""
    if comm is not None:
        comm.group = None
    gc.collect()


def _thread_ranks(fn, size, device, timeout, args):
    import torch.distributed as dist
    store = dist.HashStore()
    results: list = [None] * size
    errors: "queue.Queue" = queue.Queue()
    done = [False] * size

    def body(rank):
        comm = None
        try:
            comm = Comm(_gloo_group(store, rank, size, timeout)
                        if size > 1 else None, rank, size, device)
            _local.comm = comm
            results[rank] = fn(comm, *args)
        except BaseException as exc:           # reported to the caller
            errors.put((rank, exc, traceback.format_exc()))
        finally:
            _local.comm = None
            _release(comm)
            done[rank] = True

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(size)]
    # the ranks hand the interpreter lock to each other at every
    # collective: a short switch interval keeps that handover from
    # dominating their latency
    interval = sys.getswitchinterval()
    sys.setswitchinterval(min(interval, 5e-4))
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        while not all(done) and errors.empty():
            if time.monotonic() > deadline:
                raise TimeoutError(f"{size} thread ranks did not finish "
                                   f"within {timeout:.0f} s")
            time.sleep(0.002)
        # a rank that raised leaves its peers waiting in a collective,
        # which gives up at the group's timeout: let them end first
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
    finally:
        sys.setswitchinterval(interval)
    if not errors.empty():
        rank, exc, tb = errors.get()
        raise RuntimeError(f"rank {rank} of {size} raised:\n{tb}") from exc
    if not all(done):
        raise TimeoutError(f"{size} thread ranks did not finish within "
                           f"{timeout:.0f} s")
    return results


def run_ranks(fn: Callable, size: int, *args, device="cuda",
              threads: bool = False, timeout: float = 600.0) -> list:
    """Run ``fn(comm, *args)`` on ``size`` ranks; their results in rank
    order.  ``threads``: ranks are threads of this process (``fn`` may be
    any callable); otherwise spawned processes (``fn`` and ``args`` must
    pickle).  ``timeout`` bounds the whole run in seconds; each collective
    waits at most :data:`MAX_TIMEOUT`.  The first rank to raise makes this
    raise, naming the rank, with its traceback."""
    dev = _check_device(device)
    if threads:
        return _thread_ranks(fn, size, dev, timeout, args)
    with RankPool(size, device=dev, timeout=timeout) as pool:
        return pool.run(fn, *args)


def _worker(rank, size, device, port, timeout, tasks, results):
    import torch.distributed as dist
    try:
        # a rank computes on short vectors: intra-op threads would only
        # contend with the other ranks
        torch.set_num_threads(1)
        dev = _check_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        comm = Comm(None, rank, size, dev)
        if size > 1:
            store = dist.TCPStore("127.0.0.1", port, is_master=False,
                                  timeout=datetime.timedelta(
                                      seconds=MAX_TIMEOUT))
            comm.group = _gloo_group(store, rank, size, timeout)
        _local.comm = comm
    except BaseException:
        # the answer to the first task
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            fn, args = task
            try:
                out = fn(comm, *args)
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                return
            results.put((rank, True, out))
    finally:
        _release(comm)


class RankPool:
    """``size`` rank processes that stay up for several runs
    (:meth:`run`, or :meth:`submit` and later :meth:`collect`): one gloo
    group of spawned processes, each holding a :class:`Comm` on ``device``
    (every rank on the one card by default).  The constructor returns while
    the processes start; a failed start is raised by the first
    :meth:`collect`.  Use as a context manager; leaving it stops every
    process."""

    def __init__(self, size: int, *, device="cuda", timeout: float = 600.0):
        import torch.distributed as dist
        import torch.multiprocessing as mp
        self.size, self.timeout = size, timeout
        self.device = _check_device(device)
        # the parent hosts the rendezvous store: no port race, no network
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                    wait_for_workers=False,
                                    timeout=datetime.timedelta(
                                        seconds=MAX_TIMEOUT))
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._procs = [ctx.Process(
            target=_worker, daemon=True,
            args=(r, size, str(self.device), self._store.port, timeout,
                  self._tasks[r], self._results))
            for r in range(size)]
        for p in self._procs:
            p.start()
        self._pending = 0

    def _collect(self, deadline) -> list:
        out: list = [None] * self.size
        got = 0
        while got < self.size:
            try:
                rank, ok, val = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank process {dead[0]} of {self.size} died with "
                        f"exit code {self._procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{self.size} rank processes did not "
                                       f"answer within the deadline")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {self.size} raised:\n"
                                   f"{val}")
            out[rank] = val
            got += 1
        return out

    def submit(self, fn: Callable, *args):
        """Start ``fn(comm, *args)`` on every rank (picklable ``fn`` and
        ``args``); :meth:`collect` returns the results."""
        if self._pending:
            raise RuntimeError("collect the submitted run first")
        for q in self._tasks:
            q.put((fn, args))
        self._pending = 1

    def collect(self) -> list:
        """The submitted run's results in rank order.  A rank that raised
        (or a run past the pool's timeout from now) stops the pool and
        raises here."""
        if not self._pending:
            raise RuntimeError("nothing was submitted")
        try:
            out = self._collect(time.monotonic() + self.timeout)
        except BaseException:
            self.close()
            raise
        self._pending = 0
        return out

    def run(self, fn: Callable, *args) -> list:
        """``fn(comm, *args)`` on every rank; the results in rank order."""
        self.submit(fn, *args)
        return self.collect()

    def close(self):
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
