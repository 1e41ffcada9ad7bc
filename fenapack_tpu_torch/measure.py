"""Measurement helpers for runs on one CUDA GPU (``chip_smoke.py``,
``trace.py`` and the entry points' launch lines): kernel launch counts,
the solve path's host-sync and true-residual counts,
kernel timing by CUDA events, the device events of a
profile, the least time the card could take for a product, and the
cuSPARSE products that serve as yardsticks beside the hand-written kernels.
The solvers never call anything here.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import bsr_spmv

# H100 SXM peaks (NVIDIA data sheet, full 700 W power limit): HBM bytes/s;
# FP32 and FP64 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# read before each call that device_ms times: five times the 50 MB L2
L2_FLUSH_BYTES = 256 << 20


def launch_counts() -> dict:
    """The kernel launch counters of this process, ``{wrapper: {dtype:
    n}}`` (the plain versions count nothing, so a run on the CPU reads 0)."""
    from .utils import timing
    return {k: {t: timing.counts[f"{timing.LAUNCH}{k}.{t}"]
                for t in ("f32", "f64")} for k in timing.KERNELS}


def reset_launches() -> None:
    """Set the kernel launch counters to 0."""
    from .utils import timing
    for k in timing.counts:
        if k.startswith(timing.LAUNCH):
            timing.counts[k] = 0


def host_counts() -> dict:
    """The solve path's counters of this process (``host_syncs``,
    ``true_residuals``, the BSR reads ``bsr_*``, the ELL reads ``ell_*``,
    ``unsteady_steps``, ``unsteady_picard_iters``, ``pc_applies``,
    ``pc_graph_replays``: :data:`..utils.timing.counts` less the launch
    counters), counted on every device."""
    from .utils import timing
    return {k: n for k, n in timing.counts.items()
            if not k.startswith(timing.LAUNCH)}


def cuda_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median milliseconds per call of ``fn`` from CUDA events around
    ``inner`` back-to-back calls: host-bound for small products, and an
    operand that fits in the 50 MB L2 stays there between calls."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def device_events(prof):
    """The device-side events (kernels, copies, sets) of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def _queued_ms(fn, n: int) -> float:
    """Device milliseconds of ``n`` calls of ``fn``: CUDA events around the
    calls, all queued behind a GPU sleep, so the device runs them without
    waiting for the host.  The sleep is doubled and the
    window taken again while the device reaches the first event before the
    host has queued the last call."""
    cycles = 1 << 23                  # ~4-5 ms at the H100's clocks
    while True:
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        if not start.query():
            stop.synchronize()
            return start.elapsed_time(stop)
        stop.synchronize()
        cycles *= 2


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median device milliseconds per call of ``fn`` with the L2 flushed
    before each call, as on a path whose working set exceeds the 50 MB L2:
    the time of ``n`` (flush, call) pairs less that of ``n`` flushes alone.
    The flush is a sum over ``L2_FLUSH_BYTES``: it reads and does not
    write, so the call does not pay for writing back dirty lines that its
    loads evict."""
    buf = torch.zeros(L2_FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
    flush = buf.sum
    pair = lambda: (flush(), fn())
    fn()
    torch.cuda.synchronize()
    return float(np.median([(_queued_ms(pair, n) - _queued_ms(flush, n)) / n
                            for _ in range(reps)]))


def bound(nbytes: int, flops: int, dtype):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the operations over the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ell_bytes(vals: torch.Tensor, n_cols: int, nrhs: int = 1) -> int:
    """Bytes an ELL product must move: values and int32 columns (padding
    slots included: they are part of the input), x, y."""
    isz = vals.element_size()
    return vals.numel() * (isz + 4) + (n_cols + vals.shape[0]) * nrhs * isz


def ell_entries(A1: torch.Tensor, row_len=None) -> int:
    """Slots of an ELL product that hold entries: ``sum(row_len)`` (read
    from the device once per version of the tensor), or every slot of
    ``A1`` when there are no row lengths."""
    if row_len is None:
        return A1.numel()
    from .ops.ell_spmv import length_stats
    return length_stats(row_len)[2]


def ell_block_bytes(A1: torch.Tensor, R, d: int, n_cols: int,
                    y0: bool = False, row_len=None) -> int:
    """Bytes the ELL block product must move: an int32 column and the value
    of A1 and (when given) of each of the d*d planes of R for every entry,
    the d components of x, y and (when given) y0.  With ``row_len`` the
    entries are each row's own (the padding after them is not needed),
    else every slot."""
    isz = A1.element_size()
    planes = 1 + (0 if R is None else d * d)
    return (ell_entries(A1, row_len) * (4 + planes * isz)
            + d * (n_cols + (2 if y0 else 1) * A1.shape[0]) * isz)


def ell_block_flops(A1: torch.Tensor, R, d: int, row_len=None) -> int:
    """Operations of the ELL block product: every entry of A1 serves d
    components, every entry of R one (every slot without ``row_len``, as
    in the bytes)."""
    return 2 * ell_entries(A1, row_len) * (d + (0 if R is None else d * d))


def bsr_bytes(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
              n_cols: int, nrhs: int = 1) -> int:
    """Bytes a packed BSR product must move: the slots it streams (value
    and 16-bit id each, the shorter rows' padding included), each block
    row's neighbour words and header, x, y."""
    nb, L, b = vals.shape
    isz = vals.element_size()
    nbr, _ = bsr_spmv.unpack(idx, L, b)
    return (bsr_spmv.slots(idx, L, b) * (isz + 2) + nb * (nbr.shape[1] + 1)
            * 4 + (n_cols + n_rows) * nrhs * isz)


def library(build, x):
    """``(call, why)``: a zero-argument cuSPARSE product of the same matrix
    from ``build(x) -> (A, x_in)``, or None and the reason when PyTorch
    refuses the layout or dtype."""
    try:
        A, xin = build(x)
        A @ xin
        torch.cuda.synchronize()
        return (lambda: A @ xin), ""
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def bsr_library(op):
    """``build(x) -> (A, x_in)``: a ``torch.sparse_bsr_tensor`` of the real
    blocks of a BlockELL's dense tiles (the padding slots, which repeat a
    row's first neighbour with zero tiles, left out) and x padded to whole
    blocks."""
    nbr, tiles = bsr_spmv.dense(op.nbr, op.tiles)
    nb, b, mb = tiles.shape
    m, ncb = mb // b, -(-op.n_cols // b)
    nbr = nbr.long()
    real = torch.ones_like(nbr, dtype=torch.bool)
    real[:, 1:] = nbr[:, 1:] != nbr[:, :1]
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=nbr.device),
                      torch.cumsum(real.sum(1), 0)])
    blocks = tiles.reshape(nb, b, m, b).permute(0, 2, 1, 3)[real]

    def build(x):
        A = torch.sparse_bsr_tensor(crow, nbr[real], blocks.contiguous(),
                                    size=(nb * b, ncb * b),
                                    check_invariants=False)
        xp = torch.zeros((ncb * b,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
        xp[:op.n_cols] = x
        return A, xp
    return build


def bsr_csr_library(op):
    """``build(x) -> (A, x)``: a ``torch.sparse_csr_tensor`` of a
    BlockELL's real slots (a row's slots are in column order)."""
    nb, L, b = op.tiles.shape
    nbr, kid = bsr_spmv.unpack(op.nbr, L, b)
    real = kid != bsr_spmv.NO_SLOT
    dev = op.tiles.device
    row = (torch.arange(nb, device=dev)[:, None, None] * b
           + torch.arange(b, device=dev)[None, None, :]).expand(nb, L, b)
    col = (torch.gather(nbr, 1, (kid >> 5).clamp(max=nbr.shape[1] - 1)
                        .reshape(nb, -1)).reshape(nb, L, b) * b + (kid & 31))
    # slots (I, q, i) in row order: (I, i, q)
    perm = lambda t: t.permute(0, 2, 1)[real.permute(0, 2, 1)]
    rows, cols, vals = perm(row), perm(col), perm(op.tiles)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.bincount(
                          rows, minlength=op.n_rows), 0)])

    def build(x):
        A = torch.sparse_csr_tensor(crow, cols, vals.to(x.dtype),
                                    size=(op.n_rows, op.n_cols),
                                    check_invariants=False)
        return A, x
    return build


def csr_library(pattern, vals):
    """``build(x) -> (A, x)``: a ``torch.sparse_csr_tensor`` of an ELL
    pattern's own entries (no padding slots)."""
    dev = vals.device
    urow = torch.as_tensor(pattern._urow, device=dev)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.bincount(
                          urow, minlength=pattern.n_rows), 0)])
    col = torch.as_tensor(pattern._ucol, device=dev)
    entries = vals.reshape(-1)[torch.as_tensor(pattern._upos, device=dev)]

    def build(x):
        A = torch.sparse_csr_tensor(crow, col, entries.to(x.dtype),
                                    size=(pattern.n_rows, pattern.n_cols),
                                    check_invariants=False)
        return A, x
    return build
