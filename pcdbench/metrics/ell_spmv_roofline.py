"""ell_spmv_roofline: the ELL products' least time over the device time of
the ELL kernels (K3: the device events named ``ell_spmv_kernel`` and
``ell_block_spmv_kernel``) of the same requests, in percent (SpMV kernels).

Both sides count the kernels that ran wherever they were launched from,
CUDA graph replays included: the device time by the kernels' names in the
profile, and the least time from the program's counters ``ell_nnz_<dtype>``
and ``ell_vec_<dtype>`` (each product's stored entries, ``sum(row_len)``
and not the padding slots, the block product's A1 entries once for its d
components; and its vectors' entries), which a replay adds to as the
Python of its products would have.  :func:`cost` turns the sums of one
dtype into bytes and operations and :mod:`pcdbench.roofline` into the
least time: the bytes over the HBM rate, or the operations over the
dtype's peak if longer.  The operations count one multiply-add per entry,
which is short of a block product's d per A1 entry; the bytes bound these
products by far (at most 2 d / 12 operations a byte, against the f64
ridge of 10), so the least time does not change.

One more pass of ``profile_requests`` whole requests (the target built
again, the seed's data, the warm-up, as :mod:`pcdbench.spans` does) inside
``torch.profiler``.  An ``ell_spmv_roofline:`` line gives its numbers.
None where the run was not traced, is not on a card, or the program has no
such counters."""
import gc
import json
import time

from pcdbench import roofline, spans

KERNELS = ("ell_spmv_kernel", "ell_block_spmv_kernel")
VALUE_BYTES = {"f32": 4, "f64": 8}


def cost(nnz: int, vec: int, value_bytes: int):
    """``(bytes, operations)`` of ELL products that read ``nnz`` stored
    entries (an int32 column and a value each) and ``vec`` vector entries
    (each read or written once)."""
    return nnz * (value_bytes + 4) + vec * value_bytes, 2 * nnz


def least(reads: dict) -> float:
    """The least seconds of the products whose sums per dtype are
    ``reads[dtype] = [stored entries, vector entries]``."""
    out = 0.0
    for t, (nnz, vec) in reads.items():
        if nnz:
            vb = VALUE_BYTES[t]
            out += roofline.least_s(*cost(nnz, vec, vb), vb)
    return out


def read(ctx):
    if "ell_spmv_roofline" not in ctx:
        ctx["ell_spmv_roofline"] = _measure(ctx)
    return ctx["ell_spmv_roofline"]


def _measure(ctx):
    if not ctx.get("profile"):
        return None
    try:
        from fenapack_tpu_torch import measure
        from fenapack_tpu_torch.utils import timing
    except ImportError:
        return None
    if not all("ell_vec_" + t in getattr(timing, "counts", {})
               for t in VALUE_BYTES):
        return None
    run = spans._run_locals()
    if run is None or not run["cuda"]:
        return None
    import torch
    from torch.profiler import ProfilerActivity
    target, traffic = run["target"], run["traffic"]
    n = int(traffic.get("profile_requests", 1))
    target.build()
    target.prepare(run["seed"])
    target.warmup(int(traffic.get("warmup_steps", 1)))
    torch.cuda.synchronize()
    try:
        gc.collect()
        c0 = measure.host_counts()
        l0 = measure.launch_counts()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            iters = sum(target.solve().iters for _ in range(n))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c1 = measure.host_counts()
        l1 = measure.launch_counts()
    finally:
        target.free()
    cuda = torch.autograd.DeviceType.CUDA
    kernel_s, kernels = 0.0, 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == cuda and not e.is_user_annotation()
                and any(k in e.name() for k in KERNELS)):
            kernel_s += (e.end_ns() - e.start_ns()) * 1e-9
            kernels += 1
    del prof
    reads = {t: [c1[k + t] - c0[k + t] for k in ("ell_nnz_", "ell_vec_")]
             for t in VALUE_BYTES}
    least_s = least(reads)
    launched = sum(l1[k][t] - l0[k][t] for k in ("ell_spmv", "ell_block_spmv")
                   for t in l1[k])
    print("ell_spmv_roofline: " + json.dumps({
        "requests": n, "iters": iters, "wall_s": wall,
        "least_s": least_s, "kernel_s": kernel_s, "kernels": kernels,
        "launches": launched, "nnz_vec": reads}), flush=True)
    return 100.0 * least_s / kernel_s if kernel_s > 0 and least_s else None
