"""bsr_spmv_roofline: the BSR products' least time over the device time of
the BSR kernels (K1, K2: the device events named ``bsr_spmv_kernel``) of
the same requests, in percent (SpMV kernels).

Unlike ``spmv_roofline_pct``, whose scopes wrap the products' Python calls
and so miss every product that a CUDA graph replays, both sides here count
the kernels that ran wherever they were launched from: the device time by
the kernels' name in the profile, and the least time (:mod:`pcdbench.roofline`)
from the program's tracing counters ``bsr_nnz_<dtype>`` and
``bsr_vec_<dtype>`` (each product's operator's nonzeros and its vectors'
entries, ``(n_rows + n_cols) * k``), which a replay adds to as the Python of
its products would have.  The least time is reckoned from the sums per
dtype: the sum of the products' bytes over the HBM rate, or their
operations (those of one right-hand side) over the dtype's peak if longer,
which is at most the sum of each product's own least time.

One more pass of ``profile_requests`` whole requests (as
:mod:`pcdbench.spans` does: the target built again, the seed's data, the
warm-up), spans on (the counters count only while tracing) inside
``torch.profiler``.  A ``bsr_spmv_roofline:`` line gives its numbers.
None where the run was not traced, is not on a card, or the program has no
such counters."""
import gc
import json
import time

from pcdbench import roofline, spans

KERNEL = "bsr_spmv_kernel"
VALUE_BYTES = {"f32": 4, "f64": 8}


def least(reads: dict) -> float:
    """The least seconds of the products whose sums per dtype are
    ``reads[dtype] = [nonzeros, vector entries]``."""
    out = 0.0
    for t, (nnz, vec) in reads.items():
        if nnz:
            vb = VALUE_BYTES[t]
            out += roofline.least_s(*roofline.single(nnz, vec, 0, 1, vb, vb),
                                    vb)
    return out


def read(ctx):
    if "bsr_spmv_roofline" not in ctx:
        ctx["bsr_spmv_roofline"] = _measure(ctx)
    return ctx["bsr_spmv_roofline"]


def _measure(ctx):
    if not ctx.get("profile"):
        return None
    try:
        from fenapack_tpu_torch import measure
        from fenapack_tpu_torch.utils import timing
    except ImportError:
        return None
    if not all("bsr_vec_" + t in getattr(timing, "counts", {})
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
        l0 = sum(measure.launch_counts()["bsr_spmv"].values())
        t0 = time.perf_counter()
        with timing.tracing(), torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            iters = sum(target.solve().iters for _ in range(n))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c1 = measure.host_counts()
        launched = sum(measure.launch_counts()["bsr_spmv"].values()) - l0
    finally:
        target.free()
    cuda = torch.autograd.DeviceType.CUDA
    kernel_s, kernels = 0.0, 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == cuda and not e.is_user_annotation()
                and KERNEL in e.name()):
            kernel_s += (e.end_ns() - e.start_ns()) * 1e-9
            kernels += 1
    del prof
    reads = {t: [c1[k + t] - c0[k + t] for k in ("bsr_nnz_", "bsr_vec_")]
             for t in VALUE_BYTES}
    least_s = least(reads)
    print("bsr_spmv_roofline: " + json.dumps({
        "requests": n, "iters": iters, "wall_s": wall,
        "least_s": least_s, "kernel_s": kernel_s, "kernels": kernels,
        "launches": launched, "nnz_vec": reads}), flush=True)
    return 100.0 * least_s / kernel_s if kernel_s > 0 and least_s else None
