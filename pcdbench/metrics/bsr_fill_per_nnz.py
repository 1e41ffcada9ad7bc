"""bsr_fill_per_nnz: the tile slots that the BSR products stream per
nonzero of their operators (SpMV kernels): the program's tracing counters
``bsr_slots`` (``nb * m * b * b`` of every product, zero fill included)
over ``bsr_nnz`` (each product's operator's own nonzeros), summed over the
requests of the spans-only pass (:mod:`pcdbench.spans`, pass (a)).  1 is
no fill; None where the program has no such counters or ran no BSR
product."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx)
    counts = (p or {}).get("counts", {})
    if not counts.get("bsr_nnz") or "bsr_slots" not in counts:
        return None
    return counts["bsr_slots"] / counts["bsr_nnz"]
