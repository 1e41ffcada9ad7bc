"""pc_events_per_iter: the device events (kernels, copies, sets) launched
under the ``pc`` span in the span-profile pass (:mod:`pcdbench.spans`,
pass (b)) per outer FGMRES iteration (preconditioner)."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx)
    row = (p or {}).get("table", {}).get("pc")
    if not row or not row["under_events"] or not p["iters_b"]:
        return None
    return row["under_events"] / p["iters_b"]
