"""pc_graph_share: the share of the fieldsplit applies served by replaying
CUDA graphs (preconditioner): the program's counters
``pc_graph_replays`` over ``pc_applies`` (``measure.host_counts()``) over
the requests of the spans-only pass (:mod:`pcdbench.spans`, pass (a)), in
percent.  None where the program has no such counters or made no apply."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx)
    counts = (p or {}).get("counts", {})
    if not counts.get("pc_applies") or "pc_graph_replays" not in counts:
        return None
    return 100.0 * counts["pc_graph_replays"] / counts["pc_applies"]
