"""host_syncs_per_iter: the program's host-sync counter
(``measure.host_counts()["host_syncs"]``: every wait of the host for the
device on the solve path) over the requests of the spans-only pass
(:mod:`pcdbench.spans`, pass (a): the window's own solves, the profiler
off) divided by their outer FGMRES iterations (host launch path)."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx)
    if not p or not p["iters_a"] or "host_syncs" not in p["counts"]:
        return None
    return p["counts"]["host_syncs"] / p["iters_a"]
