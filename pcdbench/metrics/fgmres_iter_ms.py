"""fgmres_iter_ms: the window's wall time over its outer FGMRES
iterations (host clock; Oseen solve)."""


def read(ctx):
    w = ctx["window"]
    n = sum(x.iters for x in w.records)
    return w.wall_s / n * 1e3 if n else None
