"""fgmres_iters_per_solve: outer FGMRES iterations per request, from each
result's counts, averaged over the window (Oseen solve)."""


def read(ctx):
    r = ctx["window"].records
    return sum(x.iters for x in r) / len(r) if r else None
