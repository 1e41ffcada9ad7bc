"""spmv_launches_per_iter: the program's kernel launch counters (single,
block and BSR products, every dtype) over the window's outer FGMRES
iterations (SpMV kernels)."""


def read(ctx):
    n = sum(x.iters for x in ctx["window"].records)
    return ctx["launches"] / n if n else None
