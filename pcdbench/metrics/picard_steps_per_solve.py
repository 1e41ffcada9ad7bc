"""picard_steps_per_solve: nonlinear steps per request, from each result's
steps, averaged over the window (nonlinear driver)."""


def read(ctx):
    r = ctx["window"].records
    return sum(x.steps for x in r) / len(r) if r else None
