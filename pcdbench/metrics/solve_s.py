"""solve_s: seconds per request, the window's wall time over the requests it
completed (host clock, every request and all of the window)."""


def read(ctx):
    w = ctx["window"]
    return w.wall_s / len(w.records) if w.records else None
