"""device_events_per_iter: every device event of the profiled requests
(kernels, copies, sets) over their outer FGMRES iterations (host launch
path)."""


def read(ctx):
    p = ctx["profile"]
    if not p or not p["iters"] or not p["device_events"]:
        return None
    return p["device_events"] / p["iters"]
