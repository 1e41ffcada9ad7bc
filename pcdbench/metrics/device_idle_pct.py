"""device_idle_pct: the share of the untraced window in which the device
had nothing to run, in percent: 100 x (1 - the device's busy seconds per
request over the window's wall seconds per request).  The busy seconds
are the union of the device events' intervals over the traced requests,
which the profiler barely changes; the wall is the untraced window's,
since the profiler's host overhead stretches the traced requests' wall
(the traced window's length is ``device.window_s`` beside it)."""


def read(ctx):
    p, w = ctx["profile"], ctx["window"]
    if not p or not p["busy_s"] or not w.records:
        return None
    busy = p["busy_s"] / p["requests"]
    return 100.0 * (1.0 - busy / (w.wall_s / len(w.records)))
