"""step_p95_ms: the 95th percentile (linear interpolation) of the wall time
of every step of every request in the window (host clock, between the
program's step marks)."""
import numpy as np


def read(ctx):
    s = ctx["window"].step_s
    return float(np.percentile(s, 95)) * 1e3 if s else None
