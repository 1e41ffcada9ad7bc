"""picard_iters_per_step: Picard iterations (Oseen solves) per time step,
the program's counters ``unsteady_picard_iters`` over ``unsteady_steps``
in the spans-only pass (:mod:`pcdbench.spans`, pass (a): the window's own
requests, the profiler off) (time stepper).  None where the program has no
such counters or took no time step."""
from pcdbench import spans


def read(ctx):
    c = (spans.passes(ctx) or {}).get("counts", {})
    if not c.get("unsteady_steps") or "unsteady_picard_iters" not in c:
        return None
    return c["unsteady_picard_iters"] / c["unsteady_steps"]
