"""step_residual_ms: the host milliseconds of the program's
``unsteady.residual`` spans (each BDF2 residual and the read of its norm)
per time step, over the program's counter ``unsteady_steps``, in the
spans-only pass (:mod:`pcdbench.spans`, pass (a)) (time stepper).  None
where the program has no such span or counter."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx) or {}
    steps = p.get("counts", {}).get("unsteady_steps")
    row = p.get("host", {}).get("unsteady.residual")
    if not steps or not row:
        return None
    return row[1] / steps * 1e3
