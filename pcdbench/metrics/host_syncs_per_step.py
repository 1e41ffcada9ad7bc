"""host_syncs_per_step: the program's host-sync counter (every wait of the
host for the device on the solve path: the time stepper's residual norms
and true residuals, FGMRES's Hessenberg columns, the coarse inverses) per
time step, over the program's counter ``unsteady_steps``, in the
spans-only pass (:mod:`pcdbench.spans`, pass (a)) (host launch path).
None where the program has no such counters or took no time step."""
from pcdbench import spans


def read(ctx):
    c = (spans.passes(ctx) or {}).get("counts", {})
    if not c.get("unsteady_steps") or "host_syncs" not in c:
        return None
    return c["host_syncs"] / c["unsteady_steps"]
