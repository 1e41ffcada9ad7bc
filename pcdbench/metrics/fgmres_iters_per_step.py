"""fgmres_iters_per_step: the program's ``fgmres.iter`` spans (one outer
FGMRES iteration each) per time step in the spans-only pass
(:mod:`pcdbench.spans`, pass (a), whose requests are time integrations:
every such span lies inside an ``unsteady.step``), over the program's
counter ``unsteady_steps`` (Oseen solve).  None where the program has no
such counter or took no time step."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx) or {}
    steps = p.get("counts", {}).get("unsteady_steps")
    row = p.get("host", {}).get("fgmres.iter")
    if not steps or not row:
        return None
    return row[0] / steps
