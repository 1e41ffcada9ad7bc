"""step_build_ms: the host milliseconds of the program's ``oseen.build``
span per Picard step in the spans-only pass (:mod:`pcdbench.spans`, pass
(a)): the step's operator values, Kp, the velocity hierarchy's values and
the coarse inverse, with the host syncs inside it (assembly)."""
from pcdbench import spans


def read(ctx):
    p = spans.passes(ctx)
    row = (p or {}).get("host", {}).get("oseen.build")
    if not row or not row[0]:
        return None
    return row[1] / row[0] * 1e3
