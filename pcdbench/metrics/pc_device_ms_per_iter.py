"""pc_device_ms_per_iter: the union of the device events launched under
the program's ``pc`` span (the preconditioner apply of an FGMRES
iteration) in the span-profile pass (:mod:`pcdbench.spans`, pass (b)),
in ms per outer FGMRES iteration (preconditioner)."""
from pcdbench import spans


def read(ctx):
    return spans.device_ms_per_iter(ctx, "pc")
