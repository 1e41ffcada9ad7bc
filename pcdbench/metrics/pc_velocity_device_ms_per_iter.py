"""pc_velocity_device_ms_per_iter: the union of the device events launched
under the ``pc.velocity`` span (the velocity multigrid of the
preconditioner) in the span-profile pass (:mod:`pcdbench.spans`, pass
(b)), in ms per outer FGMRES iteration (preconditioner)."""
from pcdbench import spans


def read(ctx):
    return spans.device_ms_per_iter(ctx, "pc.velocity")
