"""spmv_roofline_pct: the least time of every sparse product of the profiled
requests (pcdbench/roofline.py, from the operators' entries) over the
device time of the kernels those calls launched (the device events
inside the scopes' annotations), in percent."""


def read(ctx):
    p = ctx["profile"]
    if not p:
        return None
    dev = p["spmv_device_s"]
    return 100.0 * p["least_s"] / dev if dev > 0 else None
