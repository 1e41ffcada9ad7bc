"""Readings of the comparison that decides ``correct``, for setting its
limits: the program's sound runs on many seeds and its controls, in one
process.  The benchmark's own runs never run this.

    python3 -m pcdbench.control --config step2d-brm2-l2 \\
        --seeds 11 12 13 ... [--lower 11 12 13] [--device cuda]

For every seed of ``--seeds``: the configuration as it is run, one full
solve after a one-step warm-up, judged by the reference (``sound``); and
its answer carried in float32 (``round32``: the sound state rounded to
float32, the least error that any float32 state has).  For every seed of
``--lower``: the program's own float32 path (``program32``: the
configuration's problem built with its state, residual and Krylov solve
in float32, from the configuration module's ``lower_precision``), judged
the same way.  One JSON line per reading.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import run as harness
from .steady import SteadyTarget


def _line(**kw):
    print(json.dumps(kw), flush=True)


def readings(cfg, mod, seeds, lower, device) -> list:
    out = []
    t = mod.target(cfg, device)
    t.build()
    for seed in seeds:
        t.prepare(seed)
        t.warmup(1)
        t0 = time.perf_counter()
        rec = t.solve()
        secs = time.perf_counter() - t0
        r32 = dataclasses.replace(rec, answer=rec.answer.astype(np.float32)
                                  .astype(np.float64))
        sound, rnd = t.judge([rec, r32])
        out.append(dict(kind="sound", seed=seed, steps=rec.steps,
                        iters=rec.iters, converged=rec.ok, seconds=secs,
                        **sound))
        out.append(dict(kind="round32", seed=seed, converged=rec.ok,
                        **rnd))
        _line(**out[-2])
        _line(**out[-1])
    t.free()
    if lower:
        lo = SteadyTarget(cfg, lambda: mod.lower_precision(cfg, device),
                          device)
        lo.build()
        for seed in lower:
            # the program's Anderson mixing fails on a float32 state
            lo.prepare(seed, anderson=0)
            t0 = time.perf_counter()
            rec = lo.solve()
            (r,) = lo.judge([rec])
            out.append(dict(kind="program32", seed=seed, steps=rec.steps,
                            iters=rec.iters, converged=rec.ok,
                            seconds=time.perf_counter() - t0, **r))
            _line(**out[-1])
        lo.free()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--lower", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness._cache_dirs()
    data = harness.HERE
    cfg = harness.load_json(os.path.join(data, "configs",
                                         args.config + ".json"))
    mod = harness.load_module(os.path.join(data, "configs",
                                           args.config + ".py"),
                              "pcdbench_config_control")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        _line(device=torch.cuda.get_device_name(0),
              power_limit_w=harness._power_limit())
    out = readings(cfg, mod, args.seeds, args.lower, dev)
    for kind in ("sound", "round32", "program32"):
        rows = [r for r in out if r["kind"] == kind]
        if rows:
            _line(kind=kind, seeds=len(rows), **{
                k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                for k in ("bc_err", "res_rel", "cont_rel", "lin_rel")})


if __name__ == "__main__":
    main()
