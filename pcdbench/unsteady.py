"""A span of time steps of the port's exact BDF2 loop as one request: what
the window drives for the unsteady configuration, and the judge that
decides ``correct``.

Set-up installs the seeded body force and advances ``lead_steps`` from the
impulsive start (the first of them the implicit-Euler startup), and keeps
the state ``w`` it reached and the velocity ``u_prev`` one step before.  A
request is ``UnsteadySolver.solve(span_steps * dt, w, u_prev0=u_prev,
picard_iters=...)`` from that pair: ``span_steps`` full BDF2 steps, the
same work on every request.  Its per-step ``callback`` marks the step
boundaries and keeps each step's state on the device, and its
``picard_callback`` keeps the velocity at which each step's last Oseen
solve was linearized; both come to the host once, after the span's last
step.

The judge reads every step of every request (:mod:`.reference.bdf2`), and
a record is ``ok`` where every state is finite and the true relative
residual of every linear solve reached the configuration's ``rtol_lin``.

    python3 -m pcdbench.unsteady --config cylinder-dfg2d2-l2 \\
        --seeds 11 12 13 [--lower 11] [--device cuda]

prints the readings for setting the limits, one JSON line each: the
configuration as it is run, one request after a one-step warm-up
(``sound``); every state of that request replaced by the span's start
(``unchanged``); and, for each seed of ``--lower``, the configuration
module's ``lower_precision``, the same loop in float32 (``program32``).
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

from .force import body_force
from .reference.bdf2 import SpanJudge


@dataclasses.dataclass
class Record:
    """One finished span: its time steps, FGMRES iterations, whether every
    linear solve reached the linear tolerance and every state is finite,
    the largest true relative residual of its linear solves, the state
    after every step (steps, n) and the wind of every step's last Oseen
    solve (steps, n_u), on the host."""
    steps: int
    iters: int
    ok: bool
    lin_rel_max: float
    states: np.ndarray
    winds: np.ndarray


class UnsteadyTarget:
    """``build`` makes the port's UnsteadySolver; the rest follows the
    configuration's ``problem``, ``solve`` and ``force`` objects."""

    def __init__(self, cfg: dict, build, device):
        self.cfg, self._build, self.device = cfg, build, device
        self.us = self.force = self._w0 = self._u_prev0 = None
        self._coords = self._mesh = self._start = None

    def build(self) -> None:
        self.us = self._build()
        asm = self.us.asm
        self._coords = (asm.W.V.dof_coords(), asm.W.Q.dof_coords())
        self._mesh = (np.array(asm.mesh.vertices), np.array(asm.mesh.cells))

    def _run(self, steps: int, w0=None, u_prev0=None, **hooks):
        s = self.cfg["solve"]
        return self.us.solve(steps * self.us.dt, w0, u_prev0=u_prev0,
                             picard_iters=s["picard_iters"], **hooks)

    def prepare(self, seed: int) -> None:
        """Install the seeded body force and advance ``lead_steps`` from the
        impulsive start; the pair reached starts every request."""
        f = self.cfg["force"]
        self.force = body_force(seed, self.us.asm.dim, f["amplitude"],
                                f["modes"], f["kmax"])
        self.us.asm.set_body_force(self.force)
        pair = [None, self.us.initial_state()]

        def keep(k, t, w):
            pair[:] = [pair[1], w]
        self._run(self.cfg["solve"]["lead_steps"], callback=keep)
        n_u = self.us.n_u
        self._w0, self._u_prev0 = pair[1], pair[0][:n_u].clone()
        host = lambda t: t.detach().to("cpu", torch.float64).numpy()
        self._start = (host(self._w0), host(self._u_prev0))

    def warmup(self, steps: int) -> None:
        """``steps`` time steps from the stored pair, on the cell's own
        shapes."""
        self._run(steps, self._w0, self._u_prev0)

    def solve(self, mark=None) -> Record:
        """One span; ``mark()`` at the end of every time step."""
        snaps, winds, n_u = [], {}, self.us.n_u

        def on_picard(k, i, w):
            winds[k] = w[:n_u].detach().clone()

        def on_step(k, t, w):
            snaps.append(w.detach().clone())
            winds.setdefault(k, w[:n_u])        # a step that solved nothing
            if mark is not None:
                mark()
        r = self._run(self.cfg["solve"]["span_steps"], self._w0,
                      self._u_prev0, callback=on_step,
                      picard_callback=on_picard)
        host = lambda ts: torch.stack(ts).to("cpu", torch.float64).numpy()
        states = host(snaps)
        wind = host([winds[k] for k in range(len(snaps))])
        lin = [float(v) for v in r.lin_rel]
        ok = (bool(np.all(np.isfinite(states)))
              and all(v <= self.cfg["solve"]["rtol_lin"] for v in lin))
        return Record(steps=len(r.linear_iters),
                      iters=int(sum(r.linear_iters)), ok=ok,
                      lin_rel_max=max(lin, default=0.0), states=states,
                      winds=wind)

    def free(self) -> None:
        """Drop the program's state (the judge runs after it); the
        coordinates of its dofs, its mesh and the span's start stay."""
        self.us = self._w0 = self._u_prev0 = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def judge(self, records, out=None) -> list:
        """The readings of every record, in order: the largest over its
        steps of each of the reference's readings, and the largest true
        relative residual of its linear solves (``lin_rel``).  Every step's
        readings are printed to ``out`` (default: standard output)."""
        out = sys.stdout if out is None else out
        p = self.cfg["problem"]
        j = SpanJudge(p, *self._mesh, self.force, float(p["dt"]),
                      device=self.device)
        j.layout(*self._coords)
        want = int(self.cfg["solve"]["span_steps"])
        readings = []
        for i, r in enumerate(records):
            steps = j.readings(*self._start, r.states, r.winds)
            steps += [{k: float("inf") for k in ("bc_err", "res_rel",
                                                 "cont_rel", "oseen_rel")}
                      ] * (want - len(steps))
            for k, s in enumerate(steps):
                print(f"judged request {i} step {k}: " + " ".join(
                    f"{n} {v!r}" for n, v in s.items()), file=out,
                    flush=True)
            readings.append(dict(
                {n: max(s[n] for s in steps) for n in steps[0]},
                lin_rel=r.lin_rel_max))
        return readings


# ---- the readings for setting the limits -------------------------------- #

def readings(cfg, mod, seeds, lower, device) -> list:
    out = []

    def line(**kw):
        out.append(kw)
        print(json.dumps(kw), flush=True)

    t = mod.target(cfg, device)
    t.build()
    for seed in seeds:
        t.prepare(seed)
        t.warmup(1)
        t0 = time.perf_counter()
        rec = t.solve()
        secs = time.perf_counter() - t0
        same = dataclasses.replace(rec, states=np.stack(
            [t._start[0]] * rec.steps))
        sound, unchanged = t.judge([rec, same], out=sys.stderr)
        line(kind="sound", seed=seed, steps=rec.steps, iters=rec.iters,
             converged=rec.ok, seconds=secs, **sound)
        line(kind="unchanged", seed=seed, converged=rec.ok, **unchanged)
    t.free()
    if lower:
        lo = UnsteadyTarget(cfg, lambda: mod.lower_precision(cfg, device),
                            device)
        lo.build()
        for seed in lower:
            lo.prepare(seed)
            t0 = time.perf_counter()
            rec = lo.solve()
            (r,) = lo.judge([rec], out=sys.stderr)
            line(kind="program32", seed=seed, steps=rec.steps,
                 iters=rec.iters, converged=rec.ok,
                 seconds=time.perf_counter() - t0, **r)
        lo.free()
    return out


def main(argv=None):
    from . import run as harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--lower", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness._cache_dirs()
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         args.config + ".json"))
    mod = harness.load_module(os.path.join(harness.HERE, "configs",
                                           args.config + ".py"),
                              "pcdbench_config_control")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "power_limit_w": harness._power_limit()}),
              flush=True)
    out = readings(cfg, mod, args.seeds, args.lower, dev)
    for kind in ("sound", "unchanged", "program32"):
        rows = [r for r in out if r["kind"] == kind]
        if rows:
            print(json.dumps({"kind": kind, "seeds": len(rows), **{
                k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                for k in ("bc_err", "res_rel", "cont_rel", "oseen_rel",
                          "lin_rel")}}),
                flush=True)


if __name__ == "__main__":
    main()
