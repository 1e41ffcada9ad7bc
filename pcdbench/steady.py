"""A steady solve of the port as one request: what the window drives for
the steady configurations, and the judge that decides ``correct``.

The request is ``NonlinearSolver.make_full_solve(...)`` of the solver
that the configuration's build call returns, with the configuration's
tolerances and caps, from the program's own start (the boundary values,
zero inside).  Its per-step ``callback`` is the one hook: it marks the
step boundaries, where the host already holds that step's residual.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from .force import body_force
from .reference.judge import Judge


@dataclasses.dataclass
class Record:
    """One finished solve: its Picard steps, FGMRES iterations, whether it
    reached the nonlinear tolerance within its cap of steps, the largest
    true relative residual of its linear solves, and its state on the
    host."""
    steps: int
    iters: int
    ok: bool
    lin_rel_max: float
    answer: np.ndarray


class SteadyTarget:
    """``build`` makes the port's NonlinearSolver; the rest follows the
    configuration's ``solve`` and ``force`` objects."""

    def __init__(self, cfg: dict, build, device):
        self.cfg, self._build, self.device = cfg, build, device
        self.nl = self.force = self._full = self._w0 = None
        self._coords = self._mark = None

    def build(self) -> None:
        self.nl = self._build()
        W = self.nl.asm.W
        self._coords = (W.V.dof_coords(), W.Q.dof_coords())

    def prepare(self, seed: int, **over) -> None:
        """Install the seeded body force and make the solve (``over``:
        settings of the configuration's ``solve`` replaced)."""
        f = self.cfg["force"]
        self.force = body_force(seed, self.nl.asm.dim, f["amplitude"],
                                f["modes"], f["kmax"])
        self.nl.asm.set_body_force(self.force)
        self._full = self._make(**over)
        self._w0 = self.nl.initial_state().to(torch.float64)

    def _make(self, **over):
        s = dict(self.cfg["solve"], **over)
        return self.nl.make_full_solve(
            rtol=s["rtol"], rtol_lin=s["rtol_lin"], max_steps=s["max_steps"],
            anderson=s["anderson"], callback=self._on_step)

    def _on_step(self, *_):
        if self._mark is not None:
            self._mark()

    def warmup(self, steps: int) -> None:
        """``steps`` Picard steps on the cell's own shapes."""
        self._make(max_steps=steps)(self._w0)

    def solve(self, mark=None) -> Record:
        """One full solve; ``mark()`` at the end of every Picard step."""
        self._mark = mark
        try:
            r = self._full(self._w0)
        finally:
            self._mark = None
        lin = max(r.lin_rel) if r.lin_rel else 0.0
        return Record(steps=len(r.iters), iters=int(sum(r.iters)),
                      ok=bool(r.converged), lin_rel_max=float(lin),
                      answer=r.w.detach().to("cpu", torch.float64).numpy())

    def free(self) -> None:
        """Drop the program's state (the judge runs after it); the
        coordinates of its dofs stay."""
        self.nl = self._full = self._w0 = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def judge(self, records) -> list:
        """The readings of every answer, in order: the reference's, and
        the largest true relative residual of its linear solves (``lin_rel``,
        the configuration's linear tolerance)."""
        j = Judge(self.cfg["problem"], self.force, device=self.device)
        j.layout(*self._coords)
        return [dict(j.readings(r.answer), lin_rel=r.lin_rel_max)
                for r in records]
