"""Canonical problem definitions, the port of
``fenapack_tpu/models/problems.py`` (2D steady problems).

Each problem is a small declarative class that builds the assembler,
boundary conditions and (optionally multigrid-equipped) solver in one call:

    from fenapack_tpu_torch.models import LidDrivenCavity
    nl = LidDrivenCavity(level=4, nu=1 / 100).solver(
        "BRM2", linearization="newton", gmg_subsolves=True)
    res = nl.solve(rtol=1e-5)

Every problem exposes ``mesh()``, ``assembler()``, ``bcs(asm)`` and
``solver(...)`` with dotted config overrides passed through.  Operators are
stored in the ELL layout in the problem's dtype, as the JAX models build
them.  ``device`` defaults to ``"cuda"``: the entry points run on the card
unless the caller asks for the CPU.  Unsteady solvers and 3D problems are
not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem import mesh as meshmod
from ..fem.assemble import NSAssembler
from ..fem.dofmap import DirichletBC
from ..solvers import gmg
from ..solvers.config import SolverConfig, overrides
from ..solvers.nonlinear import NonlinearSolver

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _zero(d):
    return lambda x: np.zeros((x.shape[0], d))


@dataclasses.dataclass
class _ProblemBase:
    level: int = 0
    nu: float = 0.02
    dtype: str = "float64"
    dim: int = 2
    device: str = "cuda"

    # -- overridable pieces -------------------------------------------- #
    def _base_mesh(self):
        raise NotImplementedError

    def inflow_profile(self):
        raise NotImplementedError

    def inflow_marker(self):
        return meshmod.INFLOW

    def noslip_markers(self):
        return [meshmod.WALL]

    def enclosed(self) -> bool:
        return False

    def pcd_marker_for(self, variant: str):
        """Facet marker carrying the pressure Dirichlet rows, None for none
        (the one place that decides it: the solver and the pressure
        hierarchy take what this returns)."""
        if self.enclosed():
            return meshmod.INFLOW if variant == "BRM1" else None
        return meshmod.INFLOW if variant == "BRM1" else meshmod.OUTFLOW

    # -- construction -------------------------------------------------- #
    def mesh(self, gmg_levels: Optional[int] = None):
        """The problem mesh (level ``level``), or with ``gmg_levels`` the
        multigrid hierarchy whose fine mesh it is."""
        if self.dim != 2:
            raise NotImplementedError("3D problems are not ported yet")
        if gmg_levels is None:
            m = self._base_mesh()
            for _ in range(self.level):
                m = meshmod.refine_uniform(m)[0]
            return m
        return gmg.build_hierarchy(self._base_mesh(),
                                   max(self.level, gmg_levels))

    def assembler(self, mesh=None, **asm_kw):
        m = self.mesh() if mesh is None else mesh
        kw = dict(dtype=_DTYPES[self.dtype], device=self.device)
        kw.update(asm_kw)
        return NSAssembler(m, self.nu, **kw)

    def bcs(self, asm):
        return [DirichletBC.velocity(asm.W, self.noslip_markers(),
                                     _zero(self.dim)),
                DirichletBC.velocity(asm.W, [self.inflow_marker()],
                                     self.inflow_profile())]

    def solver(self, pcd: str = "BRM2", linearization: str = "picard",
               gmg_subsolves: bool = False,
               unsteady: Optional[float] = None, asm=None, hier=None,
               **config_overrides) -> NonlinearSolver:
        """Build the solver.  ``gmg_subsolves`` equips velocity and Ap
        multigrid hierarchies; without it both subsolves are dense LU.  To
        reuse a pre-built assembler on the multigrid path, pass the
        hierarchy it was built on too (``asm.mesh is hier.fine``)."""
        if unsteady is not None:
            raise NotImplementedError("unsteady solvers are not ported yet")
        method = "gmg" if gmg_subsolves else "lu"
        over = {"pcd.variant": pcd, "dtype": self.dtype,
                "velocity.method": method, "pcd.ap.method": method}
        marker = self.pcd_marker_for(pcd)
        ap_h = v_h = None
        if gmg_subsolves:
            if hier is None:
                if asm is not None:
                    raise ValueError(
                        "gmg_subsolves with a user asm needs the hierarchy"
                        " it was built on: pass hier= as well")
                hier = self.mesh(gmg_levels=self.level)
            asm = self.assembler(hier.fine) if asm is None else asm
            dt = _DTYPES[self.dtype]
            ap_h = gmg.PressureHierarchy(
                hier, dt, device=self.device,
                pcd_markers=[marker] if marker else (), fine_asm=asm)
            v_h = gmg.VelocityHierarchy(
                hier, self.nu, dt, device=self.device,
                bc_markers=self.noslip_markers() + [self.inflow_marker()],
                fine_asm=asm)
        elif asm is None:
            asm = self.assembler()
        over.update(config_overrides)
        cfg = overrides(SolverConfig(), over)
        return NonlinearSolver(asm, self.bcs(asm), cfg, pcd_marker=marker,
                               linearization=linearization,
                               enclosed=self.enclosed(),
                               ap_hierarchy=ap_h, velocity_hierarchy=v_h)


@dataclasses.dataclass
class StepFlow2D(_ProblemBase):
    """2D backward-facing step (the reference demo; BASELINE config 1)."""
    length: float = 5.0

    def _base_mesh(self):
        return meshmod.backward_step_mesh(0, length=self.length)

    def inflow_profile(self):
        def f(x):
            v = np.zeros((x.shape[0], 2))
            v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
            return v
        return f


@dataclasses.dataclass
class LidDrivenCavity(_ProblemBase):
    """Lid-driven cavity (enclosed flow; BASELINE config 2)."""
    nu: float = 0.002            # Re = 500

    def _base_mesh(self):
        return meshmod.cavity_mesh(0)

    def enclosed(self):
        return True

    def inflow_profile(self):
        def lid(x):
            v = np.zeros((x.shape[0], 2))
            v[:, 0] = 1.0
            return v
        return lid
