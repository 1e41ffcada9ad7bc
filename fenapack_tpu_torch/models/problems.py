"""Canonical problem definitions, the port of
``fenapack_tpu/models/problems.py``.

Each problem is a small declarative class that builds the assembler,
boundary conditions and (optionally multigrid-equipped) solver in one call:

    from fenapack_tpu_torch.models import LidDrivenCavity
    nl = LidDrivenCavity(level=4, nu=1 / 100).solver(
        "BRM2", linearization="newton", gmg_subsolves=True)
    res = nl.solve(rtol=1e-5)

Every problem exposes ``mesh()``, ``assembler()``, ``bcs(asm)`` and
``solver(...)`` with dotted config overrides passed through
(``unsteady=dt`` returns a time stepper).  Operators are
stored in the ELL layout in the problem's dtype, as the JAX models build
them.  ``device`` defaults to ``"cuda"``: the entry points run on the card
unless the caller asks for the CPU.  3D problems (tet meshes, 1:8
refinement) assemble with quadrature degree 4, as the JAX models do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..fem import mesh as meshmod
from ..fem import mesh3d
from ..fem.assemble import NSAssembler
from ..fem.dofmap import DirichletBC
from ..solvers import gmg
from ..solvers.config import SolverConfig, overrides
from ..solvers.nonlinear import NonlinearSolver
from ..solvers.unsteady import UnsteadySolver

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

    def snap(self):
        """Optional in-place boundary-projection hook applied after each
        refinement (curved geometries; see ``mesh.snap_to_circle``)."""
        return None

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
        snap = self.snap()
        if gmg_levels is None:
            m = self._base_mesh()
            for _ in range(self.level):
                m = (meshmod.refine_uniform(m)[0] if m.vertices.shape[1] == 2
                     else mesh3d.refine_uniform3d(m)[0])
                if snap is not None:
                    snap(m)
            return m
        return gmg.build_hierarchy(self._base_mesh(),
                                   max(self.level, gmg_levels), snap=snap)

    def assembler(self, mesh=None, **asm_kw):
        m = self.mesh() if mesh is None else mesh
        kw = dict(dtype=_DTYPES[self.dtype], device=self.device)
        if self.dim == 3:
            kw["quad_degree"] = 4
        kw.update(asm_kw)
        return NSAssembler(m, self.nu, **kw)

    def bcs(self, asm):
        return [DirichletBC.velocity(asm.W, self.noslip_markers(),
                                     _zero(self.dim)),
                DirichletBC.velocity(asm.W, [self.inflow_marker()],
                                     self.inflow_profile())]

    def solver(self, pcd: str = "BRM2", linearization: str = "picard",
               gmg_subsolves: bool = False,
               unsteady: Optional[float] = None, theta: float = 1.0,
               scheme: str = "theta", asm=None, hier=None,
               **config_overrides):
        """Build the solver: a :class:`NonlinearSolver`, or with
        ``unsteady=dt`` an :class:`UnsteadySolver` (``scheme="bdf2"`` for
        the second-order stepper).  ``gmg_subsolves`` equips velocity and Ap
        multigrid hierarchies; without it both subsolves are dense LU.  To
        reuse a pre-built assembler on the multigrid path, pass the
        hierarchy it was built on too (``asm.mesh is hier.fine``).  The
        hierarchies take the solver's compute dtype (``dtype`` among the
        overrides: an f32 preconditioner around an f64 assembler built
        with ``block_dtype``)."""
        method = "gmg" if gmg_subsolves else "lu"
        over = {"pcd.variant": pcd, "dtype": self.dtype,
                "velocity.method": method, "pcd.ap.method": method,
                **config_overrides}
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
            dt = _DTYPES[over["dtype"]]
            ap_h = gmg.PressureHierarchy(
                hier, dt, device=self.device,
                pcd_markers=[marker] if marker else (), fine_asm=asm)
            v_h = gmg.VelocityHierarchy(
                hier, self.nu, dt, device=self.device,
                bc_markers=self.noslip_markers() + [self.inflow_marker()],
                fine_asm=asm)
        elif asm is None:
            asm = self.assembler()
        cfg = overrides(SolverConfig(), over)
        common = dict(pcd_marker=marker, linearization=linearization,
                      enclosed=self.enclosed(), ap_hierarchy=ap_h,
                      velocity_hierarchy=v_h)
        if unsteady is not None:
            return UnsteadySolver(asm, self.bcs(asm), cfg, dt=unsteady,
                                  theta=theta, scheme=scheme, **common)
        return NonlinearSolver(asm, self.bcs(asm), cfg, **common)


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


@dataclasses.dataclass
class Channel2D(_ProblemBase):
    """Straight channel (Poiseuille; unsteady workload of BASELINE config
    3)."""
    length: float = 4.0
    nu: float = 0.1

    def _base_mesh(self):
        return meshmod.channel_mesh(0, length=self.length)

    def inflow_profile(self):
        def f(x):
            v = np.zeros((x.shape[0], 2))
            v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
            return v
        return f


@dataclasses.dataclass
class ObstacleChannel2D(Channel2D):
    """Channel with a square obstacle (config 3 "channel/cylinder")."""
    length: float = 6.0
    nu: float = 0.02

    def _base_mesh(self):
        return meshmod.obstacle_channel_mesh(0, length=self.length)


@dataclasses.dataclass
class CylinderChannel2D(_ProblemBase):
    """Schafer-Turek "flow around a cylinder" channel (DFG 2D-1 / 2D-2;
    BASELINE config 3).

    Snapped-circle mesh: each refinement projects the new boundary vertices
    back onto the true circle (``mesh.snap_to_circle``), so the polygonal
    geometry error converges with the level.  ``u_mean`` sets the benchmark
    regime: 0.2 is Re = 20 (2D-1, steady), 1.0 is Re = 100 (2D-2,
    shedding), with nu fixed at 1e-3 by the benchmark's definition.  Entry
    point with the benchmark's settings: ``fenapack_tpu_torch.cylinder``.
    """
    nu: float = 0.001
    u_mean: float = 0.2          # mean inflow; the parabola's peak is 1.5x

    def _base_mesh(self):
        return meshmod.cylinder_channel_mesh(0)

    def snap(self):
        return meshmod.snap_to_circle

    def noslip_markers(self):
        return [meshmod.WALL, meshmod.CYLINDER]

    def inflow_profile(self):
        u_m = 1.5 * self.u_mean

        def f(x):
            v = np.zeros((x.shape[0], 2))
            v[:, 0] = 4.0 * u_m * x[:, 1] * (0.41 - x[:, 1]) / 0.41 ** 2
            return v
        return f


@dataclasses.dataclass
class StepFlow3D(_ProblemBase):
    """3D backward-facing step (BASELINE config 4):
    ``([-1,0]x[0,1] U [0,L]x[-1,1]) x [0,1]``, inflow ``16 y(1-y) z(1-z)``
    (peak 1) at x = -1, outflow at x = L.  Entry point with the config's
    settings: ``fenapack_tpu_torch.step3d``."""
    dim: int = 3
    nu: float = 0.05
    length: float = 3.0

    def _base_mesh(self):
        return mesh3d.backward_step_mesh3d(0, length=self.length)

    def inflow_profile(self):
        def f(x):
            v = np.zeros((x.shape[0], 3))
            v[:, 0] = 16.0 * x[:, 1] * (1 - x[:, 1]) * x[:, 2] * (1 - x[:, 2])
            return v
        return f


@dataclasses.dataclass
class Duct3D(StepFlow3D):
    """3D straight duct ``[0,L] x [0,1]^2`` (the 3D validation workload)."""
    nu: float = 0.1
    length: float = 2.0

    def _base_mesh(self):
        return mesh3d.channel_mesh3d(0, length=self.length)
