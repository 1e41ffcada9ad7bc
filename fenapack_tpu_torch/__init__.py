"""fenapack_tpu_torch: the PyTorch and CUDA port of fenapack_tpu.

PCD-preconditioned Navier-Stokes solvers on an NVIDIA GPU: host-side mesh
and dofmap setup (triangles and tets), static-sparsity Taylor-Hood assembly
summed in a fixed order, ELL and block-sparse (BSR) operators applied by
hand-written CUDA kernels, flexible GMRES around the upper Schur
fieldsplit with PCD-BRM1/BRM2 (enclosed flow included), geometric
multigrid, dense and factorization-free subsolves, Picard and Newton
drivers (with Anderson mixing on the Picard full solve, damping on the
others), GCRO-DR recycling across solves, SUPG streamline diffusion
(system and preconditioner), theta-scheme and BDF2 time stepping,
drag/lift functionals, mixed-precision iterative refinement, batched
right-hand sides, VTK export and stage timers, the model entry points
(``models``) and the custom-form API (the mini-UFL ``forms`` with ``PCDAssembler``,
``PCDKrylovSolver`` and ``PCDNewtonSolver``).  The JAX package
``fenapack_tpu`` is the reference; the layout of this package mirrors it
module by module.

This package imports ``torch``, ``numpy`` and (for host setup) ``scipy``,
never ``jax``.
"""

from .fem.mesh import (TriMesh, rectangle_mesh, box_union_mesh,
                       backward_step_mesh, cavity_mesh, channel_mesh,
                       obstacle_channel_mesh, cylinder_channel_mesh,
                       triangle_quality, snap_to_circle, refine_uniform, WALL,
                       INFLOW, OUTFLOW, CYLINDER)
from .fem.mesh3d import (TetMesh, box_mesh, box_union_mesh3d,
                         refine_uniform3d, backward_step_mesh3d,
                         channel_mesh3d)
from .fem.dofmap import TaylorHood, DirichletBC, merge_bcs
from .fem.assemble import NSAssembler, ConstOperators
from .ops.sparse import (ELL, BlockELL, SparsityPattern, BlockSparsityPattern,
                         pattern_from_dofmaps)
from .solvers.config import (SolverConfig, KrylovConfig, PCDConfig,
                             SubsolveConfig, MultigridConfig, VelocityConfig,
                             override, overrides, env_overrides)
from .solvers.krylov import (fgmres, fgmres_dr, FGMRESResult, RecycleSpace,
                             empty_recycle, refresh_recycle)
from .solvers.pcd import make_pcd_apply
from .solvers.fieldsplit import make_fieldsplit_upper
from .solvers.oseen import OseenSolver
from .solvers.nonlinear import (NonlinearSolver, NonlinearResult,
                                FullSolveResult)
from .solvers.unsteady import UnsteadySolver, UnsteadyResult
from .solvers.custom import PCDAssembler, PCDKrylovSolver, PCDNewtonSolver
from .solvers import gmg
from .fem import forms
from .utils.functionals import (boundary_reaction, eval_p1, p1_point_weights,
                                make_device_functional)
from .utils.io import save_checkpoint, load_checkpoint, save_vtk
from .utils.timing import Timings, GLOBAL_TIMINGS, device_trace
from . import models

__version__ = "0.1.0"

__all__ = [
    "TriMesh", "rectangle_mesh", "box_union_mesh", "backward_step_mesh",
    "cavity_mesh", "channel_mesh", "obstacle_channel_mesh",
    "cylinder_channel_mesh", "triangle_quality", "snap_to_circle",
    "refine_uniform", "WALL", "INFLOW", "OUTFLOW", "CYLINDER",
    "TetMesh", "box_mesh", "box_union_mesh3d", "refine_uniform3d",
    "backward_step_mesh3d", "channel_mesh3d",
    "TaylorHood", "DirichletBC", "merge_bcs", "NSAssembler",
    "ConstOperators", "ELL", "BlockELL", "SparsityPattern",
    "BlockSparsityPattern", "pattern_from_dofmaps",
    "SolverConfig", "KrylovConfig", "PCDConfig", "SubsolveConfig",
    "MultigridConfig", "VelocityConfig", "override", "overrides",
    "env_overrides",
    "fgmres", "fgmres_dr", "FGMRESResult", "RecycleSpace", "empty_recycle",
    "refresh_recycle", "make_pcd_apply", "make_fieldsplit_upper",
    "OseenSolver",
    "NonlinearSolver", "NonlinearResult", "FullSolveResult",
    "UnsteadySolver", "UnsteadyResult", "PCDAssembler", "PCDKrylovSolver",
    "PCDNewtonSolver", "gmg", "forms", "models",
    "boundary_reaction", "eval_p1", "p1_point_weights",
    "make_device_functional", "save_checkpoint", "load_checkpoint",
    "save_vtk", "Timings", "GLOBAL_TIMINGS", "device_trace",
]
