"""fenapack_tpu_torch: the PyTorch and CUDA port of fenapack_tpu.

PCD-preconditioned Navier-Stokes solvers on an NVIDIA GPU: host-side mesh
and dofmap setup, static-sparsity Taylor-Hood assembly, ELL and block-sparse
(BSR) operators applied by hand-written CUDA kernels, flexible GMRES around
the upper Schur fieldsplit with PCD-BRM1/BRM2 (enclosed flow included),
geometric multigrid and dense subsolves, Picard and Newton drivers (with
Anderson mixing on the Picard full solve) and the model entry points
(``models``).  The JAX package ``fenapack_tpu`` is the reference; the
layout of this package mirrors it module by module.

This package imports ``torch``, ``numpy`` and (for host setup) ``scipy``,
never ``jax``.
"""

from .fem.mesh import (TriMesh, rectangle_mesh, box_union_mesh,
                       backward_step_mesh, cavity_mesh, refine_uniform, WALL,
                       INFLOW, OUTFLOW)
from .fem.dofmap import TaylorHood, DirichletBC, merge_bcs
from .fem.assemble import NSAssembler, ConstOperators
from .ops.sparse import (ELL, BlockELL, SparsityPattern, BlockSparsityPattern,
                         pattern_from_dofmaps)
from .solvers.config import (SolverConfig, KrylovConfig, PCDConfig,
                             SubsolveConfig, MultigridConfig, VelocityConfig,
                             override, overrides)
from .solvers.krylov import fgmres, FGMRESResult
from .solvers.pcd import make_pcd_apply
from .solvers.fieldsplit import make_fieldsplit_upper
from .solvers.oseen import OseenSolver
from .solvers.nonlinear import (NonlinearSolver, NonlinearResult,
                                FullSolveResult)
from .solvers import gmg
from . import models

__version__ = "0.1.0"

__all__ = [
    "TriMesh", "rectangle_mesh", "box_union_mesh", "backward_step_mesh",
    "cavity_mesh", "refine_uniform", "WALL", "INFLOW", "OUTFLOW",
    "TaylorHood", "DirichletBC", "merge_bcs", "NSAssembler",
    "ConstOperators", "ELL", "BlockELL", "SparsityPattern",
    "BlockSparsityPattern", "pattern_from_dofmaps",
    "SolverConfig", "KrylovConfig", "PCDConfig", "SubsolveConfig",
    "MultigridConfig", "VelocityConfig", "override", "overrides", "fgmres",
    "FGMRESResult", "make_pcd_apply", "make_fieldsplit_upper", "OseenSolver",
    "NonlinearSolver", "NonlinearResult", "FullSolveResult", "gmg", "models",
]
