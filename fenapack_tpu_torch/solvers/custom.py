"""User-supplied-form PCD solver: the ``PCDAssembler`` API of the reference.

The port of ``fenapack_tpu/solvers/custom.py``, which mirrors
``fenapack/assembling.py::PCDAssembler`` and
``fenapack/nonlinear_solvers.py::PCDNonlinearProblem`` for problems whose
variational forms differ from the built-in Navier-Stokes ones: the user
writes forms in the :mod:`fenapack_tpu_torch.fem.forms` language (J, F, an
optional J_pc, and the PCD forms ``mp, ap, kp`` or ``fp``), and this module
assembles them into the solve the built-in path uses (FGMRES around the
upper Schur fieldsplit with PCD).

Lifecycle as the reference's ``PCDForm`` flags: forms without coefficients
(``mp``, ``ap``) and ``gp`` are assembled once at construction;
coefficient-dependent forms (``J``, ``J_pc``, ``kp``, ``fp``) at every
nonlinear iterate.  The ``fp`` form selects the non-factored PCD apply
``-Mp^{-1} Fp Ap^{-1}`` (BRM1 only).  ``gp`` (the pressure-gradient form)
follows the reference's B^T-from-form semantics: the fieldsplit's gradient
application uses the operator assembled from ``gp`` instead of the system
matrix's up-block.

Subsolves: the velocity block by a dense inverse (``lu``, the default),
``jacobi`` (omega 0.7) or ``chebyshev`` sweeps; Ap and Mp by a dense
inverse, the lumped mass inverse or Chebyshev.  :data:`DEFAULT_CONFIG`
holds the JAX package's defaults (dense velocity and Ap inverses,
Chebyshev-4 Mp).  Every sparse product is ``ELL.mv``: the K3 kernel on a
CUDA tensor.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..fem import forms as F
from ..fem.dofmap import DirichletBC, TaylorHood, merge_bcs
from ..ops import subsolve
from .config import SolverConfig, overrides
from .fieldsplit import make_fieldsplit_upper
from .krylov import FGMRESResult, fgmres
from .pcd import make_pcd_apply

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

# the JAX package's defaults for custom-form problems: dense velocity and
# Ap inverses (this port's SolverConfig defaults to multigrid, which needs
# the hierarchies of the built-in path)
DEFAULT_CONFIG = overrides(SolverConfig(), {"velocity.method": "lu",
                                            "pcd.ap.method": "lu"})


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PCDAssembler:
    """Collect user forms and assemble operators on demand.

    Parameters mirror the reference constructor (``PCDAssembler(a, L, bcs,
    a_pc=None, mp=..., ap=..., kp=..., fp=..., gp=..., bcs_pcd=[...])``);
    ``w`` names the coefficient carrying the current nonlinear iterate
    inside the forms.  ``coefficients`` maps the names of further fixed
    coefficients (body forces, material fields) to mixed-space dof values
    (tensors or arrays), merged into every assembly.  Everything lives on
    ``device``.
    """

    def __init__(self, a: F.Form, L: F.Form, bcs: Sequence[DirichletBC],
                 a_pc: Optional[F.Form] = None,
                 mp: Optional[F.Form] = None, ap: Optional[F.Form] = None,
                 kp: Optional[F.Form] = None, fp: Optional[F.Form] = None,
                 gp: Optional[F.Form] = None,
                 bcs_pcd: Sequence[DirichletBC] = (),
                 w: Optional[F.Coefficient] = None,
                 W: Optional[TaylorHood] = None,
                 coefficients: Optional[Dict[str, object]] = None,
                 quad_degree: int = 5, dtype=torch.float64,
                 device="cuda"):
        if W is None:
            if w is None:
                raise ValueError("pass W or a coefficient w to infer it")
            W = w.W
        self.W = W
        self.w = w
        self.device = torch.device(device)
        self.fc = F.FormCompiler(W, quad_degree=quad_degree, dtype=dtype,
                                 device=self.device)
        self.dtype = dtype
        self._a, self._L, self._a_pc = a, L, a_pc
        self._mp, self._ap, self._kp = mp, ap, kp
        self._fp, self._gp = fp, gp
        self.bcs = list(bcs)
        self.bcs_pcd = list(bcs_pcd)
        self.coefficients = {
            k: torch.as_tensor(v, dtype=dtype, device=self.device)
            for k, v in (coefficients or {}).items()}

        # constant forms: assembled once (the PCDForm const flag)
        self._mp_vals = (self.fc.assemble_block(mp, "p", "p",
                                                coeffs=self.coefficients)
                         if mp is not None else None)
        self._ap_vals = (self.fc.assemble_block(ap, "p", "p",
                                                coeffs=self.coefficients)
                         if ap is not None else None)

    # ------------------------------------------------------------- #
    def function_space(self) -> TaylorHood:
        return self.W

    def _coeffs(self, x) -> Dict[str, torch.Tensor]:
        c = dict(self.coefficients)
        if self.w is not None:
            c[self.w.name] = x
        return c

    def system_matrix(self, x) -> Dict[str, torch.Tensor]:
        """Block values of J(x): keys 'uu', 'up', 'pu', 'pp'."""
        c = self._coeffs(x)
        fc = self.fc
        return {
            "uu": fc.assemble_block(self._a, "u", "u", coeffs=c),
            "up": fc.assemble_block(self._a, "u", "p", coeffs=c),
            "pu": fc.assemble_block(self._a, "p", "u", coeffs=c),
            "pp": fc.assemble_block(self._a, "p", "p", coeffs=c),
        }

    def pc_matrix(self, x) -> Optional[torch.Tensor]:
        """uu-block values of J_pc (None if no separate PC form given)."""
        if self._a_pc is None:
            return None
        return self.fc.assemble_block(self._a_pc, "u", "u",
                                      coeffs=self._coeffs(x))

    def rhs_vector(self, x) -> torch.Tensor:
        """Residual vector F(x) (the reference's rhs is -F with the BC rows
        handled by the Newton loop; the masking matches the built-in path)."""
        c = self._coeffs(x)
        ru = self.fc.assemble_vector(self._L, "u", coeffs=c)
        rp = self.fc.assemble_vector(self._L, "p", coeffs=c)
        return torch.cat([ru, rp])

    def ap(self) -> Optional[torch.Tensor]:
        return self._ap_vals

    def mp(self) -> Optional[torch.Tensor]:
        return self._mp_vals

    def kp(self, x) -> Optional[torch.Tensor]:
        if self._kp is None:
            return None
        return self.fc.assemble_block(self._kp, "p", "p",
                                      coeffs=self._coeffs(x))

    def fp(self, x) -> Optional[torch.Tensor]:
        if self._fp is None:
            return None
        return self.fc.assemble_block(self._fp, "p", "p",
                                      coeffs=self._coeffs(x))

    def gp(self) -> Optional[torch.Tensor]:
        if self._gp is None:
            return None
        return self.fc.assemble_block(self._gp, "u", "p",
                                      coeffs=self.coefficients)

    def pcd_bcs(self) -> Sequence[DirichletBC]:
        return self.bcs_pcd


class PCDKrylovSolver:
    """FGMRES around the upper Schur fieldsplit with PCD over a
    :class:`PCDAssembler`: the generic-form counterpart of
    :class:`fenapack_tpu_torch.solvers.oseen.OseenSolver` and of the
    reference's ``fenapack/field_split.py::PCDKrylovSolver``.  The operators
    come from the assembler's user forms instead of the built-in factored
    assembly.

    Each dense velocity inverse is timed (``inverse_seconds``, host clock
    between device synchronisations).  Matrix products run in full
    precision: building a solver turns TF32 off, as ``OseenSolver`` does.
    """

    def __init__(self, assembler: PCDAssembler,
                 config: SolverConfig = DEFAULT_CONFIG):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.asm = assembler
        self.config = config
        W = assembler.W
        self.W = W
        self.n_u = W.dim_u
        self.n = W.dim
        self.dtype = dt = _DTYPES[config.dtype]
        self.device = dev = assembler.device
        fc = assembler.fc
        self.inverse_seconds: List[float] = []

        bc_mask_u, bc_vals_u = merge_bcs(assembler.bcs, self.n_u)
        self.bc_mask_u = torch.as_tensor(bc_mask_u, dtype=dt, device=dev)
        self.bc_vals_u = torch.as_tensor(bc_vals_u, dtype=dt, device=dev)
        self.free_u = 1.0 - self.bc_mask_u

        pcd_dofs = np.concatenate(
            [bc.dofs for bc in assembler.bcs_pcd]) if assembler.bcs_pcd \
            else np.zeros(0, np.int32)
        mask_p = np.zeros(W.dim_p)
        mask_p[pcd_dofs] = 1.0
        self.has_pcd_bcs = pcd_dofs.shape[0] > 0
        self.pcd_mask = (torch.as_tensor(mask_p, dtype=dt, device=dev)
                         if self.has_pcd_bcs else None)
        self._nullspace = not self.has_pcd_bcs

        # gp: the fieldsplit's gradient application z_u = A^{-1}(r_u - B^T
        # z_p) uses the operator of the user's gp form instead of the
        # system matrix's up-block, so the preconditioner can differ from J
        # (e.g. J carries stabilization terms that should not enter the
        # Schur composition).  Constant lifecycle: assembled once.
        gp_vals = assembler.gp()
        self._gp_op = (fc.pattern("u", "p").matrix(gp_vals.to(dt))
                       if gp_vals is not None else None)

        # constant pressure subsolves (built once)
        self._ap_solve = self._spd_solver(
            assembler.ap(), self.pcd_mask, config.pcd.ap,
            nullspace=self._nullspace)
        self._mp_solve = self._spd_solver(
            assembler.mp(), None, config.pcd.mp)

    # ------------------------------------------------------------- #
    def _spd_solver(self, vals, mask, cfg, nullspace: bool = False):
        if vals is None:
            return None
        pat = self.asm.fc.pattern("p", "p")
        dt = self.dtype
        ell = pat.matrix(vals.to(dt))
        if cfg.method == "lu":
            bc = (torch.zeros(ell.shape[0], dtype=dt, device=self.device)
                  if mask is None else mask)
            return subsolve.masked_spd_solver_dense(ell, pat, bc, dt,
                                                    nullspace=nullspace)
        if cfg.method == "lumped":
            dinv = subsolve.lumped_inverse(ell).to(dt)
            if mask is None:
                return lambda r: dinv * r
            free = 1.0 - mask
            return lambda r: free * dinv * r + mask * r
        if cfg.method == "chebyshev":
            diag = ell.diag_from(pat.diag_pos).to(dt)
            if mask is not None:
                diag = torch.where(mask > 0, torch.ones_like(diag), diag)
            dinv = 1.0 / diag
            mv = self._masked_mv(ell, mask)
            if cfg.bounds is not None:
                lmin, lmax = cfg.bounds
            else:
                lmin, lmax = subsolve.power_bounds(mv, dinv, ell.shape[0])
            return subsolve.chebyshev_solver(mv, dinv, lmin, lmax, cfg.iters)
        raise ValueError(f"unsupported subsolve {cfg.method!r} for "
                         "custom-form problems")

    @staticmethod
    def _masked_mv(ell, mask):
        if mask is None:
            return ell.mv
        free = 1.0 - mask

        def mv(x):
            return free * ell.mv(free * x) + mask * x
        return mv

    # ------------------------------------------------------------- #
    def _block_matvec(self, blocks):
        fc = self.asm.fc
        n_u = self.n_u
        Auu = fc.pattern("u", "u").matrix(blocks["uu"].to(self.dtype))
        Aup = fc.pattern("u", "p").matrix(blocks["up"].to(self.dtype))
        Apu = fc.pattern("p", "u").matrix(blocks["pu"].to(self.dtype))
        App = fc.pattern("p", "p").matrix(blocks["pp"].to(self.dtype))
        free_u, bc_u = self.free_u, self.bc_mask_u

        def matvec(x):
            xu = free_u * x[:n_u]
            p = x[n_u:]
            yu = free_u * (Auu.mv(xu) + Aup.mv(p)) + bc_u * x[:n_u]
            yp = Apu.mv(xu) + App.mv(p)
            return torch.cat([yu, yp])
        return matvec, Auu

    def _velocity_solver(self, Auu, pc_vals):
        cfg = self.config.velocity
        pat = self.asm.fc.pattern("u", "u")
        vals = pc_vals.to(self.dtype) if pc_vals is not None else Auu.vals
        if cfg.method == "lu":
            _sync(self.device)
            t0 = time.perf_counter()
            # masked in place: free A free + I_bc without another n^2 copy
            A = pat.to_dense(vals)
            A.mul_(self.free_u[:, None]).mul_(self.free_u[None, :])
            A.diagonal().add_(self.bc_mask_u)
            Ainv = torch.linalg.inv(A)
            del A
            _sync(self.device)
            self.inverse_seconds.append(time.perf_counter() - t0)
            return lambda r: Ainv @ r
        if cfg.method in ("jacobi", "chebyshev"):
            op = pat.matrix(vals)
            diag = op.diag_from(pat.diag_pos)
            diag = torch.where(self.bc_mask_u > 0, torch.ones_like(diag),
                               diag)
            dinv = 1.0 / diag
            mv = self._masked_mv(op, self.bc_mask_u)
            if cfg.method == "jacobi":
                iters, omega = cfg.iters, 0.7

                def solve(b):
                    x = omega * dinv * b
                    for _ in range(iters - 1):
                        x = x + omega * dinv * (b - mv(x))
                    return x
                return solve
            bounds = cfg.bounds or (0.1, 2.0)
            return subsolve.chebyshev_solver(mv, dinv, bounds[0], bounds[1],
                                             cfg.iters)
        raise ValueError(f"unsupported velocity method {cfg.method!r}")

    def _pcd_apply(self, x):
        """PCD Schur solve closure for the current iterate ``x``."""
        asm = self.asm
        variant = self.config.pcd.variant
        pat = asm.fc.pattern("p", "p")
        if asm._fp is not None:
            # non-factored apply with the user's full Fp form:
            # S^{-1} ~= -Mp^{-1} Fp Ap^{-1} (Kay-Loghin-Wathen order).
            # BRM1 only: BRM2's Olshanskii-Vassilevski variant is factored
            # (its exact nu Ap Ap^{-1} = I folding interacts with the
            # outflow BC rows; the raw Fp there degrades the preconditioner
            # badly, a stall at 100 iterations in the JAX package)
            if variant != "BRM1":
                raise ValueError("fp form is only supported with BRM1")
            fp = pat.matrix(asm.fp(x).to(self.dtype))
            ap_solve, mp_solve = self._ap_solve, self._mp_solve
            mask = self.pcd_mask
            chop = ((lambda r: r) if mask is None
                    else (lambda r: (1.0 - mask) * r))

            def schur(r):
                w1 = ap_solve(chop(r))
                z = fp.mv(w1)
                if mask is not None:
                    # repair the bc rows: the masked Ap solve reproduces
                    # chop(r) only on free rows; (Fp w1)_bc is unrelated to
                    # the factored apply's r_bc, and Mp^{-1} would spread
                    # the difference over the whole domain
                    z = z + mask * (r - z)
                return -mp_solve(z)
            return schur
        kp = pat.matrix(asm.kp(x).to(self.dtype))
        apply = make_pcd_apply(variant, self._ap_solve, self._mp_solve,
                               self.pcd_mask, nullspace=self._nullspace)
        return lambda r: apply(kp, r)

    # ------------------------------------------------------------- #
    def system(self, x_lin: torch.Tensor):
        """``(matvec, pc)`` at the iterate ``x_lin``: the bc-masked J(x_lin)
        and the fieldsplit preconditioner."""
        x_lin = x_lin.to(self.dtype)
        blocks = self.asm.system_matrix(x_lin)
        matvec, Auu = self._block_matvec(blocks)
        a_solve = self._velocity_solver(Auu, self.asm.pc_matrix(x_lin))
        schur = self._pcd_apply(x_lin)
        if self._gp_op is not None:
            bt_mv = self._gp_op.mv       # B^T from the user's gp form
        else:
            bt_mv = self.asm.fc.pattern("u", "p").matrix(
                blocks["up"].to(self.dtype)).mv
        pc = make_fieldsplit_upper(self.n_u, a_solve, schur, bt_mv,
                                   self.free_u)
        return matvec, pc

    def solve(self, x_lin: torch.Tensor, b: torch.Tensor) -> FGMRESResult:
        """One linear solve: J(x_lin) dx = b."""
        return self._solve(x_lin, b)[0]

    def _solve(self, x_lin, b):
        cfg = self.config.krylov
        matvec, pc = self.system(x_lin)
        return fgmres(matvec, pc, b.to(self.dtype), maxiter=cfg.maxiter,
                      rtol=cfg.rtol), matvec


class PCDNewtonSolver:
    """The nonlinear solver over (PCDAssembler, PCDKrylovSolver), the generic
    counterpart of the reference's ``PCDNewtonSolver`` /
    ``PCDNonlinearProblem`` pair.  Picard against Newton is chosen by which
    bilinear form the user passed as J (the reference's semantics)."""

    def __init__(self, solver: PCDKrylovSolver):
        self.solver = solver
        self.asm = solver.asm

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """F(x) with the velocity BC rows zeroed (and the pressure mean
        removed for enclosed flow)."""
        s = self.solver
        r = self.asm.rhs_vector(x).to(s.dtype)
        ru = s.free_u * r[:s.n_u]
        rp = r[s.n_u:]
        if s._nullspace:
            rp = rp - torch.mean(rp)
        return torch.cat([ru, rp])

    def initial_state(self) -> torch.Tensor:
        s = self.solver
        x = torch.zeros(s.n, dtype=s.dtype, device=s.device)
        x[:s.n_u] = s.bc_mask_u * s.bc_vals_u
        return x

    def solve(self, x0: Optional[torch.Tensor] = None, *, rtol: float = 1e-5,
              atol: float = 1e-12, max_steps: int = 25,
              verbose: bool = False, callback=None):
        """Returns ``(x, |F| per step, FGMRES iterations per step,
        converged)``.  ``callback(step, fnorm, result, lin_rel, x)`` runs
        after each update with |F| at the step's start, the linear solve's
        result, its true relative residual ``|b - J dx| / |b|`` and the new
        state."""
        s = self.solver
        x = self.initial_state() if x0 is None else x0.to(s.dtype)
        res_hist: List[float] = []
        it_hist: List[int] = []
        r0 = None
        converged = False
        for k in range(max_steps):
            Fv = self.residual(x)
            rn = float(torch.linalg.norm(Fv))
            res_hist.append(rn)
            if r0 is None:
                r0 = rn if rn > 0 else 1.0
            if verbose:
                print(f"  step {k:2d}: |F| = {rn:.3e}")
            if rn <= max(rtol * r0, atol):
                converged = True
                break
            result, matvec = s._solve(x, -Fv)
            it_hist.append(int(result.iters))
            dx = result.x
            if s._nullspace:
                dx = torch.cat([dx[:s.n_u],
                                dx[s.n_u:] - torch.mean(dx[s.n_u:])])
            x = x + dx
            if callback is not None:
                lin_rel = float(torch.linalg.norm(-Fv - matvec(result.x))
                                / torch.linalg.norm(Fv))
                callback(k, rn, result, lin_rel, x)
        return x, res_hist, it_hist, converged
