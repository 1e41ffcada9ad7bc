"""The Oseen linear solver: FGMRES around the upper Schur fieldsplit with PCD.

The port of ``fenapack_tpu/solvers/oseen.py::OseenSolver``: Picard or
Newton linearization (the Newton operator adds the reaction blocks R_ab to
the velocity block), PCD Dirichlet rows or enclosed flow (constant pressure
nullspace), Ap by pressure multigrid, Chebyshev or dense LU, Mp by
Chebyshev or lumped, the velocity block by multigrid, dense LU or a fixed
number of Jacobi, Chebyshev or minimal-residual sweeps.  ``theta`` and
``inv_dt`` turn the operator into the unsteady schemes' effective one,
``theta A1 + inv_dt M`` with ``theta R``, in the system matvec, the velocity
multigrid and the PCD apply (``Mp/dt`` in Fp).  SUPG streamline diffusion
enters the system operator under ``system_supg`` (before the theta
combination) and the preconditioner's velocity operator alone under
``jpc_supg``.  Two solves: :meth:`OseenSolver.solve`, FGMRES in the compute
dtype to ``krylov.rtol``, and the single-round high-precision solve of
:meth:`make_ir_solve` (the JAX package's ``krylov.hi_krylov``): f64 FGMRES
with the f64 system matvec around a preconditioner in the compute dtype,
with GCRO-DR recycling across solves under ``krylov.recycle``.

Monolithic vector layout: ``x = [u_x (n2); u_y (n2)[; u_z (n2)]; p (n1)]``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..fem.dofmap import DirichletBC, merge_bcs
from ..ops import subsolve
from ..ops.sparse import ELL
from .config import SolverConfig, SubsolveConfig
from .fieldsplit import make_fieldsplit_upper
from .krylov import empty_recycle, fgmres, fgmres_dr, refresh_recycle
from .pcd import make_pcd_apply

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class OseenSolver:
    """PCD-preconditioned Oseen solves on one mesh.

    Parameters
    ----------
    asm : the assembler (constant operators and the device live here)
    bcs : velocity Dirichlet BCs
    config : solver configuration
    linearization : "picard" | "newton" (selects the operator)
    enclosed : no outflow, pressure defined up to a constant (cavity);
        without PCD Dirichlet rows the Ap solve projects out the constant
    pcd_marker : facet marker holding the PCD Dirichlet dofs, None for
        none (the caller decides: ``models`` through ``pcd_marker_for``)
    theta, inv_dt : the time scheme's weights (steady: 1 and 0); the
        velocity block is ``theta (A1 [+ R]) + inv_dt M2``

    The compute dtype of the configuration must be the storage dtype of
    ``asm.const``.

    Matrix products run in full precision: building a solver turns TF32
    off for CUDA matmuls and cuDNN (the dense coarse solves are f32
    matrix-vector products that TF32 would reduce to ~1e-3 accuracy).
    """

    def __init__(self, asm, bcs: Sequence[DirichletBC],
                 config: SolverConfig = SolverConfig(), *,
                 pcd_marker: Optional[int],
                 linearization: str = "picard", enclosed: bool = False,
                 ap_hierarchy=None, velocity_hierarchy=None,
                 theta: float = 1.0, inv_dt: float = 0.0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if linearization not in ("picard", "newton"):
            raise ValueError(f"unknown linearization {linearization!r}")
        self.asm = asm
        self.config = config
        self.linearization = linearization
        self.theta, self.inv_dt = float(theta), float(inv_dt)
        self.dtype = dt = _DTYPES[config.dtype]
        if asm.const.Ap.vals.dtype != dt:
            raise ValueError(
                f"config dtype {config.dtype} but the assembler's constants "
                f"are {asm.const.Ap.vals.dtype}: set its block_dtype")
        dev = asm.device
        n2, n1 = asm.n2, asm.n1
        self.d = asm.dim
        self.n_u = self.d * n2
        self.n = self.n_u + n1

        bc_mask_u, bc_vals_u = merge_bcs(bcs, self.n_u)
        self.bc_mask_u = torch.as_tensor(bc_mask_u, dtype=dt, device=dev)
        self.bc_vals_u = torch.as_tensor(bc_vals_u, dtype=dt, device=dev)
        self.free_u = 1.0 - self.bc_mask_u

        self.has_pcd_bcs = pcd_marker is not None
        self.pcd_marker = pcd_marker
        self.pcd_mask = None
        if self.has_pcd_bcs:
            pcd_dofs = asm.W.Q.facet_dofs([pcd_marker])
            if pcd_dofs.shape[0] == 0:
                raise ValueError(f"pcd_marker {pcd_marker} marks no facet")
            mask_p = np.zeros(n1)
            mask_p[pcd_dofs] = 1.0
            self.pcd_mask = torch.as_tensor(mask_p, dtype=dt, device=dev)
        self._nullspace = enclosed and not self.has_pcd_bcs

        c = asm.const
        self._ap_factory = self._make_spd_solver(
            c.Ap, asm.pat_p1, self.pcd_mask, config.pcd.ap,
            hierarchy=ap_hierarchy, nullspace=self._nullspace)
        self._mp_factory = self._make_spd_solver(
            c.Mp, asm.pat_p1, None, config.pcd.mp)
        self.ap_hierarchy = ap_hierarchy
        self.velocity_hierarchy = velocity_hierarchy

    # -------------------------------------------------------------- #
    @staticmethod
    def _masked_spd_matvec(op, mask: Optional[torch.Tensor]):
        """Symmetric bc-elimination: free A free + I_bc."""
        if mask is None:
            return op.mv
        free = 1.0 - mask
        return lambda x: free * op.mv(free * x) + mask * x

    def _make_spd_solver(self, op, pattern, mask, cfg: SubsolveConfig,
                         hierarchy=None, nullspace: bool = False):
        """Return a factory for the subsolver of an SPD pressure operator
        (Ap or Mp): setup (dense inverse, spectral bounds) runs here, the
        closure is built per pipeline."""
        dt = self.dtype
        if cfg.method == "lu":
            bc = (torch.zeros(op.shape[0], dtype=dt, device=self.asm.device)
                  if mask is None else mask)
            solve = subsolve.masked_spd_solver_dense(op, pattern, bc, dt,
                                                     nullspace=nullspace)
            return lambda: solve
        if cfg.method == "lumped":
            dinv = subsolve.lumped_inverse(op).to(dt)
            if mask is None:
                return lambda: (lambda r: dinv * r)
            free = 1.0 - mask
            return lambda: (lambda r: free * dinv * r + mask * r)
        if cfg.method == "chebyshev":
            diag = op.diag_from(pattern.diag_pos)
            if mask is not None:
                diag = torch.where(mask > 0, torch.ones_like(diag), diag)
            dinv = 1.0 / diag
            mv = self._masked_spd_matvec(op, mask)
            if cfg.bounds is not None:
                lmin, lmax = cfg.bounds
            else:
                lmin, lmax = subsolve.power_bounds(mv, dinv, op.shape[0])
            return lambda: subsolve.chebyshev_solver(mv, dinv, lmin, lmax,
                                                     cfg.iters)
        if cfg.method == "gmg":
            if hierarchy is None:
                raise ValueError("pcd.ap.method 'gmg' needs an ap_hierarchy")
            hmarks = set(getattr(hierarchy, "pcd_markers", ()))
            want = {self.pcd_marker} if self.has_pcd_bcs else set()
            if hmarks != want:
                raise ValueError(
                    f"pressure GMG pcd-marker mismatch: hierarchy built with "
                    f"pcd_markers={sorted(hmarks)} but the solver's PCD "
                    f"Dirichlet rows are {sorted(want)}")
            from .gmg import make_gmg_solver
            solve = make_gmg_solver(hierarchy, cfg, dt)
            return lambda: solve
        raise NotImplementedError(
            f"subsolve method {cfg.method!r} is not ported")

    def pcd_apply(self):
        """The PCD apply ``pcd(kp, r_p)`` with fresh subsolve closures."""
        return make_pcd_apply(self.config.pcd.variant, self._ap_factory(),
                              self._mp_factory(), self.pcd_mask,
                              nullspace=self._nullspace, theta=self.theta,
                              inv_dt=self.inv_dt)

    # -------------------------------------------------------------- #
    def _operator_values_raw(self, wind: torch.Tensor, hi: bool = True):
        """Operator values ``(A1, R)`` in the wind's precision class: A1 the
        Picard operator (``system_supg``: plus the streamline diffusion;
        unsteady: ``theta A1 + inv_dt M2``), R the (d, d, ...) Newton
        reaction blocks (unsteady: times theta) or None for Picard.  The
        high-precision operator runs its per-step convection integrals in
        f32 when ``krylov.hi_ops_f32`` (as the JAX package does)."""
        c32 = bool(hi) and self.config.krylov.hi_ops_f32
        A1 = self.asm.picard_matrix_values(wind, hi=hi, compute32=c32)
        if self.config.system_supg:
            A1 = A1 + self.asm.supg_values(wind, hi=hi).to(A1.dtype)
        if self.theta != 1.0 or self.inv_dt != 0.0:
            M2 = self.asm.mass2(hi=hi).vals
            A1 = self.theta * A1 + self.inv_dt * M2.to(A1.dtype)
        R = None
        if self.linearization == "newton":
            R = self.asm.newton_reaction_values(wind, hi=hi, compute32=c32)
            if self.theta != 1.0:
                R = self.theta * R
        return A1, R

    def _operator_values(self, wind: torch.Tensor):
        A1, R = self._operator_values_raw(wind, hi=False)
        return A1.to(self.dtype), None if R is None else R.to(self.dtype)

    def _matvec_factory(self, A1vals: torch.Tensor,
                        R: Optional[torch.Tensor] = None, hi: bool = False):
        """Bc-masked monolithic matvec.  ``hi`` uses the high-precision
        operators (f64 BSR under ``hi_block``: the K1 kernel on CUDA)."""
        asm = self.asm
        n2, n_u, d = asm.n2, self.n_u, self.d
        c = asm.const_hi if hi else asm.const
        pat = asm.pat_p2_hi if hi else asm.pat_p2
        A1 = pat.matrix(A1vals)
        free_u = self.free_u.to(A1vals.dtype)
        bc_u = self.bc_mask_u.to(A1vals.dtype)

        if isinstance(A1, ELL):
            # ELL: A1 and the reaction blocks share one pattern, and the
            # velocity block is one pass over it (the pressure gradient is
            # added between A1's product and the reaction products, as
            # the composed form below adds it)
            blk = pat.block_matrix(A1vals, R)

            def velocity(xu, comps, p):
                grad_p = torch.stack([c.DT[a].mv(p) for a in range(d)])
                return blk.mv(xu.view(d, n2), grad_p).view(-1)
        else:
            Rm = (None if R is None else
                  [[pat.matrix(R[a, b]) for b in range(d)] for a in range(d)])

            def velocity(xu, comps, p):
                ys = [A1.mv(comps[a]) + c.DT[a].mv(p) for a in range(d)]
                if Rm is not None:
                    for a in range(d):
                        for b in range(d):
                            ys[a] = ys[a] + Rm[a][b].mv(comps[b])
                return torch.cat(ys)

        def matvec(x):
            xu = free_u * x[:n_u]
            p = x[n_u:]
            comps = [xu[a * n2:(a + 1) * n2] for a in range(d)]
            yu = free_u * velocity(xu, comps, p) + bc_u * x[:n_u]
            yp = sum(c.D[a].mv(comps[a]) for a in range(d))
            return torch.cat([yu, yp])
        return matvec

    def _velocity_solver(self, A1vals: torch.Tensor, wind: torch.Tensor,
                         R: Optional[torch.Tensor] = None):
        """Velocity-block subsolve at the current wind: multigrid, the
        dense inverse of the bc-masked block ("lu"), or a fixed number of
        factorization-free sweeps ("jacobi", "chebyshev", "minres")."""
        cfg = self.config.velocity
        if cfg.method == "lu":
            from .gmg import dense_velocity_block
            A = dense_velocity_block(self.asm.pat_p2, A1vals, R, self.d)
            free = self.free_u
            A = free[:, None] * A * free[None, :] + torch.diag(self.bc_mask_u)
            return subsolve.dense_lu_solver(A)
        if cfg.method in ("jacobi", "chebyshev", "minres"):
            from .gmg import velocity_block_operator
            mv, dinv = velocity_block_operator(self.asm.pat_p2, A1vals, R,
                                               self.bc_mask_u)
            iters = cfg.iters
            if cfg.method == "jacobi":
                omega = 0.7

                def solve(b):
                    x = omega * dinv * b
                    for _ in range(iters - 1):
                        x = x + omega * dinv * (b - mv(x))
                    return x
                return solve
            if cfg.method == "minres":
                from .gmg import _minres_smooth

                def solve(b):
                    x = torch.zeros_like(b)
                    for _ in range(max(1, iters // 4)):
                        x = _minres_smooth(mv, dinv, 4, b, x)
                    return x
                return solve
            lmin, lmax = cfg.bounds or (0.1, 2.0)
            return subsolve.chebyshev_solver(mv, dinv, lmin, lmax, iters)
        if cfg.method == "gmg":
            from .gmg import make_velocity_gmg_from_wind
            return make_velocity_gmg_from_wind(
                self.velocity_hierarchy, cfg, wind.to(self.dtype),
                self.bc_mask_u, self.dtype,
                newton=self.linearization == "newton",
                fine_values=(A1vals, R), theta=self.theta,
                inv_dt=self.inv_dt,
                supg=self.config.jpc_supg or self.config.system_supg)
        raise NotImplementedError(
            f"velocity method {cfg.method!r} is not ported")

    def _pipeline(self, wind: torch.Tensor, values=None):
        """The preconditioner at ``wind`` in the compute dtype.  ``values``
        are the compute-dtype system operator values ``(A1, R)`` at ``wind``
        when the caller has them already; under ``jpc_supg`` the velocity
        subsolve takes its own copy of A1 with the streamline diffusion, and
        the system keeps the unstabilized one."""
        cfg = self.config
        c = self.asm.const
        A1vals, R = self._operator_values(wind) if values is None else values
        if cfg.jpc_supg and not cfg.system_supg:
            A1vals = A1vals + self.asm.supg_values(wind).to(self.dtype)
        kp = self.asm.pat_p1.matrix(self.asm.kp_values(
            wind, surface=(cfg.pcd.variant == "BRM2")).to(self.dtype))
        a_solve = self._velocity_solver(A1vals, wind, R=R)
        pcd = self.pcd_apply()
        bt_mv = lambda p: torch.cat([c.DT[a].mv(p) for a in range(self.d)])
        return make_fieldsplit_upper(self.n_u, a_solve,
                                     lambda r_p: pcd(kp, r_p), bt_mv,
                                     self.free_u)

    # -------------------------------------------------------------- #
    def solve(self, wind: torch.Tensor, b: torch.Tensor):
        """Solve the Oseen system linearized at ``wind`` with right-hand
        side ``b``: FGMRES in the compute dtype to ``krylov.rtol * |b|``, at
        most ``krylov.maxiter`` iterations.  Returns the
        :class:`FGMRESResult` and the system matvec it solved with."""
        kcfg = self.config.krylov
        wind, b = wind.to(self.dtype), b.to(self.dtype)
        values = self._operator_values(wind)
        matvec = self._matvec_factory(*values)
        pc = self._pipeline(wind, values)
        res = fgmres(matvec, pc, b, maxiter=kcfg.maxiter, rtol=kcfg.rtol,
                     reorth_eta=kcfg.reorth_eta)
        return res, matvec

    def initial_recycle(self):
        """An empty GCRO-DR recycle space of ``krylov.recycle`` directions,
        in the assembler's (high) precision, where :meth:`make_ir_solve`
        keeps it."""
        return empty_recycle(self.config.krylov.recycle, self.n,
                             self.asm.dtype, self.asm.device)

    def make_ir_solve(self, rtol: float = 1e-8):
        """Return ``ir(wind, b, rec=None) -> (x, iters, true_resnorm,
        result, rec)``: one f64 FGMRES solve to ``rtol`` with the
        high-precision system matvec and the compute-dtype preconditioner
        (cast f64 -> compute -> f64 around each apply), then the true
        residual in f64.  With ``krylov.recycle > 0`` the solve is GCRO-DR:
        the recycle space ``rec`` of the previous solve (None: an empty one)
        is re-bound to this operator, deflates the solve, and the new space
        is returned as ``rec``; otherwise ``rec`` comes back None."""
        dt_hi = self.asm.dtype
        kcfg = self.config.krylov

        def ir(wind: torch.Tensor, b: torch.Tensor, rec=None):
            A1h, Rh = self._operator_values_raw(wind.to(dt_hi), hi=True)
            matvec_hi = self._matvec_factory(A1h, Rh, hi=True)
            pc = self._pipeline(wind.to(self.dtype))
            pc_hi = lambda r: pc(r.to(self.dtype)).to(dt_hi)
            b64 = b.to(dt_hi)
            if kcfg.recycle:
                if rec is None:
                    rec = self.initial_recycle()
                rec = refresh_recycle(matvec_hi, rec)
                res, rec = fgmres_dr(matvec_hi, pc_hi, b64, rec,
                                     maxiter=kcfg.maxiter, rtol=rtol,
                                     reorth_eta=kcfg.reorth_eta)
            else:
                res = fgmres(matvec_hi, pc_hi, b64, maxiter=kcfg.maxiter,
                             rtol=rtol, reorth_eta=kcfg.reorth_eta)
            rn = torch.linalg.norm(b64 - matvec_hi(res.x))
            return res.x, res.iters, rn, res, rec
        return ir
