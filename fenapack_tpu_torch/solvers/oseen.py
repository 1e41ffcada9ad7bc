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
``jpc_supg``.  The solves:

  * :meth:`OseenSolver.solve`, FGMRES in the compute dtype to
    ``krylov.rtol``, and :meth:`OseenSolver.solve_batch`, the same for many
    right-hand sides on one operator setup;
  * :meth:`OseenSolver.make_ir_solve`, the high-precision solve to a TRUE
    relative residual: under ``krylov.hi_krylov`` (the port's default) one
    f64 FGMRES round with the f64 system matvec around the compute-dtype
    preconditioner; otherwise mixed-precision iterative refinement, rounds
    of compute-dtype FGMRES on the scaled f64 true residual (``hi_matvec``:
    the outer matvec in f64).  GCRO-DR recycling across rounds and solves
    under ``krylov.recycle``;
  * :meth:`OseenSolver.solve_ir`, the host-loop refinement with the history
    of true residual norms, and :meth:`make_true_residual`.

The round schedule is Python float arithmetic on the host: one host sync
per round (the true residual's norm) on top of FGMRES's one per iteration.

Monolithic vector layout: ``x = [u_x (n2); u_y (n2)[; u_z (n2)]; p (n1)]``,
n2 and n1 the assembler's (alignment-padded) sizes.  Padding rows are
identity rows: the velocity padding joins the Dirichlet mask, the pressure
padding adds ``p_pad * p`` to the continuity rows and is masked in the Ap
and Mp subsolves, and the enclosed-flow projections run over the real
pressure dofs.

The solver's vectors are laid out by ``self.dist``
(:mod:`fenapack_tpu_torch.ops.dist`): whole on one device; over the
ranks of the row-sharded path after :meth:`OseenSolver.distribute`
(:mod:`fenapack_tpu_torch.parallel.sharding`), where the right-hand side,
the Krylov vectors and the solution are the rank's rows and the wind is
whole.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..fem.dofmap import DirichletBC, merge_bcs
from ..ops import subsolve
from .config import SolverConfig, SubsolveConfig
from ..ops.dist import LOCAL, zero_mean
from ..utils import timing
from .fieldsplit import PCGraphs, make_fieldsplit_upper
from .krylov import (FGMRESResult, empty_recycle, fgmres, fgmres_dr,
                     refresh_recycle)
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
        # alignment-padding velocity dofs are pinned to identity rows
        bc_mask_u = np.maximum(bc_mask_u, 1.0 - asm._u_active_np)
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
        # padded pressure dofs are pinned inside every pressure subsolve
        p_pad = 1.0 - asm._p_active_np
        self.has_p_pad = bool(p_pad.any())
        self.p_pad = (torch.as_tensor(p_pad, dtype=dt, device=dev)
                      if self.has_p_pad else None)
        self.ap_hierarchy = ap_hierarchy
        self.velocity_hierarchy = velocity_hierarchy
        for kind, h, method in (
                ("pressure", ap_hierarchy, config.pcd.ap.method),
                ("velocity", velocity_hierarchy, config.velocity.method)):
            if method == "gmg" and h is not None and \
                    h.reorder != bool(asm.W.reorder):
                raise ValueError(
                    f"{kind} GMG ordering mismatch: the assembler has "
                    f"reorder={bool(asm.W.reorder)}, the hierarchy "
                    f"{h.reorder}")
        self.dist = LOCAL
        self._pc_graphs = PCGraphs.for_layout(self.free_u.device,
                                              self.dist.size)
        self._build_subsolves()

    @staticmethod
    def _union(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
        """The union of two 0/1 masks, either of which may be None."""
        if a is None:
            return b
        if b is None:
            return a
        return torch.maximum(a, b)

    def _build_subsolves(self):
        """The Ap and Mp subsolve factories (their setup: dense inverses,
        spectral bounds) in the layout of ``self.dist``."""
        asm, cfg, c = self.asm, self.config, self.asm.const
        self._ap_factory = self._make_spd_solver(
            c.Ap, asm.pat_p1, self._union(self.pcd_mask, self.p_pad),
            cfg.pcd.ap, hierarchy=self.ap_hierarchy,
            nullspace=self._nullspace)
        self._mp_factory = self._make_spd_solver(
            c.Mp, asm.pat_p1, self.p_pad, cfg.pcd.mp)

    def zero_mean_p(self, p: torch.Tensor) -> torch.Tensor:
        """The pressure ``p`` (in this solver's layout) with its mean over
        the real pressure dofs removed: the enclosed-flow projection."""
        if not self.has_p_pad:
            return zero_mean(p, dist=self.dist)
        return zero_mean(p, self.dist.rows(self.asm.p_active, "p"),
                         self.asm.n1_real, self.dist)

    def distribute(self, dist):
        """Lay this solver's vectors out as ``dist``: the row-sharded path
        (:class:`fenapack_tpu_torch.parallel.sharding.ShardedOseen`, which
        has sharded the assembler already).  Rebuilds the subsolves; the
        masks stay full-length and each closure takes the rank's rows."""
        self.dist = dist
        self._pc_graphs = PCGraphs.for_layout(self.free_u.device, dist.size)
        self._build_subsolves()

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
        closure is built per pipeline.  ``mask`` is full-length."""
        dt, dist = self.dtype, self.dist
        if cfg.method == "lu":
            bc = (torch.zeros(op.shape[0], dtype=dt, device=self.asm.device)
                  if mask is None else mask)
            solve = subsolve.masked_spd_solver_dense(
                op, pattern, bc, dt, nullspace=nullspace, dist=dist)
            return lambda: solve
        if mask is not None:
            mask = dist.rows(mask, "p")
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
                lmin, lmax = subsolve.power_bounds(mv, dinv, op.shape[0],
                                                   dist=dist)
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
            if dist.size > 1:
                # the hierarchy's levels are not the solver's padded space:
                # its V-cycle runs whole on every rank
                whole = solve
                solve = lambda b: dist.rows(whole(dist.full(b, "p")), "p")
            return lambda: solve
        raise NotImplementedError(
            f"subsolve method {cfg.method!r} is not ported")

    def pcd_apply(self):
        """The PCD apply ``pcd(kp, r_p)`` with fresh subsolve closures."""
        dist = self.dist
        return make_pcd_apply(
            self.config.pcd.variant, self._ap_factory(), self._mp_factory(),
            None if self.pcd_mask is None else dist.rows(self.pcd_mask, "p"),
            nullspace=self._nullspace,
            active=(dist.rows(self.asm.p_active, "p") if self.has_p_pad
                    else None),
            theta=self.theta, inv_dt=self.inv_dt, dist=dist)

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
        """Bc-masked monolithic matvec, identity on the padding rows.
        ``hi`` uses the high-precision operators (f64 BSR under
        ``hi_block``: the K1 kernel on CUDA).  The input is gathered whole
        once (``dist.full``); every product reads the whole vector and
        gives this rank's rows."""
        asm, dist = self.asm, self.dist
        n2, n_u, d = asm.n2, self.n_u, self.d
        n_u_loc = n_u // dist.size
        c = asm.const_hi if hi else asm.const
        pat = asm.pat_p2_hi if hi else asm.pat_p2
        free_g = self.free_u.to(A1vals.dtype)
        free_u = dist.rows(free_g, "u")
        bc_u = dist.rows(self.bc_mask_u, "u").to(A1vals.dtype)
        p_pad = (dist.rows(self.p_pad, "p").to(A1vals.dtype)
                 if self.has_p_pad else None)
        # the pressure gradient is added between A1's product and the
        # reaction products, as the reference composes the block
        blk = pat.block_matrix(A1vals, R)

        def velocity(xu, p):
            grad_p = [c.DT[a].mv(p) for a in range(d)]
            return blk.mv(xu.view(d, n2), grad_p).view(-1)

        def matvec(x):
            xg = dist.full(x, "w")
            xu = free_g * xg[:n_u]
            p = xg[n_u:]
            yu = free_u * velocity(xu, p) + bc_u * x[:n_u_loc]
            yp = sum(c.D[a].mv(xu[a * n2:(a + 1) * n2]) for a in range(d))
            if p_pad is not None:
                yp = yp + p_pad * x[n_u_loc:]    # identity on padding rows
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
            # free A free + I_bc, in place (the block is the largest array
            # of the solve: 23,048^2 in f64 at step level 2)
            A.mul_(free[:, None]).mul_(free[None, :])
            A.diagonal().add_(self.bc_mask_u)
            return subsolve.dense_lu_solver(A, self.dist, "u")
        if cfg.method in ("jacobi", "chebyshev", "minres"):
            from .gmg import velocity_block_operator
            mv, dinv = velocity_block_operator(
                self.asm.pat_p2, A1vals, R,
                self.dist.rows(self.bc_mask_u, "u"))
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
                        x = _minres_smooth(mv, dinv, 4, b, x, self.dist)
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
                supg=self.config.jpc_supg or self.config.system_supg,
                dist=self.dist)
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
        dist = self.dist

        def bt_mv(p):
            pg = dist.full(p, "p")
            return torch.cat([c.DT[a].mv(pg) for a in range(self.d)])
        return make_fieldsplit_upper(self.n_u // dist.size, a_solve,
                                     lambda r_p: pcd(kp, r_p), bt_mv,
                                     dist.rows(self.free_u, "u"),
                                     self._pc_graphs)

    def _compute_pipeline(self, wind: torch.Tensor):
        """``(matvec, pc)`` in the compute dtype at ``wind``, from one
        assembly of the operator values."""
        wind = wind.to(self.dtype)
        values = self._operator_values(wind)
        return self._matvec_factory(*values), self._pipeline(wind, values)

    def _hi_matvec(self, wind: torch.Tensor):
        """The f64 system matvec with the operator assembled at ``wind``."""
        A1h, Rh = self._operator_values_raw(wind.to(self.asm.dtype), hi=True)
        return self._matvec_factory(A1h, Rh, hi=True)

    def _krylov(self, matvec, pc, b: torch.Tensor, rtol: float, rec=None,
                atol: float = 0.0):
        """One FGMRES solve of ``b`` in b's dtype to ``max(rtol |b|,
        atol)`` around the compute-dtype pipeline ``pc`` (which casts its
        input to the compute dtype and its output back); with a recycle
        space ``rec`` GCRO-DR (the caller re-binds ``rec`` to ``matvec``).
        Every solve of this class goes through here.  Returns ``(result,
        rec)``."""
        kcfg = self.config.krylov
        kw = dict(maxiter=kcfg.maxiter, rtol=rtol, atol=atol,
                  reorth_eta=kcfg.reorth_eta)
        if rec is None:
            return fgmres(matvec, pc, b, dist=self.dist, **kw), None
        return fgmres_dr(matvec, pc, b, rec, **kw)

    # -------------------------------------------------------------- #
    def solve(self, wind: torch.Tensor, b: torch.Tensor):
        """Solve the Oseen system linearized at ``wind`` with right-hand
        side ``b``: FGMRES in the compute dtype to ``max(krylov.rtol |b|,
        krylov.atol)``, at most ``krylov.maxiter`` iterations.  Returns the
        :class:`FGMRESResult` and the system matvec it solved with."""
        kcfg = self.config.krylov
        with timing.span("oseen.build"):
            matvec, pc = self._compute_pipeline(wind)
        res, _ = self._krylov(matvec, pc, b.to(self.dtype), kcfg.rtol,
                              atol=kcfg.atol)
        return res, matvec

    def solve_batch(self, wind: torch.Tensor, B: torch.Tensor):
        """Solve the system linearized at ``wind`` for every row of ``B``
        ``(nb, n)``: the operator values, the matvec and the preconditioner
        are built once, then one compute-dtype FGMRES runs per row, each
        equal bit for bit to :meth:`solve` of that row.  Returns ``(X,
        iters, converged)``: X ``(nb, n)`` and two NumPy arrays of length
        nb."""
        kcfg = self.config.krylov
        matvec, pc = self._compute_pipeline(wind)
        # a fresh copy of each row: a row view of B starts at an offset of
        # i * n elements, where vectorized device loads (and with them the
        # order of a reduction) may differ from a tensor of its own
        out = [self._krylov(matvec, pc, b.to(self.dtype).clone(),
                            kcfg.rtol, atol=kcfg.atol)[0] for b in B]
        return (torch.stack([r.x for r in out]),
                np.array([r.iters for r in out]),
                np.array([r.converged for r in out]))

    def initial_recycle(self):
        """An empty GCRO-DR recycle space of ``krylov.recycle`` directions
        in the dtype of the Krylov solve it deflates: the assembler's (f64)
        under ``krylov.hi_krylov``, else the compute dtype."""
        kcfg = self.config.krylov
        dt = self.asm.dtype if kcfg.hi_krylov else self.dtype
        return empty_recycle(kcfg.recycle, self.n, dt, self.asm.device)

    def make_ir_solve(self, rtol: float = 1e-8, max_rounds: int = 8):
        """Return ``ir(wind, b, rec=None) -> (x, iters, true_resnorm,
        result, rec)``, a solve to a true relative residual of ``rtol``
        with the residual in f64.

        Under ``krylov.hi_krylov``: one f64 FGMRES solve to ``rtol`` with
        the high-precision system matvec and the compute-dtype
        preconditioner.  Otherwise mixed-precision iterative refinement of
        at most ``max_rounds`` rounds, the JAX package's ``hi_krylov=False``
        loop: the carry is the f64 true residual ``(r, |r|)`` of ``x``; each
        round solves ``r / |r|`` in the compute dtype to ``rtol_k =
        clip(target * ir_safety, krylov.rtol, 1e-2)``, where ``target``
        splits the remaining reduction evenly over ``ceil(log(needed) /
        log(att))`` rounds, and ``att`` (from ``ir_attainable``) rises to
        1.5 times the achieved reduction whenever a round falls more than 4x
        short of its target.  ``hi_matvec`` runs the rounds' outer matvec in
        f64, cast around.

        With ``krylov.recycle > 0`` the solve is GCRO-DR: the recycle space
        ``rec`` (None: an empty one) is re-bound to this operator, deflates
        the solve (every round), and the new space is returned as ``rec``;
        otherwise ``rec`` comes back None.  ``iters`` is the total over
        rounds, ``result`` the last round's :class:`FGMRESResult` with
        ``bnorm`` = |b|, ``host_syncs`` the solve's host waits (the
        counter's, :mod:`..utils.timing`), ``rounds``
        the number of rounds and ``converged`` the true residual's test."""
        dt_hi = self.asm.dtype
        kcfg = self.config.krylov

        def single(wind, b, rec):
            with timing.span("oseen.build"):
                matvec_hi = self._hi_matvec(wind)
                pc = self._pipeline(wind.to(self.dtype))
            b64 = b.to(dt_hi)
            if kcfg.recycle and rec is None:
                rec = self.initial_recycle()
            if rec is not None:
                # the operator changed since the space was built
                rec = refresh_recycle(matvec_hi, rec)
            res, rec = self._krylov(matvec_hi, pc, b64, rtol, rec)
            rn = self.dist.norm(b64 - matvec_hi(res.x))
            timing.counts["true_residuals"] += 1
            return res.x, res.iters, rn, res, rec

        def rounds(wind, b, rec):
            syncs0 = timing.counts["host_syncs"]
            with timing.span("oseen.build"):
                matvec_hi = self._hi_matvec(wind)
                matvec, pc = self._compute_pipeline(wind)
            if kcfg.hi_matvec:
                matvec = lambda x: matvec_hi(x.to(dt_hi)).to(self.dtype)
            if kcfg.recycle:
                if rec is None:
                    rec = self.initial_recycle()
                # the operator changed since the space was built
                rec = refresh_recycle(matvec, rec)
            b64 = b.to(dt_hi)
            rn_t = self.dist.norm(b64)
            bnorm = rn = float(rn_t)
            timing.host_sync()
            tol = max(rtol * bnorm, 1e-300)
            x, r = torch.zeros_like(b64), b64
            att, total, k, res = kcfg.ir_attainable, 0, 0, None
            while k < max_rounds and rn > tol:
                scale = rn if rn > 0 else 1.0
                needed = min(max(tol / scale, 1e-30), 1.0)
                n_r = max(math.ceil(math.log(needed) / math.log(att)), 1)
                target = math.exp(math.log(needed) / n_r)
                rtol_k = min(max(target * kcfg.ir_safety, kcfg.rtol), 1e-2)
                res, rec = self._krylov(matvec, pc, (r / scale).to(self.dtype),
                                        rtol_k, rec)
                x = x + scale * res.x.to(dt_hi)
                r = b64 - matvec_hi(x)
                rn_t = self.dist.norm(r)
                timing.counts["true_residuals"] += 1
                rn = float(rn_t)
                timing.host_sync()
                achieved = rn / scale
                if achieved > 4.0 * target:
                    # the stall level is higher than believed: adopt it
                    att = max(att, 1.5 * achieved)
                total += res.iters
                k += 1
            if res is None:
                res = FGMRESResult(x=x, iters=0,
                                   resnorms=np.zeros(kcfg.maxiter + 1),
                                   converged=True, bnorm=bnorm,
                                   host_syncs=0)
            res = res._replace(
                bnorm=bnorm, rounds=k, converged=rn <= tol,
                host_syncs=timing.counts["host_syncs"] - syncs0)
            return x, total, rn_t, res, rec

        def ir(wind: torch.Tensor, b: torch.Tensor, rec=None):
            return (single if kcfg.hi_krylov else rounds)(wind, b, rec)
        return ir

    def make_true_residual(self):
        """Return ``true_res(wind, x, b) -> (r, |r|)``: the residual of
        ``x`` in the assembler's precision (f64), with the high-precision
        operator assembled from ``wind``."""
        dt_hi = self.asm.dtype

        def true_res(wind: torch.Tensor, x: torch.Tensor, b: torch.Tensor):
            r = b.to(dt_hi) - self._hi_matvec(wind)(x.to(dt_hi))
            return r, self.dist.norm(r)
        return true_res

    def solve_ir(self, wind: torch.Tensor, b: torch.Tensor,
                 rtol: float = 1e-8, atol: float = 0.0,
                 max_rounds: int = 12):
        """Iterative refinement on the host to ``max(rtol |b|, atol)`` in
        the TRUE (f64) residual.  Returns ``(x, total_iters, hist)``, hist
        the true residual norms at the start of each round (|b| first).
        Under ``krylov.hi_krylov`` a round is one f64 FGMRES solve that
        targets the whole remaining reduction (``max(tol / |r|, 1e-14)``);
        otherwise a round is :meth:`solve` of ``r / |r|`` in the compute
        dtype to ``krylov.rtol``.  The operators and the preconditioner are
        built once per call."""
        dt_hi = self.asm.dtype
        kcfg = self.config.krylov
        matvec_hi = self._hi_matvec(wind)
        if kcfg.hi_krylov:
            pc = self._pipeline(wind.to(self.dtype))
        else:
            matvec, pc = self._compute_pipeline(wind)
        b_hi = b.to(dt_hi)
        bnorm = float(self.dist.norm(b_hi))
        timing.host_sync()
        tol = max(rtol * bnorm, atol)
        x = torch.zeros_like(b_hi)
        hist, total = [], 0
        for rnd in range(max_rounds):
            if rnd:
                r = b_hi - matvec_hi(x)
                rn = float(self.dist.norm(r))
                timing.counts["true_residuals"] += 1
                timing.host_sync()
            else:
                r, rn = b_hi, bnorm
            hist.append(rn)
            if rn <= tol:
                break
            if kcfg.hi_krylov:
                res, _ = self._krylov(matvec_hi, pc, r / rn,
                                      max(tol / rn, 1e-14))
            else:
                res, _ = self._krylov(matvec, pc, (r / rn).to(self.dtype),
                                      kcfg.rtol)
            total += int(res.iters)
            x = x + rn * res.x.to(dt_hi)
        return x, total, hist
