"""Nonlinear drivers, the port of ``fenapack_tpu/solvers/nonlinear.py``:

  * :meth:`NonlinearSolver.solve`: Picard or Newton steps, each one
    :meth:`OseenSolver.solve` in the compute dtype (the driver of the model
    entry points and of Reynolds continuation), optionally damped;
  * :meth:`NonlinearSolver.make_full_solve`: damped Picard or Newton steps,
    each one high-precision solve, with optional Anderson mixing and the
    GCRO-DR recycle space threaded from step to step under
    ``krylov.recycle`` (the headline benchmark's loop);
  * :meth:`NonlinearSolver.solve_fused`: the same loop without Anderson
    mixing, returning a :class:`NonlinearResult` (the high-Re path);
  * :meth:`NonlinearSolver.solve_anderson`: Picard steps on the
    high-precision solve with type-II Anderson mixing over a window of m
    iterates, the Gram matrix solved on the host in f64.

Under ``system_supg`` the residual is the SUPG-stabilized one, as the
Picard operator is.

For enclosed flow (no outflow) the pressure is defined up to a constant:
the residual's continuity part is projected onto zero mean, and each
update's pressure is shifted to zero mean.  The JAX package fuses the full
solve into one device program (``lax.while_loop``); here both drivers are
Python loops over steps, and each step reads its residual norm on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..fem.dofmap import DirichletBC
from ..utils import timing
from .config import SolverConfig
from .oseen import OseenSolver

_ATOL = 1e-12       # absolute floor of the nonlinear residual test


@dataclasses.dataclass
class FullSolveResult:
    """Outcome of :meth:`NonlinearSolver.make_full_solve`'s solve."""
    w: torch.Tensor                 # final state [u_x; u_y; p] in f64
    steps: int                      # linear solves taken
    iters: List[int]                # outer FGMRES iterations per step
    res: List[float]                # nonlinear residual norms, steps + 1
    converged: bool
    lin_rel: List[float]            # true relative residual of each solve
    host_syncs: int                 # host waits for the device (counted)
    # refinement rounds of each linear solve (1 under krylov.hi_krylov)
    rounds: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class NonlinearResult:
    """Outcome of :meth:`NonlinearSolver.solve`."""
    w: torch.Tensor                 # final state [u_x; u_y; p]
    nonlinear_res: List[float]      # residual norms, steps + 1 if converged
    linear_iters: List[int]         # FGMRES iterations per step
    linear_resnorms: List[np.ndarray]   # FGMRES residual estimates per step
    converged: bool
    wall_time: float
    lin_rel: List[float]            # true relative residual of each solve

    @property
    def total_linear_iters(self) -> int:
        return int(sum(self.linear_iters))


class NonlinearSolver:
    """Picard/Newton driver around :class:`OseenSolver`."""

    def __init__(self, asm, bcs: Sequence[DirichletBC],
                 config: SolverConfig = SolverConfig(), *,
                 pcd_marker: Optional[int],
                 linearization: str = "picard", enclosed: bool = False,
                 ap_hierarchy=None, velocity_hierarchy=None):
        self.asm = asm
        self.enclosed = enclosed
        self.oseen = OseenSolver(asm, bcs, config, pcd_marker=pcd_marker,
                                 linearization=linearization,
                                 enclosed=enclosed,
                                 ap_hierarchy=ap_hierarchy,
                                 velocity_hierarchy=velocity_hierarchy)
        self.n_u, self.n = self.oseen.n_u, self.oseen.n

    def initial_state(self) -> torch.Tensor:
        """Zero state with the Dirichlet values, in the compute dtype."""
        o = self.oseen
        w = torch.zeros(self.n, dtype=o.dtype, device=self.asm.device)
        w[:self.n_u] = o.bc_mask_u * o.bc_vals_u
        return w

    def residual_of(self, w: torch.Tensor):
        """High-precision residual F(w) (velocity Dirichlet rows zeroed;
        for enclosed flow the continuity part projected onto zero mean over
        the real pressure dofs) and its norm as a 0-dim tensor.  ``w`` is
        whole; F is in the solver's layout (``oseen.dist``: the rank's rows
        on the row-sharded path)."""
        asm, n_u, o = self.asm, self.n_u, self.oseen
        dt_hi = asm.dtype
        cfg = o.config
        ru, rp = asm.residual(w[:n_u].to(dt_hi), w[n_u:].to(dt_hi),
                              supg=cfg.system_supg,
                              compute32=cfg.krylov.hi_res_f32)
        if self.enclosed:
            rp = o.zero_mean_p(rp)
        F = torch.cat([o.dist.rows(o.free_u, "u").to(dt_hi) * ru, rp])
        return F, o.dist.norm(F)

    def solve(self, w0: Optional[torch.Tensor] = None, *, rtol: float = 1e-5,
              max_steps: int = 25, damping: float = 1.0) -> NonlinearResult:
        """Picard or Newton steps ``w += damping * dw`` from ``w0`` (default
        the initial state), each ``dw`` one :meth:`OseenSolver.solve` of
        ``J(w) dw = -F(w)``, until ``|F| <= max(rtol * |F_0|, 1e-12)`` (the
        JAX package's default absolute floor).  The state is carried in the
        compute dtype."""
        t0 = time.perf_counter()
        o = self.oseen
        n_u = self.n_u
        w = self.initial_state() if w0 is None else w0.to(o.dtype)
        res_hist, it_hist, rn_hist, lin_rel = [], [], [], []
        r0, converged = None, False
        for _ in range(max_steps):
            F = self.residual_of(w)[0].to(o.dtype)
            rnorm = float(torch.linalg.norm(F))
            timing.host_sync()
            res_hist.append(rnorm)
            if r0 is None:
                r0 = rnorm if rnorm > 0 else 1.0
            if rnorm <= max(rtol * r0, _ATOL):
                converged = True
                break
            result, matvec = o.solve(w[:n_u], -F)
            it_hist.append(int(result.iters))
            rn_hist.append(result.resnorms)
            lin_rel.append(float(torch.linalg.norm(-F - matvec(result.x)))
                           / max(result.bnorm, 1e-300))
            timing.host_sync()
            dw = result.x
            if self.enclosed:
                dw = torch.cat([dw[:n_u], o.zero_mean_p(dw[n_u:])])
            w = w + damping * dw
        return NonlinearResult(w=w, nonlinear_res=res_hist,
                               linear_iters=it_hist, linear_resnorms=rn_hist,
                               converged=converged,
                               wall_time=time.perf_counter() - t0,
                               lin_rel=lin_rel)

    def solve_fused(self, w0: Optional[torch.Tensor] = None, *,
                    rtol: float = 1e-5, rtol_lin: float = 1e-8,
                    max_steps: int = 25, damping: float = 1.0,
                    callback=None) -> NonlinearResult:
        """Damped steps ``w += damping * x`` from ``w0`` (default the initial
        state): :meth:`make_full_solve`'s loop without Anderson mixing,
        returned as a :class:`NonlinearResult` (no residual estimates)."""
        t0 = time.perf_counter()
        r = self.make_full_solve(rtol, rtol_lin, max_steps, damping=damping,
                                 callback=callback)(w0)
        return NonlinearResult(w=r.w, nonlinear_res=r.res,
                               linear_iters=r.iters, linear_resnorms=[],
                               converged=r.converged,
                               wall_time=time.perf_counter() - t0,
                               lin_rel=r.lin_rel)

    def make_full_solve(self, rtol: float = 1e-5, rtol_lin: float = 1e-8,
                        max_steps: int = 25, anderson: int = 0, *,
                        damping: float = 1.0, callback=None):
        """Return ``full(w0=None) -> FullSolveResult``: steps (residual in the
        assembler's precision, one high-precision solve
        (:meth:`OseenSolver.make_ir_solve`) of ``J(w) x = -F(w)`` to
        ``rtol_lin``, update ``w += damping * x``) from ``w0`` (default the
        initial state) until ``|F| <= rtol * |F_0|``.  The state is carried
        in the assembler's precision.

        ``anderson = m >= 2`` adds type-II Anderson mixing with window m over
        the Picard map g(w) = w + damping * x: minimize ||x - dF gamma|| over
        the history's affine hull.  The (m-1)^2 normal equations are solved
        in the compute dtype, as in the JAX package.  With ``krylov.recycle
        > 0`` the GCRO-DR space of each solve deflates the next.
        ``callback(k, rn, iters, lin_rel, w, rec)`` is called after step k
        with that step's |F|, outer count and true relative residual, the
        new state and the recycle space (None without recycling)."""
        ir = self.oseen.make_ir_solve(rtol_lin)
        m = int(anderson)
        fdt = self.oseen.dtype
        n_u = self.n_u

        def full(w0: Optional[torch.Tensor] = None) -> FullSolveResult:
            with timing.request():
                return _full(w0)

        def _full(w0):
            w = (self.initial_state() if w0 is None else w0).to(
                self.asm.dtype)
            dev, dt_hi = w.device, w.dtype
            iters, res, lin_rel, rounds = [], [], [], []
            r0, k, converged, rec = 1.0, 0, False, None
            syncs0 = timing.counts["host_syncs"]
            if m >= 2:
                Fh = torch.zeros((m, self.n), dtype=dt_hi, device=dev)
                Gh = torch.zeros((m, self.n), dtype=dt_hi, device=dev)
                hc = 0
            while k < max_steps:
                with timing.span("residual"):
                    F, rn = self.residual_of(w)
                    rn = float(rn)
                    timing.host_sync()
                if k == 0:
                    r0 = rn if rn > 0 else 1.0
                res.append(rn)
                if rn <= rtol * r0:
                    converged = True
                    break
                with timing.span("picard.step"):
                    x, it, rn_lin, lin, rec = ir(w[:n_u], -F, rec)
                    lin_rel.append(float(rn_lin) / max(lin.bnorm, 1e-300))
                    timing.host_sync()
                    iters.append(int(it))
                    rounds.append(lin.rounds)
                    g = w + damping * x
                    if m >= 2:
                        with timing.span("anderson"):
                            Fh = torch.roll(Fh, -1, dims=0)
                            Fh[-1] = x
                            Gh = torch.roll(Gh, -1, dims=0)
                            Gh[-1] = g
                            hc = min(hc + 1, m)
                            g = self._mix(Fh, Gh, hc, x, g, fdt)
                    w = g
                if callback is not None:
                    callback(k, rn, iters[-1], lin_rel[-1], w, rec)
                k += 1
            return FullSolveResult(
                w=w, steps=k, iters=iters, res=res, converged=converged,
                lin_rel=lin_rel,
                host_syncs=timing.counts["host_syncs"] - syncs0,
                rounds=rounds)
        return full

    @staticmethod
    def _mix(Fh, Gh, hc: int, x, g, fdt):
        """Type-II Anderson mixing of ``g`` over the history rows ``Fh``,
        ``Gh`` (window m, the newest ``hc`` real): the Gram matrix and the
        right-hand side to the host, the regularized normal equations
        solved there in the compute dtype, ``g - gamma dG`` back."""
        m = Fh.shape[0]
        dF = Fh[1:] - Fh[:-1]
        dG = Gh[1:] - Gh[:-1]
        # only the newest hc-1 difference rows are real
        valid = np.arange(m - 1) >= (m - 1) - (hc - 1)
        G = (dF @ dF.T).cpu().numpy()
        cvec = (dF @ x).cpu().numpy()
        timing.host_sync(2)
        eye = np.eye(m - 1)
        G = np.where(np.outer(valid, valid), G, eye)
        cvec = np.where(valid, cvec, 0.0)
        lam = 1e-12 * max(np.trace(G), 1e-30)
        npf = np.float32 if fdt == torch.float32 else np.float64
        gam = np.linalg.solve((G + lam * eye).astype(npf),
                              cvec.astype(npf)).astype(np.float64)
        gam = np.where(valid, gam, 0.0)
        timing.host_sync()                  # gamma's copy to the device
        return g - torch.as_tensor(gam, device=g.device) @ dG

    def solve_anderson(self, w0: Optional[torch.Tensor] = None, *,
                       m: int = 3, rtol: float = 1e-5,
                       rtol_lin: float = 1e-8,
                       max_steps: int = 25) -> NonlinearResult:
        """Anderson-accelerated Picard (type-II mixing, window ``m``), the
        port of the JAX package's ``solve_anderson``.

        The Picard map is ``g(w) = w + x``, ``x`` the high-precision solve
        (:meth:`OseenSolver.make_ir_solve`) of ``J(w) x = -F(w)``; the
        GCRO-DR space rides from step to step under ``krylov.recycle``.
        Over the last ``m`` iterates the fixed-point residuals ``f = g(w) -
        w`` and their differences ``dF`` give the normal equations ``G
        gamma = dF f`` (the Gram matrix of the history's real rows, read to
        the host in f64 in one copy, regularized by ``1e-12 trace(G)``; a
        singular matrix gives gamma = 0), and ``w <- g - sum gamma_j dG_j``.
        Stops when ``|F| <= rtol |F_0|``; the state is carried in the
        assembler's precision."""
        t0 = time.perf_counter()
        ir = self.oseen.make_ir_solve(rtol_lin)
        n_u = self.n_u
        w = (self.initial_state() if w0 is None else w0).to(self.asm.dtype)
        hist_f, hist_g = [], []
        res_hist, it_hist, lin_rel = [], [], []
        r0, converged, rec = None, False, None
        for _ in range(max_steps):
            F, rn = self.residual_of(w)
            rn = float(rn)
            timing.host_sync()
            res_hist.append(rn)
            if r0 is None:
                r0 = rn if rn > 0 else 1.0
            if rn <= max(rtol * r0, 1e-300):
                converged = True
                break
            x, it, rn_lin, lin, rec = ir(w[:n_u], -F, rec)
            it_hist.append(int(it))
            lin_rel.append(float(rn_lin) / max(lin.bnorm, 1e-300))
            timing.host_sync()
            g = w + x
            f = g - w
            hist_f.append(f)
            hist_g.append(g)
            if len(hist_f) > m:
                hist_f.pop(0)
                hist_g.pop(0)
            if len(hist_f) < 2:
                w = g
                continue
            dF = torch.stack([b - a for a, b in zip(hist_f, hist_f[1:])])
            dG = [b - a for a, b in zip(hist_g, hist_g[1:])]
            j = dF.shape[0]
            Gc = torch.cat([(dF @ dF.T).reshape(-1), dF @ f]).cpu().numpy()
            timing.host_sync()
            G, c = Gc[:j * j].reshape(j, j), Gc[j * j:]
            lam = 1e-12 * max(np.trace(G), 1e-30)
            try:
                gam = np.linalg.solve(G + lam * np.eye(j), c)
            except np.linalg.LinAlgError:
                gam = np.zeros(j)
            w = g - sum(float(gi) * dgi for gi, dgi in zip(gam, dG))
        return NonlinearResult(w=w, nonlinear_res=res_hist,
                               linear_iters=it_hist, linear_resnorms=[],
                               converged=converged,
                               wall_time=time.perf_counter() - t0,
                               lin_rel=lin_rel)
