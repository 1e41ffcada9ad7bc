"""Picard driver with Anderson mixing, the port of
``fenapack_tpu/solvers/nonlinear.py::NonlinearSolver.make_full_solve``.

The JAX package fuses the whole nonlinear solve into one device program
(``lax.while_loop`` over steps, ``lax.cond`` for the converged check); here
it is a Python loop over Picard steps, and each step reads its residual
norm on the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..fem.dofmap import DirichletBC
from .config import SolverConfig
from .oseen import OseenSolver


@dataclasses.dataclass
class FullSolveResult:
    """Outcome of :meth:`NonlinearSolver.make_full_solve`'s solve."""
    w: torch.Tensor                 # final state [u_x; u_y; p] in f64
    steps: int                      # linear solves taken
    iters: List[int]                # outer FGMRES iterations per step
    res: List[float]                # nonlinear residual norms, steps + 1
    converged: bool
    lin_rel: List[float]            # true relative residual of each solve
    host_syncs: int                 # host reads of device values


class NonlinearSolver:
    """Picard driver around :class:`OseenSolver`."""

    def __init__(self, asm, bcs: Sequence[DirichletBC],
                 config: SolverConfig = SolverConfig(),
                 ap_hierarchy=None, velocity_hierarchy=None):
        self.asm = asm
        self.oseen = OseenSolver(asm, bcs, config, ap_hierarchy=ap_hierarchy,
                                 velocity_hierarchy=velocity_hierarchy)
        self.n_u, self.n = self.oseen.n_u, self.oseen.n

    def initial_state(self) -> torch.Tensor:
        """Zero state with the Dirichlet values, in the compute dtype."""
        o = self.oseen
        w = torch.zeros(self.n, dtype=o.dtype, device=self.asm.device)
        w[:self.n_u] = o.bc_mask_u * o.bc_vals_u
        return w

    def residual_of(self, w: torch.Tensor):
        """High-precision residual F(w) (velocity Dirichlet rows zeroed) and
        its norm as a 0-dim tensor."""
        asm, n_u = self.asm, self.n_u
        dt_hi = asm.dtype
        c32 = self.oseen.config.krylov.hi_res_f32
        ru, rp = asm.residual(w[:n_u].to(dt_hi), w[n_u:].to(dt_hi),
                              compute32=c32)
        F = torch.cat([self.oseen.free_u.to(dt_hi) * ru, rp])
        return F, torch.linalg.norm(F)

    def make_full_solve(self, rtol: float = 1e-5, rtol_lin: float = 1e-8,
                        max_steps: int = 25, anderson: int = 0):
        """Return ``full(w0) -> FullSolveResult``: Picard steps (residual,
        linear solve, update) until ``|F| <= rtol * |F_0|``.

        ``anderson = m >= 2`` adds type-II Anderson mixing with window m over
        the Picard map g(w) = w + x: minimize ||x - dF gamma|| over the
        history's affine hull.  The (m-1)^2 normal equations are solved in
        the compute dtype, as in the JAX package."""
        ir = self.oseen.make_ir_solve(rtol_lin)
        m = int(anderson)
        fdt = self.oseen.dtype
        n_u = self.n_u

        def full(w0: torch.Tensor) -> FullSolveResult:
            w = w0.to(self.asm.dtype)
            dev, dt_hi = w.device, w.dtype
            iters, res, lin_rel = [], [], []
            syncs, r0, k, converged = 0, 1.0, 0, False
            if m >= 2:
                Fh = torch.zeros((m, self.n), dtype=dt_hi, device=dev)
                Gh = torch.zeros((m, self.n), dtype=dt_hi, device=dev)
                hc = 0
            while k < max_steps:
                F, rn = self.residual_of(w)
                rn = float(rn)
                syncs += 1
                if k == 0:
                    r0 = rn if rn > 0 else 1.0
                res.append(rn)
                if rn <= rtol * r0:
                    converged = True
                    break
                x, it, rn_lin, lin = ir(w[:n_u], -F)
                lin_rel.append(float(rn_lin) / lin.bnorm)
                syncs += 1 + lin.host_syncs
                iters.append(it)
                g = w + x
                if m >= 2:
                    Fh = torch.roll(Fh, -1, dims=0)
                    Fh[-1] = x
                    Gh = torch.roll(Gh, -1, dims=0)
                    Gh[-1] = g
                    hc = min(hc + 1, m)
                    dF = Fh[1:] - Fh[:-1]
                    dG = Gh[1:] - Gh[:-1]
                    # only the newest hc-1 difference rows are real
                    valid = np.arange(m - 1) >= (m - 1) - (hc - 1)
                    G = (dF @ dF.T).cpu().numpy()
                    cvec = (dF @ x).cpu().numpy()
                    syncs += 1
                    eye = np.eye(m - 1)
                    G = np.where(np.outer(valid, valid), G, eye)
                    cvec = np.where(valid, cvec, 0.0)
                    lam = 1e-12 * max(np.trace(G), 1e-30)
                    npf = np.float32 if fdt == torch.float32 else np.float64
                    gam = np.linalg.solve((G + lam * eye).astype(npf),
                                          cvec.astype(npf)).astype(np.float64)
                    gam = np.where(valid, gam, 0.0)
                    g = g - torch.as_tensor(gam, device=dev) @ dG
                w = g
                k += 1
            return FullSolveResult(w=w, steps=k, iters=iters, res=res,
                                   converged=converged, lin_rel=lin_rel,
                                   host_syncs=syncs)
        return full
