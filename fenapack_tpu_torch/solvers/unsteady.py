"""Unsteady Navier-Stokes: theta-scheme and BDF2 time stepping with PCD
Oseen solves, the port of ``fenapack_tpu/solvers/unsteady.py``.

Every time step runs the same PCD-preconditioned solve as the steady
solvers; the constant operators (Mp, Ap, M) serve all steps.  The per-step
nonlinear problem (theta in (0, 1]; 1 = implicit Euler, 0.5 =
Crank-Nicolson), pressure fully implicit:

    M (u - u_old)/dt + theta C(u) u + (1-theta) C(u_old) u_old + B^T p = 0
    B u = 0
with  C(w) = nu L + N(w).

``scheme="bdf2"`` selects the A-stable second-order backward
differentiation formula

    M (3u - 4 u_old + u_prev)/(2 dt) + C(u) u + B^T p = 0

with an implicit-Euler startup step expressed as ``u_prev := u_old``: the
same effective operator ``1.5/dt M + A1`` serves every step including the
first.

Two time loops:

  * :meth:`UnsteadySolver.solve`: ``picard_iters`` Picard iterations per
    step (1 = the standard semi-implicit scheme: wind frozen at u_old, one
    Oseen solve per step), each one :meth:`OseenSolver.solve` in the
    compute dtype; takes time-dependent Dirichlet data (``bc_fn``).
  * :meth:`UnsteadySolver.solve_fused`: the semi-implicit step with the
    residual in the assembler's (high) precision and one high-precision
    solve (:meth:`OseenSolver.make_ir_solve`) per step, and an optional
    per-step functional evaluated on the state's device.

The JAX package also compiles a step, or the whole horizon, into one device
program; here a time loop is a Python loop and those forms have no
counterpart.

The exact loop's spans (:mod:`..utils.timing`): ``unsteady.solve`` around
:meth:`UnsteadySolver.solve` (one request), ``unsteady.step`` around a
time step, ``unsteady.picard`` around one Picard iteration (the Oseen
solve, the read of its true residual and the update),
``unsteady.residual`` around each residual and the read of its norm.  Its
counters: ``unsteady_steps``, ``unsteady_picard_iters`` (the Oseen
solves), and ``host_syncs`` at every site where it waits for the device: a
residual's norm, a linear solve's true residual, a copy of the state to
the host (``keep_history``) and of Dirichlet values to the device
(``bc_fn``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..fem.dofmap import DirichletBC, merge_bcs
from ..utils import timing
from ..utils.timing import span
from .config import SolverConfig
from .oseen import OseenSolver


@dataclasses.dataclass
class UnsteadyResult:
    w: torch.Tensor
    times: List[float]
    linear_iters: List[int]        # per time step (summed over inner Picard)
    step_res: List[float]          # nonlinear residual norm of each step
    wall_time: float
    history: Optional[List[np.ndarray]] = None
    # the true relative residual of each step's linear solve (solve: the
    # largest of its Picard solves), and (solve_fused only) the per-step
    # functional values (n_steps, k) on the state's device when a
    # functional was given
    lin_rel: Optional[List[float]] = None
    functionals: Optional[torch.Tensor] = None


class UnsteadySolver:
    """theta-scheme / BDF2 stepper around :class:`OseenSolver`.
    ``pcd_marker`` is required, as there: the facet marker of the PCD
    Dirichlet rows, None for none (the JAX package turns None into the
    outflow for BRM2 and the inflow for BRM1)."""

    def __init__(self, asm, bcs: Sequence[DirichletBC],
                 config: SolverConfig = SolverConfig(), *,
                 dt: float, pcd_marker: Optional[int],
                 theta: float = 1.0, scheme: str = "theta",
                 linearization: str = "picard", enclosed: bool = False,
                 ap_hierarchy=None, velocity_hierarchy=None,
                 bc_fn: Optional[Callable] = None):
        if scheme not in ("theta", "bdf2"):
            raise ValueError(f"unknown time scheme {scheme!r}")
        # Time-dependent Dirichlet data g(t): ``bc_fn(t)`` returns a
        # DirichletBC, a sequence of them, or a ready (n_u,) array of
        # velocity values.  Supported by :meth:`step`/:meth:`solve`, whose
        # residual keeps ``u_old`` apart, so the Dirichlet-lift mass term
        # is exact; :meth:`solve_fused` assumes u_old == u at BC dofs and
        # refuses it.
        self.bc_fn = bc_fn
        self.asm = asm
        self.dt = float(dt)
        self.theta = float(theta)
        self.scheme = scheme
        self.enclosed = enclosed
        # BDF2: the effective operator is (3/(2 dt)) M + A1, expressed as
        # theta = 1, inv_dt = 1.5/dt, so the Jacobian and the PCD Fp term
        # stay consistent
        bdf2 = scheme == "bdf2"
        self.oseen = OseenSolver(asm, bcs, config, pcd_marker=pcd_marker,
                                 linearization=linearization,
                                 enclosed=enclosed,
                                 ap_hierarchy=ap_hierarchy,
                                 velocity_hierarchy=velocity_hierarchy,
                                 theta=1.0 if bdf2 else self.theta,
                                 inv_dt=(1.5 if bdf2 else 1.0) / self.dt)
        self.n_u, self.n = self.oseen.n_u, self.oseen.n
        self._supg = config.system_supg

    # -------------------------------------------------------------- #
    # residuals
    # -------------------------------------------------------------- #
    def _mass(self, du: torch.Tensor) -> torch.Tensor:
        """``M du`` per component with the high-precision P2 mass, in the
        dtype of ``du``."""
        asm = self.asm
        M2h = asm.mass2(hi=True)
        M2 = M2h.with_vals(M2h.vals.to(du.dtype))
        return torch.cat([M2.mv(c) for c in asm.split_u(du)])

    def _conv_part(self, u: torch.Tensor) -> torch.Tensor:
        """The convection-diffusion residual of one velocity state, without
        the pressure gradient: the theta-weighted piece (SUPG-stabilized
        under ``system_supg``, as the Jacobian is)."""
        return self.asm.residual(u, None, supg=self._supg)[0].to(
            self.oseen.dtype)

    def _residual_full(self, w: torch.Tensor, u_old: torch.Tensor,
                       aux: torch.Tensor) -> torch.Tensor:
        """The scheme's residual at state ``w``.  ``aux`` is constant
        across the Picard iterations of a time step (:meth:`_step_aux`):
        ``_conv_part(u_old)`` for the theta scheme, the velocity of two
        steps ago for BDF2.  The pressure is unscaled (as the Jacobian's
        B^T block and the PCD Fp term take it): only the
        convection-diffusion part is theta-weighted."""
        asm, o = self.asm, self.oseen
        n_u, dtc, th, idt = self.n_u, o.dtype, self.theta, 1.0 / self.dt
        u, p = w[:n_u], w[n_u:]
        conv_new, rp = asm.residual(u, None, supg=self._supg)
        gp = asm.grad_p(p.to(asm.dtype)).to(dtc)
        if self.scheme == "bdf2":
            acc = (3.0 * u - 4.0 * u_old + aux).to(dtc)
            ru = self._mass(acc) * (0.5 * idt) + conv_new.to(dtc) + gp
        else:
            mass = self._mass((u - u_old).to(dtc)) * idt
            ru = mass + th * conv_new.to(dtc) + (1.0 - th) * aux + gp
        ru = o.free_u * ru
        rp = rp.to(dtc)
        if self.enclosed:
            rp = o.zero_mean_p(rp)
        return torch.cat([ru, rp])

    def _step_aux(self, u_old: torch.Tensor, u_prev) -> torch.Tensor:
        """The third residual argument of one time step: the theta-weighted
        convection of ``u_old`` (theta scheme) or the velocity of two steps
        ago (BDF2; None selects the implicit-Euler startup)."""
        if self.scheme == "bdf2":
            return u_old if u_prev is None else u_prev
        return self._conv_part(u_old)

    def _residual(self, w: torch.Tensor, u_old: torch.Tensor) -> torch.Tensor:
        """The scheme's residual with the per-step aux recomputed (BDF2:
        the startup step)."""
        return self._residual_full(w, u_old, self._step_aux(u_old, None))

    # -------------------------------------------------------------- #
    # state and boundary data
    # -------------------------------------------------------------- #
    def initial_state(self) -> torch.Tensor:
        o = self.oseen
        w = torch.zeros(self.n, dtype=o.dtype, device=self.asm.device)
        vals = (o.bc_vals_u if self.bc_fn is None else
                torch.as_tensor(self._bc_values_at(0.0), dtype=o.dtype,
                                device=self.asm.device))
        w[:self.n_u] = o.bc_mask_u * vals
        return w

    def _bc_values_at(self, t: float) -> np.ndarray:
        """Evaluate ``bc_fn(t)`` to a full (n_u,) velocity-values array."""
        out = self.bc_fn(t)
        if isinstance(out, DirichletBC):
            out = [out]
        if isinstance(out, (list, tuple)) and (
                not out or isinstance(out[0], DirichletBC)):
            return merge_bcs(out, self.n_u)[1]
        vals = np.asarray(out)
        if vals.shape != (self.n_u,):
            raise TypeError(
                f"bc_fn(t) must return a DirichletBC, a sequence of "
                f"DirichletBC, or a ready (n_u,)=({self.n_u},) velocity-"
                f"values array; got array of shape {vals.shape}")
        return vals

    def apply_bc_values(self, w: torch.Tensor, bc_vals) -> torch.Tensor:
        """``w`` with its constrained velocity dofs overwritten by new
        Dirichlet data."""
        vals = torch.as_tensor(bc_vals, dtype=w.dtype, device=w.device)
        timing.host_sync()
        u = torch.where(self.oseen.bc_mask_u > 0, vals, w[:self.n_u])
        return torch.cat([u, w[self.n_u:]])

    # -------------------------------------------------------------- #
    # the exact time loop
    # -------------------------------------------------------------- #
    def step(self, w: torch.Tensor, *, picard_iters: int = 1,
             rtol: float = 1e-6, u_prev: Optional[torch.Tensor] = None,
             bc_vals=None, lin_rel: Optional[list] = None,
             on_solve: Optional[Callable] = None):
        """Advance one time step; returns ``(w_new, linear iterations,
        last nonlinear residual norm)``.  ``u_prev`` (BDF2 only) is the
        velocity of two steps ago; None selects the startup step.
        ``bc_vals`` is the Dirichlet data at the new time level: written
        into the state before the residual, so the mass term carries the
        exact Dirichlet-lift contribution of a moving boundary.  A list
        ``lin_rel`` receives the true relative residual of each linear
        solve; ``on_solve(i, w)`` is called before the i-th Oseen solve
        with the iterate whose velocity it is linearized at."""
        with span("unsteady.step"):
            timing.counts["unsteady_steps"] += 1
            u_old = w[:self.n_u]
            aux = self._step_aux(u_old, u_prev)
            if bc_vals is not None:
                w = self.apply_bc_values(w, bc_vals)
            total, rn = 0, None
            for i in range(max(picard_iters, 1)):
                with span("unsteady.residual"):
                    F = self._residual_full(w, u_old, aux)
                    rn = float(torch.linalg.norm(F))
                    timing.host_sync()
                if rn <= rtol:
                    break
                with span("unsteady.picard"):
                    timing.counts["unsteady_picard_iters"] += 1
                    if on_solve is not None:
                        on_solve(i, w)
                    res, matvec = self.oseen.solve(w[:self.n_u], -F)
                    total += int(res.iters)
                    if lin_rel is not None:
                        lin_rel.append(
                            float(torch.linalg.norm(-F - matvec(res.x)))
                            / max(res.bnorm, 1e-300))
                        timing.host_sync()
                    w = w + res.x
            return w, total, rn

    def solve(self, t_end: float, w0: Optional[torch.Tensor] = None, *,
              picard_iters: int = 1, keep_history: bool = False,
              callback=None,
              u_prev0: Optional[torch.Tensor] = None,
              picard_callback=None) -> UnsteadyResult:
        """``round(t_end / dt)`` steps of :meth:`step` from ``w0`` (default
        the initial state).  ``u_prev0`` (BDF2 only): the velocity at
        t = -dt; with it the first step runs full BDF2 instead of the
        implicit-Euler startup, whose effective step 2 dt / 3 leaves an
        O(dt) error in the whole trajectory (restores the history when
        resuming from a checkpoint).  ``lin_rel`` of the result holds each
        step's largest true relative residual of its linear solves.
        ``callback(k, t, w)`` follows step k; ``picard_callback(k, i, w)``
        precedes its i-th Oseen solve, with the iterate whose velocity that
        solve is linearized at."""
        with timing.request("unsteady.solve"):
            return self._solve(t_end, w0, picard_iters, keep_history,
                               callback, u_prev0, picard_callback)

    def _solve(self, t_end, w0, picard_iters, keep_history, callback,
               u_prev0, picard_callback) -> UnsteadyResult:
        t0 = time.perf_counter()
        dtc = self.oseen.dtype
        w = self.initial_state() if w0 is None else w0.to(dtc)
        t = 0.0
        times, iters, resid, lin_rel = [], [], [], []
        hist = [] if keep_history else None
        u_prev = None if u_prev0 is None else u_prev0.to(dtc)
        for k in range(int(round(t_end / self.dt))):
            u_old = w[:self.n_u]
            bc_vals = (self._bc_values_at(t + self.dt)
                       if self.bc_fn is not None else None)
            rels = []
            on_solve = (None if picard_callback is None else
                        lambda i, w_i, k=k: picard_callback(k, i, w_i))
            w, it, rn = self.step(w, picard_iters=picard_iters,
                                  u_prev=u_prev, bc_vals=bc_vals,
                                  lin_rel=rels, on_solve=on_solve)
            lin_rel.append(max(rels, default=0.0))
            u_prev = u_old                   # BDF2 history (theta: unread)
            t += self.dt
            times.append(t)
            iters.append(it)
            resid.append(rn)
            if keep_history:
                hist.append(w.cpu().numpy())
                timing.host_sync()
            if callback is not None:
                callback(k, t, w)
        return UnsteadyResult(w=w, times=times, linear_iters=iters,
                              step_res=resid,
                              wall_time=time.perf_counter() - t0,
                              history=hist, lin_rel=lin_rel)

    # -------------------------------------------------------------- #
    # the semi-implicit time loop on high-precision solves
    # -------------------------------------------------------------- #
    def _residual_hi(self, w: torch.Tensor, u_prev: torch.Tensor):
        """The residual of the semi-implicit step in the assembler's
        precision: wind and ``u_old`` are both the incoming velocity, so
        the theta mass term vanishes and BDF2's reduces to
        ``M (u_prev - u) / (2 dt)``."""
        asm, n_u = self.asm, self.n_u
        dt_hi = asm.dtype
        u, p = w[:n_u].to(dt_hi), w[n_u:].to(dt_hi)
        conv, rp = asm.residual(u, None, supg=self._supg)
        ru = conv + asm.grad_p(p)
        if self.scheme == "bdf2":
            ru = ru + self._mass(u_prev.to(dt_hi) - u) * (0.5 / self.dt)
        ru = self.oseen.free_u.to(dt_hi) * ru
        if self.enclosed:
            rp = self.oseen.zero_mean_p(rp)
        F = torch.cat([ru, rp])
        return F, torch.linalg.norm(F)

    def solve_fused(self, t_end: float, w0: Optional[torch.Tensor] = None, *,
                    rtol_lin: float = 1e-8, keep_history: bool = False,
                    callback=None, functional: Optional[Callable] = None,
                    u_prev0: Optional[torch.Tensor] = None
                    ) -> UnsteadyResult:
        """The semi-implicit time loop (one linearized solve per step, the
        semantics of ``solve(picard_iters=1)``): the residual in the
        assembler's precision, then one high-precision FGMRES solve to
        ``rtol_lin`` around the compute-dtype preconditioner.

        ``functional(w_new, u_old, u_prev) -> (k,)`` (for example
        ``utils.functionals.make_device_functional``) is evaluated after
        every step on the state's device; the values come back stacked as
        ``UnsteadyResult.functionals``.  ``u_prev0``: see :meth:`solve`.
        With ``krylov.recycle > 0`` the GCRO-DR space of each step's solve
        deflates the next step's (consecutive operators differ only by the
        wind)."""
        if self.bc_fn is not None:
            raise ValueError(
                "time-dependent BCs (bc_fn) need the exact time loop: use "
                "solve(), not solve_fused(); the semi-implicit residual "
                "assumes u_old == u at BC dofs and would drop the "
                "Dirichlet-lift mass term (freezing the t=0 BC values)")
        t0 = time.perf_counter()
        ir = self.oseen.make_ir_solve(rtol_lin)
        n_u = self.n_u
        w = (self.initial_state() if w0 is None else w0).to(self.asm.dtype)
        u_prev = w[:n_u] if u_prev0 is None else u_prev0.to(w.dtype)
        t, rec = 0.0, None
        times, iters, resid, lin_rel, fvals = [], [], [], [], []
        hist = [] if keep_history else None
        for k in range(int(round(t_end / self.dt))):
            u_old = w[:n_u]
            F, rn = self._residual_hi(w, u_prev)
            x, it, rn_lin, lin, rec = ir(u_old, -F, rec)
            w = w + x
            if functional is not None:
                fvals.append(functional(w, u_old, u_prev))
            u_prev = u_old
            t += self.dt
            times.append(t)
            iters.append(int(it))
            resid.append(float(rn))
            lin_rel.append(float(rn_lin) / max(lin.bnorm, 1e-300))
            if keep_history:
                hist.append(w.cpu().numpy())
            if callback is not None:
                callback(k, t, w)
        return UnsteadyResult(
            w=w, times=times, linear_iters=iters, step_res=resid,
            wall_time=time.perf_counter() - t0, history=hist,
            lin_rel=lin_rel,
            functionals=torch.stack(fvals) if fvals else None)
