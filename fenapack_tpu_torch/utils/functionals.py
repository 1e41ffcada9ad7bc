"""Post-processing functionals: boundary forces and point values, the port
of ``fenapack_tpu/utils/functionals.py``.

Drag and lift come from the discrete-consistent reaction: at a converged
state the raw (unmasked) Galerkin momentum residual vanishes on interior
rows, and its value on a Dirichlet-boundary row j equals the surface
momentum flux tested with the nodal basis function phi_j, so the force the
fluid exerts on a marked boundary is the plain sum of residual rows over
that boundary's velocity dofs (the Babuska-Miller variational force
evaluation; no surface quadrature).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _boundary_mask(asm, markers: Sequence[int], dtype) -> torch.Tensor:
    """1.0 at the scalar P2 dofs on the ``markers`` facets."""
    mask = np.zeros(asm.n2)
    mask[asm.W.V.facet_dofs(list(markers))] = 1.0
    return torch.as_tensor(mask, dtype=dtype, device=asm.device)


def _reaction(asm, u, p, du_dt, mask, supg: bool = False) -> torch.Tensor:
    """The (d,) force on the masked boundary from the raw residual
    (``supg``: the stabilized one), as a tensor on the state's device."""
    ru = asm.residual(u, None, supg=supg)[0] + asm.grad_p(p)
    if du_dt is not None:
        M2 = asm.mass2(hi=True)
        ru = ru + torch.cat([M2.mv(c) for c in asm.split_u(du_dt)])
    return -torch.stack([torch.sum(c * mask) for c in asm.split_u(ru)])


def boundary_reaction(asm, u: torch.Tensor, p: torch.Tensor,
                      markers: Sequence[int], supg: bool = False,
                      du_dt: Optional[torch.Tensor] = None) -> np.ndarray:
    """Force (Fx, Fy) exerted by the fluid on the ``markers`` boundary.

    ``u`` is the stacked velocity vector, ``p`` the pressure vector.  The
    raw steady residual (zero body force, natural outflow) summed over the
    boundary's velocity dofs equals the traction the boundary exerts on the
    fluid; the returned force is its negative, drag positive downstream.
    For unsteady states pass ``du_dt`` (stacked like ``u``): the identity
    then needs the inertial term ``int phi_j du/dt`` on the boundary rows,
    nonzero over the boundary cells even on a no-slip obstacle.  ``supg``
    takes the SUPG-stabilized residual (a ``system_supg`` solution)."""
    dt_hi = asm.dtype
    F = _reaction(asm, u.to(dt_hi), p.to(dt_hi),
                  None if du_dt is None else du_dt.to(dt_hi),
                  _boundary_mask(asm, markers, dt_hi), supg=supg)
    return F.cpu().numpy()


def _containing_cells(asm, points):
    """For each point ``(cell, barycentric weights)`` of the first cell
    that contains it, or ``(cell, local vertex)`` of the nearest vertex for
    a point outside every cell (on a snapped curved boundary)."""
    mesh = asm.mesh
    points = np.atleast_2d(np.asarray(points, dtype=np.float64))
    verts = mesh.vertices[mesh.cells]                  # (nc, 3, 2)
    T = verts[:, 1:, :] - verts[:, :1, :]
    ok = np.abs(np.linalg.det(T)) > 1e-300
    gdim = mesh.vertices.shape[1]
    out = []
    for x in points:
        lam = np.zeros((verts.shape[0], gdim))
        lam[ok] = np.linalg.solve(np.swapaxes(T[ok], 1, 2),
                                  (x[None, :] - verts[:, 0, :])[ok][..., None]
                                  )[..., 0]
        bary = np.concatenate([1.0 - lam.sum(axis=1, keepdims=True), lam],
                              axis=1)
        cand = np.where(ok & (bary.min(axis=1) >= -1e-9))[0]
        if cand.size:
            out.append((int(cand[0]), bary[cand[0]]))
        else:
            v = int(np.argmin(np.linalg.norm(mesh.vertices - x, axis=1)))
            c, loc = np.argwhere(mesh.cells == v)[0]
            w = np.zeros(gdim + 1)
            w[loc] = 1.0
            out.append((int(c), w))
    return out


def p1_point_weights(asm, points):
    """Interpolation stencils for P1 point evaluation: ``(idx, wts)`` with
    ``idx`` (k, 3) pressure-dof indices and ``wts`` (k, 3) barycentric
    weights, so that ``p_at = (p[idx] * wts).sum(axis=1)``.  The
    containing-cell search runs once on the host."""
    cd = np.asarray(asm.W.Q.cell_dofs)
    found = _containing_cells(asm, points)
    idx = np.stack([cd[c] for c, _ in found]).astype(np.int64)
    wts = np.stack([w for _, w in found])
    return idx, wts


def eval_p1(asm, pvals, points) -> np.ndarray:
    """A P1 (pressure-space) field at physical ``points`` (k, 2), by
    barycentric interpolation in the containing cell on the host; a point
    outside every cell takes the nearest vertex's value."""
    idx, wts = p1_point_weights(asm, points)
    return (np.asarray(pvals, dtype=np.float64)[idx] * wts).sum(axis=1)


def make_device_functional(asm, markers: Sequence[int], points=(),
                           scheme: str = "steady",
                           dt: Optional[float] = None, supg: bool = False):
    """Build a per-step functional ``fn(w_new, u_old, u_prev) -> (d + k,)``:
    the boundary-reaction force components on ``markers`` followed by the
    pressure values at ``points``, a tensor on the state's device (no host
    transfer inside), for ``UnsteadySolver.solve_fused(functional=...)``.

    ``scheme``: "steady" (no inertial term), "theta" (backward-difference
    du/dt) or "bdf2" (the stepper's own second-order derivative
    ``(3u - 4u_old + u_prev) / (2 dt)``).  ``supg``: the stabilized
    residual, as :func:`boundary_reaction`."""
    if scheme not in ("steady", "theta", "bdf2"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme != "steady" and dt is None:
        raise ValueError("dt is required for unsteady schemes")
    dt_hi = asm.dtype
    n_u = asm.dim * asm.n2
    idt = None if dt is None else 1.0 / dt
    mask = _boundary_mask(asm, markers, dt_hi)
    idx = wts = None
    if len(points):
        idx, wts = p1_point_weights(asm, points)
        idx = torch.as_tensor(idx, device=asm.device)
        wts = torch.as_tensor(wts, dtype=dt_hi, device=asm.device)

    def fn(w_new, u_old, u_prev):
        u, p = w_new[:n_u].to(dt_hi), w_new[n_u:].to(dt_hi)
        if scheme == "bdf2":
            du_dt = (1.5 * u - 2.0 * u_old.to(dt_hi)
                     + 0.5 * u_prev.to(dt_hi)) * idt
        elif scheme == "theta":
            du_dt = (u - u_old.to(dt_hi)) * idt
        else:
            du_dt = None
        force = _reaction(asm, u, p, du_dt, mask, supg=supg)
        if idx is None:
            return force
        return torch.cat([force, torch.sum(p[idx] * wts, dim=1)])
    return fn
