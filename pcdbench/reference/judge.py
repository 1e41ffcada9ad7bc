"""What decides ``correct`` for a steady solve: the reference's readings of
a state that the program returned.

The program hands back ``w = [u_0 (n2); ...; u_{d-1} (n2); p (n1)]`` with
the coordinates of its P2 and P1 dofs (where each value lives).  The judge
places every value on the reference's own node at the same point (every
dof has to find one, one to one, or the state is on another mesh), then
reads three numbers:

  * ``bc_err``: the largest gap between the state's velocity and the
    boundary values at the Dirichlet nodes;
  * ``res_rel``: the reference residual's 2-norm over that of the start
    (the boundary values, zero inside), the configuration's nonlinear
    tolerance measured again;
  * ``cont_rel``: the 2-norm of the continuity residual (the mass balance
    of every pressure node) over the same start norm.  Each Oseen solve
    makes the continuity rows hold to its linear tolerance, so this
    number reads the linear accuracy that the nonlinear residual, at
    1e-5, cannot see.
"""
from __future__ import annotations

import numpy as np
import torch

from . import step
from .navier_stokes import SteadyNS

_GRID = 1024.0          # coordinates are multiples of 1/32 in both steps


def _keys(x: np.ndarray) -> np.ndarray:
    """Exact integer keys of points on the 1/1024 grid; -1 where a point
    is off the grid."""
    s = np.asarray(x, dtype=np.float64) * _GRID
    r = np.rint(s)
    on = np.all(np.abs(s - r) < 1e-6, axis=1)
    k = np.zeros(x.shape[0], dtype=np.int64)
    for a in range(x.shape[1]):
        k = k * (1 << 16) + (r[:, a].astype(np.int64) + (1 << 15))
    return np.where(on, k, -1)


def match(ref_pts: np.ndarray, prog_pts: np.ndarray) -> np.ndarray:
    """``perm`` with ``ref_pts[perm[i]] == prog_pts[i]``; ValueError unless
    the two point sets are the same, one to one."""
    rk, pk = _keys(ref_pts), _keys(prog_pts)
    if rk.shape != pk.shape or (pk < 0).any():
        raise ValueError(f"{pk.shape[0]} program dofs against "
                         f"{rk.shape[0]} reference nodes, or off the grid")
    order = np.argsort(rk)
    pos = np.clip(np.searchsorted(rk[order], pk), 0, rk.shape[0] - 1)
    perm = order[pos]
    if not (np.array_equal(rk[perm], pk)
            and np.unique(perm).shape[0] == perm.shape[0]):
        raise ValueError("the program's dofs are not the reference's nodes")
    return perm


class Judge:
    """The reference of one configuration's ``problem`` and one body
    force, on ``device``."""

    def __init__(self, spec: dict, force, *, device):
        self.device = device
        self.mesh, self.dirichlet, self.g = step.build(spec)
        self.ns = SteadyNS(self.mesh, float(spec["nu"]),
                           int(spec["quad_degree"]), self.dirichlet,
                           device=device)
        self.load = self.ns.load(force)
        u0 = torch.as_tensor(self.g.T.copy(), device=device)
        p0 = torch.zeros(self.ns.n1, dtype=torch.float64, device=device)
        self.f0 = self._norm(*self.ns.residual(u0, p0, self.load))
        self.perm_u = self.perm_p = None

    @staticmethod
    def _norm(ru, rp) -> float:
        return float(torch.sqrt(torch.sum(ru * ru) + torch.sum(rp * rp)))

    def layout(self, coords_u: np.ndarray, coords_p: np.ndarray) -> None:
        """Place the program's dofs: the coordinates of its scalar P2 dofs
        and of its P1 dofs."""
        self.perm_u = match(self.mesh.nodes, coords_u)
        self.perm_p = match(self.mesh.vertices, coords_p)

    def readings(self, w: np.ndarray) -> dict:
        """``{bc_err, res_rel, cont_rel}`` of the program's state ``w``."""
        d, n2 = self.mesh.dim, self.perm_u.shape[0]
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (d * n2 + self.perm_p.shape[0],) \
                or not np.all(np.isfinite(w)):
            return {"bc_err": float("inf"), "res_rel": float("inf"),
                    "cont_rel": float("inf")}
        u = np.zeros((d, n2))
        u[:, self.perm_u] = w[:d * n2].reshape(d, n2)
        p = np.zeros(self.perm_p.shape[0])
        p[self.perm_p] = w[d * n2:]
        bc = float(np.max(np.abs(u[:, self.dirichlet]
                                 - self.g[self.dirichlet].T)))
        ut = torch.as_tensor(u, device=self.device)
        pt = torch.as_tensor(p, device=self.device)
        ru, rp = self.ns.residual(ut, pt, self.load)
        return {"bc_err": bc, "res_rel": self._norm(ru, rp) / self.f0,
                "cont_rel": float(torch.linalg.norm(rp)) / self.f0}
