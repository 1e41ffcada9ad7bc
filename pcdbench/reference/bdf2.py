"""What decides ``correct`` for the unsteady configuration: the BDF2
residual of Taylor-Hood P2/P1 in plain PyTorch (float64, TF32 off), and its
readings of every time step that the program took.

For the step from ``(u_old, u_prev)`` to the state ``(u, p)``, with the
steady residual ``(ru, rp)`` of :class:`.navier_stokes.SteadyNS` (its
Dirichlet rows zero) and the P2 mass M assembled here:

    RU = ru + M (3 u - 4 u_old + u_prev) / (2 dt)    (Dirichlet rows zero)
    RP = rp

The step's last Picard iteration solved the Oseen system linearized at
its iterate's velocity, the wind ``a``; its residual at the end state,

    OU = RU + (((a - u) . grad) u, phi)             (Dirichlet rows zero)
    OP = RP,

holds to that linear solve's tolerance.  The mass is ``(phi_i, phi_j)`` and
the convection ``((b . grad) u_a, phi_i)`` by the configuration's
quadrature rule, applied cell by cell.  Nothing here reads the program
under test; the program's values are placed on the reference's nodes by
their coordinates (:func:`match`).

Readings of one step (:meth:`SpanJudge.readings`):

  * ``res_rel``: ``|(RU, RP)|`` of the step's end state over that of its
    first iterate, the previous state with the new boundary values (the
    nonlinear reduction that the step's Picard iterations reached);
  * ``cont_rel``: ``|RP|`` of the end state over the same denominator (the
    mass balance, which each Oseen solve makes hold to its linear
    tolerance);
  * ``oseen_rel``: ``|(OU, OP)|`` of the end state at the wind of the
    step's last Picard solve, over the same denominator (the accuracy of
    that linear solve, read by the reference: a state altered after the
    solve, anywhere, shows here);
  * ``bc_err``: the largest gap between the velocity and the boundary
    values at the Dirichlet nodes.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cylinder, quadrature
from .navier_stokes import SteadyNS


def match(ref_pts: np.ndarray, prog_pts: np.ndarray) -> np.ndarray:
    """``perm`` with ``ref_pts[perm[i]] == prog_pts[i]`` bit for bit (both
    sets are computed from the same vertices: the P2 nodes as ``0.5 * (a +
    b)``); ValueError unless the two point sets are the same, one to one.
    The cylinder's points lie on no grid, so :func:`.judge.match`, which
    keys points on the steps' 1/1024 grid, cannot place them."""
    ref_pts = np.asarray(ref_pts, dtype=np.float64)
    prog_pts = np.asarray(prog_pts, dtype=np.float64)
    if ref_pts.shape != prog_pts.shape:
        raise ValueError(f"{prog_pts.shape[0]} program dofs against "
                         f"{ref_pts.shape[0]} reference nodes")
    ro = np.lexsort(ref_pts.T[::-1])
    po = np.lexsort(prog_pts.T[::-1])
    if not np.array_equal(ref_pts[ro], prog_pts[po]):
        raise ValueError("the program's dofs are not the reference's nodes")
    if np.any(np.all(np.diff(ref_pts[ro], axis=0) == 0, axis=1)):
        raise ValueError("two reference nodes share a point")
    perm = np.empty_like(ro)
    perm[po] = ro
    return perm


class BDF2:
    """The BDF2 residual of one mesh, viscosity, rule, Dirichlet set, time
    step and load on ``device``."""

    def __init__(self, mesh, nu: float, quad_degree: int, dirichlet,
                 dt: float, *, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dt = float(dt)
        self.ns = SteadyNS(mesh, nu, quad_degree, dirichlet, device=device)
        qp, qw = quadrature.rule(mesh.dim, quad_degree)
        phi2, _ = quadrature.p2(qp)
        self.mref = torch.as_tensor(np.einsum("q,qi,qj->ij", qw, phi2, phi2),
                                    dtype=torch.float64, device=device)

    def mass(self, v: torch.Tensor) -> torch.Tensor:
        """``M v`` per component of ``v`` (d, n2), Dirichlet rows zero."""
        ns = self.ns
        out = torch.zeros_like(v)
        for sl in ns._blocks():
            cn = ns.cn[sl]
            elem = torch.einsum("c,ij,acj->aci", ns.adet[sl], self.mref,
                                v[:, cn])
            for a in range(v.shape[0]):
                out[a].index_add_(0, cn.reshape(-1), elem[a].reshape(-1))
        return out * ns.free

    def convection(self, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """``((b . grad) u_a, phi_i)`` per component, (d, n2), Dirichlet
        rows zero."""
        ns = self.ns
        out = torch.zeros_like(u)
        for sl in ns._blocks():
            cn = ns.cn[sl]
            G = torch.einsum("qik,cka->cqia", ns.dphi2, ns.Jinv[sl])
            bq = torch.einsum("qi,aci->cqa", ns.phi2, b[:, cn])
            gu = torch.einsum("aci,cqib->cqab", u[:, cn], G)
            w = ns.adet[sl][:, None] * ns.qw[None, :]
            elem = torch.einsum("cq,cqb,cqab,qi->aci", w, bq, gu, ns.phi2)
            for a in range(u.shape[0]):
                out[a].index_add_(0, cn.reshape(-1), elem[a].reshape(-1))
        return out * ns.free

    def residual(self, u, p, u_old, u_prev, load, wind=None):
        """``(RU (d, n2), RP (n1,))`` of the step from ``(u_old, u_prev)``
        to ``(u, p)``; with ``wind``, ``(OU, OP)``: the Oseen residual
        linearized at that velocity."""
        ru, rp = self.ns.residual(u, p, load)
        acc = 3.0 * u - 4.0 * u_old + u_prev
        ru = ru + self.mass(acc) * (0.5 / self.dt)
        if wind is not None:
            ru = ru + self.convection(wind - u, u)
        return ru, rp


class SpanJudge:
    """The reference of the unsteady configuration's ``problem`` on the
    program's mesh (``vertices``, ``cells``: refused unless they cover the
    published domain), with one body force, on ``device``."""

    def __init__(self, spec: dict, vertices, cells, force, dt: float, *,
                 device):
        self.device = device
        self.mesh, self.dirichlet, g = cylinder.build(vertices, cells)
        if float(spec["nu"]) != cylinder.NU:
            raise ValueError(f"the configuration's nu {spec['nu']} is not "
                             f"the benchmark's {cylinder.NU}")
        self.bdf2 = BDF2(self.mesh, cylinder.NU, int(spec["quad_degree"]),
                         self.dirichlet, dt, device=device)
        self.load = self.bdf2.ns.load(force)
        self._g = torch.as_tensor(g.T.copy(), device=device)
        self._dir = torch.as_tensor(self.dirichlet, device=device)
        self.perm_u = self.perm_p = None

    def layout(self, coords_u: np.ndarray, coords_p: np.ndarray) -> None:
        """Place the program's dofs: the coordinates of its scalar P2 dofs
        and of its P1 dofs."""
        self.perm_u = match(self.mesh.nodes, coords_u)
        self.perm_p = match(self.mesh.vertices, coords_p)

    def _place(self, w: np.ndarray):
        """``(u (d, n2), p (n1,))`` on the device of the program's state;
        None where it has another length or a value that is not finite."""
        d, n2 = self.mesh.dim, self.perm_u.shape[0]
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (d * n2 + self.perm_p.shape[0],) \
                or not np.all(np.isfinite(w)):
            return None
        u = np.zeros((d, n2))
        u[:, self.perm_u] = w[:d * n2].reshape(d, n2)
        p = np.zeros(self.perm_p.shape[0])
        p[self.perm_p] = w[d * n2:]
        return (torch.as_tensor(u, device=self.device),
                torch.as_tensor(p, device=self.device))

    @staticmethod
    def _norm(ru, rp) -> float:
        return float(torch.sqrt(torch.sum(ru * ru) + torch.sum(rp * rp)))

    def readings(self, w_start: np.ndarray, u_prev_start: np.ndarray,
                 states, winds) -> list:
        """``[{bc_err, res_rel, cont_rel, oseen_rel}]``, one per step, of
        the states (each a program state) that the program reached from the
        state ``w_start`` whose previous velocity was ``u_prev_start``;
        ``winds`` holds the program's velocity at which each step's last
        Oseen solve was linearized."""
        keys = ("bc_err", "res_rel", "cont_rel", "oseen_rel")
        bad = {k: float("inf") for k in keys}
        n1 = self.perm_p.shape[0]
        vel = lambda v: self._place(np.concatenate([v, np.zeros(n1)]))
        old, older = self._place(w_start), vel(u_prev_start)
        out = []
        for w, a in zip(states, winds):
            new, wind = self._place(w), vel(a)
            if None in (new, wind, old, older):
                # a state that is not a state: this step and the steps
                # that start from it cannot be read
                out.append(dict(bad))
                old, older = None, old
                continue
            u, p = new
            first = torch.where(self._dir, self._g, old[0])
            f0 = self._norm(*self.bdf2.residual(first, old[1], old[0],
                                                older[0], self.load))
            ru, rp = self.bdf2.residual(u, p, old[0], older[0], self.load)
            ou, _ = self.bdf2.residual(u, p, old[0], older[0], self.load,
                                       wind=wind[0])
            bc = float(torch.max(torch.abs(u - self._g)[:, self._dir]))
            out.append({"bc_err": bc, "res_rel": self._norm(ru, rp) / f0,
                        "cont_rel": float(torch.linalg.norm(rp)) / f0,
                        "oseen_rel": self._norm(ou, rp) / f0})
            old, older = new, old
        return out
