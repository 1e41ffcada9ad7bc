"""The steady incompressible Navier-Stokes residual of Taylor-Hood P2/P1,
in plain PyTorch: the reference that judges a state the program solved.

For a state (u, p) on a :class:`~.mesh.Mesh` and a body force f, with
every integral taken by the configuration's quadrature rule:

    ru_a(phi) = nu (grad u_a, grad phi) + ((u . grad) u_a, phi)
                - (p, d_a phi) - (f_a, phi)        for each P2 node phi
    rp(q)     = -(q, div u)                         for each P1 node q

Velocity rows of Dirichlet nodes are zero (they hold the boundary values
instead); the outflow is natural (no boundary term).  Cells are taken in
blocks, so that the per-point tables fit beside whatever else is on the
device.  Nothing here reads the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

from . import quadrature


class SteadyNS:
    """Residual of one mesh, viscosity and rule on ``device`` (f64)."""

    def __init__(self, mesh, nu: float, quad_degree: int, dirichlet,
                 *, device, block: int = 32768):
        self.mesh, self.nu, self.device, self.block = mesh, nu, device, block
        d = self.dim = mesh.dim
        self.n2, self.n1 = mesh.nodes.shape[0], mesh.vertices.shape[0]
        qp, qw = quadrature.rule(d, quad_degree)
        phi2, dphi2 = quadrature.p2(qp)
        phi1, _ = quadrature.p1(qp)
        self._qp = qp
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                      device=device)
        self.qw, self.phi2, self.dphi2, self.phi1 = (t(a) for a in
                                                     (qw, phi2, dphi2, phi1))
        v = mesh.vertices[mesh.cells]
        E = np.stack([v[:, k + 1] - v[:, 0] for k in range(d)], axis=2)
        self._v0, self._E = v[:, 0], E
        self.Jinv = t(np.linalg.inv(E))
        self.adet = t(np.abs(np.linalg.det(E)))
        self.cn = torch.as_tensor(mesh.cell_nodes, device=device)
        self.cv = torch.as_tensor(mesh.cells, device=device)
        self.free = t(~np.asarray(dirichlet, dtype=bool))

    def _blocks(self):
        nc = self.cn.shape[0]
        for s in range(0, nc, self.block):
            yield slice(s, min(s + self.block, nc))

    def load(self, force) -> torch.Tensor:
        """``(f_a, phi)`` for every P2 node, (d, n2); ``force(x (k, d)) ->
        (k, d)`` is evaluated at the rule's points of every cell."""
        d = self.dim
        out = torch.zeros((d, self.n2), dtype=torch.float64,
                          device=self.device)
        for sl in self._blocks():
            xq = self._v0[sl][:, None, :] + np.einsum(
                "qk,cak->cqa", self._qp, self._E[sl])
            fq = torch.as_tensor(np.asarray(force(xq.reshape(-1, d)),
                                            dtype=np.float64),
                                 device=self.device).reshape(xq.shape)
            w = self.adet[sl][:, None] * self.qw[None, :]
            elem = torch.einsum("cq,cqa,qi->cai", w, fq, self.phi2)
            idx = self.cn[sl].reshape(-1)
            for a in range(d):
                out[a].index_add_(0, idx, elem[:, a].reshape(-1))
        return out

    def residual(self, u: torch.Tensor, p: torch.Tensor,
                 load: torch.Tensor):
        """``(ru (d, n2) with Dirichlet rows zero, rp (n1,))`` at the state
        ``u`` (d, n2), ``p`` (n1,) under the load of :meth:`load`."""
        d, nu = self.dim, self.nu
        ru = torch.zeros((d, self.n2), dtype=torch.float64,
                         device=self.device)
        rp = torch.zeros(self.n1, dtype=torch.float64, device=self.device)
        for sl in self._blocks():
            cn, cv = self.cn[sl], self.cv[sl]
            G = torch.einsum("qik,cka->cqia", self.dphi2, self.Jinv[sl])
            ue = u[:, cn].permute(1, 2, 0)                  # (c, nb2, d)
            uq = torch.einsum("qi,cia->cqa", self.phi2, ue)
            gu = torch.einsum("cia,cqib->cqab", ue, G)      # d_b u_a
            pq = torch.einsum("ql,cl->cq", self.phi1, p[cv])
            w = self.adet[sl][:, None] * self.qw[None, :]
            conv = torch.einsum("cqb,cqab->cqa", uq, gu)
            elem = (nu * torch.einsum("cq,cqab,cqib->cia", w, gu, G)
                    + torch.einsum("cq,cqa,qi->cia", w, conv, self.phi2)
                    - torch.einsum("cq,cqia->cia", w * pq, G))
            div = torch.diagonal(gu, dim1=2, dim2=3).sum(-1)
            elem_p = -torch.einsum("cq,ql->cl", w * div, self.phi1)
            idx = cn.reshape(-1)
            for a in range(d):
                ru[a].index_add_(0, idx, elem[:, :, a].reshape(-1))
            rp.index_add_(0, cv.reshape(-1), elem_p.reshape(-1))
        ru = (ru - load) * self.free
        return ru, rp
