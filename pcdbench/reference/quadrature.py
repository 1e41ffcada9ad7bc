"""Quadrature rules and Lagrange bases of the plain reference (NumPy).

The configurations state their rules, and the reference integrates with
the same ones, so that a state the program converged reads the same
residual here up to rounding:

  * triangles, degree 5: Dunavant's 7-point rule (Dunavant 1985, Int. J.
    Numer. Meth. Eng. 21), its points and weights in closed form;
  * tetrahedra, degree 4: the conical-product (Stroud) rule, Gauss-Jacobi
    points in each collapsed coordinate (3 x 3 x 3 = 27 points), the
    Gauss-Jacobi nodes found by the Golub-Welsch eigenvalue method.

Bases are P1 and P2 in barycentric form on the reference simplex
(vertices at the origin and the unit points).  P2 local dofs: the vertices,
then the edge midpoints in :data:`EDGES2` / :data:`EDGES3` order.
"""
from __future__ import annotations

import math

import numpy as np

# local edges of the P2 midpoint dofs (pairs of local vertices)
EDGES2 = ((1, 2), (0, 2), (0, 1))
EDGES3 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def triangle_rule(degree: int):
    """``(points (7, 2), weights (7,))`` of Dunavant's degree-5 rule on the
    reference triangle; the weights sum to its area 1/2."""
    if degree != 5:
        raise ValueError("the reference carries the degree-5 triangle rule")
    s = math.sqrt(15.0)
    a1, a2 = (6.0 - s) / 21.0, (6.0 + s) / 21.0
    w1, w2 = (155.0 - s) / 1200.0, (155.0 + s) / 1200.0
    pts = [(1 / 3, 1 / 3)]
    wts = [9.0 / 40.0]
    for a, w in ((a2, w2), (a1, w1)):
        pts += [(a, a), (1 - 2 * a, a), (a, 1 - 2 * a)]
        wts += [w] * 3
    return np.array(pts), 0.5 * np.array(wts)


def gauss_jacobi(n: int, alpha: float, beta: float):
    """Nodes and weights of the n-point Gauss-Jacobi rule on [-1, 1] for
    the weight ``(1 - x)^alpha (1 + x)^beta`` (Golub-Welsch)."""
    k = np.arange(n, dtype=np.float64)
    ab = alpha + beta
    denom = (2 * k + ab) * (2 * k + ab + 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        diag = np.where(denom == 0, (beta - alpha) / (ab + 2),
                        (beta ** 2 - alpha ** 2) / denom)
    kk = k[1:]
    off = np.sqrt(4 * kk * (kk + alpha) * (kk + beta) * (kk + ab)
                  / ((2 * kk + ab) ** 2 * (2 * kk + ab + 1)
                     * (2 * kk + ab - 1)))
    nodes, vecs = np.linalg.eigh(np.diag(diag) + np.diag(off, 1)
                                 + np.diag(off, -1))
    mu0 = (2.0 ** (ab + 1) * math.gamma(alpha + 1) * math.gamma(beta + 1)
           / math.gamma(ab + 2))
    return nodes, mu0 * vecs[0] ** 2


def tet_rule(degree: int):
    """``(points (n^3, 3), weights)`` of the conical-product rule exact to
    ``degree`` on the reference tetrahedron, n = (degree + 2) // 2; the
    weights sum to its volume 1/6."""
    n = (degree + 2) // 2
    t1, w1 = gauss_jacobi(n, 2.0, 0.0)
    t2, w2 = gauss_jacobi(n, 1.0, 0.0)
    t3, w3 = gauss_jacobi(n, 0.0, 0.0)
    t1, w1 = 0.5 * (t1 + 1.0), w1 / 8.0
    t2, w2 = 0.5 * (t2 + 1.0), w2 / 4.0
    t3, w3 = 0.5 * (t3 + 1.0), w3 / 2.0
    a, b, c = (g.ravel() for g in np.meshgrid(t1, t2, t3, indexing="ij"))
    w = (w1[:, None, None] * w2[None, :, None] * w3[None, None, :]).ravel()
    pts = np.stack([a, b * (1 - a), c * (1 - a) * (1 - b)], axis=1)
    return pts, w


def rule(dim: int, degree: int):
    return triangle_rule(degree) if dim == 2 else tet_rule(degree)


def _barycentric(points: np.ndarray):
    """Barycentric coordinates (n, d+1) and their constant gradients
    (d+1, d) on the reference simplex."""
    d = points.shape[1]
    lam = np.concatenate([1.0 - points.sum(axis=1, keepdims=True), points],
                         axis=1)
    dlam = np.concatenate([-np.ones((1, d)), np.eye(d)])
    return lam, dlam


def p1(points: np.ndarray):
    """``(phi (n, d+1), dphi (n, d+1, d))`` of P1 at reference points."""
    lam, dlam = _barycentric(points)
    return lam, np.broadcast_to(dlam, (points.shape[0],) + dlam.shape).copy()


def p2(points: np.ndarray):
    """``(phi (n, nb), dphi (n, nb, d))`` of P2 at reference points: the
    vertex functions ``lam (2 lam - 1)``, then ``4 lam_i lam_j`` on each
    local edge."""
    lam, dlam = _barycentric(points)
    d = points.shape[1]
    edges = EDGES2 if d == 2 else EDGES3
    phi = [lam[:, k] * (2 * lam[:, k] - 1) for k in range(d + 1)]
    dphi = [(4 * lam[:, k] - 1)[:, None] * dlam[k] for k in range(d + 1)]
    for i, j in edges:
        phi.append(4 * lam[:, i] * lam[:, j])
        dphi.append(4 * (lam[:, i][:, None] * dlam[j]
                         + lam[:, j][:, None] * dlam[i]))
    return np.stack(phi, axis=1), np.stack(dphi, axis=1)
