"""Reference P1/P2 triangle elements and quadrature (host-side NumPy).

Copied from ``fenapack_tpu/fem/elements.py``.  Local dof conventions match
:class:`fenapack_tpu_torch.fem.mesh.TriMesh`:
  P1: dofs 0..2 at vertices.
  P2: dofs 0..2 at vertices, dof 3+k at the midpoint of the edge opposite
      vertex k (edge 0 = (v1,v2), edge 1 = (v0,v2), edge 2 = (v0,v1)).
"""
from __future__ import annotations

import numpy as np

P1_DIM = 3
P2_DIM = 6


def p1_basis(points: np.ndarray):
    """P1 basis at reference points (n,2) -> (phi (n,3), dphi (n,3,2))."""
    x, y = points[:, 0], points[:, 1]
    lam = np.stack([1.0 - x - y, x, y], axis=1)
    dlam = np.tile(np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]), (points.shape[0], 1, 1))
    return lam, dlam


def p2_basis(points: np.ndarray):
    """P2 basis at reference points (n,2) -> (phi (n,6), dphi (n,6,2))."""
    lam, dlam = p1_basis(points)
    n = points.shape[0]
    phi = np.empty((n, 6))
    dphi = np.empty((n, 6, 2))
    for k in range(3):
        phi[:, k] = lam[:, k] * (2.0 * lam[:, k] - 1.0)
        dphi[:, k, :] = (4.0 * lam[:, k] - 1.0)[:, None] * dlam[:, k, :]
    # edge dof 3+k on edge opposite vertex k, connecting vertices (k+1)%3,(k+2)%3
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        phi[:, 3 + k] = 4.0 * lam[:, i] * lam[:, j]
        dphi[:, 3 + k, :] = 4.0 * (lam[:, i][:, None] * dlam[:, j, :]
                                   + lam[:, j][:, None] * dlam[:, i, :])
    return phi, dphi


def triangle_quadrature(degree: int):
    """Symmetric Gauss rules on the reference triangle {x,y>=0, x+y<=1}.

    Returns (points (nq,2), weights (nq,)); weights sum to 1/2 (the area).
    """
    if degree <= 2:
        # 3-point, degree 2
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        wts = np.full(3, 1 / 6)
    elif degree <= 4:
        # 6-point, degree 4 (Dunavant)
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        pts = np.array([
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2]])
        wts = 0.5 * np.array([w1, w1, w1, w2, w2, w2])
    elif degree <= 5:
        # 7-point, degree 5 (Dunavant)
        a1, a2 = 0.470142064105115, 0.101286507323456
        w0, w1, w2 = 0.225, 0.132394152788506, 0.125939180544827
        pts = np.array([
            [1 / 3, 1 / 3],
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2]])
        wts = 0.5 * np.array([w0, w1, w1, w1, w2, w2, w2])
    elif degree <= 7:
        # 13-point, degree 7 (Dunavant; one negative-free rule)
        a1, a2 = 0.260345966079038, 0.065130102902216
        b, c = 0.312865496004875, 0.048690315425316
        w0 = -0.149570044467670
        w1, w2, w3 = 0.175615257433204, 0.053347235608839, 0.077113760890257
        pts = np.array([
            [1 / 3, 1 / 3],
            [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
            [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
            [b, c], [c, b],
            [1 - b - c, b], [b, 1 - b - c],
            [1 - b - c, c], [c, 1 - b - c]])
        wts = 0.5 * np.array([w0, w1, w1, w1, w2, w2, w2, w3, w3, w3, w3, w3, w3])
    else:
        raise NotImplementedError(f"triangle quadrature degree {degree}")
    return pts, wts


def interval_quadrature(degree: int):
    """Gauss-Legendre on [0,1] -> (points (nq,), weights (nq,)), weights sum to 1."""
    nq = max(1, (degree + 2) // 2)
    x, w = np.polynomial.legendre.leggauss(nq)
    return 0.5 * (x + 1.0), 0.5 * w


def p2_facet_basis(t: np.ndarray, local_edge: int):
    """P2 basis restricted to local edge k, at edge parameters t in [0,1].

    Edge k runs from vertex (k+1)%3 to vertex (k+2)%3.  Returns phi (nt, 6).
    Only the 3 dofs supported on the edge are nonzero.
    """
    i, j = (local_edge + 1) % 3, (local_edge + 2) % 3
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pts = (1 - t)[:, None] * verts[i] + t[:, None] * verts[j]
    phi, _ = p2_basis(pts)
    return phi, pts


def p1_facet_basis(t: np.ndarray, local_edge: int):
    i, j = (local_edge + 1) % 3, (local_edge + 2) % 3
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pts = (1 - t)[:, None] * verts[i] + t[:, None] * verts[j]
    phi, _ = p1_basis(pts)
    return phi, pts
