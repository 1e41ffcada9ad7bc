"""P1/P2 tetrahedral elements and quadrature (3D Taylor-Hood, host-side NumPy).

Copied from ``fenapack_tpu/fem/elements3d.py``; mirrors
:mod:`fenapack_tpu_torch.fem.elements` in 3D.  Quadrature uses the Duffy
(conical-product) construction: Gauss-Jacobi rules collapsed onto the
reference tetrahedron, exact to the requested degree by construction (no
hand-typed Keast tables to get wrong).

Local dof conventions (must match :class:`.mesh3d.TetMesh`):
  P1: dofs 0..3 at vertices.
  P2: dofs 0..3 at vertices; dof 4+k at the midpoint of local edge k with
      LOCAL_EDGES = [(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)].
"""
from __future__ import annotations

import numpy as np

P1_DIM = 4
P2_DIM = 10

LOCAL_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def p1_basis(points: np.ndarray):
    """P1 basis at reference points (n,3) -> (phi (n,4), dphi (n,4,3))."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    lam = np.stack([1.0 - x - y - z, x, y, z], axis=1)
    dlam = np.tile(np.array([[-1.0, -1.0, -1.0],
                             [1.0, 0.0, 0.0],
                             [0.0, 1.0, 0.0],
                             [0.0, 0.0, 1.0]]), (points.shape[0], 1, 1))
    return lam, dlam


def p2_basis(points: np.ndarray):
    """P2 basis at reference points (n,3) -> (phi (n,10), dphi (n,10,3))."""
    lam, dlam = p1_basis(points)
    n = points.shape[0]
    phi = np.empty((n, 10))
    dphi = np.empty((n, 10, 3))
    for k in range(4):
        phi[:, k] = lam[:, k] * (2.0 * lam[:, k] - 1.0)
        dphi[:, k, :] = (4.0 * lam[:, k] - 1.0)[:, None] * dlam[:, k, :]
    for e, (i, j) in enumerate(LOCAL_EDGES):
        phi[:, 4 + e] = 4.0 * lam[:, i] * lam[:, j]
        dphi[:, 4 + e, :] = 4.0 * (lam[:, i][:, None] * dlam[:, j, :]
                                   + lam[:, j][:, None] * dlam[:, i, :])
    return phi, dphi


def tet_quadrature(degree: int):
    """Conical-product (Duffy) rule on the reference tet, exact to ``degree``.

    Returns (points (nq,3), weights (nq,)); weights sum to 1/6 (the volume).
    nq = n^3 with n = ceil((degree+1)/2) + 1 margin for the Jacobi weights
    — exactness comes from Gauss-Jacobi in each collapsed coordinate.
    """
    from scipy.special import roots_jacobi
    n = (degree + 2) // 2
    # map [-1,1] -> [0,1]
    t1, w1 = roots_jacobi(n, 2.0, 0.0)      # weight (1-x)^2
    t2, w2 = roots_jacobi(n, 1.0, 0.0)      # weight (1-x)
    t3, w3 = roots_jacobi(n, 0.0, 0.0)      # Legendre
    t1 = 0.5 * (t1 + 1.0); w1 = w1 / 8.0    # absorb (1-x)^2 Jacobian scale
    t2 = 0.5 * (t2 + 1.0); w2 = w2 / 4.0
    t3 = 0.5 * (t3 + 1.0); w3 = w3 / 2.0

    T1, T2, T3 = np.meshgrid(t1, t2, t3, indexing="ij")
    W = (w1[:, None, None] * w2[None, :, None] * w3[None, None, :]).ravel()
    a, b, c = T1.ravel(), T2.ravel(), T3.ravel()
    # Duffy: x = a, y = b(1-a), z = c(1-a)(1-b); |J| = (1-a)^2 (1-b)
    # the (1-a)^2 (1-b) factors are already in the Jacobi weights
    x = a
    y = b * (1.0 - a)
    z = c * (1.0 - a) * (1.0 - b)
    return np.stack([x, y, z], axis=1), W


def triangle_face_quadrature(degree: int):
    """2D triangle rule for surface integrals — reuse the 2D module."""
    from .elements import triangle_quadrature
    return triangle_quadrature(degree)
