"""The DFG cylinder channel of the unsteady configuration, as the reference
builds it: the published geometry and boundary data, a check that a given
mesh covers that geometry, and the mesh's Dirichlet nodes and values.

Schafer & Turek 1996 (test case 2D-2): the channel [0, 2.2] x [0, 0.41]
less a cylinder of radius 0.05 centred at (0.2, 0.2); nu = 1e-3; inflow
``4 U_m y (0.41 - y) / 0.41^2`` with U_m = 1.5 in x at x = 0; no-slip on the
walls y = 0, y = 0.41 and on the cylinder; natural outflow at x = 2.2.

The mesh is input data, as a model's weights are: the program's vertices
and triangles.  :func:`check` refuses one that is not a triangulation of
the published domain with the hole an inscribed polygon of the circle;
:func:`build` then lays the P2 nodes itself (:func:`.mesh.build`) and finds
the Dirichlet nodes by position.
"""
from __future__ import annotations

import numpy as np

from . import mesh as meshes

LENGTH, HEIGHT = 2.2, 0.41
CENTRE, RADIUS = np.array([0.2, 0.2]), 0.05
U_M = 1.5
NU = 1e-3
TOL = 1e-12


def inflow(x: np.ndarray) -> np.ndarray:
    """The published inflow velocity at points x (k, 2)."""
    g = np.zeros_like(x)
    g[:, 0] = 4.0 * U_M * x[:, 1] * (HEIGHT - x[:, 1]) / HEIGHT ** 2
    return g


def _boundary_edges(cells: np.ndarray) -> np.ndarray:
    """The edges (k, 2) that one triangle alone has."""
    e = np.sort(np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                cells[:, [0, 2]]]), axis=1)
    u, n = np.unique(e, axis=0, return_counts=True)
    return u[n == 1]


def check(vertices: np.ndarray, cells: np.ndarray) -> None:
    """ValueError unless ``(vertices, cells)`` triangulate the channel less
    an inscribed polygon of the circle: every vertex in the box and not
    inside the circle, every boundary vertex on a side of the box or on the
    circle, no triangle inverted or flat, and the triangles' total area the
    box's less the polygon's, to 1e-12 (relative for the area)."""
    v = np.asarray(vertices, dtype=np.float64)
    c = np.asarray(cells, dtype=np.int64)
    if v.ndim != 2 or v.shape[1] != 2 or c.ndim != 2 or c.shape[1] != 3:
        raise ValueError("expected 2D vertices and triangles")
    x, y = v[:, 0], v[:, 1]
    r = np.linalg.norm(v - CENTRE, axis=1)
    if not (np.all((x >= -TOL) & (x <= LENGTH + TOL))
            and np.all((y >= -TOL) & (y <= HEIGHT + TOL))):
        raise ValueError("a vertex lies outside the channel")
    if np.any(r < RADIUS - TOL):
        raise ValueError("a vertex lies inside the cylinder")
    e1, e2 = v[c[:, 1]] - v[c[:, 0]], v[c[:, 2]] - v[c[:, 0]]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    if not (np.all(det > 0) or np.all(det < 0)):
        raise ValueError("a triangle is inverted or flat")
    bv = np.unique(_boundary_edges(c))
    on_box = ((np.abs(x[bv]) <= TOL) | (np.abs(x[bv] - LENGTH) <= TOL)
              | (np.abs(y[bv]) <= TOL) | (np.abs(y[bv] - HEIGHT) <= TOL))
    on_circle = np.abs(r[bv] - RADIUS) <= TOL
    if not np.all(on_box | on_circle):
        raise ValueError(f"{int(np.sum(~(on_box | on_circle)))} boundary "
                         "vertices lie neither on the box nor on the circle")
    ring = v[bv[on_circle]] - CENTRE
    p = ring[np.argsort(np.arctan2(ring[:, 1], ring[:, 0]))]
    hole = 0.5 * abs(np.sum(p[:, 0] * np.roll(p[:, 1], -1)
                            - np.roll(p[:, 0], -1) * p[:, 1]))
    area = 0.5 * np.sum(np.abs(det))
    want = LENGTH * HEIGHT - hole
    if abs(area - want) > TOL * want:
        raise ValueError(f"the triangles cover {area!r}, the domain is "
                         f"{want!r}")


def build(vertices: np.ndarray, cells: np.ndarray):
    """``(mesh, dirichlet (n2,) bool, g (n2, 2))`` of a mesh that passes
    :func:`check`: nodes of boundary facets other than the outflow's are
    Dirichlet, the inflow's carry :func:`inflow` and the rest zero."""
    check(vertices, cells)
    m = meshes.build(np.asarray(vertices, dtype=np.float64), cells)
    outflow = np.abs(m.facet_mid[:, 0] - LENGTH) <= TOL
    infl = np.abs(m.facet_mid[:, 0]) <= TOL
    dirichlet = np.zeros(m.nodes.shape[0], dtype=bool)
    dirichlet[m.facet_nodes[~outflow].ravel()] = True
    g = np.zeros_like(m.nodes)
    on_in = np.zeros_like(dirichlet)
    on_in[m.facet_nodes[infl].ravel()] = True
    g[on_in] = inflow(m.nodes[on_in])
    return m, dirichlet, g
