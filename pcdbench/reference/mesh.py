"""Meshes of the plain reference (NumPy): the backward-facing steps of the
configurations, built from their published description.

2D: ``([-1,0]x[0,1]) U ([0,L]x[-1,1])`` on a structured grid of spacing
``0.25 / 2**level``, each square split by its (0,0)-(1,1) diagonal.  Red
refinement of that grid is the same grid at half the spacing, so this is
the level-0 step refined ``level`` times.

3D: ``(([-1,0]x[0,1]) U ([0,L]x[-1,1])) x [0,W]``: cubes of side 0.5, each
split into the six Kuhn tetrahedra (one per order of the axis steps),
then ``level`` red refinements: four corner tetrahedra and the inner
octahedron cut along the diagonal between the midpoints of local edges
(0,2) and (1,3).  Cells are oriented positively after each stage by
swapping local vertices 2 and 3; the local order decides the diagonal, so
the stage order and the swap are part of the mesh.

A :class:`Mesh` holds vertices, cells, and the P2 layout: node
coordinates (vertices, then edge midpoints), each cell's P2 nodes, and the
boundary facets.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .quadrature import EDGES2, EDGES3


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray        # (nv, d)
    cells: np.ndarray           # (nc, d+1), positively oriented
    nodes: np.ndarray           # (nv + ne, d): P2 node coordinates
    cell_nodes: np.ndarray      # (nc, nb2): P2 nodes of each cell
    facet_nodes: np.ndarray     # (nbf, nfb2): P2 nodes of each boundary facet
    facet_mid: np.ndarray       # (nbf, d): boundary facet centroids

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]


def _orient(vertices: np.ndarray, cells: np.ndarray) -> np.ndarray:
    p = vertices[cells]
    d = vertices.shape[1]
    det = np.linalg.det(np.stack([p[:, k + 1] - p[:, 0] for k in range(d)],
                                 axis=1))
    cells = cells.copy()
    neg = det < 0
    if d == 2:
        cells[neg] = cells[neg][:, [0, 2, 1]]
    else:
        cells[neg] = cells[neg][:, [0, 1, 3, 2]]
    return cells


def _keep_boxes(vertices, cells, boxes):
    """Cells whose centroid lies in one of the boxes, the unused vertices
    dropped."""
    d = vertices.shape[1]
    cen = vertices[cells].mean(axis=1)
    keep = np.zeros(cells.shape[0], dtype=bool)
    tol = 1e-10
    for b in boxes:
        inside = np.ones(cells.shape[0], dtype=bool)
        for a in range(d):
            inside &= (cen[:, a] > b[a] - tol) & (cen[:, a] < b[d + a] + tol)
        keep |= inside
    cells = cells[keep]
    used = np.unique(cells)
    remap = np.full(vertices.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    return vertices[used], remap[cells]


def _grid(lo, hi, h):
    n = [int(round((hi[a] - lo[a]) / h)) for a in range(len(lo))]
    axes = [np.linspace(lo[a], hi[a], n[a] + 1) for a in range(len(lo))]
    pts = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                   axis=1)
    return pts, n


def _edges(cells: np.ndarray, local_edges, nv: int):
    """Unique edges (ne, 2) and each cell's edge ids in ``local_edges``
    order."""
    ev = np.sort(cells[:, np.array(local_edges)], axis=2).reshape(-1, 2)
    keys = ev[:, 0].astype(np.int64) * nv + ev[:, 1]
    uk, inv = np.unique(keys, return_inverse=True)
    return np.stack([uk // nv, uk % nv], axis=1), inv.reshape(cells.shape[0],
                                                               -1)


def tri_step(level: int, length: float) -> tuple:
    h = 0.25 / 2 ** level
    boxes = [(-1.0, 0.0, 0.0, 1.0), (0.0, -1.0, length, 1.0)]
    pts, (nx, ny) = _grid((-1.0, -1.0), (length, 1.0), h)
    vid = lambda i, j: i * (ny + 1) + j
    I, J = (g.ravel() for g in np.meshgrid(np.arange(nx), np.arange(ny),
                                           indexing="ij"))
    a, b, c, d = vid(I, J), vid(I + 1, J), vid(I + 1, J + 1), vid(I, J + 1)
    cells = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return _keep_boxes(pts, cells, boxes)


def tet_step(level: int, length: float, width: float = 1.0) -> tuple:
    h = 0.5
    boxes = [(-1.0, 0.0, 0.0, 0.0, 1.0, width),
             (0.0, -1.0, 0.0, length, 1.0, width)]
    pts, (nx, ny, nz) = _grid((-1.0, -1.0, 0.0), (length, 1.0, width), h)
    vid = lambda i, j, k: (i * (ny + 1) + j) * (nz + 1) + k
    I, J, K = (g.ravel() for g in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
    unit = np.eye(3, dtype=np.int64)
    tets = []
    for perm in itertools.permutations(range(3)):
        p1 = np.stack([I, J, K]) + unit[perm[0]][:, None]
        p2 = p1 + unit[perm[1]][:, None]
        tets.append(np.stack([vid(I, J, K), vid(*p1), vid(*p2),
                              vid(I + 1, J + 1, K + 1)], axis=1))
    v, cells = _keep_boxes(pts, np.concatenate(tets), boxes)
    cells = _orient(v, cells)
    for _ in range(level):
        v, cells = _refine_tets(v, cells)
    return v, cells


def _refine_tets(v: np.ndarray, cells: np.ndarray):
    nv = v.shape[0]
    edges, ce = _edges(cells, EDGES3, nv)
    v = np.concatenate([v, 0.5 * (v[edges[:, 0]] + v[edges[:, 1]])])
    m01, m02, m03, m12, m13, m23 = (nv + ce[:, k] for k in range(6))
    c0, c1, c2, c3 = (cells[:, k] for k in range(4))
    children = [(c0, m01, m02, m03), (c1, m01, m12, m13),
                (c2, m02, m12, m23), (c3, m03, m13, m23),
                (m02, m13, m01, m03), (m02, m13, m03, m23),
                (m02, m13, m23, m12), (m02, m13, m12, m01)]
    fine = np.concatenate([np.stack(ch, axis=1) for ch in children])
    return v, _orient(v, fine)


def build(vertices: np.ndarray, cells: np.ndarray) -> Mesh:
    """The P2 layout and boundary facets of a simplex mesh."""
    d = vertices.shape[1]
    cells = _orient(vertices, np.asarray(cells, dtype=np.int64))
    nv = vertices.shape[0]
    local = EDGES2 if d == 2 else EDGES3
    edges, ce = _edges(cells, local, nv)
    nodes = np.concatenate(
        [vertices, 0.5 * (vertices[edges[:, 0]] + vertices[edges[:, 1]])])
    cell_nodes = np.concatenate([cells, nv + ce], axis=1)
    # boundary facets: the facet opposite local vertex k, met by one cell
    nf = d + 1
    fl = [tuple(i for i in range(nf) if i != k) for k in range(nf)]
    fv = np.sort(cells[:, np.array(fl)], axis=2).reshape(-1, d)
    key = np.zeros(fv.shape[0], dtype=np.int64)
    for a in range(d):
        key = key * nv + fv[:, a]
    uk, first, counts = np.unique(key, return_index=True, return_counts=True)
    bf = fv[first[counts == 1]]                       # (nbf, d) vertices
    if d == 2:
        pairs = [(0, 1)]
    else:
        pairs = [(0, 1), (0, 2), (1, 2)]
    ekey = edges[:, 0] * nv + edges[:, 1]
    fe = []
    for i, j in pairs:
        lo, hi = np.minimum(bf[:, i], bf[:, j]), np.maximum(bf[:, i],
                                                            bf[:, j])
        fe.append(nv + np.searchsorted(ekey, lo * nv + hi))
    facet_nodes = np.concatenate([bf, np.stack(fe, axis=1)], axis=1)
    return Mesh(vertices=vertices, cells=cells, nodes=nodes,
                cell_nodes=cell_nodes, facet_nodes=facet_nodes,
                facet_mid=vertices[bf].mean(axis=1))
