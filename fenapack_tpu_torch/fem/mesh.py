"""Triangle meshes for the PyTorch port (host-side NumPy).

The 2D part of ``fenapack_tpu/fem/mesh.py``, copied: structured
triangulations of axis-aligned box unions (rectangle, backward-facing step,
lid-driven cavity), uniform red refinement with parent tracking (the
geometric-multigrid prolongation stencil), edge/facet topology and boundary
facet markers.  The solver only sees the frozen index and coordinate arrays
built here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TriMesh:
    """An oriented 2D triangle mesh with edge/facet topology.

    Conventions:
      - ``cells[c] = (v0, v1, v2)`` is counter-clockwise (positive Jacobian).
      - Local edge ``k`` of a cell is the edge *opposite* local vertex ``k``,
        i.e. edge 0 connects (v1, v2), edge 1 connects (v0, v2), edge 2
        connects (v0, v1).  This matches the standard P2 local dof ordering
        (3 vertex dofs followed by 3 edge-midpoint dofs).
      - ``edges`` stores each unique edge once as a sorted vertex pair.
      - Boundary facets are edges incident to exactly one cell.
    """

    vertices: np.ndarray          # (nv, 2) float64
    cells: np.ndarray             # (nc, 3) int32, CCW
    edges: np.ndarray             # (ne, 2) int32, sorted pairs
    cell_edges: np.ndarray        # (nc, 3) int32: edge id opposite local vertex k
    boundary_facets: np.ndarray   # (nbf,) int32: edge ids on the boundary
    facet_cells: np.ndarray       # (nbf,) int32: the unique cell of each boundary facet
    facet_markers: np.ndarray     # (nbf,) int32: region id (0 = unmarked)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def hmin(self) -> float:
        p = self.vertices[self.cells]                     # (nc, 3, 2)
        e = np.linalg.norm(p - np.roll(p, 1, axis=1), axis=2)
        return float(e.min())

    def hmax(self) -> float:
        p = self.vertices[self.cells]
        e = np.linalg.norm(p - np.roll(p, 1, axis=1), axis=2)
        return float(e.max())

    def mark_boundary(self, markers: Dict[int, Callable[[np.ndarray], np.ndarray]],
                      overwrite: bool = False) -> None:
        """Assign integer markers to boundary facets.

        ``markers`` maps marker id -> predicate taking facet midpoints
        (n, 2) and returning a boolean mask.  Later entries win on overlap.
        Mirrors DOLFIN ``SubDomain.mark`` usage in the fenapack demos
        (fenapack demo ``demo_navier-stokes-pcd.py``: Gamma0/Gamma1/Gamma2
        boundary marking for walls/inflow/outflow).
        """
        if overwrite:
            self.facet_markers[:] = 0
        mids = self.facet_midpoints()
        for marker_id, predicate in markers.items():
            mask = np.asarray(predicate(mids), dtype=bool)
            self.facet_markers[mask] = marker_id

    def facet_midpoints(self) -> np.ndarray:
        fv = self.edges[self.boundary_facets]             # (nbf, 2)
        return 0.5 * (self.vertices[fv[:, 0]] + self.vertices[fv[:, 1]])

    def facet_vertices(self) -> np.ndarray:
        """(nbf, 2) vertex ids of each boundary facet."""
        return self.edges[self.boundary_facets]

    def facet_normals(self) -> np.ndarray:
        """Outward unit normals of boundary facets, (nbf, 2)."""
        fv = self.edges[self.boundary_facets]
        a = self.vertices[fv[:, 0]]
        b = self.vertices[fv[:, 1]]
        t = b - a
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        # orient outward: flip if pointing toward the opposite vertex of the cell
        cells = self.cells[self.facet_cells]              # (nbf, 3)
        mids = 0.5 * (a + b)
        centroids = self.vertices[cells].mean(axis=1)
        flip = np.einsum('ij,ij->i', n, centroids - mids) > 0
        n[flip] *= -1.0
        return n


def _build_topology(vertices: np.ndarray, cells: np.ndarray) -> TriMesh:
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int32)

    # enforce CCW orientation
    p = vertices[cells]
    det = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
           - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    flip = det < 0
    cells[flip] = cells[flip][:, [0, 2, 1]]

    # local edge k opposite local vertex k
    ev = np.stack([cells[:, [1, 2]], cells[:, [0, 2]], cells[:, [0, 1]]], axis=1)  # (nc,3,2)
    ev_sorted = np.sort(ev, axis=2).reshape(-1, 2).astype(np.int64)
    from ..native import unique_i64
    nv64 = np.int64(vertices.shape[0])
    ekeys, inverse = unique_i64(ev_sorted[:, 0] * nv64 + ev_sorted[:, 1])
    edges = np.stack([ekeys // nv64, ekeys % nv64], axis=1)
    cell_edges = inverse.reshape(-1, 3).astype(np.int32)

    # boundary = edges referenced exactly once
    counts = np.bincount(inverse, minlength=edges.shape[0])
    boundary = np.where(counts == 1)[0].astype(np.int32)
    # cell owning each boundary facet
    edge_to_cell = np.full(edges.shape[0], -1, dtype=np.int32)
    flat_cells = np.repeat(np.arange(cells.shape[0], dtype=np.int32), 3)
    edge_to_cell[inverse] = flat_cells
    facet_cells = edge_to_cell[boundary]

    return TriMesh(
        vertices=vertices,
        cells=cells,
        edges=edges.astype(np.int32),
        cell_edges=cell_edges,
        boundary_facets=boundary,
        facet_cells=facet_cells,
        facet_markers=np.zeros(boundary.shape[0], dtype=np.int32),
    )


def rectangle_mesh(x0: float, y0: float, x1: float, y1: float,
                   nx: int, ny: int, diagonal: str = "right") -> TriMesh:
    """Structured triangulation of [x0,x1] x [y0,y1] with nx*ny quads split in two."""
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    a, b, c, d = vid(I, J), vid(I + 1, J), vid(I + 1, J + 1), vid(I, J + 1)
    if diagonal == "right":
        tris = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    elif diagonal == "left":
        tris = np.concatenate([np.stack([a, b, d], 1), np.stack([b, c, d], 1)])
    elif diagonal == "crossed":
        # split each quad into 4 triangles around its center
        centers = 0.25 * (vertices[a] + vertices[b] + vertices[c] + vertices[d])
        cid = vertices.shape[0] + np.arange(a.shape[0])
        vertices = np.concatenate([vertices, centers])
        tris = np.concatenate([
            np.stack([a, b, cid], 1), np.stack([b, c, cid], 1),
            np.stack([c, d, cid], 1), np.stack([d, a, cid], 1)])
    else:
        raise ValueError(f"unknown diagonal {diagonal!r}")
    return _build_topology(vertices, tris)


def box_union_mesh(boxes, h: float, diagonal: str = "right") -> TriMesh:
    """Triangulate a union of axis-aligned boxes sharing a grid of spacing ``h``.

    Every box coordinate must be an integer multiple of ``h`` (up to fp noise).
    Used for the backward-facing step L-shaped domain.
    """
    boxes = [tuple(map(float, b)) for b in boxes]
    gx0 = min(b[0] for b in boxes)
    gy0 = min(b[1] for b in boxes)
    gx1 = max(b[2] for b in boxes)
    gy1 = max(b[3] for b in boxes)
    nx = int(round((gx1 - gx0) / h))
    ny = int(round((gy1 - gy0) / h))
    full = rectangle_mesh(gx0, gy0, gx1, gy1, nx, ny, diagonal=diagonal)

    centroids = full.vertices[full.cells].mean(axis=1)
    keep = np.zeros(full.num_cells, dtype=bool)
    tol = 1e-10
    for (bx0, by0, bx1, by1) in boxes:
        inside = ((centroids[:, 0] > bx0 - tol) & (centroids[:, 0] < bx1 + tol)
                  & (centroids[:, 1] > by0 - tol) & (centroids[:, 1] < by1 + tol))
        keep |= inside
    cells = full.cells[keep]
    used = np.unique(cells)
    remap = np.full(full.num_vertices, -1, dtype=np.int32)
    remap[used] = np.arange(used.shape[0], dtype=np.int32)
    return _build_topology(full.vertices[used], remap[cells])


def refine_uniform(mesh: TriMesh) -> Tuple[TriMesh, np.ndarray]:
    """Uniform 1:4 (red) refinement.

    Returns ``(fine_mesh, parents)`` where ``parents`` is (nv_fine, 2) int32:
    fine vertex i interpolates coarse vertices ``parents[i]`` with weights
    (1/2, 1/2); for surviving coarse vertices both parents equal the coarse id.
    This is exactly the P1 prolongation stencil used by the pressure GMG
    hierarchy (TPU-side replacement for the AMG the reference gets from PETSc).
    """
    nv = mesh.num_vertices
    midpoints = 0.5 * (mesh.vertices[mesh.edges[:, 0]] + mesh.vertices[mesh.edges[:, 1]])
    vertices = np.concatenate([mesh.vertices, midpoints])
    parents = np.concatenate([
        np.stack([np.arange(nv), np.arange(nv)], axis=1),
        mesh.edges.astype(np.int64),
    ]).astype(np.int32)

    v0, v1, v2 = mesh.cells[:, 0], mesh.cells[:, 1], mesh.cells[:, 2]
    # midpoint of edge opposite vertex k
    m0 = nv + mesh.cell_edges[:, 0]
    m1 = nv + mesh.cell_edges[:, 1]
    m2 = nv + mesh.cell_edges[:, 2]
    tris = np.concatenate([
        np.stack([v0, m2, m1], 1),
        np.stack([v1, m0, m2], 1),
        np.stack([v2, m1, m0], 1),
        np.stack([m0, m1, m2], 1),
    ])
    fine = _build_topology(vertices, tris)

    # propagate facet markers: fine boundary facet midpoints lie on coarse facets
    if mesh.facet_markers.any():
        _propagate_markers(mesh, fine)
    return fine, parents


def _propagate_markers(coarse: TriMesh, fine: TriMesh) -> None:
    """Transfer facet markers from coarse mesh to a refinement of it."""
    cf = coarse.edges[coarse.boundary_facets]
    a = coarse.vertices[cf[:, 0]]
    b = coarse.vertices[cf[:, 1]]
    mids = fine.facet_midpoints()
    scale = max(coarse.hmax(), 1.0)
    tol = 1e-9 * scale
    for i in range(cf.shape[0]):
        m = coarse.facet_markers[i]
        if m == 0:
            continue
        ab = b[i] - a[i]
        L2 = ab @ ab
        t = ((mids - a[i]) @ ab) / L2
        d = mids - (a[i] + np.clip(t, 0, 1)[:, None] * ab)
        on = (np.linalg.norm(d, axis=1) < tol)
        fine.facet_markers[on] = m


# ---------------------------------------------------------------------------
# Canonical problem domains (mirroring the reference demos, SURVEY.md section 2.1
# items 10-11: fenapack demo ``demo_navier-stokes-pcd.py`` backward-facing step).
# ---------------------------------------------------------------------------

# Facet marker ids used across demos/tests.
WALL, INFLOW, OUTFLOW = 1, 2, 3


def backward_step_mesh(level: int = 0, length: float = 5.0) -> TriMesh:
    """Backward-facing step: ([-1,0]x[0,1]) U ([0,L]x[-1,1]).

    Inflow at x=-1 (parabolic), outflow at x=L, walls elsewhere.
    ``level`` halves h each increment; level 0 has h = 1/4.
    """
    h = 0.25 / (2 ** level)
    mesh = box_union_mesh([(-1.0, 0.0, 0.0, 1.0), (0.0, -1.0, length, 1.0)], h)
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 0] < -1.0 + tol,
        OUTFLOW: lambda x: x[:, 0] > length - tol,
    })
    return mesh


def cavity_mesh(level: int = 0) -> TriMesh:
    """Lid-driven cavity on [0,1]^2; lid = top (marked INFLOW for PCD BCs)."""
    n = 8 * (2 ** level)
    mesh = rectangle_mesh(0.0, 0.0, 1.0, 1.0, n, n)
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 1] > 1.0 - tol,
    })
    return mesh
