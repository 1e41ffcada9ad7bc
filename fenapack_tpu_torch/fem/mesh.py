"""Triangle meshes for the PyTorch port (host-side NumPy).

The 2D part of ``fenapack_tpu/fem/mesh.py``, copied: structured
triangulations of axis-aligned box unions (rectangle, backward-facing step,
lid-driven cavity, channels), the graded and snapped mesh of the DFG
cylinder, uniform red refinement with parent tracking (the
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
CYLINDER = 4


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


def channel_mesh(level: int = 0, length: float = 4.0) -> TriMesh:
    """Straight channel [0,L]x[0,1]: inflow x=0, outflow x=L, walls y=0,1."""
    h = 0.25 / (2 ** level)
    mesh = rectangle_mesh(0.0, 0.0, length, 1.0, int(round(length / h)), int(round(1.0 / h)))
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 0] < tol,
        OUTFLOW: lambda x: x[:, 0] > length - tol,
    })
    return mesh


def obstacle_channel_mesh(level: int = 0, length: float = 6.0) -> TriMesh:
    """Channel [0,L]x[0,1] with a square obstacle [1.5,2]x[0.375,0.625].

    The structured-mesh analogue of the reference's unsteady
    flow-past-a-cylinder workload (BASELINE config 3 "channel/cylinder";
    the square cylinder is itself a standard vortex-shedding benchmark).
    Inflow x=0, outflow x=L; the obstacle surface carries WALL markers
    automatically (it is boundary).  level 0 has h = 1/8.
    """
    h = 0.125 / (2 ** level)
    ox0, ox1, oy0, oy1 = 1.5, 2.0, 0.375, 0.625
    mesh = box_union_mesh([
        (0.0, 0.0, ox0, 1.0),
        (ox0, 0.0, ox1, oy0),
        (ox0, oy1, ox1, 1.0),
        (ox1, 0.0, length, 1.0),
    ], h)
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 0] < tol,
        OUTFLOW: lambda x: x[:, 0] > length - tol,
    })
    return mesh


def _graded_axis(x0: float, x1: float, h_coarse: float,
                 fine_regions, slope: float = 0.25) -> np.ndarray:
    """Node positions on [x0, x1] with target spacing ``h(x)``: ``h_fine``
    inside each ``(a, b, h_fine)`` region, growing linearly at ``slope``
    away from it, capped at ``h_coarse``.  Generated by explicit stepping
    (x_{k+1} = x_k + h(x_k)) then affinely rescaled to land on x1 exactly.
    """
    def h_of(x):
        h = h_coarse
        for (a, b, hf) in fine_regions:
            if x < a:
                h = min(h, hf + slope * (a - x))
            elif x > b:
                h = min(h, hf + slope * (x - b))
            else:
                h = min(h, hf)
        return h

    pts = [x0]
    while pts[-1] < x1 - 1e-12:
        pts.append(pts[-1] + h_of(pts[-1]))
    pts = np.asarray(pts)
    # rescale the tail so the final node is exactly x1 (distributes the
    # overshoot multiplicatively over the steps; max perturbation < h/L)
    pts = x0 + (pts - x0) * (x1 - x0) / (pts[-1] - x0)
    return pts


def _tensor_tri_mesh(xs: np.ndarray, ys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices + right-diagonal triangles of a (non-uniform) tensor grid."""
    nx, ny = xs.shape[0] - 1, ys.shape[0] - 1
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    a, b, c, d = vid(I, J), vid(I + 1, J), vid(I + 1, J + 1), vid(I, J + 1)
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])
    return vertices, tris


def cylinder_channel_mesh(level: int = 0) -> TriMesh:
    """Schafer-Turek "flow around a cylinder" channel (benchmark 2D-1/2/3):
    [0, 2.2] x [0, 0.41] with a circular hole of radius 0.05 at (0.2, 0.2).

    The reference's unsteady demo geometry (BASELINE config 3); upstream
    gets the curved boundary from a DOLFIN/gmsh mesh — here a graded tensor
    grid is cut and SNAPPED: vertices within half a local cell of the
    circle are projected onto it, cells whose centroid falls inside are
    dropped, and a few Laplacian smoothing passes restore quality in the
    snap band.  The hole boundary is an inscribed polygon through
    on-circle vertices (geometric error O(h^2), refining with ``level``).

    Facet markers: INFLOW x=0, OUTFLOW x=2.2, WALL y=0/0.41, CYLINDER on
    the hole.  level 0: h_fine = r/4 at the cylinder, h_coarse ~ 0.05.
    """
    r, cx, cy = 0.05, 0.2, 0.2
    hf = 0.0125 / 2 ** level
    hc = 0.05 / 2 ** level
    # fine band around the cylinder + a moderately refined near wake
    xs = _graded_axis(0.0, 2.2, hc, [(cx - 3 * r, cx + 4 * r, hf),
                                     (cx + 4 * r, cx + 12 * r, 2 * hf)])
    ys = _graded_axis(0.0, 0.41, hc, [(cy - 3 * r, cy + 3 * r, hf)])
    vertices, tris = _tensor_tri_mesh(xs, ys)

    c = np.array([cx, cy])
    d = np.linalg.norm(vertices - c, axis=1)
    # snap: project near-circle vertices exactly onto the circle
    snap = np.abs(d - r) < 0.5 * hf
    vertices[snap] = c + r * (vertices[snap] - c) / d[snap, None]

    # drop cells whose centroid lies inside the (snapped) circle
    centroids = vertices[tris].mean(axis=1)
    keep = np.linalg.norm(centroids - c, axis=1) >= r
    tris = tris[keep]
    # safety: any surviving vertex strictly inside goes onto the circle too
    d = np.linalg.norm(vertices - c, axis=1)
    inside = d < r * (1 - 1e-12)
    used_mask = np.zeros(vertices.shape[0], dtype=bool)
    used_mask[np.unique(tris)] = True
    fix = inside & used_mask
    vertices[fix] = c + r * (vertices[fix] - c) / np.maximum(d[fix, None], 1e-30)

    # Laplacian smoothing in the snap band (quality repair): move interior
    # vertices near the hole toward their neighbor mean; circle and outer
    # boundary vertices stay fixed
    used = np.unique(tris)
    remap = np.full(vertices.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.shape[0])
    verts = vertices[used]
    cells = remap[tris]
    on_circle = np.abs(np.linalg.norm(verts - c, axis=1) - r) < 1e-12
    on_outer = ((verts[:, 0] < 1e-12) | (verts[:, 0] > 2.2 - 1e-12)
                | (verts[:, 1] < 1e-12) | (verts[:, 1] > 0.41 - 1e-12))
    dist = np.linalg.norm(verts - c, axis=1)
    movable = (~on_circle) & (~on_outer) & (dist < 3.5 * r)
    ev = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [0, 2]]])
    ev = np.unique(np.sort(ev, axis=1), axis=0)
    for _ in range(8):
        acc = np.zeros_like(verts)
        cnt = np.zeros(verts.shape[0])
        np.add.at(acc, ev[:, 0], verts[ev[:, 1]])
        np.add.at(acc, ev[:, 1], verts[ev[:, 0]])
        np.add.at(cnt, ev[:, 0], 1)
        np.add.at(cnt, ev[:, 1], 1)
        mean = acc / np.maximum(cnt, 1)[:, None]
        verts[movable] += 0.5 * (mean[movable] - verts[movable])

    mesh = _build_topology(verts, cells)
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 0] < tol,
        OUTFLOW: lambda x: x[:, 0] > 2.2 - tol,
        CYLINDER: lambda x: np.linalg.norm(x - c, axis=1) < r * 1.05,
    })
    return mesh


def triangle_quality(mesh: TriMesh) -> np.ndarray:
    """Per-cell quality 4*sqrt(3)*area / sum(edge^2): 1 = equilateral."""
    p = mesh.vertices[mesh.cells]
    e = p - np.roll(p, 1, axis=1)
    l2 = (e ** 2).sum(axis=2).sum(axis=1)
    area = 0.5 * np.abs((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    return 4 * np.sqrt(3.0) * area / np.maximum(l2, 1e-300)


def snap_to_circle(mesh: TriMesh, center=(0.2, 0.2), r: float = 0.05,
                   marker: int = CYLINDER) -> None:
    """Project all vertices of ``marker``-marked boundary facets onto the
    circle (in place).  Used as the ``snap`` hook of
    ``gmg.build_hierarchy`` so each refinement of a cylinder mesh pulls
    the new chord-midpoint vertices back onto the true geometry."""
    c = np.asarray(center, dtype=np.float64)
    on = mesh.facet_markers == marker
    vids = np.unique(mesh.edges[mesh.boundary_facets[on]])
    d = np.linalg.norm(mesh.vertices[vids] - c, axis=1)
    mesh.vertices[vids] = c + r * (mesh.vertices[vids] - c) / np.maximum(
        d[:, None], 1e-30)
