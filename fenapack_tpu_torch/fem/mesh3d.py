"""Tetrahedral meshes for the 3D solver stack (BASELINE config 4).

Copied from ``fenapack_tpu/fem/mesh3d.py``.  Host-side (NumPy) machinery
mirroring :mod:`fenapack_tpu_torch.fem.mesh` in 3D: Kuhn-triangulated
structured boxes and box unions (the 3D backward-facing step), edge/face
topology (P2 dofs live on vertices + edge midpoints; boundary conditions and
surface integrals live on boundary triangle faces), and facet marking.

Upstream fenapack inherits 3D meshes from DOLFIN (``BoxMesh`` etc.); its
demo problems are 2D but the package is dimension-agnostic, so the 3D path
is provided natively here as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np


@dataclasses.dataclass
class TetMesh:
    """Oriented tetrahedral mesh with edge and boundary-face topology.

    Conventions:
      - ``cells[c] = (v0..v3)`` positively oriented (det > 0).
      - ``edges`` stores unique sorted vertex pairs; P2 dof ``nv + e`` sits
        at the midpoint of edge ``e``.
      - ``cell_edges[c, k]`` is the edge id of the k-th local edge with the
        local pair ordering LOCAL_EDGES = [(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)].
      - Boundary faces are triangles incident to exactly one cell;
        ``face_edges`` maps each boundary face to its 3 edge ids.
    """

    vertices: np.ndarray          # (nv, 3)
    cells: np.ndarray             # (nc, 4) int32
    edges: np.ndarray             # (ne, 2) int32 sorted
    cell_edges: np.ndarray        # (nc, 6) int32
    boundary_faces: np.ndarray    # (nbf, 3) int32 vertex triples (sorted)
    face_cells: np.ndarray        # (nbf,) int32 owning cell
    face_edges: np.ndarray        # (nbf, 3) int32 edge ids of the face
    facet_markers: np.ndarray     # (nbf,) int32

    LOCAL_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)])

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    def facet_midpoints(self) -> np.ndarray:
        return self.vertices[self.boundary_faces].mean(axis=1)

    def mark_boundary(self, markers: Dict[int, Callable[[np.ndarray], np.ndarray]],
                      overwrite: bool = False) -> None:
        """Assign markers to boundary faces via midpoint predicates
        (mirrors ``mesh.TriMesh.mark_boundary``)."""
        if overwrite:
            self.facet_markers[:] = 0
        mids = self.facet_midpoints()
        for marker_id, predicate in markers.items():
            mask = np.asarray(predicate(mids), dtype=bool)
            self.facet_markers[mask] = marker_id

    def face_normals(self) -> np.ndarray:
        """Outward unit normals of boundary faces, (nbf, 3)."""
        f = self.boundary_faces
        a, b, c = (self.vertices[f[:, 0]], self.vertices[f[:, 1]],
                   self.vertices[f[:, 2]])
        n = np.cross(b - a, c - a)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        centroids = self.vertices[self.cells[self.face_cells]].mean(axis=1)
        mids = (a + b + c) / 3.0
        flip = np.einsum("ij,ij->i", n, centroids - mids) > 0
        n[flip] *= -1.0
        return n

    def face_areas(self) -> np.ndarray:
        f = self.boundary_faces
        a, b, c = (self.vertices[f[:, 0]], self.vertices[f[:, 1]],
                   self.vertices[f[:, 2]])
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def _build_topology(vertices: np.ndarray, cells: np.ndarray) -> TetMesh:
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int32)

    # positive orientation
    p = vertices[cells]
    det = np.linalg.det(np.stack(
        [p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]], axis=1))
    flip = det < 0
    cells[flip] = cells[flip][:, [0, 1, 3, 2]]

    # edges (packed-key unique: np.unique(axis=0) pays a void-dtype
    # comparison sort — the native radix path is ~10x faster at scale)
    from ..native import unique_i64
    nv64 = np.int64(vertices.shape[0])
    le = TetMesh.LOCAL_EDGES
    ev = cells[:, le]                               # (nc, 6, 2)
    ev_sorted = np.sort(ev, axis=2).reshape(-1, 2).astype(np.int64)
    ekeys, e_inv = unique_i64(ev_sorted[:, 0] * nv64 + ev_sorted[:, 1])
    edges = np.stack([ekeys // nv64, ekeys % nv64], axis=1)
    cell_edges = e_inv.reshape(-1, 6).astype(np.int32)

    # faces: local face k opposite local vertex k
    lf = np.array([(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)])
    fv = cells[:, lf]                               # (nc, 4, 3)
    fv_sorted = np.sort(fv, axis=2).reshape(-1, 3).astype(np.int64)
    if nv64 ** 3 < 2 ** 62:             # packed triple fits in int64
        fkeys, f_inv = unique_i64(
            (fv_sorted[:, 0] * nv64 + fv_sorted[:, 1]) * nv64
            + fv_sorted[:, 2])
        faces = np.stack([fkeys // (nv64 * nv64), (fkeys // nv64) % nv64,
                          fkeys % nv64], axis=1)
        f_counts = np.bincount(f_inv, minlength=fkeys.shape[0])
    else:
        faces, f_inv, f_counts = np.unique(
            fv_sorted, axis=0, return_inverse=True, return_counts=True)
    boundary = np.where(f_counts == 1)[0]
    face_to_cell = np.full(faces.shape[0], -1, dtype=np.int32)
    flat_cells = np.repeat(np.arange(cells.shape[0], dtype=np.int32), 4)
    face_to_cell[f_inv] = flat_cells
    bfaces = faces[boundary].astype(np.int32)
    face_cells = face_to_cell[boundary]

    # edge ids of each boundary face: pairs (0,1),(0,2),(1,2) of the sorted triple
    pair = np.stack([bfaces[:, [0, 1]], bfaces[:, [0, 2]],
                     bfaces[:, [1, 2]]], axis=1).reshape(-1, 2)
    keys_all = edges[:, 0].astype(np.int64) * vertices.shape[0] + edges[:, 1]
    keys = pair[:, 0].astype(np.int64) * vertices.shape[0] + pair[:, 1]
    order = np.argsort(keys_all)
    pos = order[np.searchsorted(keys_all[order], keys)]
    face_edges = pos.reshape(-1, 3).astype(np.int32)

    return TetMesh(
        vertices=vertices, cells=cells, edges=edges.astype(np.int32),
        cell_edges=cell_edges, boundary_faces=bfaces, face_cells=face_cells,
        face_edges=face_edges,
        facet_markers=np.zeros(bfaces.shape[0], dtype=np.int32))


def box_mesh(x0, y0, z0, x1, y1, z1, nx, ny, nz) -> TetMesh:
    """Structured box: each of nx*ny*nz cubes split into 6 Kuhn tets
    (conforming across cubes — all tets share the main diagonal direction)."""
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    # Kuhn: 6 tets per cube, one per permutation of (e_x, e_y, e_z):
    # path v0 -> v0+e_{s0} -> +e_{s1} -> +e_{s2} ( = opposite corner)
    import itertools
    steps = {0: (1, 0, 0), 1: (0, 1, 0), 2: (0, 0, 1)}
    tets = []
    for perm in itertools.permutations((0, 1, 2)):
        a = vid(I, J, K)
        i1, j1, k1 = I + steps[perm[0]][0], J + steps[perm[0]][1], K + steps[perm[0]][2]
        b = vid(i1, j1, k1)
        i2, j2, k2 = i1 + steps[perm[1]][0], j1 + steps[perm[1]][1], k1 + steps[perm[1]][2]
        c = vid(i2, j2, k2)
        d = vid(I + 1, J + 1, K + 1)
        tets.append(np.stack([a, b, c, d], axis=1))
    return _build_topology(vertices, np.concatenate(tets))


def box_union_mesh3d(boxes, h: float) -> TetMesh:
    """Union of axis-aligned boxes on a common grid of spacing ``h``
    (3D analogue of ``mesh.box_union_mesh``)."""
    boxes = [tuple(map(float, b)) for b in boxes]
    g0 = [min(b[d] for b in boxes) for d in range(3)]
    g1 = [max(b[3 + d] for b in boxes) for d in range(3)]
    n = [int(round((g1[d] - g0[d]) / h)) for d in range(3)]
    full = box_mesh(g0[0], g0[1], g0[2], g1[0], g1[1], g1[2], *n)
    centroids = full.vertices[full.cells].mean(axis=1)
    keep = np.zeros(full.num_cells, dtype=bool)
    tol = 1e-10
    for (bx0, by0, bz0, bx1, by1, bz1) in boxes:
        inside = ((centroids[:, 0] > bx0 - tol) & (centroids[:, 0] < bx1 + tol)
                  & (centroids[:, 1] > by0 - tol) & (centroids[:, 1] < by1 + tol)
                  & (centroids[:, 2] > bz0 - tol) & (centroids[:, 2] < bz1 + tol))
        keep |= inside
    cells = full.cells[keep]
    used = np.unique(cells)
    remap = np.full(full.num_vertices, -1, dtype=np.int32)
    remap[used] = np.arange(used.shape[0], dtype=np.int32)
    return _build_topology(full.vertices[used], remap[cells])


def refine_uniform3d(mesh: TetMesh) -> Tuple[TetMesh, np.ndarray]:
    """Uniform 1:8 (red) tet refinement with parent tracking.

    Returns ``(fine, parents)`` with the same contract as the 2D
    ``fem.mesh.refine_uniform``: ``parents`` is (nv_fine, 2) int32 — the
    P1 prolongation stencil (surviving vertices have equal parents, new
    vertices average their edge endpoints).  Child cells are emitted in 8
    contiguous blocks of ``num_cells`` (4 corner tets + 4 octahedron tets
    split along the fixed diagonal m02-m13), the order the P2 GMG transfer
    relies on to recover each fine cell's parent.
    """
    nv = mesh.num_vertices
    midpoints = 0.5 * (mesh.vertices[mesh.edges[:, 0]]
                       + mesh.vertices[mesh.edges[:, 1]])
    vertices = np.concatenate([mesh.vertices, midpoints])
    parents = np.concatenate([
        np.stack([np.arange(nv), np.arange(nv)], axis=1),
        mesh.edges.astype(np.int64),
    ]).astype(np.int32)

    v = [mesh.cells[:, k] for k in range(4)]
    # midpoint ids by local edge order LOCAL_EDGES=[(0,1),(0,2),(0,3),
    # (1,2),(1,3),(2,3)]
    m01, m02, m03, m12, m13, m23 = (nv + mesh.cell_edges[:, k]
                                    for k in range(6))
    blocks = [
        np.stack([v[0], m01, m02, m03], 1),     # corner tets
        np.stack([v[1], m01, m12, m13], 1),
        np.stack([v[2], m02, m12, m23], 1),
        np.stack([v[3], m03, m13, m23], 1),
        # octahedron split along diagonal (m02, m13); equator cycle
        # m01 -> m03 -> m23 -> m12 (consecutive pairs share a tet face)
        np.stack([m02, m13, m01, m03], 1),
        np.stack([m02, m13, m03, m23], 1),
        np.stack([m02, m13, m23, m12], 1),
        np.stack([m02, m13, m12, m01], 1),
    ]
    fine = _build_topology(vertices, np.concatenate(blocks))
    if mesh.facet_markers.any():
        _propagate_markers3d(mesh, fine, parents)
    return fine, parents


def _propagate_markers3d(coarse: TetMesh, fine: TetMesh,
                         parents: np.ndarray) -> None:
    """Transfer facet markers topologically: each fine boundary face is one
    of the 4 sub-triangles of a coarse boundary face, and the union of its
    vertices' parents is exactly that coarse face's vertex triple."""
    pu = parents[fine.boundary_faces]                 # (nbf_f, 3, 2)
    tri = np.sort(pu.reshape(pu.shape[0], -1), axis=1).astype(np.int64)
    # unique-ify the 6 sorted parent ids down to <=3 per row, vectorized
    # (the old per-row np.unique Python loop cost minutes at 3D scale):
    # keep each value's first occurrence, left-compact via argsort of the
    # keep mask (stable), pad with the row's last kept value.
    keep = np.ones_like(tri, dtype=bool)
    keep[:, 1:] = tri[:, 1:] != tri[:, :-1]
    # stable order: kept entries first, original order preserved
    order = np.argsort(~keep, axis=1, kind="stable")
    compact = np.take_along_axis(tri, order, axis=1)
    nkeep = keep.sum(axis=1)
    keys_f = compact[:, :3]
    # rows with fewer than 3 distinct parents: pad with the last distinct
    pad_val = np.take_along_axis(compact, (nkeep - 1)[:, None], axis=1)
    col = np.arange(3)[None, :]
    keys_f = np.where(col < nkeep[:, None], keys_f, pad_val)
    nvc = coarse.num_vertices
    key_f = (keys_f[:, 0] * nvc + keys_f[:, 1]) * nvc + keys_f[:, 2]
    cf = np.sort(coarse.boundary_faces, axis=1).astype(np.int64)
    key_c = (cf[:, 0] * nvc + cf[:, 1]) * nvc + cf[:, 2]
    order = np.argsort(key_c)
    pos = np.searchsorted(key_c[order], key_f)
    pos = np.clip(pos, 0, key_c.shape[0] - 1)
    hit = key_c[order[pos]] == key_f
    fine.facet_markers[hit] = coarse.facet_markers[order[pos[hit]]]


# marker ids shared with the 2D module
from .mesh import WALL, INFLOW, OUTFLOW   # noqa: E402


def backward_step_mesh3d(level: int = 0, length: float = 3.0,
                         width: float = 1.0) -> TetMesh:
    """3D backward-facing step (BASELINE config 4):
    ([-1,0]x[0,1] U [0,L]x[-1,1]) x [0,W].  Inflow x=-1, outflow x=L."""
    h = 0.5 / (2 ** level)
    mesh = box_union_mesh3d([(-1.0, 0.0, 0.0, 0.0, 1.0, width),
                             (0.0, -1.0, 0.0, length, 1.0, width)], h)
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 0] < -1.0 + tol,
        OUTFLOW: lambda x: x[:, 0] > length - tol,
    })
    return mesh


def channel_mesh3d(level: int = 0, length: float = 2.0) -> TetMesh:
    """Square duct [0,L] x [0,1]^2: inflow x=0, outflow x=L."""
    h = 0.5 / (2 ** level)
    n = int(round(1.0 / h))
    mesh = box_mesh(0.0, 0.0, 0.0, length, 1.0, 1.0,
                    int(round(length / h)), n, n)
    tol = 1e-9
    mesh.mark_boundary({
        WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        INFLOW: lambda x: x[:, 0] < tol,
        OUTFLOW: lambda x: x[:, 0] > length - tol,
    })
    return mesh
