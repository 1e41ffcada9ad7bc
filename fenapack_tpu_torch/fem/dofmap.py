"""Function spaces, dofmaps and Dirichlet boundary conditions (NumPy).

The port of ``fenapack_tpu/fem/dofmap.py``: P1/P2 on triangles and tets.  Velocity and pressure
unknowns live in separate flat arrays, so field-split index sets are static
slices; boundary conditions become masks and value arrays.

Velocity layout: scalar P2 dofs are [vertex dofs | edge-midpoint dofs]; the
vector-valued space stacks components: ``u = [u_x (n2); u_y (n2)]`` (and
``u_z`` in 3D).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import numpy as np

from .mesh import TriMesh


@dataclasses.dataclass
class P1Space:
    """Scalar continuous P1 (pressure space of Taylor-Hood)."""
    mesh: TriMesh

    @property
    def dim(self) -> int:
        return self.mesh.num_vertices

    @property
    def cell_dofs(self) -> np.ndarray:       # (nc, 3)
        return self.mesh.cells

    def dof_coords(self) -> np.ndarray:      # (ndof, 2)
        return self.mesh.vertices

    def facet_dofs(self, markers: Sequence[int]) -> np.ndarray:
        """Unique dofs on boundary facets with marker in ``markers``."""
        sel = np.isin(self.mesh.facet_markers, markers)
        fv = self.mesh.edges[self.mesh.boundary_facets[sel]]
        return np.unique(fv.ravel()).astype(np.int32)

    def vertex_dofs(self) -> np.ndarray:
        return np.arange(self.mesh.num_vertices, dtype=np.int32)


@dataclasses.dataclass
class P2Space:
    """Scalar continuous P2 (one velocity component of Taylor-Hood)."""
    mesh: TriMesh

    @property
    def dim(self) -> int:
        return self.mesh.num_vertices + self.mesh.num_edges

    @property
    def cell_dofs(self) -> np.ndarray:       # (nc, 6)
        nv = self.mesh.num_vertices
        return np.concatenate([self.mesh.cells, nv + self.mesh.cell_edges],
                              axis=1)

    def dof_coords(self) -> np.ndarray:
        mids = 0.5 * (self.mesh.vertices[self.mesh.edges[:, 0]]
                      + self.mesh.vertices[self.mesh.edges[:, 1]])
        return np.concatenate([self.mesh.vertices, mids])

    def facet_dofs(self, markers: Sequence[int]) -> np.ndarray:
        """Unique dofs (vertices and edge midpoints) on marked facets."""
        sel = np.isin(self.mesh.facet_markers, markers)
        facets = self.mesh.boundary_facets[sel]
        fv = self.mesh.edges[facets]
        nv = self.mesh.num_vertices
        return np.unique(np.concatenate([fv.ravel(), nv + facets])
                         ).astype(np.int32)

    def vertex_dofs(self) -> np.ndarray:
        return np.arange(self.mesh.num_vertices, dtype=np.int32)


@dataclasses.dataclass
class P1Space3D:
    """Scalar continuous P1 on tets (pressure space of 3D Taylor-Hood)."""
    mesh: object      # TetMesh

    @property
    def dim(self) -> int:
        return self.mesh.num_vertices

    @property
    def cell_dofs(self) -> np.ndarray:       # (nc, 4)
        return self.mesh.cells

    def dof_coords(self) -> np.ndarray:
        return self.mesh.vertices

    def facet_dofs(self, markers: Sequence[int]) -> np.ndarray:
        sel = np.isin(self.mesh.facet_markers, markers)
        fv = self.mesh.boundary_faces[sel]
        return np.unique(fv.ravel()).astype(np.int32)

    def vertex_dofs(self) -> np.ndarray:
        return np.arange(self.mesh.num_vertices, dtype=np.int32)


@dataclasses.dataclass
class P2Space3D:
    """Scalar continuous P2 on tets (one velocity component)."""
    mesh: object      # TetMesh

    @property
    def dim(self) -> int:
        return self.mesh.num_vertices + self.mesh.num_edges

    @property
    def cell_dofs(self) -> np.ndarray:       # (nc, 10)
        nv = self.mesh.num_vertices
        return np.concatenate([self.mesh.cells, nv + self.mesh.cell_edges],
                              axis=1)

    def dof_coords(self) -> np.ndarray:
        mids = 0.5 * (self.mesh.vertices[self.mesh.edges[:, 0]]
                      + self.mesh.vertices[self.mesh.edges[:, 1]])
        return np.concatenate([self.mesh.vertices, mids])

    def facet_dofs(self, markers: Sequence[int]) -> np.ndarray:
        """Vertices and edge midpoints of marked boundary faces."""
        sel = np.isin(self.mesh.facet_markers, markers)
        fv = self.mesh.boundary_faces[sel]
        fe = self.mesh.face_edges[sel]
        nv = self.mesh.num_vertices
        return np.unique(np.concatenate([fv.ravel(), nv + fe.ravel()])
                         ).astype(np.int32)

    def vertex_dofs(self) -> np.ndarray:
        return np.arange(self.mesh.num_vertices, dtype=np.int32)


class ReorderedSpace:
    """A scalar space with relabeled dofs: ``rank[old_dof] = new_dof``.

    Bandwidth-reducing (RCM) orderings keep the block-sparse layout's
    neighbour-block count small.  All dof-producing methods return NEW ids.
    """

    def __init__(self, base, rank: np.ndarray):
        self.base = base
        self.rank = np.asarray(rank, dtype=np.int32)
        self._perm = np.argsort(self.rank)        # new -> old

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def cell_dofs(self) -> np.ndarray:
        return self.rank[self.base.cell_dofs]

    def dof_coords(self) -> np.ndarray:
        return self.base.dof_coords()[self._perm]

    def facet_dofs(self, markers) -> np.ndarray:
        return self.rank[self.base.facet_dofs(markers)]

    def vertex_dofs(self) -> np.ndarray:
        """New dof ids sitting at mesh vertices."""
        return self.rank[:self.base.mesh.num_vertices]


def rcm_rank(cell_dofs: np.ndarray, ndof: int) -> np.ndarray:
    """Reverse-Cuthill-McKee rank (old dof -> new dof) from cell
    connectivity: the shared native kernel, else scipy."""
    from ..native import rcm_rank as native_rcm
    rank = native_rcm(cell_dofs, ndof)
    if rank is not None:
        return rank
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    a = cell_dofs.shape[1]
    rows = np.repeat(cell_dofs, a, axis=1).ravel()
    cols = np.tile(cell_dofs, (1, a)).ravel()
    A = sp.csr_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)),
                      shape=(ndof, ndof))
    perm = reverse_cuthill_mckee(A, symmetric_mode=True)   # new -> old
    rank = np.empty(ndof, dtype=np.int32)
    rank[perm] = np.arange(ndof, dtype=np.int32)
    return rank


@dataclasses.dataclass
class TaylorHood:
    """Mixed P2^d x P1 space on a triangle (d = 2) or tet (d = 3) mesh:
    ``dim_u = d * n2``, ``dim_p = n1``.  ``reorder`` relabels the velocity
    dofs by RCM and the pressure dofs by the ordering it induces on the
    shared vertices.

    ``align > 1`` pads each scalar space to a multiple of ``align`` (the
    row-sharded layout of :mod:`fenapack_tpu_torch.parallel.sharding`:
    every distributed axis divides by the number of ranks).  ``V.dim`` and
    ``Q.dim`` stay the real sizes; the padded dofs follow them, touch no
    cell, and the solvers pin them to identity rows."""
    mesh: object          # TriMesh or TetMesh
    align: int = 1
    reorder: bool = False

    def __post_init__(self):
        self.gdim = self.mesh.vertices.shape[1]
        if self.gdim == 2:
            self.V, self.Q = P2Space(self.mesh), P1Space(self.mesh)
        elif self.gdim == 3:
            self.V, self.Q = P2Space3D(self.mesh), P1Space3D(self.mesh)
        else:
            raise ValueError(f"no Taylor-Hood space in {self.gdim} "
                             f"dimensions")
        if self.reorder:
            v_rank = rcm_rank(self.V.cell_dofs, self.V.dim)
            self.V = ReorderedSpace(self.V, v_rank)
            nv = self.mesh.vertices.shape[0]
            q_rank = np.argsort(np.argsort(v_rank[:nv])).astype(np.int32)
            self.Q = ReorderedSpace(self.Q, q_rank)
        a = self.align
        self.n2 = -(-self.V.dim // a) * a      # padded scalar P2 size
        self.n1 = -(-self.Q.dim // a) * a      # padded P1 size

    @property
    def dim_u(self) -> int:
        return self.gdim * self.n2

    @property
    def dim_p(self) -> int:
        return self.n1

    @property
    def dim(self) -> int:
        return self.dim_u + self.dim_p

    def velocity_dof(self, scalar_dofs: np.ndarray, component: int
                     ) -> np.ndarray:
        """Map scalar-P2 dof ids to stacked vector-space dof ids."""
        return scalar_dofs + component * self.n2


@dataclasses.dataclass
class DirichletBC:
    """Strong BC: ``dofs`` (int32) pinned to ``values`` (float64)."""
    dofs: np.ndarray
    values: np.ndarray

    @staticmethod
    def velocity(W: TaylorHood, markers: Sequence[int],
                 value: Callable[[np.ndarray], np.ndarray]) -> "DirichletBC":
        """``value`` maps coords (n, d) -> velocity (n, d)."""
        sdofs = W.V.facet_dofs(markers)
        coords = W.V.dof_coords()[sdofs]
        vals = np.asarray(value(coords), dtype=np.float64)
        d = W.gdim
        dofs = np.concatenate([W.velocity_dof(sdofs, a) for a in range(d)])
        return DirichletBC(dofs.astype(np.int32),
                           np.concatenate([vals[:, a] for a in range(d)]))

    @staticmethod
    def pressure(W: TaylorHood, markers: Sequence[int],
                 value: float = 0.0) -> "DirichletBC":
        dofs = W.Q.facet_dofs(markers)
        return DirichletBC(dofs.astype(np.int32),
                           np.full(dofs.shape[0], value, dtype=np.float64))


def merge_bcs(bcs: Sequence[DirichletBC], dim: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge BCs into full-size float (mask, values); later BCs win.  The
    mask is 1.0 at constrained dofs, so operators apply symmetric Dirichlet
    elimination as ``y = free*A@(free*x) + mask*x``."""
    mask = np.zeros(dim)
    values = np.zeros(dim)
    for bc in bcs:
        mask[bc.dofs] = 1.0
        values[bc.dofs] = bc.values
    return mask, values
