"""Geometric multigrid for the PCD Ap subsolve and the velocity block.

The port of ``fenapack_tpu/solvers/gmg.py``: hierarchies built by uniform
refinement with parent tracking (curved boundaries snapped after every
refinement), re-discretized coarse operators, damped-Jacobi or
minimal-residual smoothing and a dense explicit-inverse coarse solve.

  * P1 prolongation interpolates each fine vertex from its two parents;
    restriction is its transpose.
  * P2 transfers use the identity *P2 dofs on mesh M = vertices of
    refine(M)*: the wind moves fine -> coarse by injection (a slice), and
    P2 prolongation interpolates each fine edge midpoint with the coarse
    basis of its parent cell.
  * The velocity operator (Picard, or Picard plus the Newton reaction
    blocks) is re-assembled on every level from the injected wind, so each
    V-cycle follows the current nonlinear iterate.
  * Enclosed flow (no PCD Dirichlet rows) gets a pure-Neumann pressure
    hierarchy whose coarse solve is the dense inverse of ``Ap + 1/n``.
  * A base mesh whose P2 velocity space exceeds ``DENSE_MAX`` while its P1
    space does not gets one more level below it: the P1 space of the same
    mesh (:class:`PCoarseTransfer`), with the scalar convection-diffusion
    operator ``nu (Ap + Kp(w))`` plus P1 streamline diffusion and a dense
    inverse.  A base mesh too large even for that is solved by a fixed
    budget of minimal-residual sweeps; a pressure base level above the cap
    by Chebyshev iterations.
  * Unsteady schemes pass ``theta`` and ``inv_dt``: every level's operator
    becomes ``theta A1 + inv_dt M`` (and ``theta R``); ``supg`` adds the
    P2 streamline diffusion to every level but the fine one after that
    combination (the fine level is the caller's operator).

Triangle meshes refine 1:4 and tet meshes 1:8 (``fem.mesh3d``).  With
``block_size`` the transfers are stored as BSR matrices and applied by the
BSR SpMV kernel; without it prolongations are gathers and each restriction
is the transposed prolongation stored as an ELL matrix and applied by the
ELL SpMV kernel, whose rows sum in a fixed order (a scatter-add would sum
in no fixed order on the card).

Every level takes the fine assembler's dof order (``reorder``): natural,
or each level relabeled by its own RCM (``TaylorHood(reorder=True)``), as
the block layout's assemblers are by default.  The transfers then compose
the two levels' ranks: their stencils are indexed by the new fine ids and
point at the new coarse ids, and the wind's injection is a gather.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..fem import elements, elements3d, mesh3d
from ..fem import mesh as meshmod
from ..ops import subsolve
from ..ops.sparse import ELL, BlockSparsityPattern, SparsityPattern
from .config import MultigridConfig, VelocityConfig
from ..ops.dist import LOCAL
from ..utils import timing

# Largest coarse system inverted densely (the JAX package's default
# FENAPACK_GMG_DENSE_MAX).  Read at every build, so a test may lower it.
DENSE_MAX = 8192


# --------------------------------------------------------------------- #
# hierarchy construction
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class MeshHierarchy:
    """Coarse-to-fine meshes (``TriMesh`` or ``TetMesh``) from uniform
    refinement.  ``parents[l]`` maps level-(l+1) vertices to their two
    level-l parent vertices (equal for surviving coarse vertices)."""
    meshes: List[object]
    parents: List[np.ndarray]

    @property
    def fine(self):
        return self.meshes[-1]


def build_hierarchy(coarse, levels: int,
                    snap: Optional[Callable] = None) -> MeshHierarchy:
    """Refine ``coarse`` ``levels`` times (1:4 for a triangle mesh, 1:8 for
    a tet mesh); the finest mesh is the problem mesh.  ``snap(mesh)``, if
    given, is applied to every refined mesh in place
    (``mesh.snap_to_circle`` for the cylinder: new boundary vertices go
    back onto the true geometry).  The P1 transfer keeps the (1/2, 1/2)
    parent stencil at snapped vertices; the P2 transfer takes its midpoint
    weights from the snapped coordinates."""
    refine = (mesh3d.refine_uniform3d if coarse.vertices.shape[1] == 3
              else meshmod.refine_uniform)
    meshes, parents = [coarse], []
    for _ in range(levels):
        fine, par = refine(meshes[-1])
        if snap is not None:
            snap(fine)
        meshes.append(fine)
        parents.append(par)
    return MeshHierarchy(meshes=meshes, parents=parents)


def _ordering(fine_asm, reorder: Optional[bool]) -> bool:
    """A hierarchy's dof order: ``reorder`` where given, else the fine
    assembler's (natural without one).  A fine assembler in the other order
    raises: its vectors would meet levels they do not match."""
    fine = None if fine_asm is None else bool(fine_asm.W.reorder)
    if reorder is None:
        return bool(fine)
    if fine is not None and fine != bool(reorder):
        raise ValueError(f"fine_asm has reorder={fine} but the hierarchy "
                         f"reorder={bool(reorder)}: the orderings must match")
    return bool(reorder)


def _ids(rank: Optional[np.ndarray], n: int) -> np.ndarray:
    """A level's new dof ids by old id: its rank, or the identity."""
    return (np.arange(n, dtype=np.int64) if rank is None
            else np.asarray(rank, dtype=np.int64))


def _block_transfer(rows, cols, vals, n_rows, n_cols, block, device):
    pat = BlockSparsityPattern(rows, cols, n_rows, n_cols, block=block,
                               device=device)
    return pat.assemble(vals)


def _ell_restriction(rows, cols, vals: np.ndarray, n_fine, n_coarse, dtype,
                     device) -> ELL:
    """The restriction, the transpose of the prolongation with entries
    ``(rows, cols, vals)`` (fine row, coarse column), as an ELL matrix:
    each coarse row sums its fine entries in column order, the same order
    on every run.  Entries of weight exactly 0 (a coarse P2 function that
    vanishes at a fine midpoint: about half of them in 3D) are left out."""
    keep = vals != 0.0
    pat = SparsityPattern(cols[keep], rows[keep], n_coarse, n_fine,
                          device=device)
    return pat.assemble(torch.as_tensor(vals[keep], dtype=dtype,
                                        device=device))


class P1Transfer:
    """Prolongation/restriction between two P1 levels from parent pairs.
    ``rank_fine`` / ``rank_coarse``: the levels' relabelings (old vertex ->
    new dof), None where a level keeps the natural order."""

    def __init__(self, parents: np.ndarray, n_coarse: int, dtype, *, device,
                 block_size: Optional[int] = None,
                 rank_fine: Optional[np.ndarray] = None,
                 rank_coarse: Optional[np.ndarray] = None):
        nf = parents.shape[0]
        pa = parents[:, 0].astype(np.int64)
        pb = parents[:, 1].astype(np.int64)
        if rank_fine is not None or rank_coarse is not None:
            rf, rc = _ids(rank_fine, nf), _ids(rank_coarse, n_coarse)
            pa_r, pb_r = np.empty_like(pa), np.empty_like(pb)
            pa_r[rf], pb_r[rf] = rc[pa], rc[pb]
            pa, pb = pa_r, pb_r
        self.pa = torch.as_tensor(pa, device=device)
        self.pb = torch.as_tensor(pb, device=device)
        self.n_coarse, self.n_fine = n_coarse, nf
        self._P = None
        rows = np.arange(nf, dtype=np.int64).repeat(2)
        cols = np.stack([pa, pb], axis=1).ravel()
        if block_size:
            vals = torch.full((2 * nf,), 0.5, dtype=dtype, device=device)
            self._P = _block_transfer(rows, cols, vals, nf, n_coarse,
                                      block_size, device)
            self._PT = _block_transfer(cols, rows, vals, n_coarse, nf,
                                       block_size, device)
        else:
            self._PT = _ell_restriction(rows, cols, np.full(2 * nf, 0.5),
                                        nf, n_coarse, dtype, device)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        if self._P is not None:
            return self._P.mv(xc)
        return 0.5 * (xc[self.pa] + xc[self.pb])

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        return self._PT.mv(rf)


# --------------------------------------------------------------------- #
# generic V-cycle over static level lists
# --------------------------------------------------------------------- #

def _jacobi_smooth(matvec, dinv, omega, iters, b, x):
    for _ in range(iters):
        x = x + omega * dinv * (b - matvec(x))
    return x


def _minres_smooth(matvec, dinv, iters, b, x, dist=LOCAL):
    """Minimal-residual smoother: the Jacobi-preconditioned Krylov
    directions ``z_i = (D^-1 A)^i D^-1 r`` and the combination of them that
    minimizes ``|r - A Z y|``, from the (iters x iters) normal equations
    with the ridge ``1e-7 trace(G) / iters + 1e-30`` (finite when the
    directions degenerate).  Robust on convection-dominated, nonsymmetric
    level operators, where damped Jacobi with a fixed omega amplifies
    characteristic modes.  The small system is solved by
    ``torch.linalg.solve_ex``, which leaves its ``info`` on the device:
    the smoother makes no host synchronisation.  ``dist``: the layout of
    the level's vectors (:mod:`.dist`); the Gram sums are reduced over its
    ranks in one reduction."""
    r = b - matvec(x)
    z = dinv * r
    Zs, Ws = [], []
    for _ in range(iters):
        w = matvec(z)
        Zs.append(z)
        Ws.append(w)
        z = dinv * w
    W = torch.stack(Ws)                                  # (s, n)
    Z = torch.stack(Zs)
    G, c = dist.gram(W, r)
    lam = 1e-7 * torch.trace(G) / G.shape[0] + 1e-30
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    y = torch.linalg.solve_ex(G + lam * eye, c)[0]
    return x + Z.T @ y


def make_vcycle(matvecs: Sequence[Callable], dinvs: Sequence[torch.Tensor],
                transfers: Sequence, coarse_solve: Callable,
                masks: Sequence[Optional[torch.Tensor]],
                smooth_iters: int = 2, omega: float = 0.67,
                cycles: int = 1, smoother: str = "jacobi",
                dists: Optional[Sequence] = None) -> Callable:
    """Fixed-shape V-cycle ``solve(b) -> x``.  ``matvecs``, ``dinvs`` and
    ``masks`` are per level, coarse to fine; ``transfers`` connect
    consecutive levels; ``masks`` chop the Dirichlet rows of restricted
    residuals (1.0 = pinned).  ``smoother``: "jacobi" (damped, ``omega``)
    or "minres" (:func:`_minres_smooth`).  ``dists``: each level's vector
    layout (default: whole on every level)."""
    if smoother not in ("jacobi", "minres"):
        raise ValueError(f"unknown smoother {smoother!r}")
    L = len(matvecs)
    dists = list(dists) if dists is not None else [LOCAL] * L

    def smooth(lvl, b, x):
        if smoother == "minres":
            return _minres_smooth(matvecs[lvl], dinvs[lvl], smooth_iters,
                                  b, x, dists[lvl])
        return _jacobi_smooth(matvecs[lvl], dinvs[lvl], omega, smooth_iters,
                              b, x)

    def chop(x, lvl):
        m = masks[lvl]
        return x * (1.0 - m) if m is not None else x

    def cycle(lvl: int, b: torch.Tensor) -> torch.Tensor:
        if lvl == 0:
            return coarse_solve(b)
        t = transfers[lvl - 1]
        x = smooth(lvl, b, torch.zeros_like(b))
        r = chop(b - matvecs[lvl](x), lvl)
        ec = cycle(lvl - 1, chop(t.restrict(r), lvl - 1))
        x = x + chop(t.prolong(ec), lvl)
        return smooth(lvl, b, x)

    def solve(b: torch.Tensor) -> torch.Tensor:
        x = cycle(L - 1, b)
        for _ in range(cycles - 1):
            # extra cycles as a stationary iteration
            x = x + cycle(L - 1, b - matvecs[L - 1](x))
        return x
    return solve


# --------------------------------------------------------------------- #
# pressure (Ap) GMG
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class PLevel:
    """One pressure level: its assembler, Ap operator and PCD-BC mask."""
    asm: object
    Ap: object
    mask: Optional[torch.Tensor]


class PressureHierarchy:
    """Per-level pressure stiffness and transfers for the Ap subsolve.
    ``pcd_markers``: facet markers whose P1 dofs are Dirichlet-pinned on
    every level (the PCD BC rows).  ``fine_asm`` (the solver's assembler)
    serves as the fine level; it must carry no alignment padding (the
    solver's padded pressure tail passes the V-cycle as identity)."""

    def __init__(self, hier: MeshHierarchy, dtype, *, device,
                 pcd_markers: Sequence[int] = (),
                 block_size: Optional[int] = None, fine_asm=None,
                 reorder: Optional[bool] = None):
        from ..fem.assemble import NSAssembler
        if fine_asm is not None and fine_asm.mesh is not hier.fine:
            raise ValueError("fine_asm was built on a different mesh")
        if fine_asm is not None and fine_asm.row_align != 1:
            raise ValueError("fine_asm with row alignment padding cannot "
                             "seed the hierarchy fine level")
        self.hier, self.dtype = hier, dtype
        self.reorder = _ordering(fine_asm, reorder)
        self.pcd_markers = tuple(pcd_markers)
        self.levels: List[PLevel] = []
        self.transfers: List[P1Transfer] = []
        ranks = []
        L = len(hier.meshes)
        for l, mesh in enumerate(hier.meshes):
            if fine_asm is not None and l == L - 1:
                asm = fine_asm
            else:
                asm = NSAssembler(mesh, nu=1.0, device=device, dtype=dtype,
                                  quad_degree=2, block_size=block_size,
                                  p1_only=True, reorder=self.reorder)
            Ap = asm.const.Ap.with_vals(asm.const.Ap.vals.to(dtype))
            dofs = asm.W.Q.facet_dofs(list(pcd_markers))
            mask = None
            if dofs.size:
                m = np.zeros(asm.n1)
                m[dofs] = 1.0
                mask = torch.as_tensor(m, dtype=dtype, device=device)
            self.levels.append(PLevel(asm, Ap, mask))
            ranks.append(asm.W.Q.rank if self.reorder else None)
            if l > 0:
                self.transfers.append(P1Transfer(
                    hier.parents[l - 1], hier.meshes[l - 1].num_vertices,
                    dtype, device=device, block_size=block_size,
                    rank_fine=ranks[l], rank_coarse=ranks[l - 1]))


def make_gmg_solver(hierarchy: PressureHierarchy, cfg: MultigridConfig,
                    dtype) -> Callable:
    """Ap^{-1} approximation by V-cycles on the pressure hierarchy, with the
    Dirichlet rows of the hierarchy's own ``pcd_markers`` on every level.
    A fine vector longer than the hierarchy's fine space passes its tail
    through as identity."""
    matvecs, dinvs, masks = [], [], []
    for lev in hierarchy.levels:
        Ap, mask = lev.Ap, lev.mask
        diag = Ap.diag_from(lev.asm.pat_p1.diag_pos)
        if mask is not None:
            free = 1.0 - mask
            mv = (lambda A, fr, mk: lambda x: fr * A.mv(fr * x) + mk * x)(
                Ap, free, mask)
            diag = torch.where(mask > 0, torch.ones_like(diag), diag)
        else:
            mv = Ap.mv
        matvecs.append(mv)
        dinvs.append(1.0 / diag)
        masks.append(mask)

    lev0 = hierarchy.levels[0]
    if lev0.Ap.shape[0] > DENSE_MAX:
        # too large for an explicit inverse: the coarse operator is SPD, so
        # Chebyshev with measured Jacobi-scaled bounds solves it
        lmin, lmax = subsolve.power_bounds(matvecs[0], dinvs[0],
                                           lev0.Ap.shape[0])
        coarse = subsolve.chebyshev_solver(
            matvecs[0], dinvs[0], lmin, lmax,
            iters=max(16, 4 * cfg.smooth_iters))
    elif lev0.mask is None:
        # enclosed flow: regularize the singular coarse Neumann operator
        A = lev0.asm.pat_p1.to_dense(lev0.Ap.vals).to(dtype)
        coarse = subsolve.dense_lu_solver(A + 1.0 / A.shape[0])
    else:
        coarse = subsolve.masked_spd_solver_dense(lev0.Ap, lev0.asm.pat_p1,
                                                  lev0.mask, dtype)
    vcycle = make_vcycle(matvecs, dinvs, hierarchy.transfers, coarse, masks,
                         smooth_iters=cfg.smooth_iters, cycles=cfg.cycles)
    n_hier = hierarchy.levels[-1].Ap.shape[0]

    def solve(b: torch.Tensor) -> torch.Tensor:
        xh = vcycle(b[:n_hier])
        if b.shape[0] == n_hier:
            return xh
        return torch.cat([xh, b[n_hier:]])
    return solve


# --------------------------------------------------------------------- #
# velocity block GMG (P2 vector field, wind-dependent operator)
# --------------------------------------------------------------------- #

class P2Transfer:
    """P2 scalar-field transfer between a mesh and its refinement (2D and
    3D): the first ``nv_f`` fine dofs (fine vertices) coincide with the
    coarse P2 dofs; each fine edge midpoint is interpolated with the coarse
    P2 basis (6 functions on a triangle, 10 on a tet) of its parent cell
    (weights precomputed on the host).  ``rank_fine`` / ``rank_coarse``:
    the levels' relabelings (old dof -> new dof), None where a level keeps
    the natural order."""

    def __init__(self, coarse, fine, dtype, *, device,
                 block_size: Optional[int] = None,
                 rank_fine: Optional[np.ndarray] = None,
                 rank_coarse: Optional[np.ndarray] = None):
        d = coarse.vertices.shape[1]
        nv_f, ne_f = fine.num_vertices, fine.num_edges
        self.n_coarse = coarse.num_vertices + coarse.num_edges
        if self.n_coarse != nv_f:
            raise ValueError("fine mesh must be the refinement of coarse")
        self.n_fine = nv_f + ne_f
        # refinement emits the children of each coarse cell (4 on a
        # triangle, 8 on a tet) in contiguous blocks of length nc_coarse
        child_parent = np.tile(np.arange(coarse.num_cells, dtype=np.int64),
                               4 if d == 2 else 8)
        fe_cell = np.full(ne_f, -1, dtype=np.int64)
        for k in range(fine.cell_edges.shape[1]):
            fe_cell[fine.cell_edges[:, k]] = np.arange(fine.num_cells)
        parent = child_parent[fe_cell]
        mids = 0.5 * (fine.vertices[fine.edges[:, 0]]
                      + fine.vertices[fine.edges[:, 1]])
        v = coarse.vertices[coarse.cells[parent]]        # (ne_f, d+1, d)
        J = np.stack([v[:, i + 1] - v[:, 0] for i in range(d)], axis=2)
        ref = np.linalg.solve(J, (mids - v[:, 0])[..., None])[..., 0]
        phi, _ = (elements if d == 2 else elements3d).p2_basis(ref)
        nb2 = phi.shape[1]
        cdofs = np.concatenate([coarse.cells[parent],
                                coarse.num_vertices
                                + coarse.cell_edges[parent]], axis=1)
        cdofs = cdofs.astype(np.int64)
        relabeled = rank_fine is not None or rank_coarse is not None
        rf = _ids(rank_fine, self.n_fine)
        rc = _ids(rank_coarse, self.n_coarse)
        self._inj = None
        if relabeled:
            # fine vertex i is coarse dof i: new coarse id -> new fine id
            inj = np.empty(self.n_coarse, dtype=np.int64)
            inj[rc[:nv_f]] = rf[:nv_f]
            self._inj = torch.as_tensor(inj, device=device)
            # the gather prolongation's stencil of every new fine id: an
            # identity entry at a vertex, the basis weights at a midpoint
            mid_dofs = np.zeros((self.n_fine, nb2), dtype=np.int64)
            mid_w = np.zeros((self.n_fine, nb2))
            mid_dofs[rf[:nv_f], 0] = rc[:nv_f]
            mid_w[rf[:nv_f], 0] = 1.0
            mid_dofs[rf[nv_f:]] = rc[cdofs]
            mid_w[rf[nv_f:]] = phi
        else:
            mid_dofs, mid_w = cdofs, phi
        self._relabeled = relabeled
        self.mid_dofs = torch.as_tensor(mid_dofs, device=device)
        self.mid_w = torch.as_tensor(mid_w, dtype=dtype, device=device)
        self._P = None
        rows = np.concatenate([rf[:nv_f], rf[nv_f:].repeat(nb2)])
        cols = np.concatenate([rc[:nv_f], rc[cdofs].ravel()])
        vals = np.concatenate([np.ones(nv_f), phi.ravel()])
        if block_size:
            vals = torch.as_tensor(vals, dtype=dtype, device=device)
            self._P = _block_transfer(rows, cols, vals, self.n_fine,
                                      self.n_coarse, block_size, device)
            self._PT = _block_transfer(cols, rows, vals, self.n_coarse,
                                       self.n_fine, block_size, device)
        else:
            self._PT = _ell_restriction(rows, cols, vals, self.n_fine,
                                        self.n_coarse, dtype, device)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        if self._P is not None:
            return self._P.mv(xc)
        mid = torch.sum(self.mid_w * xc[self.mid_dofs], dim=1)
        return mid if self._relabeled else torch.cat([xc, mid])

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        return self._PT.mv(rf)

    def inject(self, xf: torch.Tensor) -> torch.Tensor:
        """Fine P2 -> coarse P2 by point evaluation (for the wind): the
        leading slice, or a gather by the levels' ranks."""
        if self._inj is not None:
            return xf[self._inj]
        return xf[:self.n_coarse]


class VelocityHierarchy:
    """Per-level assemblers, P2 transfers and scalar Dirichlet masks for the
    velocity convection-diffusion block.  ``bc_markers``: facet markers
    carrying velocity Dirichlet BCs (values are irrelevant: multigrid
    solves error equations).  ``p1_mask``: the base level's mask at its
    vertices in P1 ids, the p-coarse bottom level's (alignment padding
    pinned)."""

    def __init__(self, hier: MeshHierarchy, nu: float, dtype, *, device,
                 bc_markers: Sequence[int] = (), fine_asm=None,
                 block_size: Optional[int] = None,
                 reorder: Optional[bool] = None):
        from ..fem.assemble import NSAssembler
        self.hier, self.nu, self.dtype = hier, nu, dtype
        self.reorder = _ordering(fine_asm, reorder)
        self.asms, self.masks, self.transfers = [], [], []
        ranks = []
        last = len(hier.meshes) - 1
        for l, mesh in enumerate(hier.meshes):
            if l == last and fine_asm is not None:
                asm = fine_asm
            else:
                asm = NSAssembler(mesh, nu=nu, device=device, dtype=dtype,
                                  quad_degree=4, block_size=block_size,
                                  reorder=self.reorder)
            self.asms.append(asm)
            ranks.append(asm.W.V.rank if self.reorder else None)
            m = np.zeros(asm.n2)
            if bc_markers:
                m[asm.W.V.facet_dofs(list(bc_markers))] = 1.0
            self.masks.append(torch.as_tensor(m, dtype=dtype, device=device))
            if l == 0:
                m1 = np.ones(asm.n1)
                m1[_ids(asm.W.Q.rank if self.reorder else None,
                        mesh.num_vertices)] = m[asm.W.V.vertex_dofs()]
                self.p1_mask = torch.as_tensor(m1, dtype=dtype,
                                               device=device)
            if l > 0:
                self.transfers.append(P2Transfer(
                    hier.meshes[l - 1], mesh, dtype, device=device,
                    block_size=block_size, rank_fine=ranks[l],
                    rank_coarse=ranks[l - 1]))


class PCoarseTransfer:
    """P1 <-> P2 embedding on one mesh (the p-coarse bottom level).
    ``prolong`` interpolates a P1 function into the P2 space of the same
    mesh (vertex dofs copy, edge-midpoint dofs average their edge's
    endpoints); ``restrict`` is its transpose.  For a base mesh whose P2
    space is over ``DENSE_MAX`` (the DFG cylinder: ~18.6k velocity dofs at
    level 0) the P1 space is 4x smaller and brings back an exact bottom
    solve."""

    def __init__(self, W, *, device, dtype=torch.float64):
        mesh = W.mesh
        nv = mesh.num_vertices
        self.n_coarse, self.n_fine = W.Q.dim, W.V.dim
        # new P2 ids of the vertices and edge midpoints, new P1 ids of the
        # vertices (the identity in the natural order)
        reordered = bool(W.reorder)
        p2 = _ids(W.V.rank if reordered else None, self.n_fine)
        q = _ids(W.Q.rank if reordered else None, nv)
        # one 0.5 weight per index slot: vertex rows hit their own P1 dof
        # twice, edge rows their two endpoints
        IA, IB = np.empty(self.n_fine, np.int64), np.empty(self.n_fine,
                                                           np.int64)
        IA[p2[:nv]] = IB[p2[:nv]] = q
        IA[p2[nv:]] = q[mesh.edges[:, 0]]
        IB[p2[nv:]] = q[mesh.edges[:, 1]]
        self._IA = torch.as_tensor(IA, device=device)
        self._IB = torch.as_tensor(IB, device=device)
        self._PT = _ell_restriction(
            np.arange(self.n_fine, dtype=np.int64).repeat(2),
            np.stack([IA, IB], axis=1).ravel(), np.full(2 * self.n_fine, 0.5),
            self.n_fine, self.n_coarse, dtype, device)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return 0.5 * (xc[self._IA] + xc[self._IB])

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        return self._PT.mv(rf)


class _VectorTransfer:
    """Lift a scalar transfer to the stacked [u_x; u_y[; u_z]] layout.

    ``n2c``/``n2f`` are the (possibly alignment-padded) per-component
    sizes; the scalar transfer acts on the leading real dofs and the
    padding stays zero.  ``dist`` lays out the fine level's vectors (the
    coarse level is whole): a restriction gathers the fine vector, a
    prolongation keeps the rank's rows."""

    def __init__(self, t: P2Transfer, n2c: int, n2f: int, d: int = 2,
                 dist=LOCAL):
        self.t, self.n2c, self.n2f, self.d = t, n2c, n2f, d
        self.dist = dist

    @staticmethod
    def _pad(x, n):
        return torch.nn.functional.pad(x, (0, n - x.shape[0])) \
            if n > x.shape[0] else x

    def prolong(self, xc):
        t, n2c = self.t, self.n2c
        return self.dist.rows(torch.cat([
            self._pad(t.prolong(xc[a * n2c:(a + 1) * n2c][:t.n_coarse]),
                      self.n2f) for a in range(self.d)]), "u")

    def restrict(self, rf):
        t, n2f = self.t, self.n2f
        rf = self.dist.full(rf, "u")
        return torch.cat([
            self._pad(t.restrict(rf[a * n2f:(a + 1) * n2f][:t.n_fine]),
                      self.n2c) for a in range(self.d)])


def _velocity_gmg_plan(vh: VelocityHierarchy, d: int):
    """``(pcoarse, dense)``: the bottom-level strategy, shared by the
    assembly half and the closure half of the velocity V-cycle.  Neither:
    minimal-residual sweeps on the base level."""
    asm0 = vh.asms[0]
    pcoarse = d * asm0.n2 > DENSE_MAX >= d * asm0.n1
    dense = (not pcoarse) and d * asm0.n2 <= DENSE_MAX
    return pcoarse, dense


def _pcoarse_mask(vh: VelocityHierarchy, d: int) -> torch.Tensor:
    """Stacked P1 Dirichlet mask of the p-coarse bottom level: the base
    level's P2 mask at the vertices."""
    return torch.cat([vh.p1_mask] * d)


def _velocity_level_masks(vh: VelocityHierarchy, bc_mask_u_fine, d: int):
    """Stacked per-level velocity masks, coarse to fine (fine = caller's)."""
    L = len(vh.asms)
    return [bc_mask_u_fine if l == L - 1 else torch.cat([vh.masks[l]] * d)
            for l in range(L)]


def dense_velocity_block(pattern, A1vals: torch.Tensor,
                         R: Optional[torch.Tensor], d: int) -> torch.Tensor:
    """Dense (d*n2, d*n2) velocity block: ``A1`` on each diagonal block,
    plus the Newton reaction blocks ``R[a, b]`` when given."""
    A = torch.block_diag(*([pattern.to_dense(A1vals)] * d))
    if R is not None:
        A = A + torch.cat([torch.cat([pattern.to_dense(R[a, b])
                                      for b in range(d)], dim=1)
                           for a in range(d)], dim=0)
    return A


def velocity_block_operator(pattern, A1vals: torch.Tensor,
                            R: Optional[torch.Tensor], mask: torch.Tensor):
    """``(mv, dinv)`` of the bc-masked velocity block over ``pattern``:
    ``mv(x) = free A (free x) + mask x`` for the stacked d components (A1
    on each diagonal block plus the Newton reaction blocks ``R[a, b]`` when
    given) and the inverse of its diagonal (1 on the masked rows).  In the
    ELL layout the block is one block product; in the BSR layout each
    component is one single product with A1, plus one per reaction
    block."""
    n2 = pattern.n_rows
    d = mask.shape[0] // n2
    free = 1.0 - mask
    A1 = pattern.matrix(A1vals)
    Rm = (None if R is None else
          [[pattern.matrix(R[a, b]) for b in range(d)] for a in range(d)])
    if isinstance(A1, ELL):
        blk = pattern.block_matrix(A1vals, R)

        def block(xf):
            return blk.mv(xf.view(d, n2)).view(-1)
    else:
        def block(xf):
            comps = [xf[a * n2:(a + 1) * n2] for a in range(d)]
            ys = [A1.mv(comps[a]) for a in range(d)]
            if Rm is not None:
                for a in range(d):
                    for b in range(d):
                        ys[a] = ys[a] + Rm[a][b].mv(comps[b])
            return torch.cat(ys)

    diag1 = A1.diag_from(pattern.diag_pos)
    diag = torch.cat([diag1 if Rm is None else
                      diag1 + Rm[a][a].diag_from(pattern.diag_pos)
                      for a in range(d)])
    diag = torch.where(mask > 0, torch.ones_like(diag), diag)
    return (lambda x: free * block(free * x) + mask * x), 1.0 / diag


def velocity_gmg_values(vh: VelocityHierarchy, wind_fine: torch.Tensor,
                        bc_mask_u_fine: torch.Tensor, dtype,
                        newton: bool = False, fine_values=None,
                        theta: float = 1.0, inv_dt: float = 0.0,
                        supg: bool = False):
    """Assembly half of the velocity V-cycle: the operator values ``(A1,
    R)`` of every level (``R`` the Newton reaction blocks, None for
    Picard; the fine level is ``fine_values`` when given), the P1 values of
    the p-coarse bottom level and the dense inverse of the masked bottom
    operator (None where the bottom is solved by sweeps).  ``theta`` and
    ``inv_dt`` turn every level into the unsteady schemes' effective
    operator ``theta A1 + inv_dt M2`` with ``theta R``; ``fine_values``
    must then hold that combination already.  ``supg`` adds the streamline
    diffusion to every level's A1 after that combination, unscaled; the
    fine level takes the caller's values as they are (under
    ``system_supg`` with theta != 1 the fine level carries theta SUPG and
    the coarse levels SUPG, as in the JAX package)."""
    L = len(vh.asms)
    d = vh.asms[-1].dim
    unsteady = theta != 1.0 or inv_dt != 0.0
    winds = [None] * L
    winds[L - 1] = wind_fine
    for l in range(L - 2, -1, -1):
        n2f = vh.asms[l + 1].n2
        winds[l] = torch.cat([vh.transfers[l].inject(
            winds[l + 1][a * n2f:(a + 1) * n2f]) for a in range(d)])

    def level_values(asm, wl):
        A1 = asm.picard_matrix_values(wl).to(dtype)
        if unsteady:
            A1 = theta * A1 + inv_dt * asm.mass2(hi=False).vals.to(dtype)
        if supg:
            A1 = A1 + asm.supg_values(wl).to(dtype)
        R = None
        if newton:
            R = asm.newton_reaction_values(wl).to(dtype)
            if theta != 1.0:
                R = theta * R
        return A1, R

    levels = [level_values(asm, winds[l])
              for l, asm in enumerate(vh.asms[:-1])]
    if fine_values is not None:
        A1f, Rf = fine_values
        levels.append((A1f.to(dtype), None if Rf is None else Rf.to(dtype)))
    else:
        levels.append(level_values(vh.asms[-1], winds[-1]))

    asm0 = vh.asms[0]
    pcoarse, dense = _velocity_gmg_plan(vh, d)
    p1_vals = coarse_inv = None
    if pcoarse:
        # the p-coarse bottom level (see PCoarseTransfer): nu (Ap + Kp(w))
        # per component, Picard form; the Newton reaction is left to the
        # smoothed P2 levels (an inexactness of the preconditioner only)
        w0 = winds[0].to(dtype)
        p1_vals = vh.nu * (asm0.const.Ap.vals.to(dtype)
                           + asm0.kp_values(w0).to(dtype))
        if unsteady:
            p1_vals = (theta * p1_vals
                       + inv_dt * (vh.nu * asm0.const.Mp.vals.to(dtype)))
        # streamline diffusion after the theta/inv_dt combination, as on
        # the P2 levels: a theta-scaled stabilization would weaken the
        # base level relative to the rest of the hierarchy
        p1_vals = p1_vals + asm0.supg_p1_values(w0).to(dtype)
        A = torch.block_diag(*([asm0.pat_p1.to_dense(p1_vals)] * d))
        mask0 = _pcoarse_mask(vh, d)
    elif dense:
        A = dense_velocity_block(asm0.pat_p2, *levels[0], d)
        mask0 = _velocity_level_masks(vh, bc_mask_u_fine, d)[0]
    if pcoarse or dense:
        free0 = 1.0 - mask0
        A = free0[:, None] * A * free0[None, :] + torch.diag(mask0)
        coarse_inv = torch.linalg.inv(A)
        timing.host_sync()          # inv reads its singularity check
    return {"levels": levels, "p1_vals": p1_vals, "coarse_inv": coarse_inv}


def make_velocity_gmg_from_values(vh: VelocityHierarchy,
                                  cfg: VelocityConfig, vals,
                                  bc_mask_u_fine: torch.Tensor,
                                  omega: float = 0.6,
                                  dist=LOCAL) -> Callable:
    """Closure half of the velocity V-cycle, from
    :func:`velocity_gmg_values` output.  In the ELL layout a level matvec is
    one block product over the level's shared pattern (A1 on every
    component plus the Newton reaction blocks); in the BSR layout each
    component is one single-RHS product with the level's scalar operator,
    plus one per Newton reaction block.  The smoother is
    ``cfg.smoother``.  ``dist`` lays out the fine level's vectors (the
    solver's); the coarser levels are whole on every rank."""
    d = vh.asms[-1].dim
    L = len(vh.asms)
    level_masks = _velocity_level_masks(vh, bc_mask_u_fine, d)
    level_masks[-1] = dist.rows(level_masks[-1], "u")
    dists = [LOCAL] * (L - 1) + [dist]
    matvecs, dinvs, vtransfers = [], [], []
    for l, asm in enumerate(vh.asms):
        n2, mask_u = asm.n2, level_masks[l]
        mv, dinv = velocity_block_operator(asm.pat_p2, *vals["levels"][l],
                                           mask_u)
        matvecs.append(mv)
        dinvs.append(dinv)
        if l > 0:
            vtransfers.append(_VectorTransfer(vh.transfers[l - 1],
                                              vh.asms[l - 1].n2, n2, d=d,
                                              dist=dists[l]))

    asm0 = vh.asms[0]
    pcoarse, dense = _velocity_gmg_plan(vh, d)
    if pcoarse:
        # one more level below the base mesh: its P1 space.  The V-cycle
        # solves this level by the dense inverse and never applies its
        # matvec or diagonal, so the level's entries are placeholders
        matvecs.insert(0, None)
        dinvs.insert(0, None)
        level_masks.insert(0, _pcoarse_mask(vh, d))
        vtransfers.insert(0, _VectorTransfer(
            PCoarseTransfer(asm0.W, device=asm0.device, dtype=vh.dtype),
            asm0.n1, asm0.n2, d=d, dist=dists[0]))
        dists.insert(0, LOCAL)
    if pcoarse or dense:
        Ainv = dists[0].rows(vals["coarse_inv"], "u")
        coarse_solve = lambda b: Ainv @ dists[0].full(b, "u")
    else:
        # a fixed budget of minimal-residual sweeps (FGMRES is flexible:
        # an inexact bottom solve only shifts the iteration counts)
        mv0, dinv0 = matvecs[0], dinvs[0]
        sweeps = max(8, 2 * cfg.smooth_iters)

        def coarse_solve(b):
            x = _minres_smooth(mv0, dinv0, sweeps, b, torch.zeros_like(b),
                               dists[0])
            return _minres_smooth(mv0, dinv0, sweeps, b, x, dists[0])
    return make_vcycle(matvecs, dinvs, vtransfers, coarse_solve,
                       level_masks, smooth_iters=cfg.smooth_iters,
                       omega=omega, cycles=cfg.cycles,
                       smoother=cfg.smoother, dists=dists)


def make_velocity_gmg_from_wind(vh: VelocityHierarchy, cfg: VelocityConfig,
                                wind_fine: torch.Tensor,
                                bc_mask_u_fine: torch.Tensor, dtype,
                                omega: float = 0.6, newton: bool = False,
                                fine_values=None, theta: float = 1.0,
                                inv_dt: float = 0.0,
                                supg: bool = False,
                                dist=LOCAL) -> Callable:
    """V-cycle preconditioner for the velocity block, re-discretizing the
    Picard (``newton``: plus reaction) operator on every level from the
    injected wind.  ``fine_values`` is the fine level's ``(A1, R)``;
    ``theta``/``inv_dt``/``supg``: see :func:`velocity_gmg_values`.  The
    wind and ``bc_mask_u_fine`` are whole; ``dist`` lays out the vectors
    the V-cycle is applied to."""
    vals = velocity_gmg_values(vh, wind_fine, bc_mask_u_fine, dtype,
                               newton=newton, fine_values=fine_values,
                               theta=theta, inv_dt=inv_dt, supg=supg)
    return make_velocity_gmg_from_values(vh, cfg, vals, bc_mask_u_fine,
                                         omega=omega, dist=dist)
