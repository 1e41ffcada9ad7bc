"""Geometric multigrid for the PCD Ap subsolve and the velocity block.

The port of ``fenapack_tpu/solvers/gmg.py`` on the main path: hierarchies
built by uniform refinement with parent tracking, re-discretized coarse
operators, damped-Jacobi smoothing and a dense explicit-inverse coarse
solve.

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

With ``block_size`` the transfers are stored as BSR matrices and applied by
the BSR SpMV kernel; without it they are gathers and scatter-adds.
Dofs keep the natural order on every level.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..fem import mesh as meshmod
from ..fem.elements import p2_basis
from ..fem.mesh import TriMesh
from ..ops import subsolve
from ..ops.sparse import BlockSparsityPattern
from .config import MultigridConfig

# Largest coarse system inverted densely (the JAX package's default
# FENAPACK_GMG_DENSE_MAX); larger bottom levels are not ported yet.
DENSE_MAX = 8192


# --------------------------------------------------------------------- #
# hierarchy construction
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class MeshHierarchy:
    """Coarse-to-fine meshes from uniform refinement.  ``parents[l]`` maps
    level-(l+1) vertices to their two level-l parent vertices (equal for
    surviving coarse vertices)."""
    meshes: List[TriMesh]
    parents: List[np.ndarray]

    @property
    def fine(self) -> TriMesh:
        return self.meshes[-1]


def build_hierarchy(coarse: TriMesh, levels: int) -> MeshHierarchy:
    """Refine ``coarse`` ``levels`` times; the finest mesh is the problem
    mesh."""
    meshes, parents = [coarse], []
    for _ in range(levels):
        fine, par = meshmod.refine_uniform(meshes[-1])
        meshes.append(fine)
        parents.append(par)
    return MeshHierarchy(meshes=meshes, parents=parents)


def _block_transfer(rows, cols, vals, n_rows, n_cols, block, device):
    pat = BlockSparsityPattern(rows, cols, n_rows, n_cols, block=block,
                               device=device)
    return pat.assemble(vals)


class P1Transfer:
    """Prolongation/restriction between two P1 levels from parent pairs."""

    def __init__(self, parents: np.ndarray, n_coarse: int, dtype, *, device,
                 block_size: Optional[int] = None):
        nf = parents.shape[0]
        pa = parents[:, 0].astype(np.int64)
        pb = parents[:, 1].astype(np.int64)
        self.pa = torch.as_tensor(pa, device=device)
        self.pb = torch.as_tensor(pb, device=device)
        self.n_coarse, self.n_fine = n_coarse, nf
        self._P = self._PT = None
        if block_size:
            rows = np.arange(nf, dtype=np.int64).repeat(2)
            cols = np.stack([pa, pb], axis=1).ravel()
            vals = torch.full((2 * nf,), 0.5, dtype=dtype, device=device)
            self._P = _block_transfer(rows, cols, vals, nf, n_coarse,
                                      block_size, device)
            self._PT = _block_transfer(cols, rows, vals, n_coarse, nf,
                                       block_size, device)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        if self._P is not None:
            return self._P.mv(xc)
        return 0.5 * (xc[self.pa] + xc[self.pb])

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        if self._PT is not None:
            return self._PT.mv(rf)
        z = torch.zeros(self.n_coarse, dtype=rf.dtype, device=rf.device)
        z.index_add_(0, self.pa, 0.5 * rf)
        return z.index_add_(0, self.pb, 0.5 * rf)


# --------------------------------------------------------------------- #
# generic V-cycle over static level lists
# --------------------------------------------------------------------- #

def _jacobi_smooth(matvec, dinv, omega, iters, b, x):
    for _ in range(iters):
        x = x + omega * dinv * (b - matvec(x))
    return x


def make_vcycle(matvecs: Sequence[Callable], dinvs: Sequence[torch.Tensor],
                transfers: Sequence, coarse_solve: Callable,
                masks: Sequence[Optional[torch.Tensor]],
                smooth_iters: int = 2, omega: float = 0.67,
                cycles: int = 1) -> Callable:
    """Fixed-shape damped-Jacobi V-cycle ``solve(b) -> x``.  ``matvecs``,
    ``dinvs`` and ``masks`` are per level, coarse to fine; ``transfers``
    connect consecutive levels; ``masks`` chop the Dirichlet rows of
    restricted residuals (1.0 = pinned)."""
    L = len(matvecs)

    def smooth(lvl, b, x):
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
    serves as the fine level."""

    def __init__(self, hier: MeshHierarchy, dtype, *, device,
                 pcd_markers: Sequence[int] = (),
                 block_size: Optional[int] = None, fine_asm=None):
        from ..fem.assemble import NSAssembler
        if fine_asm is not None and fine_asm.mesh is not hier.fine:
            raise ValueError("fine_asm was built on a different mesh")
        self.hier, self.dtype = hier, dtype
        self.pcd_markers = tuple(pcd_markers)
        self.levels: List[PLevel] = []
        self.transfers: List[P1Transfer] = []
        L = len(hier.meshes)
        for l, mesh in enumerate(hier.meshes):
            if fine_asm is not None and l == L - 1:
                asm = fine_asm
            else:
                asm = NSAssembler(mesh, nu=1.0, device=device, dtype=dtype,
                                  quad_degree=2, block_size=block_size,
                                  p1_only=True)
            Ap = asm.const.Ap.with_vals(asm.const.Ap.vals.to(dtype))
            dofs = asm.W.Q.facet_dofs(list(pcd_markers))
            mask = None
            if dofs.size:
                m = np.zeros(asm.n1)
                m[dofs] = 1.0
                mask = torch.as_tensor(m, dtype=dtype, device=device)
            self.levels.append(PLevel(asm, Ap, mask))
            if l > 0:
                self.transfers.append(P1Transfer(
                    hier.parents[l - 1], hier.meshes[l - 1].num_vertices,
                    dtype, device=device, block_size=block_size))


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
        raise NotImplementedError(
            f"pressure GMG needs a coarse level of at most {DENSE_MAX} dofs "
            "(dense coarse solve)")
    if lev0.mask is None:
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
    """P2 scalar-field transfer between a mesh and its refinement: the first
    ``nv_f`` fine dofs (fine vertices) coincide with the coarse P2 dofs; each
    fine edge midpoint is interpolated with the coarse P2 basis of its
    parent cell (weights precomputed on the host)."""

    def __init__(self, coarse: TriMesh, fine: TriMesh, dtype, *, device,
                 block_size: Optional[int] = None):
        nv_f, ne_f = fine.num_vertices, fine.num_edges
        self.n_coarse = coarse.num_vertices + coarse.num_edges
        if self.n_coarse != nv_f:
            raise ValueError("fine mesh must be refine_uniform(coarse)")
        self.n_fine = nv_f + ne_f
        # refinement emits the 4 children of each coarse cell in 4
        # contiguous blocks of length nc_coarse
        child_parent = np.tile(np.arange(coarse.num_cells, dtype=np.int64), 4)
        fe_cell = np.full(ne_f, -1, dtype=np.int64)
        for k in range(fine.cell_edges.shape[1]):
            fe_cell[fine.cell_edges[:, k]] = np.arange(fine.num_cells)
        parent = child_parent[fe_cell]
        mids = 0.5 * (fine.vertices[fine.edges[:, 0]]
                      + fine.vertices[fine.edges[:, 1]])
        v = coarse.vertices[coarse.cells[parent]]        # (ne_f, 3, 2)
        J = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], axis=2)
        ref = np.linalg.solve(J, (mids - v[:, 0])[..., None])[..., 0]
        phi, _ = p2_basis(ref)                           # (ne_f, 6)
        nb2 = phi.shape[1]
        cdofs = np.concatenate([coarse.cells[parent],
                                coarse.num_vertices
                                + coarse.cell_edges[parent]], axis=1)
        self.mid_dofs = torch.as_tensor(cdofs.astype(np.int64),
                                        device=device)
        self.mid_w = torch.as_tensor(phi, dtype=dtype, device=device)
        self._P = self._PT = None
        if block_size:
            rows = np.concatenate([np.arange(nv_f, dtype=np.int64),
                                   np.arange(nv_f, self.n_fine,
                                             dtype=np.int64).repeat(nb2)])
            cols = np.concatenate([np.arange(nv_f, dtype=np.int64),
                                   cdofs.astype(np.int64).ravel()])
            vals = torch.as_tensor(
                np.concatenate([np.ones(nv_f), phi.ravel()]), dtype=dtype,
                device=device)
            self._P = _block_transfer(rows, cols, vals, self.n_fine,
                                      self.n_coarse, block_size, device)
            self._PT = _block_transfer(cols, rows, vals, self.n_coarse,
                                       self.n_fine, block_size, device)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        if self._P is not None:
            return self._P.mv(xc)
        mid = torch.sum(self.mid_w * xc[self.mid_dofs], dim=1)
        return torch.cat([xc, mid])

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        if self._PT is not None:
            return self._PT.mv(rf)
        z = rf[:self.n_coarse].clone()
        upd = self.mid_w * rf[self.n_coarse:, None]
        return z.index_add_(0, self.mid_dofs.reshape(-1), upd.reshape(-1))

    def inject(self, xf: torch.Tensor) -> torch.Tensor:
        """Fine P2 -> coarse P2 by point evaluation (for the wind)."""
        return xf[:self.n_coarse]


class VelocityHierarchy:
    """Per-level assemblers, P2 transfers and scalar Dirichlet masks for the
    velocity convection-diffusion block.  ``bc_markers``: facet markers
    carrying velocity Dirichlet BCs (values are irrelevant: multigrid
    solves error equations)."""

    def __init__(self, hier: MeshHierarchy, nu: float, dtype, *, device,
                 bc_markers: Sequence[int] = (), fine_asm=None,
                 block_size: Optional[int] = None):
        from ..fem.assemble import NSAssembler
        self.hier, self.nu, self.dtype = hier, nu, dtype
        self.asms, self.masks, self.transfers = [], [], []
        last = len(hier.meshes) - 1
        for l, mesh in enumerate(hier.meshes):
            if l == last and fine_asm is not None:
                asm = fine_asm
            else:
                asm = NSAssembler(mesh, nu=nu, device=device, dtype=dtype,
                                  quad_degree=4, block_size=block_size)
            self.asms.append(asm)
            m = np.zeros(asm.n2)
            if bc_markers:
                m[asm.W.V.facet_dofs(list(bc_markers))] = 1.0
            self.masks.append(torch.as_tensor(m, dtype=dtype, device=device))
            if l > 0:
                self.transfers.append(P2Transfer(
                    hier.meshes[l - 1], mesh, dtype, device=device,
                    block_size=block_size))


class _VectorTransfer:
    """Lift a scalar P2 transfer to the stacked [u_x; u_y] layout."""

    def __init__(self, t: P2Transfer, n2c: int, n2f: int, d: int = 2):
        self.t, self.n2c, self.n2f, self.d = t, n2c, n2f, d

    def prolong(self, xc):
        return torch.cat([self.t.prolong(xc[a * self.n2c:(a + 1) * self.n2c])
                          for a in range(self.d)])

    def restrict(self, rf):
        return torch.cat([self.t.restrict(rf[a * self.n2f:(a + 1) * self.n2f])
                          for a in range(self.d)])


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


def velocity_gmg_values(vh: VelocityHierarchy, wind_fine: torch.Tensor,
                        bc_mask_u_fine: torch.Tensor, dtype,
                        newton: bool = False, fine_values=None):
    """Assembly half of the velocity V-cycle: the operator values ``(A1,
    R)`` of every level (``R`` the Newton reaction blocks, None for
    Picard; the fine level is ``fine_values`` when given) and the dense
    inverse of the masked coarse operator."""
    L = len(vh.asms)
    d = vh.asms[-1].dim
    winds = [None] * L
    winds[L - 1] = wind_fine
    for l in range(L - 2, -1, -1):
        n2f = vh.asms[l + 1].n2
        winds[l] = torch.cat([vh.transfers[l].inject(
            winds[l + 1][a * n2f:(a + 1) * n2f]) for a in range(d)])

    def level_values(asm, wl):
        R = asm.newton_reaction_values(wl).to(dtype) if newton else None
        return asm.picard_matrix_values(wl).to(dtype), R

    levels = [level_values(asm, winds[l])
              for l, asm in enumerate(vh.asms[:-1])]
    if fine_values is not None:
        A1f, Rf = fine_values
        levels.append((A1f.to(dtype), None if Rf is None else Rf.to(dtype)))
    else:
        levels.append(level_values(vh.asms[-1], winds[-1]))

    asm0 = vh.asms[0]
    if d * asm0.n2 > DENSE_MAX:
        raise NotImplementedError(
            f"velocity GMG needs a coarse level of at most {DENSE_MAX} dofs")
    A = dense_velocity_block(asm0.pat_p2, *levels[0], d)
    mask0 = _velocity_level_masks(vh, bc_mask_u_fine, d)[0]
    free0 = 1.0 - mask0
    A = free0[:, None] * A * free0[None, :] + torch.diag(mask0)
    return {"levels": levels, "coarse_inv": torch.linalg.inv(A)}


def make_velocity_gmg_from_values(vh: VelocityHierarchy,
                                  cfg: MultigridConfig, vals,
                                  bc_mask_u_fine: torch.Tensor,
                                  omega: float = 0.6) -> Callable:
    """Closure half of the velocity V-cycle, from
    :func:`velocity_gmg_values` output.  Each component is one single-RHS
    product with the level's scalar operator, plus one per Newton reaction
    block."""
    d = vh.asms[-1].dim
    level_masks = _velocity_level_masks(vh, bc_mask_u_fine, d)
    matvecs, dinvs, vtransfers = [], [], []
    for l, asm in enumerate(vh.asms):
        n2, mask_u = asm.n2, level_masks[l]
        free = 1.0 - mask_u
        A1v, Rv = vals["levels"][l]
        A1 = asm.pat_p2.matrix(A1v)
        R = (None if Rv is None else
             [[asm.pat_p2.matrix(Rv[a, b]) for b in range(d)]
              for a in range(d)])

        def mv(x, A1=A1, R=R, n2=n2, free=free, mask=mask_u):
            xf = free * x
            comps = [xf[a * n2:(a + 1) * n2] for a in range(d)]
            ys = [A1.mv(comps[a]) for a in range(d)]
            if R is not None:
                for a in range(d):
                    for b in range(d):
                        ys[a] = ys[a] + R[a][b].mv(comps[b])
            return free * torch.cat(ys) + mask * x

        diag1 = A1.diag_from(asm.pat_p2.diag_pos)
        diag = torch.cat([diag1 if R is None else
                          diag1 + R[a][a].diag_from(asm.pat_p2.diag_pos)
                          for a in range(d)])
        diag = torch.where(mask_u > 0, torch.ones_like(diag), diag)
        matvecs.append(mv)
        dinvs.append(1.0 / diag)
        if l > 0:
            vtransfers.append(_VectorTransfer(vh.transfers[l - 1],
                                              vh.asms[l - 1].n2, n2, d=d))
    Ainv = vals["coarse_inv"]
    return make_vcycle(matvecs, dinvs, vtransfers, lambda b: Ainv @ b,
                       level_masks, smooth_iters=cfg.smooth_iters,
                       omega=omega, cycles=cfg.cycles)


def make_velocity_gmg_from_wind(vh: VelocityHierarchy, cfg: MultigridConfig,
                                wind_fine: torch.Tensor,
                                bc_mask_u_fine: torch.Tensor, dtype,
                                omega: float = 0.6, newton: bool = False,
                                fine_values=None) -> Callable:
    """V-cycle preconditioner for the velocity block, re-discretizing the
    Picard (``newton``: plus reaction) operator on every level from the
    injected wind.  ``fine_values`` is the fine level's ``(A1, R)``."""
    vals = velocity_gmg_values(vh, wind_fine, bc_mask_u_fine, dtype,
                               newton=newton, fine_values=fine_values)
    return make_velocity_gmg_from_values(vh, cfg, vals, bc_mask_u_fine,
                                         omega=omega)
