"""Batched Taylor-Hood P2/P1 assembly on tensors, triangles and tets.

The port of ``fenapack_tpu/fem/assemble.py::NSAssembler``: per-cell element
tensors are batched matrix products over quadrature points, summed into
static-sparsity operators in a fixed order (``ops.sparse.SegmentSum``).
Constant operators (viscous Laplacian L, divergence D and gradient DT,
pressure mass Mp and stiffness Ap) are assembled once; the wind-dependent
ones (convection N(w), the Newton reaction blocks R_ab(w), pressure
convection Kp with the BRM2 inflow surface term, the P1 streamline
diffusion of the p-coarse multigrid level) are plain functions of the
current velocity iterate.

Precision follows the JAX package: a wind of lower precision than the
assembler is promoted before the element integrals, and ``compute32`` runs
the per-step convection integrals in f32 and casts the assembled values up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import elements as el
from . import elements3d as el3
from .dofmap import TaylorHood
from .mesh import INFLOW
from ..ops.sparse import (BlockSparsityPattern, SegmentSum,
                          pattern_from_dofmaps)


def _pad_rows(a: np.ndarray, n_extra: int) -> np.ndarray:
    """``a`` with ``n_extra`` rows of zeros appended."""
    if not n_extra:
        return a
    return np.concatenate(
        [a, np.zeros((n_extra,) + a.shape[1:], dtype=a.dtype)])


@dataclasses.dataclass
class ConstOperators:
    """Mesh-constant operators.  ``L`` is the unscaled scalar P2 stiffness
    (applied per component); ``D[a]``/``DT[a]`` the divergence/gradient
    blocks with the ``-int q d_a u_a`` sign, so the system is
    ``[[A, D^T], [D, 0]]``; ``Mp`` is scaled by 1/nu; ``Ap`` is unscaled.
    A pressure-only assembler leaves ``L``, ``D`` and ``DT`` empty.  ``M2``
    is the unscaled scalar P2 mass (the M/dt of the unsteady schemes), kept
    in the ELL layout only: a block-sparse set leaves it None and
    :meth:`NSAssembler.mass2` assembles it on demand."""
    L: Optional[object]
    Mp: object
    Ap: object
    D: Tuple[object, ...]
    DT: Tuple[object, ...]
    M2: Optional[object] = None


class NSAssembler:
    """Navier-Stokes / PCD operator assembly on one triangle or tet mesh
    (3D callers pass ``quad_degree=4``, as the JAX package's do).

    ``block_size`` selects the block-sparse (BSR) layout with that tile
    size; ``block_dtype`` the storage dtype of the compute-precision
    constants (``const``, in either layout: an f64 assembler with f32
    ``const`` serves an f32 preconditioner around the f64 outer matvec and
    residual of ``const_hi``); ``hi_block`` keeps the high-precision operators
    (``const_hi``, the outer matvec and residual) in the same block layout
    instead of ELL.  ``p1_only`` builds the pressure space alone (pattern,
    Ap, Mp), as the pressure multigrid levels need.  Velocity layout:
    ``u = [u_x (n2); u_y (n2)]`` (and ``u_z`` in 3D).  Under ``reorder``
    the velocity dofs are relabeled by RCM and the pressure dofs by the
    order it induces on the vertices (``TaylorHood(reorder=True)``);
    otherwise they keep the mesh's natural order.  ``reorder=None`` (the
    JAX package's default) reorders exactly in the block layout: a BSR
    tile stores zeros wherever its block row misses a block column, and
    RCM's narrow band cuts the stored slots per nonzero at b = 32 from
    195x to 25x for the scalar P2 operator at the step's level 4, while
    the ELL layout reads each row's own entries in either order.  The
    ring path (:mod:`fenapack_tpu_torch.parallel`) asks for it explicitly:
    it keeps every operator's bandwidth within one row block.

    ``row_align > 1`` pads both scalar spaces to multiples of it
    (``TaylorHood(align=)``; ``n2``, ``n1`` padded, ``n2_real``,
    ``n1_real`` real; ``u_active``/``p_active`` are 1.0 on the real dofs
    and 0.0 on the padding) and the cell axis with phantom cells of zero
    measure (zero ``Jinv``, ``adet``, ``g1`` and ``h_cell``), so that every
    axis divides by the number of ranks of the row-sharded path
    (:mod:`fenapack_tpu_torch.parallel.sharding`).  The sparsity patterns
    are those of the real cells: an assembly sum reads the entries of the
    real cells alone, and a phantom cell's element values are never read.
    """

    def __init__(self, mesh, nu: float, *, device, dtype=torch.float64,
                 quad_degree: int = 5, block_size: Optional[int] = None,
                 block_dtype=None, hi_block: bool = False,
                 p1_only: bool = False, reorder: Optional[bool] = None,
                 row_align: int = 1):
        t0 = time.perf_counter()
        self.device = torch.device(device)
        self._p1_only = bool(p1_only)
        self.mesh = mesh
        self.nu = float(nu)
        self.dtype = dtype
        self.quad_degree = quad_degree
        self.dim = d = mesh.vertices.shape[1]
        self.block_size = block_size
        self.row_align = int(row_align)
        if reorder is None:
            reorder = bool(block_size)
        self.W = W = TaylorHood(mesh, align=self.row_align, reorder=reorder)
        self.n2, self.n1 = W.n2, W.n1           # padded sizes
        self.n2_real, self.n1_real = W.V.dim, W.Q.dim
        # active-dof masks: 0.0 on the alignment padding
        p_act = np.zeros(self.n1)
        p_act[:self.n1_real] = 1.0
        u_act = np.zeros(d * self.n2)
        for a in range(d):
            u_act[a * self.n2:a * self.n2 + self.n2_real] = 1.0
        self._p_active_np, self._u_active_np = p_act, u_act

        if d == 2:
            qp, qw = el.triangle_quadrature(quad_degree)
            phi2, dphi2 = el.p2_basis(qp)
            phi1, dphi1 = el.p1_basis(qp)
        else:
            qp, qw = el3.tet_quadrature(quad_degree)
            phi2, dphi2 = el3.p2_basis(qp)
            phi1, dphi1 = el3.p1_basis(qp)
        self.nq = qp.shape[0]
        self.nb2, self.nb1 = phi2.shape[1], phi1.shape[1]

        v = mesh.vertices[mesh.cells]                       # (nc, d+1, d)
        J = np.stack([v[:, i + 1] - v[:, 0] for i in range(d)], axis=2)
        Jinv = np.linalg.inv(J)
        adet = np.abs(np.linalg.det(J))
        self._v0, self._Jinv_np = v[:, 0], Jinv
        g1 = np.einsum("ik,ckd->cid", dphi1[0], Jinv)       # (nc, nb1, d)
        # cell diameters, read by the streamline diffusion: the longest of
        # |v_i - v_(i-1)| taken cyclically, as in the JAX package (every
        # edge of a triangle; 4 of the 6 edges of a tet)
        h_cell = np.linalg.norm(v - np.roll(v, 1, axis=1), axis=2).max(axis=1)
        cd2 = W.V.cell_dofs.astype(np.int64)
        cd1 = W.Q.cell_dofs.astype(np.int64)
        # phantom cells pad the cell axis to a multiple of row_align: zero
        # geometry, dofmap rows of dof 0
        self.nc_real = nc = cd2.shape[0]
        nc_pad = -(-nc // self.row_align) * self.row_align - nc
        Jinv, g1, adet, h_cell = (_pad_rows(a, nc_pad)
                                  for a in (Jinv, g1, adet, h_cell))
        self.nc = nc + nc_pad
        self._cd2_np, self._cd1_np = _pad_rows(cd2, nc_pad), _pad_rows(
            cd1, nc_pad)

        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=self.device)
        self.cd2 = torch.as_tensor(self._cd2_np, device=self.device)
        self.cd1 = torch.as_tensor(self._cd1_np, device=self.device)
        self.Jinv, self.dphi2, self.g1 = t(Jinv), t(dphi2), t(g1)
        self.adet, self.qw, self.h_cell = t(adet), t(qw), t(h_cell)
        self.phi2, self.phi1 = t(phi2), t(phi1)
        self.p_active, self.u_active = t(p_act), t(u_act)
        self.wdet = self.adet[:, None] * self.qw[None, :]   # (nc, nq)
        self._host_tabs = dict(Jinv=Jinv, dphi2=dphi2, g1=g1, phi2=phi2,
                               phi1=phi1)

        def build_patterns(block):
            dofmaps = ((cd2, cd2, self.n2, self.n2),
                       (cd1, cd1, self.n1, self.n1),
                       (cd1, cd2, self.n1, self.n2),
                       (cd2, cd1, self.n2, self.n1))
            return tuple(
                None if self._p1_only and (nr, ncol) != (self.n1, self.n1)
                else pattern_from_dofmaps(cr, cc, nr, ncol, block=block,
                                          device=self.device)
                for cr, cc, nr, ncol in dofmaps)

        self.pat_p2, self.pat_p1, self.pat_div, self.pat_divT = \
            build_patterns(block_size)
        if block_size and not hi_block:
            (self.pat_p2_hi, self.pat_p1_hi, self.pat_div_hi,
             self.pat_divT_hi) = build_patterns(None)
        else:
            self.pat_p2_hi, self.pat_p1_hi = self.pat_p2, self.pat_p1
            self.pat_div_hi, self.pat_divT_hi = self.pat_div, self.pat_divT

        self._load_u = None              # body-force load (set_body_force)
        self.n_inflow_facets = 0
        if not self._p1_only:
            self._flat = self._flat_tables()
            self._setup_facets()
        t1 = time.perf_counter()

        if block_size or block_dtype is not None:
            self.const_hi = self._assemble_constant(hi=True)
            self.const = self._assemble_constant(hi=False,
                                                 out_dtype=block_dtype)
        else:
            self.const = self.const_hi = self._assemble_constant()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # host clock: dofmaps, patterns and tables; the constant operators
        self.setup_seconds = {"dofmaps and patterns": t1 - t0,
                              "constant operators": time.perf_counter() - t1}

    # ------------------------------------------------------------------ #
    def _setup_facets(self):
        """INFLOW-facet quadrature tables for the BRM2 Kp surface term
        ``-(1/nu) (w.n) p q ds``: physical facet quadrature points mapped
        back to reference coordinates in the owning cell.  Facets are edges
        (degree-4 Gauss rule) in 2D and triangles (the degree-4 triangle
        rule, whose weights sum to 1/2, times twice the area) in 3D."""
        mesh = self.mesh
        sel = np.where(mesh.facet_markers == INFLOW)[0]
        self.n_inflow_facets = sel.shape[0]
        if not sel.shape[0]:
            return
        d = self.dim
        if d == 2:
            fv = mesh.edges[mesh.boundary_facets[sel]]        # (nf, 2)
            fcells = mesh.facet_cells[sel]
            normals = mesh.facet_normals()[sel]
            tq, wq = el.interval_quadrature(4)
            bary = np.stack([1 - tq, tq], axis=1)             # (ntq, 2)
            a, b = mesh.vertices[fv[:, 0]], mesh.vertices[fv[:, 1]]
            measure = np.linalg.norm(b - a, axis=1)
            basis2, basis1 = el.p2_basis, el.p1_basis
        else:
            fv = mesh.boundary_faces[sel]                     # (nf, 3)
            fcells = mesh.face_cells[sel]
            normals = mesh.face_normals()[sel]
            qp2, wq = el3.triangle_face_quadrature(4)
            bary = np.concatenate([1 - qp2.sum(1, keepdims=True), qp2],
                                  axis=1)                     # (ntq, 3)
            measure = 2.0 * mesh.face_areas()[sel]
            basis2, basis1 = el3.p2_basis, el3.p1_basis
        pts = np.einsum("qv,fvd->fqd", bary, mesh.vertices[fv])
        pref = np.einsum("fkd,fqd->fqk", self._Jinv_np[fcells],
                         pts - self._v0[fcells][:, None, :])
        nf, ntq = pref.shape[:2]
        p2, _ = basis2(pref.reshape(-1, d))
        p1, _ = basis1(pref.reshape(-1, d))
        t = lambda x: torch.as_tensor(x, dtype=self.dtype, device=self.device)
        self.f_phi2 = t(p2.reshape(nf, ntq, -1))
        self.f_phi1 = t(p1.reshape(nf, ntq, -1))
        self.f_wlen = t(measure[:, None] * wq[None, :])
        self.f_normals = t(normals)
        self.f_cd2 = torch.as_tensor(self._cd2_np[fcells], device=self.device)
        f_cd1 = self._cd1_np[fcells]
        # surface entries land in the volume P1 pattern's slots, added to
        # the volume values in a fixed order
        self._kp_surf_pos = self.pat_p1.entry_positions(f_cd1, f_cd1)
        self.kp_surf_sum = SegmentSum(self._kp_surf_pos,
                                      self.pat_p1.value_size,
                                      device=self.device)

    def _pats(self, hi: bool):
        if hi:
            return (self.pat_p2_hi, self.pat_p1_hi, self.pat_div_hi,
                    self.pat_divT_hi)
        return (self.pat_p2, self.pat_p1, self.pat_div, self.pat_divT)

    def _assemble_constant(self, hi: bool = False, out_dtype=None
                           ) -> ConstOperators:
        """Constant operators via factored element integrals: a tiny
        reference-cell tensor contracted once over quadrature, composed with
        per-cell metric tensors.  Assembled in the assembler dtype; the
        RESULT is cast to ``out_dtype`` (f32-accumulated sums would carry
        ~2e-6 relative error)."""
        p2, p1, pdiv, pdivT = self._pats(hi)
        phi1, dphi2, Jinv = self.phi1, self.dphi2, self.Jinv
        adet, qw, g1 = self.adet, self.qw, self.g1
        od = out_dtype or self.dtype

        def asm_op(pat, elem):
            return pat.matrix(pat.assemble_values(elem).to(od))

        mref1 = torch.einsum("q,ql,qm->lm", qw, phi1, phi1)
        mass_p1 = adet[:, None, None] * mref1[None] / self.nu
        stiff_p1 = torch.einsum("c,cld,cmd->clm", adet * torch.sum(qw), g1, g1)
        if self._p1_only:
            return ConstOperators(L=None, Mp=asm_op(p1, mass_p1),
                                  Ap=asm_op(p1, stiff_p1), D=(), DT=())
        # viscous: adet_c * (Jinv Jinv^T)_ckl * T_klij,
        # T_klij = sum_q qw dphi_qik dphi_qjl
        M = torch.einsum("ckd,cld->ckl", Jinv, Jinv)
        T = torch.einsum("q,qik,qjl->klij", qw, dphi2, dphi2)
        visc = torch.einsum("c,ckl,klij->cij", adet, M, T)
        # divergence: D_a[l,j] = -adet * (sum_q qw phi1 dphi_qjk) Jinv_ka
        R = torch.einsum("q,ql,qjk->ljk", qw, phi1, dphi2)
        div_all = -torch.einsum("c,ljk,cka->clja", adet, R, Jinv)
        div = [div_all[..., a] for a in range(self.dim)]
        M2 = None
        if not isinstance(p2, BlockSparsityPattern):
            M2 = p2.matrix(self.mass2_values(hi=hi).to(od))
        return ConstOperators(
            L=asm_op(p2, visc),
            Mp=asm_op(p1, mass_p1), Ap=asm_op(p1, stiff_p1),
            D=tuple(asm_op(pdiv, da) for da in div),
            DT=tuple(asm_op(pdivT, da.transpose(1, 2)) for da in div),
            M2=M2)

    # ------------------------------------------------------------------ #
    def split_u(self, u: torch.Tensor):
        """Components of the stacked velocity vector."""
        n2 = self.n2
        return [u[a * n2:(a + 1) * n2] for a in range(self.dim)]

    def mass2_values(self, hi: bool = False) -> torch.Tensor:
        """Scalar P2 mass values in the layout of the ``hi`` pattern."""
        mref = torch.einsum("q,qi,qj->ij", self.qw, self.phi2, self.phi2)
        elem = self.adet[:, None, None] * mref[None]
        return self._pats(hi)[0].assemble_values(elem)

    def mass2(self, hi: bool = True):
        """The scalar P2 mass operator of the ``hi`` set: the stored
        constant, or assembled on demand where the set does not keep it."""
        M2 = (self.const_hi if hi else self.const).M2
        if M2 is None:
            M2 = self._pats(hi)[0].matrix(self.mass2_values(hi=hi))
        return M2

    def wind_at_quad(self, u: torch.Tensor) -> torch.Tensor:
        """The stacked velocity at the cells' quadrature points,
        (nc, nq, d)."""
        ucell = torch.stack([c[self.cd2] for c in self.split_u(u)], dim=-1)
        return torch.einsum("qi,cid->cqd", self.phi2.to(u.dtype), ucell)

    def _flat_tables(self):
        """Quadrature tables that turn the per-step element integrals into
        plain (nc, M) @ (M, N) products (the JAX package's flat path)."""
        h = self._host_tabs
        d, nq, nb2, nb1 = self.dim, self.nq, self.nb2, self.nb1
        phi2, dphi2, phi1 = h["phi2"], h["dphi2"], h["phi1"]
        # uq: (nc, d*nb2) @ P -> (nc, nq*d); P[(a,i),(q,b)] = phi2 d_ab
        P = np.zeros((d * nb2, nq * d))
        for a in range(d):
            for q in range(nq):
                P[a * nb2:(a + 1) * nb2, q * d + a] = phi2[q]
        # convection: elem_(ij) = t_(q,k) @ B2[(q,k),(i,j)],
        # B2 = phi2_qi dphi2_qjk
        B2 = np.zeros((nq * d, nb2 * nb2))
        for q in range(nq):
            for k in range(d):
                B2[q * d + k] = np.outer(phi2[q], dphi2[q, :, k]).ravel()
        # kp: elem_(lm) = v_(q,m) @ B1, B1[(q,m),(l,m')] = phi1_ql d_mm'
        B1 = np.zeros((nq * nb1, nb1 * nb1))
        for q in range(nq):
            for m in range(nb1):
                B1[q * nb1 + m, m::nb1] = phi1[q]
        # newton reaction: du_(q,a,k) = ucell_flat @ Pg,
        # Pg[(a,i), (q*d+a)*d+k] = dphi2_qik
        Pg = np.zeros((d * nb2, nq * d * d))
        for a in range(d):
            for q in range(nq):
                for k in range(d):
                    Pg[a * nb2:(a + 1) * nb2, (q * d + a) * d + k] = \
                        dphi2[q, :, k]
        # Bp[q, (i,j)] = phi2_qi phi2_qj (mass-like q-contraction)
        Bp = np.stack([np.outer(phi2[q], phi2[q]).ravel()
                       for q in range(nq)])
        return dict(P=P, B2=B2, B1=B1, Pg=Pg, Bp=Bp,
                    Jf=h["Jinv"].reshape(self.nc, d * d),
                    g1f=h["g1"].reshape(self.nc, nb1 * d))

    def _tab(self, name: str, dtype) -> torch.Tensor:
        """Flat table in ``dtype`` (cached per dtype on first use)."""
        key = (name, dtype)
        cache = self.__dict__.setdefault("_tab_cache", {})
        if key not in cache:
            cache[key] = torch.as_tensor(self._flat[name], dtype=dtype,
                                         device=self.device)
        return cache[key]

    def _uq_flat(self, u: torch.Tensor, cdt) -> torch.Tensor:
        """(nc, nq*d) wind at quadrature points.  As in the JAX package the
        per-cell dofs are taken in the promoted (wind, assembler) dtype and
        the table ``P`` is rounded to ``cdt`` first."""
        wdt = torch.promote_types(u.dtype, self.dtype)
        ucf = torch.cat([c.to(wdt)[self.cd2] for c in self.split_u(u)], dim=1)
        return (ucf @ self._tab("P", cdt).to(wdt)).to(cdt)

    def convection_values(self, u: torch.Tensor, hi: bool = False,
                          compute32: bool = False) -> torch.Tensor:
        """Scalar convection N(w) values: N[i,j] = int (w.grad phi_j) phi_i.
        ``compute32`` runs the element integrals in f32 and casts the
        assembled values to the assembler dtype."""
        d, nq = self.dim, self.nq
        cdt = (torch.float32 if compute32
               else torch.promote_types(u.dtype, self.dtype))
        uqf = self._uq_flat(u, cdt)                        # (nc, nq*d)
        wdet = self.wdet.to(cdt)
        Jf = self._tab("Jf", cdt)
        # t[(q,k)] = wdet_q * sum_b uq_(q,b) Jinv_(k,b)
        cols = []
        for k in range(d):
            acc = 0.0
            for b in range(d):
                acc = acc + uqf[:, b::d] * Jf[:, k * d + b, None]
            cols.append(wdet * acc)
        t = torch.stack(cols, dim=2).reshape(uqf.shape[0], nq * d)
        vals = self._pats(hi)[0].assemble_values(t @ self._tab("B2", cdt))
        return vals.to(self.dtype) if compute32 else vals

    def newton_reaction_values(self, u: torch.Tensor, hi: bool = False,
                               compute32: bool = False) -> torch.Tensor:
        """(d, d, *value_shape) values of the Newton reaction blocks
        R_ab[i,j] = int phi_j (d_b u_a) phi_i.  ``compute32``: see
        :meth:`convection_values`."""
        d, nq = self.dim, self.nq
        pat = self._pats(hi)[0]
        cdt = (torch.float32 if compute32
               else torch.promote_types(u.dtype, self.dtype))
        ucf = torch.cat([c[self.cd2] for c in self.split_u(u)],
                        dim=1).to(cdt)
        du = ucf @ self._tab("Pg", cdt)                  # (nc, nq*d*d)
        Jf = self._tab("Jf", cdt)
        wdet = self.wdet.to(cdt)
        Bp = self._tab("Bp", cdt)
        outs = []
        for a in range(d):
            for b in range(d):
                gu = 0.0
                for k in range(d):
                    # du column (q*d + a)*d + k: stride d*d over q
                    gu = gu + du[:, a * d + k::d * d] * Jf[:, k * d + b, None]
                vals = pat.assemble_values((wdet * gu) @ Bp)
                outs.append(vals.to(self.dtype) if compute32 else vals)
        return torch.stack(outs).reshape((d, d) + tuple(pat.value_shape))

    def kp_values(self, u: torch.Tensor, surface: bool = False
                  ) -> torch.Tensor:
        """Pressure convection Kp = (1/nu) int (w.grad p) q dx
        [+ the BRM2 inflow surface term when ``surface``]."""
        d, nq, nb1 = self.dim, self.nq, self.nb1
        cdt = torch.promote_types(u.dtype, self.dtype)
        uqf = self._uq_flat(u, cdt)
        g1f = self._tab("g1f", cdt)
        wdet = self.wdet.to(cdt)
        cols = []
        for m in range(nb1):
            acc = 0.0
            for b in range(d):
                acc = acc + uqf[:, b::d] * g1f[:, m * d + b, None]
            cols.append(wdet * acc)
        v = torch.stack(cols, dim=2).reshape(uqf.shape[0], nq * nb1)
        elem = (v @ self._tab("B1", cdt)) / self.nu
        vals = self.pat_p1.assemble_values(elem)
        return self._kp_surface(vals, u) if surface else vals

    def _kp_surface(self, vals: torch.Tensor, u: torch.Tensor):
        """BRM2 inflow surface term added into the volume Kp values."""
        if not self.n_inflow_facets:
            return vals
        cdt = vals.dtype
        ucell = torch.stack([c.to(cdt)[self.f_cd2] for c in self.split_u(u)],
                            dim=-1)
        uq_f = torch.einsum("fqi,fid->fqd", self.f_phi2.to(cdt), ucell)
        un = torch.einsum("fqd,fd->fq", uq_f, self.f_normals.to(cdt))
        elem_s = -torch.einsum("fq,fq,fql,fqm->flm", self.f_wlen.to(cdt), un,
                               self.f_phi1.to(cdt),
                               self.f_phi1.to(cdt)) / self.nu
        return self.kp_surf_sum(elem_s, base=vals.reshape(-1)).reshape(
            vals.shape)

    def supg_p1_values(self, u: torch.Tensor) -> torch.Tensor:
        """Streamline-diffusion values for the scalar P1
        convection-diffusion operator ``nu Ap + nu Kp(u)``, the p-coarse
        bottom level of the velocity multigrid
        (``solvers/gmg.py::PCoarseTransfer``).  The delta of
        :meth:`_supg_delta` on P1 gradients (constant per cell):
        ``delta (w . grad q_l)(w . grad q_m)`` at every quadrature point.
        Without it the bottom level's exact inverse amplifies the
        oscillatory Galerkin modes at Pe > 1."""
        uq = self.wind_at_quad(u)                          # (nc, nq, d)
        dt = uq.dtype
        v = torch.einsum("cqd,cmd->cqm", uq, self.g1.to(dt))
        elem = torch.einsum("cq,cql,cqm->clm",
                            self.wdet.to(dt) * self._supg_delta(uq), v, v)
        return self.pat_p1.assemble_values(elem)

    def _supg_delta(self, uq: torch.Tensor) -> torch.Tensor:
        """The Elman-Silvester-Wathen streamline-diffusion parameter at the
        quadrature points, (nc, nq): ``h / (2 |w|) (1 - 1 / Pe)`` where the
        cell Peclet number ``Pe = |w| h / (2 nu)`` exceeds 1, else 0."""
        umag = torch.clamp(torch.sqrt(torch.sum(uq * uq, dim=-1)), min=1e-30)
        h = self.h_cell.to(uq.dtype)[:, None]
        pe = umag * h / (2.0 * self.nu)
        return torch.where(pe > 1.0, h / (2.0 * umag) * (1.0 - 1.0 / pe),
                           torch.zeros_like(pe))

    def supg_values(self, u: torch.Tensor, hi: bool = False) -> torch.Tensor:
        """Streamline-diffusion (SUPG) values of the scalar P2 operator,
        ``delta (w . grad phi_i)(w . grad phi_j)`` with the delta of
        :meth:`_supg_delta`, on the P2 pattern of the ``hi`` set (Elman,
        Silvester & Wathen, Finite Elements and Fast Iterative Solvers, 2nd
        ed., sec. 8.3.2).  The preconditioner's velocity operator takes it
        under ``jpc_supg``, the system under ``system_supg``."""
        cdt = torch.promote_types(u.dtype, self.dtype)
        uq = self.wind_at_quad(u.to(cdt))                  # (nc, nq, d)
        # w . grad phi_i = (Jinv w) . grad_ref phi_i
        s = torch.einsum("cqd,ckd->cqk", uq, self.Jinv.to(cdt))
        wg = torch.einsum("cqk,qik->cqi", s, self.dphi2.to(cdt))
        sw = self.wdet.to(cdt) * self._supg_delta(uq)
        elem = torch.einsum("cqi,cqj->cij", wg * sw[..., None], wg)
        return self._pats(hi)[0].assemble_values(elem)

    def picard_matrix_values(self, u: torch.Tensor, hi: bool = False,
                             compute32: bool = False) -> torch.Tensor:
        """A1 = nu * L + N(u) scalar values (applied to each component)."""
        L = self.const_hi.L if hi else self.const.L
        conv = self.convection_values(u, hi=hi, compute32=compute32)
        return self.nu * L.vals.to(conv.dtype) + conv

    def residual(self, u: torch.Tensor, p: Optional[torch.Tensor],
                 hi: bool = True, supg: bool = False,
                 compute32: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Steady NS residual with natural outflow: ``ru_a = A1(u) u_a +
        DT_a p - f_a``, ``rp = sum_a D_a u_a`` (BC masking by the caller),
        with the load ``f`` of :meth:`set_body_force` (zero when none is
        set).  A time-independent load enters every time scheme as it is
        (it is state-independent, so no Jacobian changes); under ``supg``
        it is not test-weighted by the streamline term, as in the JAX
        package.  ``p=None`` leaves the pressure gradient out: the
        convection-diffusion part alone, the theta-weighted piece of the
        unsteady residuals.  ``hi`` selects the high-precision operators.
        ``supg`` adds the streamline diffusion of :meth:`supg_values` at the
        state itself to A1 (the stabilized system of ``system_supg``, whose
        Picard operator lags the same term)."""
        A1vals = self.picard_matrix_values(u, hi=hi, compute32=compute32)
        if supg:
            A1vals = A1vals + self.supg_values(u, hi=hi).to(A1vals.dtype)
        A1 = self._pats(hi)[0].matrix(A1vals)
        c = self.const_hi if hi else self.const
        comps = self.split_u(u)
        ru = torch.cat([A1.mv(comps[a]) for a in range(self.dim)])
        if p is not None:
            ru = ru + self.grad_p(p, hi=hi)
        if self._load_u is not None:
            ru = ru - self._load_u.to(ru.dtype)
        rp = sum(c.D[a].mv(comps[a]) for a in range(self.dim))
        return ru, rp

    def set_body_force(self, f) -> None:
        """Install a body force: :meth:`residual` gains ``-int f . v dx``.

        ``f(x: (k, d)) -> (k, d)`` is evaluated at the quadrature points of
        every cell (triangles or tets) and integrated against the P2 basis
        on the host in NumPy, summed with ``np.add.at`` in the JAX package's
        order; the load vector is held on the assembler's device in its
        dtype, zero on the alignment padding."""
        d, mesh = self.dim, self.mesh
        if d == 2:
            qp, qw = el.triangle_quadrature(self.quad_degree)
            phi2, _ = el.p2_basis(qp)                 # (nq, nb2)
        else:
            qp, qw = el3.tet_quadrature(self.quad_degree)
            phi2, _ = el3.p2_basis(qp)
        nc = self.nc_real
        v = mesh.vertices[mesh.cells]                 # (nc, d+1, d)
        v0 = v[:, 0]
        E = v[:, 1:] - v0[:, None]                    # (nc, d, d) edges
        adet = np.abs(np.linalg.det(
            np.stack([E[:, i] for i in range(d)], axis=2)))
        xq = v0[:, None, :] + np.einsum("qk,nkd->nqd", qp, E)
        fq = np.asarray(f(xq.reshape(-1, d))).reshape(nc, len(qw), d)
        elem = np.einsum("n,q,nqa,qi->nai", adet, qw, fq, phi2)
        b = np.zeros(d * self.n2)
        for a in range(d):
            np.add.at(b, a * self.n2 + self._cd2_np[:nc], elem[:, a, :])
        b *= self._u_active_np                        # padding rows stay 0
        self._load_u = torch.as_tensor(b, dtype=self.dtype,
                                       device=self.device)

    def grad_p(self, p: torch.Tensor, hi: bool = True) -> torch.Tensor:
        """The pressure gradient ``B^T p`` stacked over the components
        (unscaled in every time scheme, as the Jacobian's block is)."""
        c = self.const_hi if hi else self.const
        return torch.cat([c.DT[a].mv(p) for a in range(self.dim)])
