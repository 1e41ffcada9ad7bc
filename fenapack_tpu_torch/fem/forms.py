"""Custom variational forms: a small UFL-like form language and compiler.

The port of ``fenapack_tpu/fem/forms.py``, the user-facing half of
``fenapack/assembling.py::PCDAssembler``: the reference accepts arbitrary
UFL forms (``a``/J, ``L``/F, ``a_pc``/J_pc and the PCD forms ``mp, ap, kp,
fp, gp``) and assembles them through DOLFIN/FFC.  Here user forms are
Python expression trees over trial/test functions and coefficients; the
compiler evaluates them at quadrature points with broadcast trial/test axes
and sums the element tensors into the static-sparsity layouts of
:mod:`fenapack_tpu_torch.ops.sparse`.  Constant forms are assembled once,
coefficient-dependent ones re-assembled from new coefficient values.

Every sum of scattered values goes through ``ops.sparse.SegmentSum`` (cell
blocks through the pattern's own, facet blocks and vectors through tables
built once per measure and block), so a repeated assembly gives the same
bits on every run and device.

The factored assembler (:class:`fenapack_tpu_torch.fem.assemble
.NSAssembler`) stays the path for the standard Navier-Stokes forms: it
avoids the O(nc * nb_trial * nb_test) element tensors of this generic
compiler.  Use this module when the formulation differs from the built-ins
(extra terms, another stabilization, modified PCD operators).

Example (the fenapack demo's PCD forms)::

    W = TaylorHood(mesh)
    u, p = TrialFunctions(W); v, q = TestFunctions(W)
    w = Coefficient(W, "w"); u_, p_ = split(w)
    nu = 0.02
    mp = (1/nu) * p * q * dx
    ap = inner(grad(p), grad(q)) * dx
    kp = ((1/nu) * dot(grad(p), u_) * q * dx
          - (1/nu) * dot(u_, n) * p * q * ds(INFLOW))
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import elements as el
from . import elements3d as el3
from .dofmap import TaylorHood
from ..ops.sparse import SegmentSum, SparsityPattern, pattern_from_dofmaps


# --------------------------------------------------------------------- #
# expression nodes
# --------------------------------------------------------------------- #

class Expr:
    rank = 0                  # tensor rank of the value (0/1/2)

    def __add__(self, o):
        return Sum(self, as_expr(o))

    def __radd__(self, o):
        return Sum(as_expr(o), self)

    def __sub__(self, o):
        return Sum(self, Product(ConstantExpr(-1.0), as_expr(o)))

    def __rsub__(self, o):
        return Sum(as_expr(o), Product(ConstantExpr(-1.0), self))

    def __mul__(self, o):
        if isinstance(o, Measure):
            return Form([Integral(self, o)])
        return Product(self, as_expr(o))

    def __rmul__(self, o):
        return Product(as_expr(o), self)

    def __neg__(self):
        return Product(ConstantExpr(-1.0), self)

    def __truediv__(self, o):
        if isinstance(o, Expr):
            raise TypeError("division by expressions is not supported")
        return Product(ConstantExpr(1.0 / float(o)), self)


def as_expr(o) -> Expr:
    if isinstance(o, Expr):
        return o
    return ConstantExpr(float(o))


@dataclasses.dataclass
class ConstantExpr(Expr):
    value: float
    rank = 0


class Argument(Expr):
    """Trial (number=1) or test (number=0) function on a subspace block.

    ``block`` is 'u' (vector P2) or 'p' (scalar P1) for the mixed
    Taylor-Hood space.
    """

    def __init__(self, W, number: int, block: str):
        self.W = W
        self.number = number
        self.block = block
        self.rank = 1 if block == "u" else 0


class Coefficient(Expr):
    """Named coefficient on the mixed space (dof values given at assembly)."""

    def __init__(self, W, name: str):
        self.W = W
        self.name = name
        self.rank = 0          # use split() to get the typed parts


class CoefPart(Expr):
    def __init__(self, coef: Coefficient, block: str):
        self.coef = coef
        self.block = block
        self.rank = 1 if block == "u" else 0


def split(w: Coefficient) -> Tuple[CoefPart, CoefPart]:
    return CoefPart(w, "u"), CoefPart(w, "p")


class FacetNormal(Expr):
    rank = 1

    def __init__(self, mesh=None):
        self.mesh = mesh


@dataclasses.dataclass
class Grad(Expr):
    operand: Expr

    def __post_init__(self):
        self.rank = self.operand.rank + 1
        if self.rank > 2:
            raise ValueError("grad of tensor expressions not supported")


@dataclasses.dataclass
class Div(Expr):
    operand: Expr
    rank = 0

    def __post_init__(self):
        if self.operand.rank != 1:
            raise ValueError("div expects a vector expression")


@dataclasses.dataclass
class Sum(Expr):
    a: Expr
    b: Expr

    def __post_init__(self):
        if self.a.rank != self.b.rank:
            raise ValueError("rank mismatch in sum")
        self.rank = self.a.rank


@dataclasses.dataclass
class Product(Expr):
    a: Expr
    b: Expr

    def __post_init__(self):
        if self.a.rank and self.b.rank:
            raise ValueError("use dot/inner to contract non-scalars")
        self.rank = self.a.rank + self.b.rank


@dataclasses.dataclass
class Dot(Expr):
    """Contraction of the last axis of ``a`` with the first axis of ``b``."""
    a: Expr
    b: Expr

    def __post_init__(self):
        if self.a.rank == 0 or self.b.rank == 0:
            raise ValueError("dot expects non-scalar operands")
        self.rank = self.a.rank + self.b.rank - 2


@dataclasses.dataclass
class Inner(Expr):
    """Full contraction (operands of equal rank)."""
    a: Expr
    b: Expr
    rank = 0

    def __post_init__(self):
        if self.a.rank != self.b.rank:
            raise ValueError("inner expects equal ranks")


def grad(e: Expr) -> Expr:
    return Grad(as_expr(e))


def div(e: Expr) -> Expr:
    return Div(as_expr(e))


def dot(a: Expr, b: Expr) -> Expr:
    return Dot(as_expr(a), as_expr(b))


def inner(a: Expr, b: Expr) -> Expr:
    return Inner(as_expr(a), as_expr(b))


def TrialFunctions(W) -> Tuple[Argument, Argument]:
    return Argument(W, 1, "u"), Argument(W, 1, "p")


def TestFunctions(W) -> Tuple[Argument, Argument]:
    return Argument(W, 0, "u"), Argument(W, 0, "p")


def TrialFunction(W, block: str = "p") -> Argument:
    return Argument(W, 1, block)


def TestFunction(W, block: str = "p") -> Argument:
    return Argument(W, 0, block)


# --------------------------------------------------------------------- #
# measures / integrals / forms
# --------------------------------------------------------------------- #

class Measure:
    def __init__(self, kind: str, marker: Optional[int] = None):
        self.kind = kind
        self.marker = marker

    def __call__(self, marker: int) -> "Measure":
        return Measure(self.kind, marker)


dx = Measure("cell")
ds = Measure("facet")


@dataclasses.dataclass
class Integral:
    integrand: Expr
    measure: Measure


class Form:
    def __init__(self, integrals: List[Integral]):
        self.integrals = integrals

    def __add__(self, o: "Form") -> "Form":
        return Form(self.integrals + o.integrals)

    def __sub__(self, o: "Form") -> "Form":
        neg = [Integral(Product(ConstantExpr(-1.0), i.integrand), i.measure)
               for i in o.integrals]
        return Form(self.integrals + neg)

    def __neg__(self) -> "Form":
        return Form([Integral(Product(ConstantExpr(-1.0), i.integrand),
                              i.measure) for i in self.integrals])


# --------------------------------------------------------------------- #
# compiler
# --------------------------------------------------------------------- #

class _CellCtx:
    """Per-quadrature-point evaluation tables for cell integrals.

    Value convention: every evaluated expression is a tensor of shape
    ``(C, T, S) + comp`` with C in {1, nc}, T in {1, nt}, S in {1, ns}
    (trial/test broadcast axes) and comp the tensor axes ((), (d,), (d,d)).
    """

    def __init__(self, comp, q: int):
        c = comp
        self.d = c.d
        self.nc = c.nc
        self.phi = {"u": c.phi2[q], "p": c.phi1[q]}          # (nb,)
        # physical gradients at q: (nc, nb, d)
        self.gphi = {
            "u": torch.einsum("ik,ckd->cid", c.dphi2[q], c.Jinv),
            "p": torch.einsum("ik,ckd->cid", c.dphi1[q], c.Jinv),
        }
        self.cell_dofs = {"u": c.cd2, "p": c.cd1}
        self.normal = None

    def coef_cell_values(self, comp, values, block):
        """(nc, nb) scalar / (nc, nb, d) vector per-cell dof values."""
        return comp.coef_cell_values(values, block)


class _FacetCtx:
    """Per-quadrature-point tables for exterior facet integrals."""

    def __init__(self, comp, tab, q: int):
        self.d = comp.d
        self.nc = tab["nf"]
        self.phi = None                                       # facet-varying
        self.phi_f = {"u": tab["phi2"][:, q], "p": tab["phi1"][:, q]}
        self.gphi = {
            "u": torch.einsum("fik,fkd->fid", tab["dphi2"][:, q],
                              tab["Jinv"]),
            "p": torch.einsum("fik,fkd->fid", tab["dphi1"][:, q],
                              tab["Jinv"]),
        }
        self.cell_dofs = {"u": tab["cd2"], "p": tab["cd1"]}
        self.normal = tab["normals"]                          # (nf, d)

    def coef_cell_values(self, comp, values, block):
        return comp.coef_cell_values(values, block,
                                     cell_dofs=self.cell_dofs[block])


class FormCompiler:
    """Quadrature tables and assembly for one Taylor-Hood space.

    Independent of :class:`NSAssembler` (it repeats the small geometry
    setup) so custom-form problems do not pay for the built-in operators.
    Tables, patterns and sum tables live on ``device`` and are built once:
    the quadrature contexts on first use, the facet tables and their sums
    once per marker, the sums of the vector scatters once per measure and
    block.
    """

    def __init__(self, W: TaylorHood, quad_degree: int = 5,
                 dtype=torch.float64, *, device):
        self.W = W
        mesh = W.mesh
        self.mesh = mesh
        self.dtype = dtype
        self.device = torch.device(device)
        d = mesh.vertices.shape[1]
        self.d = d
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

        v = mesh.vertices[mesh.cells]
        J = np.stack([v[:, i + 1] - v[:, 0] for i in range(d)], axis=2)
        Jinv = np.linalg.inv(J)
        adet = np.abs(np.linalg.det(J))
        self.nc = mesh.cells.shape[0]
        self._v0 = v[:, 0]
        self._Jinv_np = Jinv

        t = self._t
        self.Jinv = t(Jinv)
        self.wdet = t(adet[:, None] * qw[None, :])            # (nc, nq)
        self.phi2, self.phi1 = t(phi2), t(phi1)
        self.dphi2, self.dphi1 = t(dphi2), t(dphi1)
        self._cd2_np = W.V.cell_dofs.astype(np.int64)
        self._cd1_np = W.Q.cell_dofs.astype(np.int64)
        self.cd2 = torch.as_tensor(self._cd2_np, device=self.device)
        self.cd1 = torch.as_tensor(self._cd1_np, device=self.device)
        self._cell_ctxs: Optional[List[_CellCtx]] = None
        self._facet_tabs: Dict[int, dict] = {}

        # block dof layouts (vector velocity dofs stacked per component)
        self.block_dofs = {
            "u": np.concatenate([self._cd2_np + a * W.n2 for a in range(d)],
                                axis=1),
            "p": self._cd1_np,
        }
        self.block_dim = {"u": d * W.n2, "p": W.n1}
        self.block_nb = {"u": d * self.nb2, "p": self.nb1}
        self._patterns: Dict[Tuple[str, str], SparsityPattern] = {}
        # sums of scattered facet-block and vector entries, keyed by
        # (marker, test block, trial block) and (marker or None, block)
        self._block_sums: Dict[Tuple[int, str, str], SegmentSum] = {}
        self._vector_sums: Dict[Tuple[Optional[int], str], SegmentSum] = {}

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # ---------------------------------------------------------------- #
    def pattern(self, test_block: str, trial_block: str) -> SparsityPattern:
        key = (test_block, trial_block)
        if key not in self._patterns:
            self._patterns[key] = pattern_from_dofmaps(
                self.block_dofs[test_block].astype(np.int32),
                self.block_dofs[trial_block].astype(np.int32),
                self.block_dim[test_block], self.block_dim[trial_block],
                device=self.device)
        return self._patterns[key]

    def _cell_contexts(self) -> List[_CellCtx]:
        if self._cell_ctxs is None:
            self._cell_ctxs = [_CellCtx(self, q) for q in range(self.nq)]
        return self._cell_ctxs

    def _facet_tables(self, marker: int) -> dict:
        if marker in self._facet_tabs:
            return self._facet_tabs[marker]
        mesh, d = self.mesh, self.d
        sel = np.where(mesh.facet_markers == marker)[0]
        if d == 2:
            fv = mesh.edges[mesh.boundary_facets[sel]]
            fcells = mesh.facet_cells[sel]
            normals = mesh.facet_normals()[sel]
            tq, wq = el.interval_quadrature(4)
            bary = np.stack([1 - tq, tq], axis=1)
            a = mesh.vertices[fv[:, 0]]
            b = mesh.vertices[fv[:, 1]]
            measure = np.linalg.norm(b - a, axis=1)
            basis2, basis1 = el.p2_basis, el.p1_basis
        else:
            fv = mesh.boundary_faces[sel]
            fcells = mesh.face_cells[sel]
            normals = mesh.face_normals()[sel]
            qp2, wq = el3.triangle_face_quadrature(4)
            bary = np.concatenate([1 - qp2.sum(1, keepdims=True), qp2],
                                  axis=1)
            measure = 2.0 * mesh.face_areas()[sel]
            basis2, basis1 = el3.p2_basis, el3.p1_basis

        verts = mesh.vertices[fv]
        pts = np.einsum("qv,fvd->fqd", bary, verts)
        v0 = self._v0[fcells][:, None, :]
        Jinv = self._Jinv_np[fcells]
        pref = np.einsum("fkd,fqd->fqk", Jinv, pts - v0)
        nf, ntq = pref.shape[:2]
        flat = pref.reshape(-1, d)
        p2, dp2 = basis2(flat)
        p1, dp1 = basis1(flat)
        t = self._t
        cd2, cd1 = self._cd2_np[fcells], self._cd1_np[fcells]
        tab = dict(
            nf=nf, ntq=ntq,
            phi2=t(p2.reshape(nf, ntq, -1)),
            phi1=t(p1.reshape(nf, ntq, -1)),
            dphi2=t(dp2.reshape(nf, ntq, -1, d)),
            dphi1=t(dp1.reshape(nf, ntq, -1, d)),
            Jinv=t(Jinv),
            wlen=t(measure[:, None] * wq[None, :]),
            normals=t(normals),
            cd2=torch.as_tensor(cd2, device=self.device),
            cd1=torch.as_tensor(cd1, device=self.device),
            fcells=fcells,
        )
        # block dof layouts restricted to facet owner cells
        tab["block_dofs"] = {
            "u": np.concatenate([cd2 + a * self.W.n2 for a in range(d)],
                                axis=1),
            "p": cd1}
        tab["ctxs"] = [_FacetCtx(self, tab, q) for q in range(ntq)]
        self._facet_tabs[marker] = tab
        return tab

    def _block_sum(self, marker: int, tab: dict, test_block: str,
                   trial_block: str) -> SegmentSum:
        """Sum of facet element values (nf, test, trial) into the values of
        ``pattern(test_block, trial_block)``."""
        key = (marker, test_block, trial_block)
        if key not in self._block_sums:
            pat = self.pattern(test_block, trial_block)
            pos = pat.entry_positions(tab["block_dofs"][test_block],
                                      tab["block_dofs"][trial_block])
            self._block_sums[key] = SegmentSum(pos, pat.value_size,
                                               device=self.device)
        return self._block_sums[key]

    def _vector_sum(self, marker: Optional[int], dofs: np.ndarray,
                    block: str) -> SegmentSum:
        """Sum of element vectors (nc or nf, nb) into a vector of the block
        (cell integrals: ``marker`` None)."""
        key = (marker, block)
        if key not in self._vector_sums:
            self._vector_sums[key] = SegmentSum(
                dofs, self.block_dim[block], device=self.device)
        return self._vector_sums[key]

    # ---------------------------------------------------------------- #
    def coef_cell_values(self, values, block: str, cell_dofs=None):
        """Per-cell dof values of a mixed-space coefficient part."""
        W, d = self.W, self.d
        if cell_dofs is None:
            cell_dofs = self.cd2 if block == "u" else self.cd1
        if block == "p":
            return values[W.dim_u:][cell_dofs]
        comps = [values[a * W.n2:(a + 1) * W.n2][cell_dofs]
                 for a in range(d)]
        return torch.stack(comps, dim=-1)                    # (nc, nb2, d)

    # ---------------------------------------------------------------- #
    def _zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _eval(self, e: Expr, ctx, active: dict, coeffs: dict):
        """Evaluate ``e`` at the ctx quadrature point -> (C,T,S)+comp."""
        d = self.d
        if isinstance(e, ConstantExpr):
            return torch.full((1, 1, 1), e.value, dtype=self.dtype,
                              device=self.device)
        if isinstance(e, Argument):
            blk = active.get(e.number)
            axis = 1 if e.number == 1 else 2                 # trial/test
            if blk != e.block:
                # inactive block: multilinearity zeroes the term
                return self._zeros([1, 1, 1] + ([d] if e.rank else []))
            eye = torch.eye(d, dtype=self.dtype, device=self.device)
            if ctx.phi is not None:                          # cell ctx
                phi = ctx.phi[e.block]                       # (nb,)
                if e.block == "p":
                    return (phi.reshape(1, -1, 1) if axis == 1
                            else phi.reshape(1, 1, -1))
                nb = phi.shape[0]
                arr = torch.einsum("ab,i->aib", eye, phi).reshape(d * nb, d)
            else:                                            # facet ctx
                phi = ctx.phi_f[e.block]                     # (nf, nb)
                if e.block == "p":
                    return (phi[:, :, None] if axis == 1
                            else phi[:, None, :])
                nf, nb = phi.shape
                arr = torch.einsum("ab,fi->faib", eye,
                                   phi).reshape(nf, d * nb, d)
                return (arr[:, :, None, :] if axis == 1
                        else arr[:, None, :, :])
            return (arr[None, :, None, :] if axis == 1
                    else arr[None, None, :, :])
        if isinstance(e, Grad) and isinstance(e.operand, Argument):
            a = e.operand
            blk = active.get(a.number)
            axis = 1 if a.number == 1 else 2
            if blk != a.block:
                return self._zeros([1, 1, 1] + [d] * e.rank)
            g = ctx.gphi[a.block]                            # (nc, nb, d)
            if a.block == "p":
                return (g[:, :, None, :] if axis == 1
                        else g[:, None, :, :])
            nc, nb, _ = g.shape
            # vector grad: (nc, d*nb, comp, deriv) = delta_{a,comp} g[i,k]
            eye = torch.eye(d, dtype=self.dtype, device=self.device)
            arr = torch.einsum("ab,cik->caibk", eye,
                               g).reshape(nc, d * nb, d, d)
            return (arr[:, :, None] if axis == 1
                    else arr[:, None, :])
        if isinstance(e, CoefPart):
            vals = coeffs[e.coef.name].to(self.dtype)
            cv = ctx.coef_cell_values(self, vals, e.block)
            phi = (ctx.phi[e.block] if ctx.phi is not None
                   else ctx.phi_f[e.block])
            if e.block == "p":
                v = (torch.einsum("i,ci->c", phi, cv) if phi.ndim == 1
                     else torch.einsum("ci,ci->c", phi, cv))
                return v[:, None, None]
            if phi.ndim == 1:
                v = torch.einsum("i,cid->cd", phi, cv)
            else:
                v = torch.einsum("ci,cid->cd", phi, cv)
            return v[:, None, None, :]
        if isinstance(e, Grad) and isinstance(e.operand, CoefPart):
            cp = e.operand
            vals = coeffs[cp.coef.name].to(self.dtype)
            cv = ctx.coef_cell_values(self, vals, cp.block)
            g = ctx.gphi[cp.block]                           # (nc, nb, d)
            if cp.block == "p":
                return torch.einsum("cik,ci->ck", g, cv)[:, None, None, :]
            return torch.einsum("cik,cia->cak", g,
                                cv)[:, None, None, :, :]
        if isinstance(e, Div):
            g = self._eval(Grad(e.operand), ctx, active, coeffs)
            return torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        if isinstance(e, Grad):
            if isinstance(e.operand, Sum):
                return (self._eval(Grad(e.operand.a), ctx, active, coeffs)
                        + self._eval(Grad(e.operand.b), ctx, active, coeffs))
            raise ValueError(
                f"grad of {type(e.operand).__name__} not supported")
        if isinstance(e, FacetNormal):
            if ctx.normal is None:
                raise ValueError("FacetNormal only valid in ds integrals")
            return ctx.normal[:, None, None, :]
        if isinstance(e, Sum):
            return (self._eval(e.a, ctx, active, coeffs)
                    + self._eval(e.b, ctx, active, coeffs))
        if isinstance(e, Product):
            va = self._eval(e.a, ctx, active, coeffs)
            vb = self._eval(e.b, ctx, active, coeffs)
            # align comp axes: the scalar side gets trailing singleton dims
            while va.ndim < vb.ndim:
                va = va[..., None]
            while vb.ndim < va.ndim:
                vb = vb[..., None]
            return va * vb
        if isinstance(e, Dot):
            va = self._eval(e.a, ctx, active, coeffs)
            vb = self._eval(e.b, ctx, active, coeffs)
            return _dot_last_first(va, vb, e.a.rank, e.b.rank)
        if isinstance(e, Inner):
            va = self._eval(e.a, ctx, active, coeffs)
            vb = self._eval(e.b, ctx, active, coeffs)
            r = e.a.rank
            return (torch.sum(va * vb, dim=tuple(range(-r, 0))) if r
                    else va * vb)
        raise ValueError(f"cannot evaluate {type(e).__name__}")

    def _integrate(self, integrand: Expr, ctxs, weights, shape,
                   active: dict, coeffs: dict) -> torch.Tensor:
        """Element tensor (C, T, S): the integrand at every quadrature
        point of ``ctxs``, weighted by the columns of ``weights``."""
        elem = self._zeros(shape)
        for q, ctx in enumerate(ctxs):
            val = self._eval(integrand, ctx, active, coeffs)
            if val.ndim != 3:
                raise ValueError("integrand must be scalar")
            elem = elem + weights[:, q, None, None] * val
        return elem

    # ---------------------------------------------------------------- #
    def assemble_block(self, form: Form, test_block: str, trial_block: str,
                       coeffs: Optional[dict] = None) -> torch.Tensor:
        """Element-assemble the (test_block, trial_block) block of a
        bilinear form; returns ELL values for ``self.pattern(...)``."""
        coeffs = coeffs or {}
        active = {1: trial_block, 0: test_block}
        nt = self.block_nb[trial_block]
        ns = self.block_nb[test_block]
        pat = self.pattern(test_block, trial_block)
        total = None
        for integ in form.integrals:
            if integ.measure.kind == "cell":
                elem = self._integrate(integ.integrand,
                                       self._cell_contexts(), self.wdet,
                                       (self.nc, nt, ns), active, coeffs)
                vals = pat.assemble_values(
                    elem.transpose(1, 2))          # (nc, test, trial)
            else:
                marker = integ.measure.marker
                tab = self._facet_tables(marker)
                if tab["nf"] == 0:
                    continue
                elem = self._integrate(integ.integrand, tab["ctxs"],
                                       tab["wlen"], (tab["nf"], nt, ns),
                                       active, coeffs)
                vals = self._block_sum(marker, tab, test_block, trial_block)(
                    elem.transpose(1, 2)).reshape(pat.value_shape)
            total = vals if total is None else total + vals
        if total is None:
            total = self._zeros(pat.value_shape)
        return total

    def assemble_vector(self, form: Form, test_block: str,
                        coeffs: Optional[dict] = None) -> torch.Tensor:
        """Assemble a linear form (test functions only) into a vector."""
        coeffs = coeffs or {}
        active = {1: None, 0: test_block}
        ns = self.block_nb[test_block]
        out = self._zeros(self.block_dim[test_block])
        for integ in form.integrals:
            if integ.measure.kind == "cell":
                elem = self._integrate(integ.integrand,
                                       self._cell_contexts(), self.wdet,
                                       (self.nc, 1, ns), active, coeffs)
                fsum = self._vector_sum(None, self.block_dofs[test_block],
                                        test_block)
            else:
                marker = integ.measure.marker
                tab = self._facet_tables(marker)
                if tab["nf"] == 0:
                    continue
                elem = self._integrate(integ.integrand, tab["ctxs"],
                                       tab["wlen"], (tab["nf"], 1, ns),
                                       active, coeffs)
                fsum = self._vector_sum(marker,
                                        tab["block_dofs"][test_block],
                                        test_block)
            out = fsum(elem[:, 0, :], base=out)
        return out


def _dot_last_first(va, vb, ra: int, rb: int):
    """Contract the last comp axis of ``va`` with the first comp axis of
    ``vb`` (UFL ``dot`` semantics); comp axes sit at the end, the (C,T,S)
    prefixes broadcast."""
    if rb == 1:
        w = vb
        for _ in range(ra - 1):
            w = w[..., None, :]
        return torch.sum(va * w, dim=-1)
    if ra == 1 and rb == 2:
        # (..., k) . (..., k, j) -> (..., j)
        return torch.sum(va[..., :, None] * vb, dim=-2)
    raise ValueError("unsupported dot ranks")
