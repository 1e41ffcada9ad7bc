"""The single-device solver run as one SPMD program over row-sharded ranks:
the port of ``fenapack_tpu/parallel/sharding.py`` (the JAX package's GSPMD
path, its default multi-chip path).

JAX annotates shardings and lets its compiler partition the single-chip
FGMRES/PCD program.  PyTorch has no such pass, so here every rank runs the
single-device algorithm itself (:class:`ShardedOseen.step`), with one
distribution object, :class:`RowShard`, in place of the identity layout of
:mod:`fenapack_tpu_torch.ops.dist`:

  * each rank owns one contiguous row block of every field component
    (``n2 / n`` rows of each velocity component, ``n1 / n`` of the
    pressure; the assembler is built with ``row_align`` a multiple of n);
  * every constant operator (L, Mp, Ap, M2, each D and D^T) keeps the
    rank's rows over global columns, and a product gathers its input whole
    first (the all-gather GSPMD inserts for an ELL column gather;
    :class:`.spmd.RowBlockELL`) and runs K3 on the owned rows.  A BSR
    operator keeps the rank's block rows when its block rows divide by the
    ranks and the block rows are the vector's rows; otherwise every rank
    holds it whole, computes every row and keeps its own (K2, or K1 in
    f64);
  * the per-step assembly (A1, R, Kp, SUPG) takes the rank's block of cells
    (the phantom cells at the end), sums its entries into a partial of the
    whole value array in a fixed order, and the partials meet at their
    rows' owners, added in rank order (:meth:`Comm.reduce_scatter`): no
    atomics.  The values differ from the single-device ones only in the
    order of that sum.  The facet batch of the Kp surface term is whole on
    every rank and adds into the owned rows;
  * reductions (FGMRES's Gram-Schmidt coefficients and norms, the Gram
    sums of the minimal-residual smoother, the pressure mean) are one
    all-reduce each, added in rank order, so every rank reads the same
    Hessenberg column and takes the same stopping decisions;
  * a dense subsolve (the LU velocity block, the dense Ap) keeps the rank's
    rows of the inverse and applies them to the gathered vector; the
    pressure multigrid, whose levels are not the solver's padded space, and
    the velocity multigrid's coarse levels run whole on every rank.

The state given to and returned by :meth:`ShardedOseen.step` is whole and
equal bit for bit on every rank.  One rank is one :class:`.comm.Comm`
participant (a gloo rank process on the card, or a thread rank on the CPU).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..fem.assemble import ConstOperators
from ..ops.bsr_spmv import bsr_spmv
from ..ops.ell_spmv import ell_block_spmv, ell_spmv
from ..ops.sparse import (ELL, BlockSparsityPattern, ComposedBlock,
                          SegmentSum, stacked)
from . import comm as commmod
from .spmd import RowBlockELL


class RowShard:
    """The row-sharded layout of the distribution interface of
    :mod:`fenapack_tpu_torch.ops.dist`: rank r owns rows ``[r n / s,
    (r+1) n / s)`` of every field component of length n (s ranks).  Its
    reductions are one all-reduce each (:meth:`Comm.allreduce_sum`, added
    in rank order), its gathers one all-gather."""

    def __init__(self, comm, d: int, n2: int, n1: int):
        self.comm, self.size, self.rank = comm, comm.size, comm.rank
        if n2 % self.size or n1 % self.size:
            raise ValueError(f"sizes {n2}, {n1} do not divide by "
                             f"{self.size} ranks")
        self.n2, self.n1 = n2, n1
        self._blocks = {"v": (n2,), "p": (n1,), "u": (n2,) * d,
                        "w": (n2,) * d + (n1,)}

    def space_of(self, n: int) -> str:
        """The scalar space of an operator axis of length ``n``."""
        return {self.n2: "v", self.n1: "p"}[n]

    def rows(self, x: torch.Tensor, space: str) -> torch.Tensor:
        r, s = self.rank, self.size
        parts, off = [], 0
        for n in self._blocks[space]:
            nl = n // s
            parts.append(x[off + r * nl:off + (r + 1) * nl])
            off += n
        return parts[0].clone() if len(parts) == 1 else torch.cat(parts)

    def full(self, x: torch.Tensor, space: str) -> torch.Tensor:
        g = self.comm.all_gather(x)                 # (s, n_loc, ...)
        parts, off = [], 0
        for n in self._blocks[space]:
            nl = n // self.size
            parts.append(g[:, off:off + nl].reshape((n,) + tuple(
                x.shape[1:])))
            off += nl
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.allreduce_sum(t)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self._reduce(torch.sum(x * x).reshape(1)))[0]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(torch.sum(x).reshape(1))[0]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum(x) / (x.shape[0] * self.size)

    def proj(self, V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._reduce(V @ w)

    def proj_norm(self, V: torch.Tensor, w: torch.Tensor):
        t = self._reduce(torch.cat([V @ w, (w @ w).reshape(1)]))
        return t[:-1], torch.sqrt(t[-1])

    def gram(self, W: torch.Tensor, r: torch.Tensor):
        k = W.shape[0]
        t = self._reduce(torch.cat([(W @ W.T).reshape(-1), W @ r]))
        return t[:k * k].view(k, k), t[k * k:]


# --------------------------------------------------------------------- #
# operators on the rank's rows
# --------------------------------------------------------------------- #

class ShardedELL(ELL):
    """The rank's rows of an ELL matrix over global columns.  A product
    takes the rank's rows of x (gathered whole by the
    :class:`.spmd.RowBlockELL` of the pattern) or x whole, and gives the
    rank's rows of ``A x`` (K3)."""

    def __init__(self, cols, vals, rb: RowBlockELL, comm):
        super().__init__(cols, vals, rb.n_cols)
        self.rb, self.comm = rb, comm

    @property
    def shape(self):
        return (self.rb.n_rows, self.n_cols)

    def with_vals(self, vals) -> "ShardedELL":
        return ShardedELL(self.cols, vals, self.rb, self.comm)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == self.n_cols:
            return x
        return self.rb.extend(self.comm, x)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self.cols, self.vals, self.whole(x).contiguous(),
                        self.n_cols)



class ShardedELLBlock(ShardedELL):
    """The rank's rows of the velocity block (A1 on every component plus
    the reaction blocks R) over one ELL pattern: one K3 block product."""

    def __init__(self, cols, A1, R, rb: RowBlockELL, comm):
        super().__init__(cols, A1, rb, comm)
        self.A1, self.R = A1, R

    def mv(self, x: torch.Tensor, y0=None) -> torch.Tensor:
        return ell_block_spmv(self.cols, self.A1, self.R,
                              self.whole(x).contiguous(), self.n_cols,
                              stacked(y0))


class ShardedBlockELL:
    """A BSR matrix on the row-sharded layout: the rank's block rows
    (``pat.sharded``) or the whole matrix, of which a product keeps the
    rank's rows (K2 in f32, K1 in f64)."""

    def __init__(self, nbr, tiles, pat: "ShardedPattern"):
        self.nbr, self.tiles, self.pat = nbr, tiles, pat
        self.n_cols = pat.n_cols

    @property
    def shape(self):
        return (self.pat.n_rows_full, self.n_cols)

    @property
    def vals(self):
        return self.tiles

    def with_vals(self, tiles) -> "ShardedBlockELL":
        return ShardedBlockELL(self.nbr, tiles, self.pat)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pat
        if x.shape[0] != self.n_cols:
            x = p.dist.full(x, p.col_space)
        if p.sharded:
            return bsr_spmv(self.nbr, self.tiles, x.contiguous(), p.n_rows,
                            self.n_cols)
        y = bsr_spmv(self.nbr, self.tiles, x.contiguous(), p.n_rows_full,
                     self.n_cols)
        return p.dist.rows(y, p.row_space)

    def _rows(self, v):
        p = self.pat
        return v if p.sharded else p.dist.rows(v, p.row_space)

    def row_sums(self) -> torch.Tensor:
        p = self.pat
        n = p.n_rows if p.sharded else p.n_rows_full
        return self._rows(torch.sum(self.tiles, dim=1).reshape(-1)[:n])

    def diag_from(self, diag_pos: torch.Tensor) -> torch.Tensor:
        return self._rows(self.tiles.reshape(-1)[diag_pos])


class _OwnedSum:
    """The entries of a :class:`SegmentSum` that land in the rank's rows:
    the selected source entries, summed in their original order."""

    def __init__(self, ssum: SegmentSum, sel: np.ndarray, device):
        self.ssum = ssum
        self.sel = torch.as_tensor(sel, dtype=torch.int64, device=device)

    def __call__(self, src, base=None):
        return self.ssum(src.reshape(-1).index_select(0, self.sel), base)


class ShardedPattern:
    """A sparsity pattern on the row-sharded layout: assembly over the
    rank's block of cells ``cells = (c0, c1)`` (entries of the real cells
    only), the partial sums added at their rows' owners in rank order, and
    the operators of :meth:`matrix` / :meth:`block_matrix` on the rank's
    rows.  ``n_rows`` is the rank's row count of the vector layout;
    ``value_shape`` that of the values it holds."""

    def __init__(self, pat, dist: RowShard, cells: Tuple[int, int],
                 nc_real: int):
        s, r = dist.size, dist.rank
        self.pat, self.dist, self.comm = pat, dist, dist.comm
        self.n_rows_full, self.n_cols = pat.n_rows, pat.n_cols
        self.n_rows = pat.n_rows // s
        self.row_space = dist.space_of(pat.n_rows)
        self.col_space = dist.space_of(pat.n_cols)
        self.block = isinstance(pat, BlockSparsityPattern)
        if self.block:
            b, nb, L = pat.block, pat.nb, pat.L
            self.sharded = pat.n_rows == nb * b and nb % s == 0
            nbl = nb // s
            self._chunk = nbl * L * b
            if self.sharded:
                self.value_shape = (nbl, L, b)
                self.nbr = pat.nbr[r * nbl:(r + 1) * nbl].contiguous()
            else:
                self.value_shape = tuple(pat.value_shape)
                self.nbr = pat.nbr
        else:
            self.sharded = True
            self.K = pat.K
            self.value_shape = (self.n_rows, pat.K)
            self._chunk = self.n_rows * pat.K
            self.rb = RowBlockELL(pat, s)
            self.cols = pat.cols[r * self.n_rows:
                                 (r + 1) * self.n_rows].clone()
        self.diag_pos = pat.diag_pos
        if pat.diag_pos is not None and self.sharded:
            # rows without a diagonal entry (the alignment padding, whose
            # diagonal the solvers mask) read the first value, as whole
            dp = dist.rows(pat.diag_pos, self.row_space) - r * self._chunk
            self.diag_pos = torch.where((dp >= 0) & (dp < self._chunk), dp,
                                        torch.zeros_like(dp))
        per = pat._entry_pos_np.shape[0] // nc_real
        e0, e1 = (min(c, nc_real) * per for c in cells)
        self._sum = SegmentSum(pat._entry_pos_np[e0:e1], pat.value_size,
                               device=pat.device)
        # the whole pattern's device tables are not needed any more
        pat._sum = None
        if not self.block:
            pat.cols = None

    def owned(self, vals: torch.Tensor) -> torch.Tensor:
        """The rank's part of a whole value array."""
        if not self.sharded:
            return vals
        r, lead = self.dist.rank, self.value_shape[0]
        return vals[r * lead:(r + 1) * lead].clone()

    def assemble_values(self, element_values: torch.Tensor) -> torch.Tensor:
        """The values from the element tensors of the rank's cells."""
        part = self._sum(element_values)
        if self.sharded:
            v = self.comm.reduce_scatter(part.view(self.dist.size, -1))
        else:
            v = self.comm.allreduce_sum(part)
        return v.reshape(self.value_shape)

    def matrix(self, vals: torch.Tensor):
        if self.block:
            return ShardedBlockELL(self.nbr, vals, self)
        return ShardedELL(self.cols, vals, self.rb, self.comm)

    def block_matrix(self, A1vals, Rvals=None):
        if self.block:
            return ComposedBlock(self.matrix, A1vals, Rvals)
        return ShardedELLBlock(self.cols, A1vals, Rvals, self.rb, self.comm)

    def to_dense(self, vals: torch.Tensor) -> torch.Tensor:
        """The whole dense matrix (the values gathered whole)."""
        if self.sharded:
            vals = self.comm.all_gather(vals).reshape(self.pat.value_shape)
        return self.pat.to_dense(vals)


def _shard_assembler(asm, dist: RowShard):
    """Shard ``asm`` in place: its per-cell batches to the rank's block of
    cells, its patterns and constant operators to the rank's rows, the
    body-force load to the rank's rows and the Kp surface term to the
    entries of the rank's rows (the facet batch stays whole)."""
    s, r = dist.size, dist.rank
    ncl = asm.nc // s
    c0, c1 = r * ncl, (r + 1) * ncl
    for name in ("cd2", "cd1", "Jinv", "g1", "adet", "wdet", "h_cell"):
        setattr(asm, name, getattr(asm, name)[c0:c1].clone())
    asm._flat = dict(asm._flat)
    for name in ("Jf", "g1f"):
        asm._flat[name] = asm._flat[name][c0:c1]
    asm.__dict__.pop("_tab_cache", None)

    sharded = {}

    def shard(p):
        if p is not None and id(p) not in sharded:
            sharded[id(p)] = ShardedPattern(p, dist, (c0, c1), asm.nc_real)
        return None if p is None else sharded[id(p)]
    names = ("pat_p2", "pat_p1", "pat_div", "pat_divT")
    for name in names + tuple(n + "_hi" for n in names):
        setattr(asm, name, shard(getattr(asm, name)))

    def shard_const(c, hi):
        p2, p1, pdiv, pdivT = asm._pats(hi)
        own = lambda pat, op: (None if op is None
                               else pat.matrix(pat.owned(op.vals)))
        return ConstOperators(
            L=own(p2, c.L), Mp=own(p1, c.Mp), Ap=own(p1, c.Ap),
            D=tuple(own(pdiv, op) for op in c.D),
            DT=tuple(own(pdivT, op) for op in c.DT), M2=own(p2, c.M2))
    same = asm.const is asm.const_hi
    asm.const_hi = shard_const(asm.const_hi, True)
    asm.const = asm.const_hi if same else shard_const(asm.const, False)
    if asm._load_u is not None:
        asm._load_u = dist.rows(asm._load_u, "u")
    if asm.n_inflow_facets and asm.pat_p1.sharded:
        pos, chunk = asm._kp_surf_pos, asm.pat_p1._chunk
        lo = r * chunk
        sel = np.flatnonzero((pos >= lo) & (pos < lo + chunk))
        asm.kp_surf_sum = _OwnedSum(
            SegmentSum(pos[sel] - lo, chunk, device=asm.device), sel,
            asm.device)


# --------------------------------------------------------------------- #
# the public surface of the JAX module
# --------------------------------------------------------------------- #

class DeviceMesh:
    """The port's counterpart of a 1-D ``jax.sharding.Mesh``: the calling
    rank's group (its :class:`.comm.Comm`), its size and device, and the
    axis name."""

    def __init__(self, comm, axis: str = "dd"):
        self.comm, self.axis = comm, axis
        self.size, self.device = comm.size, comm.device


def make_device_mesh(n_devices: Optional[int] = None,
                     axis: str = "dd") -> DeviceMesh:
    """The 1-D mesh of the calling rank's group (:func:`.comm.current`;
    outside a rank launcher, one rank on the card).  Raises when the group
    is smaller than ``n_devices``, as the JAX package's does, and when it
    is larger, where the JAX package takes the first ``n_devices``: every
    rank of a gloo group takes part in its collectives, so a mesh here is
    the whole group."""
    comm = commmod.current()
    if comm is None:
        comm = commmod.Comm(None, 0, 1, commmod._check_device("cuda"))
    if n_devices is not None:
        if comm.size < n_devices:
            raise ValueError(f"need {n_devices} devices, have {comm.size}")
        if comm.size > n_devices:
            raise ValueError(f"a mesh of {n_devices} devices in a group of "
                             f"{comm.size} ranks: run {n_devices} ranks")
    return DeviceMesh(comm, axis)


class ShardedOseen:
    """Shard a :class:`fenapack_tpu_torch.solvers.nonlinear.NonlinearSolver`
    over the ranks of ``device_mesh`` and expose its full Picard/Newton
    step, run collectively by every rank.

    The layout (the module docstring): per-cell assembly batches sharded
    over cells, operator rows and vectors sharded over rows, small tables,
    facet batches and the Givens algebra whole.  Mutates the solver's
    assembler and Oseen solver in place; a velocity multigrid must be
    seeded with the solver's assembler (``VelocityHierarchy(fine_asm=)``)."""

    def __init__(self, nl, device_mesh: DeviceMesh, axis: str = "dd"):
        self.nl, self.mesh, self.axis = nl, device_mesh, axis
        asm = nl.asm
        n_dev = device_mesh.size
        if asm.row_align % n_dev != 0:
            raise ValueError(
                f"assembler row_align={asm.row_align} must be a multiple of "
                f"the device mesh size {n_dev}; build the NSAssembler with "
                f"row_align=<n_devices>")
        vh = nl.oseen.velocity_hierarchy
        if vh is not None and vh.asms[-1] is not asm:
            raise ValueError("the velocity hierarchy's fine level must be "
                             "the solver's assembler: build it with "
                             "VelocityHierarchy(fine_asm=nl.asm)")
        self.dist = RowShard(device_mesh.comm, asm.dim, asm.n2, asm.n1)
        _shard_assembler(asm, self.dist)
        nl.oseen.distribute(self.dist)

    def step(self, w: torch.Tensor):
        """One nonlinear update ``w <- w + Oseen_solve(w, -F(w))`` from the
        whole state ``w`` (equal on every rank).  Returns ``(w_new, iters,
        resnorms)``: ``w_new`` whole (the ranks' rows all-gathered, equal
        bit for bit on every rank), the FGMRES count and its residual
        estimates.  :attr:`fgmres_seconds` is then the wall time of the
        step's FGMRES loop alone (between two device syncs)."""
        nl, o = self.nl, self.nl.oseen
        w = w.to(o.dtype)
        F = nl.residual_of(w)[0].to(o.dtype)
        res, self.fgmres_seconds = timed_solve(o, w[:nl.n_u], -F)
        return w + self.dist.full(res.x, "w"), res.iters, res.resnorms


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_solve(oseen, wind: torch.Tensor, b: torch.Tensor):
    """``oseen.solve(wind, b)``'s FGMRES result, and the seconds of its
    FGMRES loop alone: the operators and the preconditioner are built
    first, and the loop runs between two syncs of the solver's device."""
    matvec, pc = oseen._compute_pipeline(wind)
    dev = oseen.asm.device
    _sync(dev)
    t0 = time.perf_counter()
    res, _ = oseen._krylov(matvec, pc, b.to(oseen.dtype),
                           oseen.config.krylov.rtol)
    _sync(dev)
    return res, time.perf_counter() - t0
