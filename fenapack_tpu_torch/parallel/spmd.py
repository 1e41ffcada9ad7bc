"""Row-block distributed products, reductions and FGMRES over ranks.

The port of ``fenapack_tpu/parallel/spmd.py``.  Operators are row-block
partitioned: rank i owns rows ``[i n_loc, (i+1) n_loc)`` of every ELL
matrix and vector.  Each rank computes its rows of ``A x`` from its block
of ``x`` plus what it reads from the other ranks:

  * :class:`RingHaloELL`: under a bandwidth-reducing (RCM) dof order the
    columns of rank i's rows fall inside the blocks of ranks i-1, i, i+1,
    so each rank receives a fixed-width halo from its two ring neighbours
    (:meth:`Comm.ring_exchange`) and computes on the extended vector
    ``[left halo | x_loc | right halo]``.  The host setup (halo width,
    columns rebased to the extended vector) is the JAX package's,
    unchanged.  It raises where the sparsity needs more than one hop.
  * :class:`RowBlockELL`: the all-gather fallback, global columns.
  * :func:`pdot`, :func:`pnorm`, :func:`psum_minres_smooth`: local partial
    sums plus one all-reduce.
  * :func:`spmd_fgmres` / :func:`_fgmres_local`: right-preconditioned
    FGMRES whose Krylov vectors stay row-partitioned.  Per iteration it
    all-reduces the two classical Gram-Schmidt projections and the new
    vector's norm; the Givens rotations, the residual estimate and the
    stopping test run in f64 on the host on those all-reduced values, the
    same on every rank, so every rank takes the same number of iterations.

Every rank-local product is the ELL SpMV kernel K3
(:func:`fenapack_tpu_torch.ops.ell_spmv.ell_spmv`, the block product for
the d components of a velocity field) over the extended column space
``c_loc + 2 h``; on CPU tensors its plain version.  Functions here take and
return the rank's blocks (``x_loc``); the :class:`Comm` replaces the JAX
package's mesh axis.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
from scipy.linalg import solve_triangular

from ..ops.ell_spmv import ell_block_spmv, ell_spmv


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


class RowBlockELL:
    """ELL matrix partitioned into contiguous row blocks, its products
    reading ``x`` all-gathered (global column indices, no halo)."""

    kind = "allgather"

    def __init__(self, ell, n_dev: int):
        n, _ = tuple(ell.cols.shape)
        if n % n_dev or ell.n_cols % n_dev:
            raise ValueError(f"rows {n} / cols {ell.n_cols} not divisible "
                             f"by {n_dev}")
        self.n_dev = n_dev
        self.n_rows, self.n_cols = n, ell.n_cols
        self.n_loc, self.c_loc = n // n_dev, ell.n_cols // n_dev
        self.halo = 0
        self.cols_ext = _np(ell.cols).astype(np.int32)
        self.n_ext = self.n_cols

    def extend(self, comm, x_loc: torch.Tensor) -> torch.Tensor:
        """The global vector (``(..., n_cols)``) from the ranks' blocks."""
        g = comm.all_gather(x_loc)                     # (size, ..., c_loc)
        if x_loc.dim() == 1:
            return g.reshape(-1)
        return g.movedim(0, -2).reshape(tuple(x_loc.shape[:-1]) + (-1,))

    def mv_local(self, comm, vals_loc, cols_loc, x_loc):
        """Owned rows of A @ x (x all-gathered)."""
        return _local_product(cols_loc, vals_loc, self.extend(comm, x_loc),
                              self.n_ext)


class RingHaloELL:
    """Row-block ELL SpMV whose remote reads are a one-hop ring exchange.

    Host setup (the JAX package's, on NumPy arrays): the halo width ``h``
    is the largest reach of any rank's rows beyond the column block it
    co-owns, and ``cols_ext`` rebases each rank's columns to its extended
    vector ``[x[start-h:start) | x_loc | x[end:end+h)]``.  ``valid`` is the
    structural slot mask; without it the slots with a nonzero value count
    (safe for constant operators only: a wind-dependent operator must pass
    its pattern, or a value that happens to be zero at one wind would
    shrink the halo of every later one).  Padding slots are re-pointed at
    the block start.  Raises ``ValueError`` if the sparsity needs more than
    one hop (use :class:`RowBlockELL` or reorder the dofs)."""

    kind = "ring"

    def __init__(self, ell, n_dev: int, valid=None):
        n, K = tuple(ell.cols.shape)
        n_cols = ell.n_cols
        if n % n_dev:
            raise ValueError(f"rows {n} not divisible by {n_dev}")
        if n_cols % n_dev:
            raise ValueError(f"cols {n_cols} not divisible by {n_dev}")
        n_loc = n // n_dev
        c_loc = n_cols // n_dev
        self.n_loc, self.c_loc, self.n_dev = n_loc, c_loc, n_dev
        cols = _np(ell.cols)
        vals = _np(ell.vals)
        valid_all = _np(valid) if valid is not None else vals != 0

        h = 0
        for i in range(n_dev):
            blk = cols[i * n_loc:(i + 1) * n_loc]
            ok = valid_all[i * n_loc:(i + 1) * n_loc]
            c = np.where(ok, blk, i * c_loc)
            lo = int(c.min()) - i * c_loc
            hi = int(c.max()) - ((i + 1) * c_loc - 1)
            h = max(h, -lo, hi)
        if h > c_loc:
            raise ValueError(
                f"halo width {h} exceeds column block size {c_loc}: "
                "sparsity is not one-hop under this ordering; use "
                "RowBlockELL (all-gather) or reorder dofs (RCM)")
        self.halo = h

        cols_ext = np.empty_like(cols)
        for i in range(n_dev):
            blk = slice(i * n_loc, (i + 1) * n_loc)
            c = np.where(valid_all[blk], cols[blk], i * c_loc)
            cols_ext[blk] = c - (i * c_loc - h)
        self.cols_ext = cols_ext.astype(np.int32)
        self.n_ext = c_loc + 2 * h

    def extend(self, comm, x_loc: torch.Tensor) -> torch.Tensor:
        """``[left halo | x_loc | right halo]`` along the last dimension
        (one exchange; zeros at the ring's ends)."""
        return ring_extend(comm, [(x_loc, self.halo)])[0]

    def mv_local(self, comm, vals_loc, cols_loc, x_loc):
        """Owned rows of A @ x; one halo exchange each way.  ``x_loc`` is
        the rank's block of the column-space vector, ``(c_loc,)`` or
        ``(d, c_loc)`` (the same matrix on each of d components)."""
        return _local_product(cols_loc, vals_loc, self.extend(comm, x_loc),
                              self.n_ext)


def local_rows(t: torch.Tensor, rank: int, n_loc: int) -> torch.Tensor:
    """Rank ``rank``'s row block of a row-partitioned array (a copy)."""
    return t[rank * n_loc:(rank + 1) * n_loc].contiguous()


def ring_extend(comm, parts: Sequence[Tuple[torch.Tensor, int]]
                ) -> List[torch.Tensor]:
    """Extended vectors ``[left | x | right]`` of several ``(x, h)`` pairs
    from ONE exchange (:meth:`Comm.ring_exchange`)."""
    halos = comm.ring_exchange(parts)
    return [torch.cat([left, x, right], dim=-1) if h else x
            for (x, h), (left, right) in zip(parts, halos)]


def narrow_ext(ext: torch.Tensor, H: int, h: int) -> torch.Tensor:
    """The extended vector of halo ``h`` inside one of halo ``H >= h``."""
    if h == H:
        return ext
    return ext[..., H - h:ext.shape[-1] - (H - h)].contiguous()


def _local_product(cols_loc, vals_loc, ext, n_ext):
    """K3 over the extended column space: the single product for a vector,
    the block product (one matrix on every component) for ``(d, n)``."""
    if ext.dim() == 1:
        return ell_spmv(cols_loc, vals_loc, ext.contiguous(), n_ext)
    return ell_block_spmv(cols_loc, vals_loc, None, ext.contiguous(), n_ext)


# --------------------------------------------------------------------- #
# reductions
# --------------------------------------------------------------------- #

def pdot(comm, a_loc: torch.Tensor, b_loc: torch.Tensor) -> torch.Tensor:
    """Distributed dot product (all-reduce)."""
    return comm.allreduce_sum(torch.dot(a_loc.reshape(-1),
                                        b_loc.reshape(-1)))


def pnorm(comm, a_loc: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(pdot(comm, a_loc, a_loc))


def psum_minres_smooth(comm, mv_local: Callable, dinv_loc, s_iters: int,
                       b_loc, x_loc=None):
    """Distributed minimal-residual (GMRES-polynomial) smoother step: the
    Jacobi-scaled Krylov directions from the rank-local matvec, the small
    Gram system ``W W^T`` and ``W r`` summed over the ranks in one
    all-reduce, the same ridge as the single-device smoother.  ``x_loc``
    None stands for zeros: the residual is ``b`` itself (the same bits as
    ``b - A 0``), and its product, a halo exchange, is not taken."""
    r = b_loc if x_loc is None else b_loc - mv_local(x_loc)
    z = dinv_loc * r
    Zs, Ws = [], []
    for _ in range(s_iters):
        w = mv_local(z)
        Zs.append(z)
        Ws.append(w)
        z = dinv_loc * w
    W = torch.stack(Ws)
    Z = torch.stack(Zs)
    s = W.shape[0]
    Gc = comm.allreduce_sum(torch.cat([(W @ W.T).reshape(-1), W @ r]))
    G, c = Gc[:s * s].reshape(s, s), Gc[s * s:]
    lam = 1e-7 * torch.trace(G) / s + 1e-30
    eye = torch.eye(s, dtype=G.dtype, device=G.device)
    y = torch.linalg.solve_ex(G + lam * eye, c)[0]
    return Z.T @ y if x_loc is None else x_loc + Z.T @ y


# --------------------------------------------------------------------- #
# standalone distributed products (one operator, rank blocks in and out)
# --------------------------------------------------------------------- #

def make_spmd_spmv(ell, comm):
    """``f(x_loc) -> (A x)_loc``: the rank's rows of ``A x`` from its block
    of ``x``, all-gathered.  Rows and columns must divide by the number of
    ranks."""
    rb = RowBlockELL(ell, comm.size)
    cols = local_rows(torch.as_tensor(rb.cols_ext, device=ell.vals.device),
                      comm.rank, rb.n_loc)
    vals = local_rows(ell.vals, comm.rank, rb.n_loc)
    return lambda x_loc: rb.mv_local(comm, vals, cols, x_loc)


def make_spmd_dot(comm):
    """Distributed dot product of two rank blocks."""
    return lambda a_loc, b_loc: pdot(comm, a_loc, b_loc)


def make_ring_spmv(ell, comm):
    """``f(x_loc) -> (A x)_loc`` with the one-hop ring halo exchange
    (:class:`RingHaloELL`)."""
    rh = RingHaloELL(ell, comm.size)
    cols = local_rows(torch.as_tensor(rh.cols_ext, device=ell.vals.device),
                      comm.rank, rh.n_loc)
    vals = local_rows(ell.vals, comm.rank, rh.n_loc)
    return lambda x_loc: rh.mv_local(comm, vals, cols, x_loc)


# --------------------------------------------------------------------- #
# distributed FGMRES
# --------------------------------------------------------------------- #

def spmd_fgmres(comm, make_ops: Callable, operands, b_loc: torch.Tensor, *,
                maxiter: int = 60, rtol: float = 1e-8):
    """Right-preconditioned FGMRES over the ranks.  ``make_ops(operands)
    -> (matvec_local, pc_local)`` builds the rank-local operator and
    preconditioner from the rank's ``operands``; they may communicate
    themselves (ring products, all-reduces).  Returns ``(x_loc, iters,
    resnorm_estimate)``."""
    matvec_local, pc_local = make_ops(operands)
    return _fgmres_local(comm, matvec_local, pc_local, b_loc,
                         maxiter=maxiter, rtol=rtol)


def _fgmres_local(comm, matvec_local: Callable, pc_local: Callable,
                  b_loc: torch.Tensor, *, maxiter: int, rtol: float):
    """The rank-local FGMRES body (see the module docstring).  Classical
    Gram-Schmidt twice, each pass one all-reduce of the (k+1) projections,
    and one all-reduce of the new vector's norm; no restarts."""
    m = maxiter
    dev, dt = b_loc.device, b_loc.dtype
    n_loc = b_loc.shape[0]
    dotb = comm.allreduce_sum_host(torch.dot(b_loc, b_loc))
    beta = float(np.sqrt(dotb.double().item()))
    tol = rtol * beta
    V = torch.zeros((m + 1, n_loc), dtype=dt, device=dev)
    V[0] = b_loc / (beta if beta > 0 else 1.0)
    Z = torch.zeros((m, n_loc), dtype=dt, device=dev)
    R = np.zeros((m, m))
    cs, sn = np.ones(m), np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta
    k, done = 0, beta <= tol
    while k < m and not done:
        z = pc_local(V[k])
        w = matvec_local(z)
        Z[k] = z
        Vk = V[:k + 1]
        h1 = comm.allreduce_sum_host(Vk @ w)
        w = w - Vk.T @ h1.to(dev)
        h2 = comm.allreduce_sum_host(Vk @ w)
        w = w - Vk.T @ h2.to(dev)
        wn2 = comm.allreduce_sum_host(torch.dot(w, w))
        wnorm = float(np.sqrt(wn2.double().item()))
        h = np.zeros(k + 2)
        h[:k + 1] = (h1 + h2).double().numpy()
        h[k + 1] = wnorm
        V[k + 1] = w / (wnorm if wnorm > 0 else 1.0)
        for i in range(k):                         # earlier rotations
            hi = cs[i] * h[i] + sn[i] * h[i + 1]
            h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
            h[i] = hi
        denom = float(np.hypot(h[k], h[k + 1]))
        ck, sk = (h[k] / denom, h[k + 1] / denom) if denom > 0 else (1., 0.)
        cs[k], sn[k] = ck, sk
        h[k], h[k + 1] = denom, 0.0
        R[:k + 1, k] = h[:k + 1]
        res = abs(sk * g[k])
        g[k + 1] = -sk * g[k]
        g[k] = ck * g[k]
        k += 1
        done = res <= tol
    if k:
        Rk = R[:k, :k] + np.diag(np.where(np.diag(R[:k, :k]) == 0, 1.0, 0.0))
        y = solve_triangular(Rk, g[:k], lower=False)
        x_loc = Z[:k].T @ torch.as_tensor(y, dtype=dt, device=dev)
    else:
        x_loc = torch.zeros_like(b_loc)
    return x_loc, k, float(abs(g[k]))
