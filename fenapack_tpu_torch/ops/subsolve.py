"""Inner subsolves: Jacobi, lumped mass, fixed-iteration Chebyshev and
dense explicit inverses.

The port of ``fenapack_tpu/ops/subsolve.py`` (Jacobi, lumped mass,
Chebyshev, power bounds, dense solvers).  Every solver here is a
fixed-iteration preconditioner: a static chain of SpMVs and vector updates,
no data-dependent control flow.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def make_jacobi(diag: torch.Tensor) -> Callable:
    dinv = 1.0 / diag
    return lambda r: dinv * r


def lumped_inverse(M) -> torch.Tensor:
    """Row-sum (lumped) mass inverse: exact for the constant mode,
    spectrally equivalent to Mp^{-1} (standard PCD practice for the mass
    subsolve).  Empty rows (alignment padding) get identity."""
    rs = M.row_sums()
    ok = rs != 0
    return torch.where(ok, 1.0 / torch.where(ok, rs, torch.ones_like(rs)),
                       torch.ones_like(rs))


def chebyshev_solver(matvec: Callable, dinv: torch.Tensor, lmin: float,
                     lmax: float, iters: int) -> Callable:
    """Return ``solve(b) ~= A^{-1} b`` via ``iters`` Jacobi-Chebyshev steps.

    ``lmin``/``lmax`` bound the spectrum of ``diag(A)^{-1} A``.  Standard
    three-term recurrence (Saad, Iterative Methods, alg. 12.1).
    """
    d = 0.5 * (lmax + lmin)
    c = 0.5 * (lmax - lmin)

    def solve(b):
        x = torch.zeros_like(b)
        r = b
        p = torch.zeros_like(b)
        alpha = 0.0
        for i in range(iters):
            z = dinv * r
            if i == 0:
                p = z
                alpha = 1.0 / d
            else:
                # first-step beta is (1/2)(c*alpha_0)^2, later ones
                # (c*alpha/2)^2: the halved first step is not a typo
                beta = (0.5 * (c * alpha) ** 2 if i == 1
                        else (0.5 * c * alpha) ** 2)
                alpha = 1.0 / (d - beta / alpha)
                p = z + beta * p
            x = x + alpha * p
            r = r - alpha * matvec(p)
        return x
    return solve


def power_bounds(matvec: Callable, dinv: torch.Tensor, n: int,
                 iters: int = 50, seed: int = 0) -> Tuple[float, float]:
    """Estimate (lmin, lmax) of ``diag^{-1} A`` for an SPD ``A`` by power
    iteration on D^{-1}A, then on (lmax I - D^{-1}A).  Setup-time only."""
    rng = np.random.default_rng(seed)
    op = lambda v: dinv * matvec(v)
    like = dict(dtype=dinv.dtype, device=dinv.device)

    v = torch.as_tensor(rng.standard_normal(n), **like)
    v = v / torch.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = op(v)
        lam = torch.linalg.norm(w)
        v = w / lam
    lmax = float(lam)

    v = torch.as_tensor(rng.standard_normal(n), **like)
    v = v / torch.linalg.norm(v)
    mu = 0.0
    for _ in range(iters):
        w = lmax * v - op(v)
        mu = torch.linalg.norm(w)
        v = w / mu
    lmin = float(lmax - mu)
    return max(lmin, 1e-12), lmax * 1.01


def dense_lu_solver(A_dense: torch.Tensor) -> Callable:
    """Exact dense solver via a precomputed explicit inverse: one matrix-
    vector product per apply (FGMRES absorbs the inverse's extra rounding).
    Needs full-precision matrix products: TF32 off (the solvers set it)."""
    Ainv = torch.linalg.inv(A_dense)
    return lambda b: Ainv @ b


def masked_spd_solver_dense(op, pattern, bc_mask: torch.Tensor,
                            dtype=None, nullspace: bool = False) -> Callable:
    """Dense exact solver of the symmetric bc-eliminated operator
    ``free A free + I_bc``.

    ``nullspace=True`` (enclosed flow: pure-Neumann pressure Laplacian) adds
    the rank-1 constant shift ``(1/n_free) free free^T`` so the inverse
    exists; with the constant-mode projections of the PCD apply it acts as
    the pseudo-inverse."""
    dt = dtype or op.vals.dtype
    A = pattern.to_dense(op.vals).to(dt)
    bc = bc_mask.to(dt)
    free = 1.0 - bc
    A = free[:, None] * A * free[None, :] + torch.diag(bc)
    if nullspace:
        n_free = torch.clamp(torch.sum(free), min=1.0)
        A = A + torch.outer(free, free) / n_free
    return dense_lu_solver(A)
