"""Flexible GMRES (right-preconditioned), the port of
``fenapack_tpu/solvers/krylov.py::fgmres``.

Flexible because the PCD preconditioner contains iterative subsolves.  No
restarts: ``maxiter`` is the Krylov dimension.

  * Orthogonalization is classical Gram-Schmidt with selective
    reorthogonalization ("twice is enough", Kahan-Parlett): the second pass
    counts only when the first one shrank ``|w|`` below ``reorth_eta *
    |w_pre|``.  The decision is taken on the device (the second pass is
    multiplied by the 0/1 outcome), so it costs no host round trip.
  * The Hessenberg column goes to the host once per iteration, where the
    Givens rotations, the residual estimate and the convergence and
    breakdown tests run in NumPy in the Krylov dtype.  That copy is the one
    host synchronisation of an iteration; ``FGMRESResult.host_syncs``
    counts them.
  * The solve starts from x = 0.  Convergence is tested on the residual
    estimate ``|g[k+1]|`` against ``rtol * ||b||``; ``converged`` reports
    that test only, so a breakdown stop or the ``maxiter`` cap never passes
    for convergence.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from scipy.linalg import solve_triangular

_EPS = {torch.float32: 6.0e-8, torch.float64: 2.3e-16}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


class FGMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorms: np.ndarray        # (maxiter + 1,), padded with the last value
    converged: bool
    bnorm: float
    host_syncs: int


def _rotate(h: np.ndarray, cs: np.ndarray, sn: np.ndarray, k: int):
    """Apply the k accumulated Givens rotations to Hessenberg column h."""
    for i in range(k):
        hi = cs[i] * h[i] + sn[i] * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = hi


def fgmres(matvec: Callable, pc: Callable, b: torch.Tensor, *,
           maxiter: int = 100, rtol: float = 1e-8,
           reorth_eta: float = 0.0) -> FGMRESResult:
    """Solve ``A x = b`` with right preconditioner ``pc`` (flexible).
    ``reorth_eta = 0`` runs the second Gram-Schmidt pass unconditionally."""
    n, m = b.shape[0], maxiter
    dtype, dev = b.dtype, b.device
    npdt = _NP[dtype]
    bnorm = beta = npdt(torch.linalg.norm(b).cpu())
    syncs = 1
    tol = rtol * bnorm

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    V[0] = b / (beta if beta > 0 else 1.0)
    Z = torch.zeros((m, n), dtype=dtype, device=dev)
    R = np.zeros((m, m), dtype=npdt)
    cs = np.ones(m, dtype=npdt)
    sn = np.zeros(m, dtype=npdt)
    g = np.zeros(m + 1, dtype=npdt)
    g[0] = beta
    hist = np.full(m + 1, beta, dtype=npdt)
    k = 0
    done = beta <= tol
    while k < m and not done:
        z = pc(V[k])
        w = matvec(z)
        Z[k] = z
        Vk = V[:k + 1]
        wnorm_pre = torch.linalg.norm(w)
        h1 = Vk @ w
        w = w - Vk.T @ h1
        h2 = Vk @ w
        if reorth_eta > 0.0:
            keep = torch.linalg.norm(w) < reorth_eta * wnorm_pre
            h2 = h2 * keep
        w = w - Vk.T @ h2
        wnorm = torch.linalg.norm(w)
        V[k + 1] = w / torch.where(wnorm > 0, wnorm, torch.ones_like(wnorm))
        col = torch.cat([h1 + h2, torch.stack([wnorm, wnorm_pre])])
        col = col.cpu().numpy()
        syncs += 1
        h = np.zeros(m + 1, dtype=npdt)
        h[:k + 1] = col[:k + 1]
        h[k + 1] = col[k + 1]
        wn, wn_pre = col[k + 1], col[k + 2]
        # (near-)breakdown: the new direction lies numerically in the span;
        # normalizing it would inject amplified noise into the basis and
        # decouple the estimate from the true residual.  Stop instead.
        breakdown = wn <= 100.0 * _EPS[dtype] * wn_pre
        _rotate(h, cs, sn, k)
        denom = np.hypot(h[k], h[k + 1])
        ck = h[k] / denom if denom > 0 else npdt(1.0)
        sk = h[k + 1] / denom if denom > 0 else npdt(0.0)
        cs[k], sn[k] = ck, sk
        h[k], h[k + 1] = denom, 0.0
        R[:, k] = h[:m]
        res = abs(sk * g[k])
        g[k + 1], g[k] = -sk * g[k], ck * g[k]
        hist[k + 1] = res
        done = res <= tol or breakdown
        k += 1

    x = torch.zeros_like(b)
    if k:
        y = solve_triangular(R[:k, :k], g[:k], lower=False).astype(npdt)
        x = Z[:k].T @ torch.as_tensor(y, device=dev)
    hist[k + 1:] = hist[k]
    return FGMRESResult(x=x, iters=k, resnorms=hist,
                        converged=bool(hist[m] <= tol), bnorm=float(bnorm),
                        host_syncs=syncs)
