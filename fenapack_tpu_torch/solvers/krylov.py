"""Flexible GMRES (right-preconditioned) and its deflated-recycling
variant, the port of ``fenapack_tpu/solvers/krylov.py::fgmres`` and
``fgmres_dr``.

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
    counts every host wait of the solve (the counter of
    :mod:`..utils.timing`): ``|b|``, one per iteration, and the copy of the
    small solution ``y`` to the device.
  * The solve starts from x = 0.  Convergence is tested on the residual
    estimate ``|g[k+1]|`` against ``rtol * ||b||``; ``converged`` reports
    that test only, so a breakdown stop or the ``maxiter`` cap never passes
    for convergence.
  * GCRO-DR (:func:`fgmres_dr`, Parks et al. 2006): a recycle space of
    ``k`` directions ``U`` with ``C = A U``, ``C C^T = I`` deflates the
    Arnoldi process, which runs on ``(I - C C^T) A pc``.  The projections
    ``C w`` ride the Hessenberg column's copy to the host, so recycling adds
    no host synchronisation per iteration.  The next space is harvested
    from the smallest singular directions of the small augmented
    Hessenberg matrix (NumPy f64 on the host), and re-bound to the operator
    by matvecs and a QR on the device (:func:`refresh_recycle`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from scipy.linalg import solve_triangular

from ..ops.dist import LOCAL
from ..utils import timing

_EPS = {torch.float32: 6.0e-8, torch.float64: 2.3e-16}
_NP = {torch.float32: np.float32, torch.float64: np.float64}


class FGMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorms: np.ndarray        # (maxiter + 1,), padded with the last value
    converged: bool
    bnorm: float
    host_syncs: int
    # refinement rounds behind the result (OseenSolver.make_ir_solve's
    # multi-round mode); a single FGMRES solve is one
    rounds: int = 1


def _rotate(h: np.ndarray, cs: np.ndarray, sn: np.ndarray, k: int):
    """Apply the k accumulated Givens rotations to Hessenberg column h."""
    for i in range(k):
        hi = cs[i] * h[i] + sn[i] * h[i + 1]
        h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
        h[i] = hi


class RecycleSpace(NamedTuple):
    """A GCRO-DR recycle space: ``k`` solution-space directions ``U``
    (rows) with their operator images ``C = A U`` (rows, orthonormal).

    ``valid`` is per direction (0.0 | 1.0), so a space fills up across
    solves shorter than ``k`` iterations.  Invalid rows of ``U`` and ``C``
    are exactly zero, so every consumer (the deflation projection, the
    solution's reconstruction, the small augmented matrix) is right without
    masking, and valid rows come first (the harvest sorts by score), so a
    factorization sees trailing zero columns only."""
    U: torch.Tensor             # (k, n)
    C: torch.Tensor             # (k, n), C = A U, C C^T = diag(valid)
    valid: torch.Tensor         # (k,) 0.0 | 1.0


def empty_recycle(k: int, n: int, dtype, device) -> RecycleSpace:
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return RecycleSpace(U=z(k, n), C=z(k, n), valid=z(k))


def refresh_recycle(matvec: Callable, rec: RecycleSpace) -> RecycleSpace:
    """Re-bind a recycle space to a new operator: ``C' = A U`` by ``k``
    matvecs, ``C' = Q R`` (QR of the tall ``C'^T`` on the device), then
    ``U <- R^{-T} U`` and ``C <- Q^T``, so that ``C = A U`` and ``C C^T =
    I`` hold for the new operator.  Near-zero pivots (the invalid
    directions' zero columns) are pinned to 1 and their rows zeroed."""
    dt = rec.U.dtype
    Cp = torch.stack([matvec(u) for u in rec.U])            # (k, n)
    Q, R = torch.linalg.qr(Cp.T)                            # (n, k), (k, k)
    pin = (torch.abs(torch.diagonal(R)) <= 1e-20).to(dt)
    U = torch.linalg.solve_triangular((R + torch.diag(pin)).T, rec.U,
                                      upper=False)
    ok = (rec.valid > 0)[:, None]
    return RecycleSpace(U=torch.where(ok, U, 0.0),
                        C=torch.where(ok, Q.T, 0.0), valid=rec.valid)


def fgmres(matvec: Callable, pc: Callable, b: torch.Tensor, *,
           maxiter: int = 100, rtol: float = 1e-8, atol: float = 0.0,
           reorth_eta: float = 0.0, dist=LOCAL) -> FGMRESResult:
    """Solve ``A x = b`` with right preconditioner ``pc`` (flexible) to
    ``max(rtol |b|, atol)``.
    ``reorth_eta = 0`` runs the second Gram-Schmidt pass unconditionally.
    ``dist`` (:mod:`.dist`) lays the Krylov vectors out over ranks: each
    rank holds its rows of ``b``, of the basis and of ``x``; the
    Gram-Schmidt projections and norms are reduced over the ranks (three
    reductions per iteration), so every rank reads the same Hessenberg
    column and stops at the same iteration."""
    return _fgmres(matvec, pc, b, None, maxiter, rtol, reorth_eta, dist,
                   atol)[0]


def fgmres_dr(matvec: Callable, pc: Callable, b: torch.Tensor,
              rec: RecycleSpace, *, maxiter: int = 100, rtol: float = 1e-8,
              atol: float = 0.0, reorth_eta: float = 0.0):
    """Deflated-recycling FGMRES (GCRO-DR): :func:`fgmres` with the Krylov
    space augmented by ``rec``, whose ``C = A U`` must hold for this
    operator (:func:`refresh_recycle` after the operator changed).  Returns
    ``(result, rec_new)``: ``rec_new`` holds the directions of the smallest
    singular values of the augmented space, the ones the next solve
    converges slowest on."""
    return _fgmres(matvec, pc, b, rec, maxiter, rtol, reorth_eta,
                   atol=atol)


def _fgmres(matvec, pc, b, rec: Optional[RecycleSpace], maxiter: int,
            rtol: float, reorth_eta: float, dist=LOCAL, atol: float = 0.0):
    with timing.span("fgmres"):
        return _fgmres_spanned(matvec, pc, b, rec, maxiter, rtol,
                               reorth_eta, dist, atol)


def _fgmres_spanned(matvec, pc, b, rec, maxiter, rtol, reorth_eta, dist,
                    atol):
    n, m = b.shape[0], maxiter
    syncs0 = timing.counts["host_syncs"]
    dtype, dev = b.dtype, b.device
    npdt = _NP[dtype]
    r0 = b
    if rec is None:
        bnorm = beta = npdt(dist.norm(b).cpu())
        timing.host_sync()
    elif dist.size > 1:
        raise NotImplementedError("GCRO-DR recycling runs on one device")
    else:
        # project out the recycle image space; the C components of the
        # solution are reconstructed at the end (x += U^T (c0 - B y))
        U, C = rec.U, rec.C
        kr = U.shape[0]
        c0 = C @ b
        r0 = b - C.T @ c0
        head = torch.cat([torch.stack([torch.linalg.norm(b),
                                       torch.linalg.norm(r0)]),
                          rec.valid]).cpu().numpy()
        timing.host_sync()
        bnorm, beta, valid = npdt(head[0]), npdt(head[1]), head[2:]
        Bm = np.zeros((m, kr), dtype=npdt)          # C w per iteration
        Hm = np.zeros((m + 1, m), dtype=npdt)       # pre-rotation columns
    tol = max(rtol * bnorm, atol)

    V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
    V[0] = r0 / (beta if beta > 0 else 1.0)
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
        with timing.span("fgmres.iter"):
            with timing.span("pc"):
                z = pc(V[k])
            with timing.span("fgmres.matvec"):
                w = matvec(z)
            Z[k] = z
            parts = []
            if rec is not None:
                bk = C @ w
                w = w - C.T @ bk
                parts = [bk]
            Vk = V[:k + 1]
            h1, wnorm_pre = dist.proj_norm(Vk, w)
            w = w - Vk.T @ h1
            if reorth_eta > 0.0:
                h2, wnorm_mid = dist.proj_norm(Vk, w)
                h2 = h2 * (wnorm_mid < reorth_eta * wnorm_pre)
            else:
                h2 = dist.proj(Vk, w)
            w = w - Vk.T @ h2
            wnorm = dist.norm(w)
            V[k + 1] = w / torch.where(wnorm > 0, wnorm,
                                       torch.ones_like(wnorm))
            col = torch.cat([h1 + h2, torch.stack([wnorm, wnorm_pre])]
                            + parts)
            with timing.span("fgmres.host"):
                col = col.cpu().numpy()
                timing.host_sync()
                h = np.zeros(m + 1, dtype=npdt)
                h[:k + 1] = col[:k + 1]
                h[k + 1] = col[k + 1]
                wn, wn_pre = col[k + 1], col[k + 2]
                if rec is not None:
                    Bm[k] = col[k + 3:]
                    Hm[:, k] = h
                # (near-)breakdown: the new direction lies numerically in
                # the span; normalizing it would inject amplified noise
                # into the basis and decouple the estimate from the true
                # residual.  Stop instead.
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
    y = np.zeros(0, dtype=npdt)
    if k:
        y = solve_triangular(R[:k, :k], g[:k], lower=False).astype(npdt)
        x = Z[:k].T @ torch.as_tensor(y, device=dev)
        timing.host_sync()
    hist[k + 1:] = hist[k]
    if rec is not None:
        x = x + U.T @ (c0 - torch.as_tensor(Bm[:k].T @ y, device=dev))
        timing.host_sync()
        # C-space correction passes: the reconstruction trusts C = A U,
        # which holds to rounding only; each pass removes the C component
        # of the true residual once more, for one matvec
        for _ in range(2):
            x = x + U.T @ (C @ (b - matvec(x)))
        rec = _deflation_update(matvec, rec, valid, Z[:k], Bm[:k],
                                Hm[:k + 1, :k])
    result = FGMRESResult(x=x, iters=k, resnorms=hist,
                          converged=bool(hist[m] <= tol), bnorm=float(bnorm),
                          host_syncs=timing.counts["host_syncs"] - syncs0)
    return result, rec


def _deflation_update(matvec, rec: RecycleSpace, valid: np.ndarray, Z,
                      Bm: np.ndarray, Hm: np.ndarray) -> RecycleSpace:
    """The next recycle space from the combined space ``[U, Z]``.

    The augmented Arnoldi relation is ``A [U, Z] = [C, V] G`` with ``G =
    [[diag(valid), B^T], [0, H]]`` over the ``k_it`` active iterations.
    The new span is that of the ``k`` right singular directions of ``G``
    with the smallest singular values; a direction with weight on an
    invalid column of ``U`` scores 1e6 higher, so valid candidates come
    first and a direction is kept only if it lives in the valid columns
    (a short solve fills the space partly).  Only the span is taken from
    the small problem: ``C = A U`` is re-bound by matvecs and a QR
    (mapping ``U`` through ``G``'s tiny singular values would amplify
    their rounding by ``1/sigma_min``)."""
    kr = rec.U.shape[0]
    k_it = Z.shape[0]
    G = np.zeros((kr + k_it + 1, kr + k_it))
    G[:kr, :kr] = np.diag(valid)
    G[:kr, kr:] = Bm.T
    G[kr:, kr:] = Hm
    _, sig, Vt = np.linalg.svd(G)                   # sig descending
    inv_energy = (Vt ** 2) @ np.concatenate([1.0 - valid, np.zeros(k_it)])
    scores = sig + 1e6 * inv_energy
    idx = np.argsort(scores, kind="stable")[:kr]
    sel_ok = (inv_energy[idx] < 0.5).astype(np.float64)
    W = torch.as_tensor(Vt[idx] * sel_ok[:, None], dtype=rec.U.dtype,
                        device=rec.U.device)        # (kr, kr + k_it)
    Ut = W[:, :kr] @ rec.U + W[:, kr:] @ Z          # (kr, n)
    ok = torch.as_tensor(sel_ok, dtype=rec.U.dtype, device=rec.U.device)
    timing.host_sync(2)
    # orthonormalize the span (invalid rows are zero and sorted last)
    Qu = torch.linalg.qr(Ut.T)[0] * ok[None, :]
    return refresh_recycle(matvec, RecycleSpace(
        U=Qu.T.contiguous(), C=torch.zeros_like(Ut), valid=ok))
