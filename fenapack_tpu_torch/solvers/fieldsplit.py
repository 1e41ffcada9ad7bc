"""Upper-triangular Schur fieldsplit preconditioner as function composition.

The port of ``fenapack_tpu/solvers/fieldsplit.py``:

    P = [ A   B^T ]      P^{-1} r :  z_p = S_hat^{-1} r_p
        [ 0    S  ]                  z_u = A_hat^{-1} (r_u - B^T z_p)

with ``S_hat^{-1}`` the PCD apply and ``A_hat^{-1}`` the velocity subsolve.
The monolithic vector is ``[u_x; u_y; p]``, so the splits are slices.
Velocity Dirichlet dofs carry an identity block: ``z_u = r_u`` there.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.timing import span


def make_fieldsplit_upper(n_u: int, a_solve: Callable, schur_solve: Callable,
                          bt_mv: Callable, free_u: torch.Tensor) -> Callable:
    """``a_solve(r_u)`` approximates the bc-masked velocity block inverse,
    ``schur_solve(r_p)`` is the PCD apply (wind bound), ``bt_mv(p)`` applies
    B^T, ``free_u`` masks free velocity dofs (0 at Dirichlet dofs)."""
    def apply(r: torch.Tensor) -> torch.Tensor:
        r_u, r_p = r[:n_u], r[n_u:]
        with span("pc.pcd"):
            z_p = schur_solve(r_p)
        with span("pc.bt"):
            rhs = free_u * (r_u - bt_mv(z_p))
        with span("pc.velocity"):
            z_u = free_u * a_solve(rhs) + (1.0 - free_u) * r_u
        return torch.cat([z_u, z_p])
    return apply
