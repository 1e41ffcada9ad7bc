"""PCD (pressure-convection-diffusion) Schur complement approximations.

The port of ``fenapack_tpu/solvers/pcd.py::make_pcd_apply`` (steady).  A
PCD apply is a plain function ``z_p = pcd(kp, r_p)`` composed from subsolve
closures; the wind-dependent Kp operator is an argument.  Signs as in the
reference; the 1/nu scaling is folded into Mp and Kp:

  BRM1 (pressure BCs on the inflow):
      w1 <- Ap_bc^{-1} chop(x)
      y  <- -Mp^{-1} (x + Kp w1)

  BRM2 (pressure BCs on the outflow; Kp includes the inflow surface term):
      w1 <- Mp^{-1} x
      y  <- -(w1 + Ap_bc^{-1} chop(Kp w1))

``chop`` zeroes the rows of the PCD Dirichlet dofs; the Ap solve with those
rows is the symmetric masked operator ``free Ap free + I_bc``.  For enclosed
flow without PCD Dirichlet rows (BRM2 on the lid-driven cavity) the constant
nullspace is projected out around the Ap solve and from the result, the
analogue of fenapack attaching a constant nullspace to the Ap solver.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def make_pcd_apply(variant: str, ap_solve: Callable, mp_solve: Callable,
                   bc_mask: Optional[torch.Tensor],
                   nullspace: bool = False) -> Callable:
    """Build ``pcd(kp, r_p) -> z_p``.  ``ap_solve``/``mp_solve`` approximate
    Ap^{-1} (BC masking built in) and Mp^{-1}; ``bc_mask`` is the PCD-BC dof
    mask (1.0 at Dirichlet dofs) or None; ``nullspace`` projects the
    constant mode out around the Ap solve and from the result."""
    free = None if bc_mask is None else 1.0 - bc_mask

    def chop(x):
        return x if free is None else x * free

    def project(x):
        return x - torch.mean(x) if nullspace else x

    def ap_inv(x):
        return project(ap_solve(project(x)))

    if variant == "BRM1":
        def apply(kp, x: torch.Tensor) -> torch.Tensor:
            w1 = ap_inv(chop(x))
            return project(-mp_solve(x + kp.mv(w1)))
    elif variant == "BRM2":
        def apply(kp, x: torch.Tensor) -> torch.Tensor:
            w1 = mp_solve(x)
            return project(-(w1 + ap_inv(chop(kp.mv(w1)))))
    else:
        raise ValueError(f"unknown PCD variant {variant!r}")
    return apply
