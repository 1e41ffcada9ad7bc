"""Carry state of the JAX package across into this port's tensors.

The caller converts the JAX objects to NumPy arrays (``np.asarray``); these
functions turn the arrays into the port's operators and vectors on a given
device, so that both packages can apply the same operator values to the
same vectors.  Nothing here imports jax.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .fem.assemble import ConstOperators
from .ops import bsr_spmv
from .ops.sparse import ELL, BlockELL


def operator(arrays: Mapping[str, np.ndarray], *, device,
             dtype: Optional[torch.dtype] = None):
    """A :class:`BlockELL` from ``nbr``/``tiles``/``n_rows``/``n_cols`` (the
    JAX package's dense tiles, packed: :func:`.ops.bsr_spmv.pack`) or an
    :class:`ELL` from ``cols``/``vals``/``n_cols`` (int32 columns, the
    layout of both packages)."""
    if "nbr" in arrays:
        idx, vals = bsr_spmv.pack(
            torch.as_tensor(np.array(arrays["nbr"]), dtype=torch.int32),
            torch.as_tensor(np.array(arrays["tiles"]), dtype=dtype))
        return BlockELL(idx.to(device), vals.to(device),
                        int(arrays["n_rows"]), int(arrays["n_cols"]))
    return ELL(torch.as_tensor(np.array(arrays["cols"]), dtype=torch.int32,
                               device=device),
               torch.as_tensor(np.array(arrays["vals"]), dtype=dtype,
                               device=device),
               int(arrays["n_cols"]))


def pattern_index(arrays: Mapping[str, np.ndarray], *, device) -> dict:
    """A pattern's index arrays (``nbr``, ``entry_pos``, ``diag_pos``, any
    subset) as tensors: int32 ``nbr``, int64 positions.  (The JAX
    package's BSR positions are those of its dense tiles:
    ``BlockSparsityPattern.dense_positions`` maps the port's to them.)"""
    out = {}
    for name, a in arrays.items():
        dt = torch.int32 if name == "nbr" else torch.int64
        out[name] = torch.as_tensor(np.array(a), dtype=dt, device=device)
    return out


def const_operators(arrays: Mapping[str, object], *, device,
                    dtype: Optional[torch.dtype] = None) -> ConstOperators:
    """A :class:`ConstOperators` set from per-operator array mappings:
    ``L``, ``Mp``, ``Ap`` and (optional) ``M2`` are mappings as for
    :func:`operator`, ``D`` and ``DT`` sequences of them (one per
    direction)."""
    op = lambda a: operator(a, device=device, dtype=dtype)
    return ConstOperators(
        L=op(arrays["L"]) if arrays.get("L") is not None else None,
        Mp=op(arrays["Mp"]), Ap=op(arrays["Ap"]),
        D=tuple(op(a) for a in arrays.get("D", ())),
        DT=tuple(op(a) for a in arrays.get("DT", ())),
        M2=op(arrays["M2"]) if arrays.get("M2") is not None else None)


def reaction_values(R: np.ndarray, *, device,
                    dtype=torch.float64) -> torch.Tensor:
    """Newton reaction blocks ``R[a, b]`` of shape (d, d, *value_shape), as
    ``NSAssembler.newton_reaction_values`` returns them in both packages."""
    R = np.array(R)
    if R.ndim < 3 or R.shape[0] != R.shape[1]:
        raise ValueError(f"expected (d, d, ...) reaction values, got "
                         f"{R.shape}")
    return torch.as_tensor(R, dtype=dtype, device=device)


def state(w: np.ndarray, *, device, dtype=torch.float64) -> torch.Tensor:
    """A state vector ``w = [u_x; u_y; p]`` as a tensor."""
    return torch.as_tensor(np.array(w), dtype=dtype, device=device)
