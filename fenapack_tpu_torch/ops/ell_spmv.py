"""ELL SpMV (kernel K3): the CUDA kernel wrapper and its plain version.

The hand-written kernel ``csrc/ell_spmv.cu`` replaces the Pallas ELL kernel
of ``fenapack_tpu/ops/pallas_spmv.py`` (``_spmv_kernel``, driven by
``PallasSpMV``): ``y[i] = sum_k vals[i, k] * x[cols[i, k]]`` over the ELL
layout of :class:`fenapack_tpu_torch.ops.sparse.ELL` (``cols`` int32,
padding slots hold column 0 and value 0).  Every ``ELL.mv`` goes through
:func:`ell_spmv`.

:func:`ell_spmv` takes the plain PyTorch version only for tensors on the
CPU.  For a CUDA tensor it launches the kernel or raises; nothing falls
back.  The kernel library is built at first use by :mod:`.kernels`.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels

MAX_RHS = 8                       # kMaxRhs in csrc/ell_spmv.cu
_NAMES = {torch.float32: "f32", torch.float64: "f64"}

# Kernel launches per dtype.  Incremented only where the kernel is
# launched, never by the plain version, so a run on the card can show that
# its path went through the kernel.
launches = {"f32": 0, "f64": 0}


def reset_launches():
    for key in launches:
        launches[key] = 0


_fns = {}


def _kernel(name: str):
    """The C entry point ``ell_spmv_<name>`` with its argument types set."""
    if name not in _fns:
        fn = getattr(kernels.load("ell_spmv"), "ell_spmv_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def ell_spmv_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                   n_cols: int) -> torch.Tensor:
    """Plain PyTorch ELL product: gather x at the columns, then a sum over
    the slots (the formula of ``fenapack_tpu.ops.sparse.ELL.mv``).  ``x``
    is (n_cols,) or (n_cols, k)."""
    g = x[cols.long()]
    if x.dim() == 1:
        return torch.sum(vals * g, dim=1)
    return torch.einsum("nk,nkb->nb", vals, g)


def _check(cols, vals, x, n_cols):
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"expected cols and vals of one (n_rows, K) shape, "
                         f"got {tuple(cols.shape)} and {tuple(vals.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype not in _NAMES or x.dtype != vals.dtype:
        raise TypeError(f"vals and x must share float32 or float64, got "
                        f"{vals.dtype} and {x.dtype}")
    if x.dim() not in (1, 2) or x.shape[0] != n_cols:
        raise ValueError(f"x must be ({n_cols},) or ({n_cols}, k), got "
                         f"{tuple(x.shape)}")
    if not (cols.device == vals.device == x.device):
        raise ValueError(f"cols, vals and x lie on different devices: "
                         f"{cols.device}, {vals.device}, {x.device}")


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             n_cols: int) -> torch.Tensor:
    """y = A @ x for the ELL matrix (cols, vals) with ``n_cols`` columns.

    ``x`` is (n_cols,) or (n_cols, k) with k <= MAX_RHS; one pass over the
    matrix serves all k right-hand sides.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check(cols, vals, x, n_cols)
    if x.device.type == "cpu":
        return ell_spmv_plain(cols, vals, x, n_cols)
    if x.device.type != "cuda":
        raise ValueError(f"no ELL SpMV for device {x.device}")
    k = 1 if x.dim() == 1 else x.shape[1]
    if not 1 <= k <= MAX_RHS:
        raise ValueError(f"1 to {MAX_RHS} right-hand sides, got {k}")
    if not (cols.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("cols, vals and x must be contiguous")
    name = _NAMES[vals.dtype]
    n_rows, K = cols.shape
    y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel(name)(cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
                       y.data_ptr(), n_rows, K, k, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv_{name} launch failed: CUDA error {rc}")
    launches[name] += 1
    return y
