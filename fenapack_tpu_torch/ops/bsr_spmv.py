"""Block-sparse (BSR) SpMV: the CUDA kernel wrapper and its plain version.

One hand-written kernel family (``csrc/bsr_spmv.cu``) replaces both Pallas
BSR kernels of ``fenapack_tpu/ops/pallas_spmv.py`` that the main path runs:
``bsr_spmv_f64`` the f64-accurate outer matvec (K1, ``DF32BlockSpMV``) and
``bsr_spmv_f32`` every f32 preconditioner product (K2, ``PallasBSRSpMV``).

:func:`bsr_spmv` takes the plain PyTorch version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; nothing falls back.  A
launch, and only a launch, adds to ``launch.bsr_spmv.<dtype>`` of
:data:`..utils.timing.counts`, so a run on the card can show that its main
path went through the kernels.

The kernel library is built at first use by :mod:`.kernels`.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from ..utils import timing

MAX_RHS = 8                       # kMaxRhs in csrc/bsr_spmv.cu
_NAMES = {torch.float32: "f32", torch.float64: "f64"}

_fns = {}


def _kernel(name: str):
    """The C entry point ``bsr_spmv_<name>`` with its argument types set."""
    if name not in _fns:
        fn = getattr(kernels.load("bsr_spmv"), "bsr_spmv_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def bsr_spmv_plain(nbr: torch.Tensor, tiles: torch.Tensor, x: torch.Tensor,
                   n_rows: int, n_cols: int) -> torch.Tensor:
    """Plain PyTorch BSR product: gather the neighbour blocks of x, then one
    batched (b, m*b) @ (m*b, k) product per block row (the formula of
    ``fenapack_tpu.ops.sparse.BlockELL.mv``).  ``x`` is (n_cols,) or
    (n_cols, k)."""
    nb, b, mb = tiles.shape
    ncb = -(-n_cols // b) * b
    k = 1 if x.dim() == 1 else x.shape[1]
    xb = torch.zeros((ncb, k), dtype=x.dtype, device=x.device)
    xb[:n_cols] = x.reshape(n_cols, k)
    g = xb.reshape(ncb // b, b, k)[nbr.long()].reshape(nb, mb, k)
    y = torch.bmm(tiles, g).reshape(nb * b, k)[:n_rows]
    return y.reshape(n_rows) if x.dim() == 1 else y


def _check(nbr, tiles, x, n_rows, n_cols):
    if tiles.dim() != 3 or nbr.dim() != 2:
        raise ValueError(f"expected nbr (nb, m) and tiles (nb, b, m*b), got "
                         f"{tuple(nbr.shape)} and {tuple(tiles.shape)}")
    nb, b, mb = tiles.shape
    m = nbr.shape[1]
    if nbr.shape[0] != nb or mb != m * b:
        raise ValueError(f"nbr {tuple(nbr.shape)} does not match tiles "
                         f"{tuple(tiles.shape)}")
    if nbr.dtype != torch.int32:
        raise TypeError(f"nbr must be int32, got {nbr.dtype}")
    if tiles.dtype not in _NAMES or x.dtype != tiles.dtype:
        raise TypeError(f"tiles and x must share float32 or float64, got "
                        f"{tiles.dtype} and {x.dtype}")
    if x.dim() not in (1, 2) or x.shape[0] != n_cols:
        raise ValueError(f"x must be ({n_cols},) or ({n_cols}, k), got "
                         f"{tuple(x.shape)}")
    if not 0 <= n_rows <= nb * b:
        raise ValueError(f"n_rows={n_rows} exceeds the {nb * b} tile rows")
    if not (nbr.device == tiles.device == x.device):
        raise ValueError(f"nbr, tiles and x lie on different devices: "
                         f"{nbr.device}, {tiles.device}, {x.device}")


def bsr_spmv(nbr: torch.Tensor, tiles: torch.Tensor, x: torch.Tensor,
             n_rows: int, n_cols: int) -> torch.Tensor:
    """y = A @ x for the BSR matrix (nbr, tiles) of shape (n_rows, n_cols).

    ``x`` is (n_cols,) or (n_cols, k) with k <= MAX_RHS; one pass over the
    tiles serves all k right-hand sides.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32: K2, float64: K1)."""
    _check(nbr, tiles, x, n_rows, n_cols)
    if x.device.type == "cpu":
        return bsr_spmv_plain(nbr, tiles, x, n_rows, n_cols)
    if x.device.type != "cuda":
        raise ValueError(f"no BSR SpMV for device {x.device}")
    k = 1 if x.dim() == 1 else x.shape[1]
    if k > MAX_RHS:
        raise ValueError(f"at most {MAX_RHS} right-hand sides, got {k}")
    if not (nbr.is_contiguous() and tiles.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("nbr, tiles and x must be contiguous")
    name = _NAMES[tiles.dtype]
    fn = _kernel(name)
    y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    _, b, mb = tiles.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(nbr.data_ptr(), tiles.data_ptr(), x.data_ptr(), y.data_ptr(),
            b, mb // b, n_rows, n_cols, k, stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmv_{name} launch failed: CUDA error {rc}")
    timing.launched("bsr_spmv", name)
    return y
