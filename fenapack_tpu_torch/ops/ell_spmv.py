"""ELL SpMV (kernel K3): the CUDA kernel wrappers and their plain versions.

The hand-written kernels of ``csrc/ell_spmv.cu`` replace the Pallas ELL
kernel of ``fenapack_tpu/ops/pallas_spmv.py`` (``_spmv_kernel``, driven by
``PallasSpMV``) over the ELL layout of
:class:`fenapack_tpu_torch.ops.sparse.ELL` (``cols`` int32, padding slots
hold column 0 and value 0).  Two entry points:

  * :func:`ell_spmv`, the single product ``y[i] = sum_k vals[i, k] *
    x[cols[i, k]]`` with 1-8 right-hand sides: every ``ELL.mv``;
  * :func:`ell_block_spmv`, the velocity block over one shared column
    array, ``y[a] = A1 x[a] + sum_b R[a, b] x[b]`` for the d components
    of a vector field: what the reference composes from ``ELL.mv`` calls
    in its Newton and Picard velocity matvecs, here one pass that reads
    the columns once and each of the 1 + d*d value planes once.  Given
    each row's entry count (``row_len``, which the patterns of
    :mod:`.sparse` carry), it reads a row's own entries and none of the
    padding after them.

Both take the plain PyTorch version only for tensors on the CPU.  For a
CUDA tensor they launch the kernel or raise; nothing falls back.  A launch,
and only a launch, adds to ``launch.<entry point>.<dtype>`` of
:data:`..utils.timing.counts`.  The kernel library is built at first use
by :mod:`.kernels`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import kernels
from ..utils import timing

MAX_RHS = 8                       # kMaxRhs in csrc/ell_spmv.cu
MAX_DIM = 3                       # kMaxDim in csrc/ell_spmv.cu
_NAMES = {torch.float32: "f32", torch.float64: "f64"}

# C entry points: pointers and the stream are void*, sizes are ints
_ARGTYPES = {
    "ell_spmv": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p],
    "ell_block_spmv": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p],
}
_fns = {}


def _kernel(entry: str, name: str):
    """The C entry point ``<entry>_<name>`` with its argument types set."""
    if (entry, name) not in _fns:
        fn = getattr(kernels.load("ell_spmv"), f"{entry}_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[entry]
        _fns[entry, name] = fn
    return _fns[entry, name]


def ell_spmv_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                   n_cols: int) -> torch.Tensor:
    """Plain PyTorch ELL product: gather x at the columns, then a sum over
    the slots (the formula of ``fenapack_tpu.ops.sparse.ELL.mv``).  ``x``
    is (n_cols,) or (n_cols, k)."""
    g = torch.index_select(x, 0, cols.reshape(-1)).view(
        tuple(cols.shape) + tuple(x.shape[1:]))
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
    rc = _kernel("ell_spmv", name)(cols.data_ptr(), vals.data_ptr(),
                                   x.data_ptr(), y.data_ptr(), n_rows, K, k,
                                   stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv_{name} launch failed: CUDA error {rc}")
    timing.launched("ell_spmv", name)
    return y


def ell_block_spmv_plain(cols: torch.Tensor, A1: torch.Tensor,
                         R: Optional[torch.Tensor], x: torch.Tensor,
                         n_cols: int,
                         y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch block product, composed as the reference composes it:
    per component ``a`` the single product with ``A1``, then ``y0[a]``,
    then the products with ``R[a, 0]``, ``R[a, 1]``, ... added in turn."""
    d = x.shape[0]
    ys = [ell_spmv_plain(cols, A1, x[a], n_cols) for a in range(d)]
    if y0 is not None:
        ys = [ys[a] + y0[a] for a in range(d)]
    if R is not None:
        for a in range(d):
            for b in range(d):
                ys[a] = ys[a] + ell_spmv_plain(cols, R[a, b], x[b], n_cols)
    return torch.stack(ys)


# (version, smallest, largest, sum) of each row_len tensor read so far:
# read again only after the tensor is changed, so that a product on the
# card does not wait for the device to check lengths it has seen
_length_stats = WeakIdKeyDictionary()


def length_stats(row_len: torch.Tensor):
    """``(smallest, largest, sum)`` of a row-length tensor, read from the
    device once per version of the tensor."""
    seen = _length_stats.get(row_len)
    if seen is None or seen[0] != row_len._version:
        stats = ((0, 0, 0) if row_len.numel() == 0 else tuple(
            int(v) for v in torch.stack([row_len.min().long(),
                                         row_len.max().long(),
                                         row_len.sum()]).tolist()))
        seen = (row_len._version,) + stats
        _length_stats[row_len] = seen
    return seen[1:]


def _check_lengths(row_len, cols):
    if row_len.dtype != torch.int32:
        raise TypeError(f"row_len must be int32, got {row_len.dtype}")
    if row_len.device != cols.device:
        raise ValueError(f"row_len lies on {row_len.device}, cols on "
                         f"{cols.device}")
    if row_len.shape != cols.shape[:1] or not row_len.is_contiguous():
        raise ValueError(f"row_len must be a contiguous ({cols.shape[0]},) "
                         f"tensor, got {tuple(row_len.shape)}")
    lo, hi, _ = length_stats(row_len)
    if lo < 0 or hi > cols.shape[1]:
        raise ValueError(f"row lengths must lie in 0..{cols.shape[1]}, got "
                         f"{lo}..{hi}")


def _check_block(cols, A1, R, x, n_cols, y0):
    if cols.dim() != 2 or A1.shape != cols.shape:
        raise ValueError(f"expected cols and A1 of one (n_rows, K) shape, "
                         f"got {tuple(cols.shape)} and {tuple(A1.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if x.dim() != 2 or x.shape[1] != n_cols:
        raise ValueError(f"x must be (d, {n_cols}), got {tuple(x.shape)}")
    d = x.shape[0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"1 to {MAX_DIM} components, got {d}")
    if R is not None and R.shape != (d, d) + tuple(cols.shape):
        raise ValueError(f"R must be {(d, d) + tuple(cols.shape)}, got "
                         f"{tuple(R.shape)}")
    if y0 is not None and y0.shape != (d, cols.shape[0]):
        raise ValueError(f"y0 must be {(d, cols.shape[0])}, got "
                         f"{tuple(y0.shape)}")
    given = [t for t in (A1, R, x, y0) if t is not None]
    if A1.dtype not in _NAMES or any(t.dtype != A1.dtype for t in given):
        raise TypeError("A1, R, x and y0 must share float32 or float64, got "
                        + ", ".join(str(t.dtype) for t in given))
    if any(t.device != cols.device for t in given):
        raise ValueError("cols, A1, R, x and y0 lie on different devices: "
                         + ", ".join(str(t.device) for t in [cols] + given))
    if not all(t.is_contiguous() for t in [cols] + given):
        raise ValueError("cols, A1, R, x and y0 must be contiguous")


def ell_block_spmv(cols: torch.Tensor, A1: torch.Tensor,
                   R: Optional[torch.Tensor], x: torch.Tensor, n_cols: int,
                   y0: Optional[torch.Tensor] = None,
                   row_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y[a] = A1 x[a] + y0[a] + sum_b R[a, b] x[b]`` for ``a < d``.

    ``A1`` (n_rows, K) and the d*d planes of ``R`` (d, d, n_rows, K) share
    the column array ``cols``; ``x`` is (d, n_cols), the components of a
    vector field one after the other as in the state vector, and the result
    is (d, n_rows) in the same order.  ``R`` may be None (Picard: one pass
    over A1 serves every component), and so may ``y0`` (d, n_rows), a term
    added between A1's product and the reaction products.  d is 1 to
    MAX_DIM.  ``row_len`` (n_rows,) int32, each row's entry count in 0..K,
    says that the slots past it are padding (column 0, value 0), which the
    kernel then does not read; None means every row is K long.  CPU tensors
    take the plain version (padding adds zero: the lengths change nothing
    there); CUDA tensors launch the kernel."""
    _check_block(cols, A1, R, x, n_cols, y0)
    if row_len is not None:
        _check_lengths(row_len, cols)
    if x.device.type == "cpu":
        return ell_block_spmv_plain(cols, A1, R, x, n_cols, y0)
    if x.device.type != "cuda":
        raise ValueError(f"no ELL SpMV for device {x.device}")
    name = _NAMES[A1.dtype]
    (n_rows, K), d = cols.shape, x.shape[0]
    y = torch.empty((d, n_rows), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel("ell_block_spmv", name)(
        cols.data_ptr(), A1.data_ptr(), None if R is None else R.data_ptr(),
        x.data_ptr(), None if y0 is None else y0.data_ptr(), y.data_ptr(),
        None if row_len is None else row_len.data_ptr(), n_rows, K, n_cols,
        d, stream)
    if rc != 0:
        raise RuntimeError(f"ell_block_spmv_{name} launch failed: CUDA "
                           f"error {rc}")
    timing.launched("ell_block_spmv", name)
    return y
