"""Block-sparse (BSR) SpMV: the CUDA kernel wrapper, its plain version and
the packed layout both read.

One hand-written kernel family (``csrc/bsr_spmv.cu``) replaces both Pallas
BSR kernels of ``fenapack_tpu/ops/pallas_spmv.py`` that the main path runs:
``bsr_spmv_f64`` the f64-accurate outer matvec (K1, ``DF32BlockSpMV``) and
``bsr_spmv_f32`` every f32 preconditioner product (K2, ``PallasBSRSpMV``).

**Layout: packed slices.**  The rows are grouped in block rows of ``b``
(at most 32) as in the JAX package's BSR layout, and block row I couples to
the block columns ``nbr[I, :m]``; but where that layout stores dense
``b x b`` tiles, this one stores each block row as one slice of ``L`` steps
by ``b`` lanes holding only the pattern's own entries:

  * ``vals`` (nb, L, b): ``vals[I, q, i]`` is the q-th entry of row
    ``I*b + i``, the entries of a row in the order (neighbour j, column c)
    of the dense tile row; ``L`` is the longest row, padding holds 0;
  * ``idx`` (nb, W) int32 (a pattern's and a ``BlockELL``'s ``nbr``),
    one row per block row: the neighbours
    ``idx[I, :m]``, then up to column ``S - 1`` (``S`` a multiple of
    :data:`ALIGN`) zeros, then the header ``idx[I, S - 1] = m << 16 |
    steps[I]`` (the block row's longest row: the steps the kernel reads),
    then from column ``S`` the 16-bit slot ids, two to a word, little-endian:
    slot (q, i) is half-word ``q*b + i``; a real slot's id is ``k = j*32 +
    c`` (column ``nbr[I, k >> 5]*b + (k & 31)``), a padding slot's
    :data:`NO_SLOT`.  ``W = S + ceil(L*b / 2)``.

:func:`pack_index` builds ``idx`` on the host, :func:`pack` packs dense
tiles, :func:`dense` gives the dense tiles back (the JAX package's layout:
every tile entry of the packed values, bit for bit).

:func:`bsr_spmv` takes the plain PyTorch version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; nothing falls back.  A
launch, and only a launch, adds to ``launch.bsr_spmv.<dtype>`` of
:data:`..utils.timing.counts`, so a run on the card can show that its main
path went through the kernels.

The kernel library is built at first use by :mod:`.kernels`.
"""
from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from . import kernels
from ..utils import timing

MAX_RHS = 8                       # kMaxRhs in csrc/bsr_spmv.cu
NO_SLOT = 0xFFFF                  # kNoSlot: a padding slot's id
ALIGN = 16                        # int32 words: slot ids on a 64 B boundary
MAX_BLOCK = 32                    # a block row's rows are a warp's lanes
_NAMES = {torch.float32: "f32", torch.float64: "f64"}

_fns = {}
# by id of a live index array: the neighbours and where each real slot
# lands in the dense tiles (the plain version's scatter, decoded once)
_scatter = {}


def _kernel(name: str):
    """The C entry point ``bsr_spmv_<name>`` with its argument types set."""
    if name not in _fns:
        fn = getattr(kernels.load("bsr_spmv"), "bsr_spmv_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def id_words(L: int, b: int) -> int:
    """The int32 words of one block row's slot ids."""
    return -(-L * b // 2)


def pack_index(nbr: np.ndarray, kid: np.ndarray) -> np.ndarray:
    """The index array ``idx`` (module docstring) from the neighbours
    ``nbr`` (nb, m) and the slot ids ``kid`` (nb, L, b), padding
    :data:`NO_SLOT`."""
    nb, m = nbr.shape
    _, L, b = kid.shape
    if m * 32 > NO_SLOT:
        raise ValueError(f"{m} neighbour blocks: the 16-bit slot ids hold "
                         f"at most {NO_SLOT // 32}")
    real = kid != NO_SLOT
    steps = np.where(real.any(axis=2),
                     np.arange(1, L + 1)[None, :], 0).max(axis=1,
                                                           initial=0)
    S = -(-(m + 1) // ALIGN) * ALIGN
    out = np.zeros((nb, S + id_words(L, b)), dtype=np.int32)
    out[:, :m] = nbr
    out[:, S - 1] = (m << 16) | steps
    ids = np.full((nb, 2 * id_words(L, b)), NO_SLOT, dtype="<u2")
    ids[:, :L * b] = kid.reshape(nb, L * b)
    out[:, S:] = ids.view("<i4")
    return out


def _header(idx: torch.Tensor, L: int, b: int) -> int:
    """``S``: the column of the first slot-id word."""
    return idx.shape[1] - id_words(L, b)


def steps(idx: torch.Tensor, L: int, b: int) -> torch.Tensor:
    """Each block row's steps (its longest row), (nb,) int64."""
    return idx[:, _header(idx, L, b) - 1].long() & 0xFFFF


def slots(idx, L: int, b: int) -> int:
    """The slots a product streams: ``b`` lanes for each step of each block
    row (padding of the shorter rows included)."""
    return b * int(steps(torch.as_tensor(idx), L, b).sum())


def unpack(idx: torch.Tensor, L: int, b: int):
    """``(nbr, kid)``: the neighbours (nb, m) and the slot ids (nb, L, b),
    both int64."""
    S = _header(idx, L, b)
    nb = idx.shape[0]
    m = int(idx[0, S - 1]) >> 16 if nb else 0
    w = idx[:, S:].long() & 0xFFFFFFFF
    kid = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(nb, -1)
    return idx[:, :m].long(), kid[:, :L * b].reshape(nb, L, b)


def scatter(idx: torch.Tensor, L: int, b: int):
    """``(nbr, src, dst)``: the neighbours, and for each real slot its flat
    position in the values and in the dense tiles (decoded once per index
    array)."""
    key = (L, b)
    got = _scatter.get(id(idx))
    if got is None or got[0] != key:
        if got is None:
            weakref.finalize(idx, _scatter.pop, id(idx), None)
        nbr, kid = unpack(idx, L, b)
        nb, m = nbr.shape
        real = (kid != NO_SLOT).reshape(-1)
        row = (torch.arange(nb, device=idx.device)[:, None, None] * b
               + torch.arange(b, device=idx.device)[None, None, :])
        pos = (row * (m * b) + (kid >> 5) * b + (kid & 31)).reshape(-1)
        src = torch.nonzero(real).reshape(-1)
        got = _scatter[id(idx)] = (key, nbr, src, pos[src])
    return got[1:]


def dense(idx: torch.Tensor, vals: torch.Tensor):
    """``(nbr, tiles)``: the int32 neighbours (nb, m) and the dense tiles
    (nb, b, m*b), ``tiles[I, i, j*b + c] = A[I*b + i, nbr[I, j]*b + c]``,
    with every real slot's value in its place (padding slots are never
    written) and zeros elsewhere."""
    nb, L, b = vals.shape
    nbr, src, dst = scatter(idx, L, b)
    m = nbr.shape[1]
    tiles = torch.zeros(nb * b * m * b, dtype=vals.dtype, device=vals.device)
    tiles[dst] = vals.reshape(-1)[src]
    return nbr.to(torch.int32), tiles.reshape(nb, b, m * b)


def pack(nbr: torch.Tensor, tiles: torch.Tensor):
    """``(idx, vals)``: dense tiles (nb, b, m*b) over the neighbours ``nbr``
    (nb, m) packed, their nonzero entries the packed slots (a zero entry
    adds nothing to a product).  On the tiles' device."""
    t = tiles.detach().cpu().numpy()
    nb, b, _ = t.shape
    I, i, kk = np.nonzero(t)
    row = I * b + i
    counts = np.bincount(row, minlength=nb * b)
    L = max(int(counts.max(initial=0)), 1)
    q = np.arange(row.shape[0]) - (np.cumsum(counts) - counts)[row]
    kid = np.full((nb, L, b), NO_SLOT, dtype=np.int64)
    kid[I, q, i] = (kk // b) * 32 + kk % b
    vals = np.zeros((nb, L, b), dtype=t.dtype)
    vals[I, q, i] = t[I, i, kk]
    idx = pack_index(nbr.detach().cpu().numpy(), kid)
    return (torch.as_tensor(idx, device=tiles.device),
            torch.as_tensor(vals, device=tiles.device))


def bsr_spmv_plain(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
                   n_rows: int, n_cols: int) -> torch.Tensor:
    """Plain PyTorch BSR product: the dense tiles (:func:`dense`), the
    neighbour blocks of x gathered, then one batched (b, m*b) @ (m*b, k)
    product per block row (the formula of
    ``fenapack_tpu.ops.sparse.BlockELL.mv``).  ``x`` is (n_cols,) or
    (n_cols, k)."""
    nbr, tiles = dense(idx, vals)
    nb, b, mb = tiles.shape
    ncb = -(-n_cols // b) * b
    k = 1 if x.dim() == 1 else x.shape[1]
    xb = torch.zeros((ncb, k), dtype=x.dtype, device=x.device)
    xb[:n_cols] = x.reshape(n_cols, k)
    g = xb.reshape(ncb // b, b, k)[nbr.long()].reshape(nb, mb, k)
    y = torch.bmm(tiles, g).reshape(nb * b, k)[:n_rows]
    return y.reshape(n_rows) if x.dim() == 1 else y


def _check(idx, vals, x, n_rows, n_cols):
    if vals.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"expected idx (nb, W) and vals (nb, L, b), got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    nb, L, b = vals.shape
    S = idx.shape[1] - id_words(L, b)
    if not 0 < b <= MAX_BLOCK:
        raise ValueError(f"block {b}: the kernel takes 1 to {MAX_BLOCK}")
    if idx.shape[0] != nb or S < ALIGN or S % ALIGN:
        raise ValueError(f"idx {tuple(idx.shape)} does not match vals "
                         f"{tuple(vals.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if vals.dtype not in _NAMES or x.dtype != vals.dtype:
        raise TypeError(f"vals and x must share float32 or float64, got "
                        f"{vals.dtype} and {x.dtype}")
    if x.dim() not in (1, 2) or x.shape[0] != n_cols:
        raise ValueError(f"x must be ({n_cols},) or ({n_cols}, k), got "
                         f"{tuple(x.shape)}")
    if not 0 <= n_rows <= nb * b:
        raise ValueError(f"n_rows={n_rows} exceeds the {nb * b} block rows' "
                         f"rows")
    if not (idx.device == vals.device == x.device):
        raise ValueError(f"idx, vals and x lie on different devices: "
                         f"{idx.device}, {vals.device}, {x.device}")


def bsr_spmv(idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             n_rows: int, n_cols: int) -> torch.Tensor:
    """y = A @ x for the packed BSR matrix (idx, vals) of shape (n_rows,
    n_cols).

    ``x`` is (n_cols,) or (n_cols, k) with k <= MAX_RHS; one pass over the
    slices serves all k right-hand sides.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (float32: K2, float64: K1)."""
    _check(idx, vals, x, n_rows, n_cols)
    if x.device.type == "cpu":
        return bsr_spmv_plain(idx, vals, x, n_rows, n_cols)
    if x.device.type != "cuda":
        raise ValueError(f"no BSR SpMV for device {x.device}")
    k = 1 if x.dim() == 1 else x.shape[1]
    if k > MAX_RHS:
        raise ValueError(f"at most {MAX_RHS} right-hand sides, got {k}")
    if not (idx.is_contiguous() and vals.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("idx, vals and x must be contiguous")
    name = _NAMES[vals.dtype]
    fn = _kernel(name)
    y = torch.empty((n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    _, L, b = vals.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(idx.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            b, L, idx.shape[1], n_rows, n_cols, k, stream)
    if rc != 0:
        raise RuntimeError(f"bsr_spmv_{name} launch failed: CUDA error {rc}")
    timing.launched("bsr_spmv", name)
    return y
