"""Static-sparsity operators on tensors (``fenapack_tpu/ops/sparse.py``).

The sparsity of every FEM operator is fixed by the mesh, so layouts are
built once on the host (NumPy); assembling new values is one sum of scattered
element values in a fixed order (:class:`SegmentSum`, the same bits on every
run and on every device).  Two layouts share one interface
(``pattern.matrix(vals) -> op`` with ``op.mv/with_vals/diag_from``):

  * :class:`SparsityPattern` / :class:`ELL`: per-row padded column lists
    (int32, the JAX package's layout).  Its product is the ELL SpMV kernel
    of :mod:`fenapack_tpu_torch.ops.ell_spmv` (K3).  :class:`ELLBlock`
    (``pattern.block_matrix(A1vals, Rvals)``) is the velocity block of d
    components whose operators share the pattern, applied in one pass by
    the same module's block product, which reads each row's own entries
    only (the pattern's ``row_len``).
  * :class:`BlockSparsityPattern` / :class:`BlockELL`: block-sparse rows
    (BSR) of dense ``b x b`` tiles stored flat,
    ``tiles[I, i, j*b + c] = A[I*b + i, nbr[I, j]*b + c]``.  Its product is
    the BSR SpMV kernel of :mod:`fenapack_tpu_torch.ops.bsr_spmv` (K1, K2).

On a CUDA tensor both products launch their hand-written kernel; on a CPU
tensor they run the kernel's plain PyTorch version.

Patterns are memoized on disk in the JAX package's format (``.npz`` keyed by
a hash of the dofmaps), by default under ``build/patterns`` at the root of
the checkout; ``FENAPACK_CACHE`` relocates the cache, and an empty value
turns it off.
"""
from __future__ import annotations

import hashlib
import os
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

from .bsr_spmv import bsr_spmv
from .ell_spmv import ell_block_spmv, ell_spmv
from ..utils.timing import bsr_read, span


class SegmentSum:
    """Scattered values summed in a fixed order: ``out[t] = base[t] +
    src[i_1] + src[i_2] + ...`` over the entries ``i_1 < i_2 < ...`` with
    ``index[i] == t``, added left to right.

    That is the order in which ``index_add_`` adds on the CPU, so the result
    is bit for bit ``base.clone().index_add_(0, index, src)`` there.  On
    CUDA, ``index_add_`` adds duplicates with atomics in no fixed order, and
    assembled values could differ in the last bits from one run to the
    next; this sum takes the same order on every device.  Targets are
    ordered by their number of entries, largest first, so the k-th entries
    of all targets that have one are a prefix: a sum is ``max`` gathers and
    in-place adds into that prefix, and one copy to the targets.  The host
    tables hold one index per entry and none for padding.
    """

    def __init__(self, index: np.ndarray, size: int, *, device):
        index = np.asarray(index, dtype=np.int64).ravel()
        self.size = int(size)
        counts = np.bincount(index, minlength=self.size)
        order = np.argsort(index, kind="stable")
        start = np.cumsum(counts) - counts
        targets = np.flatnonzero(counts)
        targets = targets[np.argsort(-counts[targets], kind="stable")]
        mult = counts[targets]
        # lengths[k]: targets with more than k entries (a prefix)
        hist = np.bincount(mult, minlength=int(mult.max(initial=0)) + 1)
        self.lengths = [int(n) for n in
                        (mult.shape[0] - np.cumsum(hist))[:-1]]
        idx = np.concatenate(
            [order[start[targets[:n]] + k] for k, n in enumerate(self.lengths)]
            or [np.zeros(0, np.int64)])
        self.targets = torch.as_tensor(targets, device=device)
        self.idx = torch.as_tensor(idx.astype(np.int32), device=device)

    def __call__(self, src: torch.Tensor,
                 base: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sums over the flat ``src``, added to the flat ``base`` (of
        ``size`` values) or to zeros."""
        src = src.reshape(-1)
        if base is None:
            acc = torch.zeros(self.targets.shape[0], dtype=src.dtype,
                              device=src.device)
            out = torch.zeros(self.size, dtype=src.dtype, device=src.device)
        else:
            acc = base.index_select(0, self.targets)
            out = base.clone()
        pos = 0
        for n in self.lengths:
            acc[:n].add_(src.index_select(0, self.idx[pos:pos + n]))
            pos += n
        return out.index_copy_(0, self.targets, acc)


class ELL:
    """ELL sparse matrix: ``cols`` (n_rows, K) int32, ``vals`` same shape.
    Padded slots have ``col = 0`` and ``val = 0``; they follow a row's own
    entries, of which ``row_len`` (n_rows,) int32 holds the count when the
    pattern is known (None: every row is K long)."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, n_cols: int,
                 row_len: Optional[torch.Tensor] = None):
        self.cols, self.vals, self.n_cols = cols, vals, n_cols
        self.row_len = row_len

    @property
    def shape(self):
        return (self.cols.shape[0], self.n_cols)

    def with_vals(self, vals: torch.Tensor) -> "ELL":
        return ELL(self.cols, vals, self.n_cols, self.row_len)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape (n_cols,) or (n_cols, k)."""
        with span("spmv.ell"):
            return ell_spmv(self.cols, self.vals, x.contiguous(),
                            self.n_cols)

    def row_sums(self) -> torch.Tensor:
        return torch.sum(self.vals, dim=1)

    def diag_from(self, diag_pos: torch.Tensor) -> torch.Tensor:
        return self.vals.reshape(-1)[diag_pos]


class ELLBlock:
    """The velocity block over one ELL pattern: ``A1`` (n_rows, K) on every
    component's diagonal plus, when given, the reaction blocks ``R``
    (d, d, n_rows, K), all over the column array ``cols`` whose rows hold
    ``row_len`` entries each (None: K)."""

    def __init__(self, cols: torch.Tensor, A1: torch.Tensor,
                 R: Optional[torch.Tensor], n_cols: int,
                 row_len: Optional[torch.Tensor] = None):
        self.cols, self.A1, self.R, self.n_cols = cols, A1, R, n_cols
        self.row_len = row_len

    def mv(self, x: torch.Tensor,
           y0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``y[a] = A1 x[a] + y0[a] + sum_b R[a, b] x[b]`` for x of shape
        (d, n_cols): (d, n_rows), the components in the order of x."""
        with span("spmv.ell_block"):
            return ell_block_spmv(self.cols, self.A1, self.R, x,
                                  self.n_cols, y0, row_len=self.row_len)


class BlockELL:
    """Block-sparse-row matrix: block row I couples to block columns
    ``nbr[I, :]`` (padding slots repeat a valid block and hold zero tiles);
    ``tiles`` is (nb, b, m*b) in the flat layout of the module docstring.
    ``nnz``: the operator's own nonzeros where its pattern is known (the
    tracing counters' ``bsr_nnz``); None: the product is not counted."""

    def __init__(self, nbr: torch.Tensor, tiles: torch.Tensor, n_rows: int,
                 n_cols: int, nnz: Optional[int] = None):
        self.nbr, self.tiles = nbr, tiles
        self.n_rows, self.n_cols = n_rows, n_cols
        self.nnz = nnz

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def vals(self):
        return self.tiles

    def with_vals(self, vals: torch.Tensor) -> "BlockELL":
        return BlockELL(self.nbr, vals, self.n_rows, self.n_cols, self.nnz)

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape (n_cols,) or (n_cols, k)."""
        with span("spmv.bsr"):
            if self.nnz is not None:
                bsr_read(self.tiles.numel(), self.nnz)
            return bsr_spmv(self.nbr, self.tiles, x.contiguous(),
                            self.n_rows, self.n_cols)

    def row_sums(self) -> torch.Tensor:
        return torch.sum(self.tiles, dim=2).reshape(-1)[:self.n_rows]

    def diag_from(self, diag_pos: torch.Tensor) -> torch.Tensor:
        return self.tiles.reshape(-1)[diag_pos]


class SparsityPattern:
    """Host-side scatter layout of one (test space x trial space) operator.

    Built once from the COO entry list of the cell dofmaps; provides
    ``entry_pos`` (flat value position of every COO entry; assembly sums
    the element values at these positions in entry order, as
    ``zeros(size).index_add_(0, entry_pos, element_values)`` does on the
    CPU: :class:`SegmentSum`), ``matrix`` and, for square operators,
    ``diag_pos``.  Index tensors live on ``device``.
    """

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n_rows: int,
                 n_cols: int, *, device):
        from ..native import unique_i64
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        uniq, inverse = unique_i64(rows * n_cols + cols)
        self.device = torch.device(device)
        self.n_rows, self.n_cols = n_rows, n_cols
        self.nnz = uniq.shape[0]
        self._ukeys = uniq
        self._urow, self._ucol = uniq // n_cols, uniq % n_cols
        self._layout(self._urow, self._ucol)
        entry_pos = self._upos[inverse]
        diag_pos = None
        if n_rows == n_cols:
            dmask = self._urow == self._ucol
            diag_pos = np.zeros(n_rows, dtype=np.int64)
            diag_pos[self._urow[dmask]] = self._upos[dmask]
        self._set_positions(entry_pos, diag_pos)

    def _set_positions(self, entry_pos, diag_pos):
        self._entry_pos_np = np.asarray(entry_pos, dtype=np.int32)
        self.diag_pos = (None if diag_pos is None else torch.as_tensor(
            np.asarray(diag_pos), dtype=torch.int64, device=self.device))
        self._sum = SegmentSum(self._entry_pos_np, self.value_size,
                               device=self.device)

    @property
    def entry_pos(self) -> torch.Tensor:
        """The flat value position of every COO entry (int64, on the
        pattern's device); assembly reads the sum tables instead."""
        return torch.as_tensor(self._entry_pos_np, dtype=torch.int64,
                               device=self.device)

    def _layout(self, urow, ucol):
        counts = np.bincount(urow, minlength=self.n_rows)
        K = int(counts.max()) if counts.size else 1
        row_start = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(urow.shape[0]) - row_start[urow]
        self._upos = urow * K + slot
        self.K = K
        self.value_shape = (self.n_rows, K)
        ell_cols = np.zeros((self.n_rows, K), dtype=np.int32)
        ell_cols.reshape(-1)[self._upos] = ucol
        self._set_cols(ell_cols, counts)

    def _set_cols(self, ell_cols, counts):
        """The column array and ``row_len``, each row's entry count (its
        slots past that hold column 0 and, once assembled, value 0)."""
        self._ell_cols_np = ell_cols
        self.cols = torch.as_tensor(ell_cols, dtype=torch.int32,
                                    device=self.device)
        self.row_len = torch.as_tensor(counts.astype(np.int32),
                                       device=self.device)

    @property
    def value_size(self) -> int:
        return int(np.prod(self.value_shape))

    def matrix(self, vals: torch.Tensor):
        return ELL(self.cols, vals, self.n_cols, self.row_len)

    def block_matrix(self, A1vals: torch.Tensor,
                     Rvals: Optional[torch.Tensor] = None):
        """The velocity block ``A1`` per component plus the reaction blocks
        ``Rvals`` (d, d, n_rows, K) or None, all over this pattern."""
        return ELLBlock(self.cols, A1vals, Rvals, self.n_cols, self.row_len)

    def assemble_values(self, element_values: torch.Tensor) -> torch.Tensor:
        """Sum flat element-tensor values into a value array, each slot's
        entries in entry order (:class:`SegmentSum`): the same bits on
        every run and device."""
        return self._sum(element_values).reshape(self.value_shape)

    def assemble(self, element_values: torch.Tensor):
        return self.matrix(self.assemble_values(element_values))

    def entry_positions(self, test_dofs: np.ndarray, trial_dofs: np.ndarray
                        ) -> np.ndarray:
        """Flat value positions for extra COO entries (facet terms) whose
        (row, col) pairs are already in the pattern.  ``test_dofs`` (nf, a),
        ``trial_dofs`` (nf, b) -> positions (nf*a*b,) matching element
        values (nf, a, b) raveled C-style."""
        from ..native import searchsorted_i64
        a, b = test_dofs.shape[1], trial_dofs.shape[1]
        rows = np.repeat(np.asarray(test_dofs, dtype=np.int64), b,
                         axis=1).ravel()
        cols = np.tile(np.asarray(trial_dofs, dtype=np.int64), (1, a)).ravel()
        keys = rows * self.n_cols + cols
        idx, hits = searchsorted_i64(self._ukeys, keys)
        if hits != keys.shape[0]:
            raise ValueError("facet entries not contained in the pattern")
        return self._upos[idx]

    def to_dense(self, vals: torch.Tensor) -> torch.Tensor:
        """Dense (n_rows, n_cols) matrix from a value array.  Only the
        pattern's own entries are written: the layout's padding slots (which
        hold zeros) are never scattered, so no index falls out of bounds."""
        if not hasattr(self, "_dense_idx"):
            self._dense_idx = (
                torch.as_tensor(self._urow * self.n_cols + self._ucol,
                                device=self.device),
                torch.as_tensor(self._upos, dtype=torch.int64,
                                device=self.device))
        dense_pos, upos = self._dense_idx
        dense = torch.zeros(self.n_rows * self.n_cols, dtype=vals.dtype,
                            device=vals.device)
        dense[dense_pos] = vals.reshape(-1)[upos]
        return dense.reshape(self.n_rows, self.n_cols)

    # ---- disk memoization (pattern_from_dofmaps), JAX package format ---- #
    def _to_cache(self) -> dict:
        return dict(ukeys=self._ukeys, upos=self._upos,
                    entry_pos=self._entry_pos_np,
                    diag_pos=(self.diag_pos.cpu().numpy().astype(np.int32)
                              if self.diag_pos is not None
                              else np.zeros(0, np.int32)),
                    **self._layout_cache())

    def _layout_cache(self) -> dict:
        return dict(ell_cols=self._ell_cols_np, K=np.int64(self.K))

    @classmethod
    def _from_cache(cls, d: dict, n_rows: int, n_cols: int, block, device):
        self = object.__new__(cls)
        self.device = torch.device(device)
        self.n_rows, self.n_cols = n_rows, n_cols
        self._ukeys = d["ukeys"]
        self._urow, self._ucol = self._ukeys // n_cols, self._ukeys % n_cols
        self.nnz = self._ukeys.shape[0]
        self._upos = d["upos"]
        self._restore_layout(d, block)
        self._set_positions(d["entry_pos"],
                            d["diag_pos"] if d["diag_pos"].size else None)
        return self

    def _restore_layout(self, d, block):
        self.K = int(d["K"])
        self.value_shape = (self.n_rows, self.K)
        # the row lengths are not stored: they are the entries per row
        self._set_cols(d["ell_cols"],
                       np.bincount(self._urow, minlength=self.n_rows))


class BlockSparsityPattern(SparsityPattern):
    """Block-sparse-row layout with tile size ``block`` (rows and columns
    grouped in blocks of ``b``; the two spaces may differ in size)."""

    def __init__(self, rows, cols, n_rows, n_cols, block: int = 32, *,
                 device):
        self.block = int(block)
        super().__init__(rows, cols, n_rows, n_cols, device=device)

    def _layout(self, urow, ucol):
        from ..native import unique_i64
        b = self.block
        nb = -(-self.n_rows // b)
        ncb = -(-self.n_cols // b)
        upairs, pinv = unique_i64((urow // b) * ncb + ucol // b)
        pbr, pbc = upairs // ncb, upairs % ncb
        counts = np.bincount(pbr, minlength=nb)
        m = int(counts.max()) if counts.size else 1
        row_start = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(upairs.shape[0]) - row_start[pbr]
        tile_of_pair = pbr * m + slot
        nbr = np.zeros((nb, m), dtype=np.int32)
        nbr.reshape(-1)[tile_of_pair] = pbc
        # padding slots repeat the row's first neighbour (their tiles are 0)
        filled = np.zeros((nb, m), dtype=bool)
        filled.reshape(-1)[tile_of_pair] = True
        first = np.where(counts > 0, nbr[:, 0], 0)
        nbr = np.where(filled, nbr, first[:, None]).astype(np.int32)
        tid = tile_of_pair[pinv]
        self._upos = (((tid // m) * b + urow % b) * (m * b)
                      + (tid % m) * b + ucol % b)
        self._set_block_layout(nb, m, nbr)

    def _set_block_layout(self, nb, m, nbr):
        b = self.block
        self.nb, self.m = nb, m
        self.value_shape = (nb, b, m * b)
        self._nbr_np = nbr
        self.nbr = torch.as_tensor(nbr, dtype=torch.int32, device=self.device)
        self.fill_ratio = float(nb * m * b * b) / max(self.nnz, 1)

    def matrix(self, vals: torch.Tensor):
        return BlockELL(self.nbr, vals, self.n_rows, self.n_cols, self.nnz)

    def block_matrix(self, A1vals, Rvals=None):
        raise NotImplementedError(
            "the one-pass velocity block exists for the ELL layout only")

    def _layout_cache(self) -> dict:
        return dict(nbr=self._nbr_np, shape_meta=np.asarray(
            [self.nb, self.m, self.block], dtype=np.int64))

    def _restore_layout(self, d, block):
        self.block = int(block)
        nb, m, b = (int(v) for v in d["shape_meta"])
        if b != self.block:
            raise ValueError(f"cached pattern has block {b}, not {block}")
        self._set_block_layout(nb, m, d["nbr"])


def _pattern_cache_dir() -> Optional[str]:
    d = os.environ.get("FENAPACK_CACHE")
    if d == "":
        return None
    return d or os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "build", "patterns")


def pattern_from_dofmaps(test_dofs: np.ndarray, trial_dofs: np.ndarray,
                         n_rows: int, n_cols: int,
                         block: Optional[int] = None, *, device
                         ) -> SparsityPattern:
    """Pattern of sum_cells outer(test_dofs[c], trial_dofs[c]).

    ``test_dofs`` (nc, a), ``trial_dofs`` (nc, b); entry order matches
    element values of shape (nc, a, b) raveled C-style.  ``block`` selects
    the block-sparse layout (tile size).  Memoized on disk (module
    docstring)."""
    a, b = test_dofs.shape[1], trial_dofs.shape[1]
    cls = BlockSparsityPattern if block else SparsityPattern
    cache_dir = _pattern_cache_dir()
    path = None
    if cache_dir is not None:
        hsh = hashlib.blake2b(digest_size=20)
        for part in (test_dofs, trial_dofs):
            hsh.update(np.ascontiguousarray(part).tobytes())
        hsh.update(f"v2|{n_rows}|{n_cols}|{block}".encode())
        path = os.path.join(cache_dir, hsh.hexdigest() + ".npz")
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    data = {k: z[k] for k in z.files}
                return cls._from_cache(data, n_rows, n_cols, block, device)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                pass                    # corrupt or stale: rebuild

    rows = np.repeat(test_dofs, b, axis=1)
    cols = np.tile(trial_dofs, (1, a))
    if block:
        pat = BlockSparsityPattern(rows, cols, n_rows, n_cols, block=block,
                                   device=device)
    else:
        pat = SparsityPattern(rows, cols, n_rows, n_cols, device=device)
    if path is not None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            # one temporary file per writer: thread ranks of one process
            # may build the same pattern at once
            tmp = path + f".tmp{os.getpid()}-{threading.get_ident()}.npz"
            np.savez(tmp, **pat._to_cache())
            os.replace(tmp, path)
        except OSError:
            pass
    return pat
