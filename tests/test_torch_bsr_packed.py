"""The packed BSR layout (``ops/bsr_spmv.py``): each block row of 32 rows
stored as one slice of its rows' own entries.

On the step's level-1 patterns (RCM order, b = 32) the packed values,
densified, are the dense tiles of the layout before packing bit for bit,
and padding slots are never scattered; the plain packed product is the
dense ``bmm`` formula bit for bit on ragged random patterns; the BSR
counters count the slots a product streams; a pattern cache file of the
dense layout is never read as packed; the benchmark's SpMV scopes
(``pcdbench.trace.SpmvScopes``, which wrap ``ops.sparse.bsr_spmv`` and
count an operator without a pattern by ``count_nonzero(op.tiles)``) run
``BlockELL.mv`` and ``ComposedBlock.mv``.  On a CUDA GPU only: the kernel
against the plain version on those patterns and on the step l1 operators,
eagerly and replayed from a CUDA graph."""
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import bench, measure
from fenapack_tpu_torch.ops import bsr_spmv as K
from fenapack_tpu_torch.ops import sparse
from fenapack_tpu_torch.ops.sparse import (BlockSparsityPattern, SegmentSum,
                                           pattern_from_dofmaps)
from fenapack_tpu_torch.solvers import gmg
from fenapack_tpu_torch.utils import timing

NAMES = ["pat_p2", "pat_p1", "pat_div", "pat_divT", "transfer"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the BSR kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def step1():
    """``bench.build(1)`` on the CPU and the COO lists of its BSR
    transfers, ``(rows, cols, vals, n_rows, n_cols, block)`` each."""
    made = []
    orig = gmg._block_transfer

    def keep(rows, cols, vals, n_rows, n_cols, block, device):
        made.append((rows, cols, vals, n_rows, n_cols, block))
        return orig(rows, cols, vals, n_rows, n_cols, block, device)
    gmg._block_transfer = keep
    try:
        nl = bench.build(1, device="cpu")
    finally:
        gmg._block_transfer = orig
    return nl, made


def _pattern(step1, name):
    """``(pattern, entry values)``: seeded values, one per COO entry (the
    transfer's own weights)."""
    nl, made = step1
    if name == "transfer":
        rows, cols, vals, nr, nc, b = made[0]
        pat = BlockSparsityPattern(rows, cols, nr, nc, block=b,
                                   device="cpu")
        return pat, vals.double()
    pat = getattr(nl.asm, name)
    rng = np.random.default_rng(NAMES.index(name))
    return pat, torch.as_tensor(
        rng.standard_normal(pat._entry_pos_np.shape[0]))


def _dense_tiles(pat, elem):
    """The dense tiles (nb, b, m*b) of the layout before packing, summed as
    that layout's assembly summed them: each COO entry at
    ``tiles[I, i, j*b + c]``, ``nbr[I, j]`` its block column, the entries
    of a slot in entry order."""
    b, m = pat.block, pat.m
    u_of_pos = np.empty(pat.value_size, dtype=np.int64)
    u_of_pos[pat._upos] = np.arange(pat.nnz)
    u = u_of_pos[pat._entry_pos_np]
    rows, cols = pat._urow[u], pat._ucol[u]
    nbr = pat.neighbours.numpy()
    I = rows // b
    j = np.argmax(nbr[I] == (cols // b)[:, None], axis=1)
    pos = ((I * b + rows % b) * m + j) * b + cols % b
    return SegmentSum(pos, pat.nb * b * m * b, device="cpu")(elem).reshape(
        pat.nb, b, m * b)


@pytest.mark.parametrize("name", NAMES)
def test_packed_values_densified_are_the_dense_tiles(step1, name):
    pat, elem = _pattern(step1, name)
    vals = pat.assemble_values(elem)
    assert vals.shape == (pat.nb, pat.L, 32)
    ref = _dense_tiles(pat, elem)
    assert torch.equal(pat.dense_tiles(vals), ref)
    # padding slots are never scattered
    padded = torch.full((pat.value_size,), float("nan"), dtype=vals.dtype)
    padded[pat._upos] = vals.reshape(-1)[pat._upos]
    assert torch.equal(pat.dense_tiles(padded.reshape(vals.shape)), ref)
    # the positions of the dense layout, entry by entry and on the diagonal
    dpos = pat.dense_positions(pat._entry_pos_np)
    assert torch.equal(ref.reshape(-1)[dpos], vals.reshape(-1)[
        pat.entry_pos])
    if pat.diag_pos is not None:
        assert torch.equal(ref.reshape(-1)[pat.dense_positions(
            pat.diag_pos.numpy())], pat.matrix(vals).diag_from(pat.diag_pos))


def _ragged_pattern(seed, n_rows=203, n_cols=150):
    """A random pattern over n_rows (not a multiple of 32) with rows of
    1 to 30 entries, every seventh row and the rows 64-95 (a whole block
    row) empty."""
    rng = np.random.default_rng(seed)
    live = [r for r in range(n_rows) if r % 7 and not 64 <= r < 96]
    lens = rng.integers(1, 31, size=len(live))
    rows = np.repeat(live, lens)
    cols = rng.integers(0, n_cols, size=rows.shape[0])
    return BlockSparsityPattern(rows, cols, n_rows, n_cols, block=32,
                                device="cpu"), rows.shape[0], rng


def _bmm_formula(tiles, nbr, x, n_rows, n_cols):
    """The dense product of the layout before packing."""
    nb, b, mb = tiles.shape
    ncb = -(-n_cols // b) * b
    k = 1 if x.dim() == 1 else x.shape[1]
    xb = torch.zeros((ncb, k), dtype=x.dtype)
    xb[:n_cols] = x.reshape(n_cols, k)
    g = xb.reshape(ncb // b, b, k)[nbr.long()].reshape(nb, mb, k)
    y = torch.bmm(tiles, g).reshape(nb * b, k)[:n_rows]
    return y.reshape(n_rows) if x.dim() == 1 else y


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_packed_product_is_the_dense_formula(dtype, k):
    pat, n_entries, rng = _ragged_pattern(k)
    elem = torch.as_tensor(rng.standard_normal(n_entries), dtype=dtype)
    vals = pat.assemble_values(elem)
    shape = (pat.n_cols,) if k == 1 else (pat.n_cols, k)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    y = pat.matrix(vals).mv(x)
    ref = _bmm_formula(_dense_tiles(pat, elem), pat.neighbours, x,
                       pat.n_rows, pat.n_cols)
    assert torch.equal(y, ref)
    dense = pat.to_dense(vals)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - dense @ x).abs().max()) <= tol * float(
        (dense.abs() @ x.abs()).max())
    empty = [r for r in range(pat.n_rows) if not r % 7 or 64 <= r < 96]
    assert not y[empty].any()
    # the block row of empty rows takes no step; every other block row
    # as many as its longest row
    lens = np.bincount(pat._urow, minlength=pat.nb * 32).reshape(pat.nb, 32)
    assert torch.equal(K.steps(pat.nbr, pat.L, 32),
                       torch.as_tensor(lens.max(axis=1)))


@pytest.mark.parametrize("name", NAMES)
def test_bsr_slots_count_the_packed_slots(step1, name):
    pat, elem = _pattern(step1, name)
    lens = np.bincount(pat._urow, minlength=pat.nb * 32).reshape(pat.nb, 32)
    assert pat.slots == 32 * int(lens.max(axis=1).sum())
    assert pat.fill_ratio == pat.slots / pat.nnz
    # the main path's patterns stream at most 2.5 slots a nonzero, where
    # dense tiles held 15-27
    assert 1.0 <= pat.fill_ratio <= 2.5 < pat.tile_fill
    op = pat.matrix(pat.assemble_values(elem).float())
    c0 = measure.host_counts()
    op.mv(torch.ones(pat.n_cols))
    c1 = measure.host_counts()
    assert c1["bsr_slots"] - c0["bsr_slots"] == pat.slots
    assert c1["bsr_nnz"] - c0["bsr_nnz"] == pat.nnz
    assert c1["bsr_nnz_f32"] - c0["bsr_nnz_f32"] == pat.nnz


def _v2_file(path, pat):
    """A cache file of the layout before packing (dense-tile positions)."""
    b, m, nb = pat.block, pat.m, pat.nb
    np.savez(path, ukeys=pat._ukeys,
             upos=pat.dense_positions(pat._upos),
             entry_pos=pat.dense_positions(pat._entry_pos_np).astype(
                 np.int32),
             diag_pos=np.zeros(0, np.int32),
             nbr=pat.neighbours.numpy(),
             shape_meta=np.asarray([nb, m, b], dtype=np.int64))


def test_a_dense_layout_cache_file_is_not_read_as_packed(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("FENAPACK_CACHE", str(tmp_path))
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 150, size=(60, 3))
    cols = rng.integers(0, 90, size=(60, 6))
    fresh = pattern_from_dofmaps(rows, cols, 150, 90, block=32,
                                 device="cpu")
    (v3,) = tmp_path.glob("*.npz")
    # the dense layout's file under its own key (v2) is not the packed key
    hsh = hashlib.blake2b(digest_size=20)
    for part in (rows, cols):
        hsh.update(np.ascontiguousarray(part).tobytes())
    hsh.update(b"v2|150|90|32")
    v2 = tmp_path / (hsh.hexdigest() + ".npz")
    assert v2 != v3
    _v2_file(v2, fresh)
    # and a dense layout's file under the packed key is rebuilt, not read
    os.unlink(v3)
    _v2_file(v3, fresh)
    again = pattern_from_dofmaps(rows, cols, 150, 90, block=32,
                                 device="cpu")
    assert again.value_shape == fresh.value_shape
    assert torch.equal(again.nbr, fresh.nbr)
    np.testing.assert_array_equal(again._upos, fresh._upos)
    with np.load(v3) as z:
        assert list(z["shape_meta"]) == [fresh.nb, fresh.m, 32, fresh.L]


def test_the_benchmark_scopes_wrap_the_block_products(step1):
    """``SpmvScopes`` replaces ``ops.sparse.bsr_spmv`` by name: the single
    products, the composed velocity block and a transfer whose pattern is
    gone (counted by ``count_nonzero(op.tiles)``) run through it and give
    what they give without it."""
    from pcdbench.trace import SpmvScopes
    nl, _ = step1
    pat = nl.asm.pat_p2
    rng = np.random.default_rng(9)
    v = torch.as_tensor(rng.standard_normal(pat.value_shape)).float()
    v.reshape(-1)[np.setdiff1d(np.arange(pat.value_size), pat._upos)] = 0
    R = torch.as_tensor(rng.standard_normal((2, 2) + pat.value_shape),
                        dtype=torch.float32) * (v != 0)
    P = nl.oseen.velocity_hierarchy.transfers[0]._P
    x = torch.randn(pat.n_cols)
    X = torch.randn(2, pat.n_cols)
    xc = torch.randn(P.n_cols)
    run = lambda: (pat.matrix(v).mv(x), pat.block_matrix(v, R).mv(X),
                   pat.block_matrix(v).mv(X, X), P.mv(xc))
    off = run()
    with timing.tracing(), SpmvScopes() as scopes:
        assert sparse.bsr_spmv is not K.bsr_spmv
        on = run()
    assert sparse.bsr_spmv is K.bsr_spmv
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert scopes.calls["bsr"] == 1 + (2 + 4) + 2 + 1
    assert scopes.unknown == 0 and scopes.least_s > 0


# ---- on a CUDA GPU ------------------------------------------------------ #

def _graphed(fn):
    """A CUDA graph of ``fn()`` (warmed on a side stream) and its output."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    return g, out


def _check_kernel(idx, vals, n_rows, n_cols, dev, seed=0):
    """The kernel against the plain version at k = 1, 2, 8, eagerly and
    replayed from a graph with new x."""
    g = torch.Generator().manual_seed(seed)
    tol = 1e-5 if vals.dtype == torch.float32 else 1e-12
    for k in (1, 2, 8):
        shape = (n_cols,) if k == 1 else (n_cols, k)
        x = torch.randn(shape, generator=g, dtype=torch.float64).to(
            dev, vals.dtype)
        y = K.bsr_spmv(idx, vals, x, n_rows, n_cols)
        ref = K.bsr_spmv_plain(idx, vals, x, n_rows, n_cols)
        scale = max(float(ref.abs().max()), 1e-300)
        assert float((y - ref).abs().max()) <= tol * scale
        graph, out = _graphed(lambda: K.bsr_spmv(idx, vals, x, n_rows,
                                                 n_cols))
        x.copy_(torch.randn(shape, generator=g, dtype=torch.float64))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, K.bsr_spmv(idx, vals, x, n_rows, n_cols))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_on_the_step_patterns(cuda, step1, name,
                                                   dtype):
    pat, elem = _pattern(step1, name)
    vals = pat.assemble_values(elem).to(cuda, dtype)
    _check_kernel(pat.nbr.to(cuda), vals, pat.n_rows, pat.n_cols, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_ragged_patterns(cuda, dtype):
    for seed in range(3):
        pat, n_entries, rng = _ragged_pattern(seed)
        vals = pat.assemble_values(torch.as_tensor(
            rng.standard_normal(n_entries), dtype=dtype))
        _check_kernel(pat.nbr.to(cuda), vals.to(cuda), pat.n_rows,
                      pat.n_cols, cuda, seed)


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_step_l1_operators(cuda):
    """Every BSR operator of the main path at level 1, with the values it
    applies at the initial state (``bsr_ab.path_operators``)."""
    from fenapack_tpu_torch.bsr_ab import path_operators
    nl = bench.build(1, device=cuda)
    ops = path_operators(nl)
    assert len(ops) > 10
    for _, op in ops:
        _check_kernel(op.nbr, op.tiles, op.n_rows, op.n_cols, cuda)
