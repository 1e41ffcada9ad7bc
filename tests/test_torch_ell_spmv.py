"""ELL SpMV (kernel K3): the plain PyTorch versions of the single product
and of the velocity-block product against the JAX package's Pallas ELL
kernel run as its own tests run it (``PallasSpMV`` in interpret mode) and
against its ``ELL.mv`` with two right-hand sides, the wrappers' checks,
and, on a CUDA GPU only, the hand-written kernels against their plain
versions.

Tolerances (max |y - y_ref| / max |y_ref|): float32 1e-5, float64 1e-12;
the two sides sum in different orders."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import interop
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.dofmap import TaylorHood
from fenapack_tpu_torch.ops import ell_spmv as K
from fenapack_tpu_torch.ops.sparse import ELL, ELLBlock, SparsityPattern, \
    pattern_from_dofmaps

TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}
# the cavity's four ELL patterns at level 1: (test dofs, trial dofs)
CAVITY_PATTERNS = {"p2": ("V", "V"), "p1": ("Q", "Q"), "div": ("Q", "V"),
                   "divT": ("V", "Q")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the ELL kernel has no CPU mode")
    return torch.device("cuda")


def _relerr(y, ref):
    y, ref = np.asarray(y, dtype=np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


def _random_pattern():
    """The random n = 513 pattern of ``tests/test_pallas_spmv.py``."""
    rng = np.random.default_rng(0)
    n, nnz = 513, 5000
    return rng, rng.integers(0, n, nnz), rng.integers(0, n, nnz), n


def _jax_pallas(jell, x):
    from fenapack_tpu.ops.pallas_spmv import PallasSpMV
    return np.asarray(PallasSpMV(jell, tile_r=64, interpret=True)(x))


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_plain_matches_jax_pallas_kernel_random(np_dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.ops.sparse import SparsityPattern as JPattern
    rng, rows, cols, n = _random_pattern()
    vals = rng.standard_normal(rows.shape[0]).astype(np_dtype)
    x = rng.standard_normal(n).astype(np_dtype)
    jell = JPattern(rows, cols, n, n).assemble(jnp.asarray(vals))
    pat = SparsityPattern(rows, cols, n, n, device="cpu")
    ell = pat.assemble(torch.as_tensor(vals))
    assert ell.cols.dtype == torch.int32
    np.testing.assert_array_equal(ell.cols.numpy(), np.asarray(jell.cols))
    y = ell.mv(torch.as_tensor(x))
    assert y.dtype == DTYPES[np_dtype] and y.shape == (n,)
    assert _relerr(y.numpy(), _jax_pallas(jell, jnp.asarray(x))) <= \
        TOL[np_dtype]


def _cavity_pair(name, np_dtype, seed):
    """(port ELL, JAX ELL, rng) of one level-1 cavity pattern, carried from
    the JAX side by ``interop`` with random values."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.ops.sparse import pattern_from_dofmaps as jpattern
    W = TaylorHood(tmesh.cavity_mesh(1))
    test, trial = (getattr(W, s) for s in CAVITY_PATTERNS[name])
    args = (test.cell_dofs, trial.cell_dofs, test.dim, trial.dim)
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((test.cell_dofs.shape[0],
                                test.cell_dofs.shape[1],
                                trial.cell_dofs.shape[1])).astype(np_dtype)
    jell = jpattern(*args).assemble(jnp.asarray(vals))
    port = interop.operator({"cols": np.asarray(jell.cols),
                             "vals": np.asarray(jell.vals),
                             "n_cols": jell.n_cols}, device="cpu")
    # the port's own pattern and assembly give the same operator
    own = pattern_from_dofmaps(*args, device="cpu").assemble(
        torch.as_tensor(vals))
    assert torch.equal(own.cols, port.cols)
    assert _relerr(own.vals.numpy(), port.vals.numpy()) <= TOL[np_dtype]
    return port, jell, rng


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(CAVITY_PATTERNS))
def test_plain_matches_jax_pallas_kernel_cavity(name, np_dtype):
    import jax.numpy as jnp
    port, jell, rng = _cavity_pair(name, np_dtype, seed=1)
    x = rng.standard_normal(port.n_cols).astype(np_dtype)
    y = port.mv(torch.as_tensor(x))
    assert y.shape == (port.shape[0],)
    assert _relerr(y.numpy(), _jax_pallas(jell, jnp.asarray(x))) <= \
        TOL[np_dtype]


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_two_rhs_match_jax_ell(np_dtype):
    import jax.numpy as jnp
    port, jell, rng = _cavity_pair("p2", np_dtype, seed=2)
    X = rng.standard_normal((port.n_cols, 2)).astype(np_dtype)
    Y = port.mv(torch.as_tensor(X))
    assert Y.shape == (port.shape[0], 2)
    assert _relerr(Y.numpy(), np.asarray(jell.mv(jnp.asarray(X)))) <= \
        TOL[np_dtype]
    for j in range(2):
        yj = port.mv(torch.as_tensor(np.ascontiguousarray(X[:, j])))
        assert _relerr(Y[:, j].numpy(), yj.numpy()) <= TOL[np_dtype]


def _random_ell(dtype, device, n=300, K=7, n_cols=211, seed=1):
    g = torch.Generator().manual_seed(seed)
    cols = torch.randint(0, n_cols, (n, K), generator=g, dtype=torch.int32)
    vals = torch.randn(n, K, generator=g, dtype=dtype)
    return cols.to(device), vals.to(device), n_cols


def test_plain_version_of_a_dense_matrix():
    """The plain version against a dense product built from the layout's
    definition; repeated columns in a row add up like any other slot."""
    cols, vals, nc = _random_ell(torch.float64, "cpu", n=40, K=5, n_cols=9)
    A = torch.zeros(40, nc, dtype=torch.float64)
    for i in range(40):
        for k in range(5):
            A[i, int(cols[i, k])] += vals[i, k]
    x = torch.randn(nc, dtype=torch.float64)
    torch.testing.assert_close(K.ell_spmv_plain(cols, vals, x, nc), A @ x,
                               rtol=0, atol=1e-12)


def test_wrapper_rejects_bad_arguments():
    cols, vals, nc = _random_ell(torch.float64, "cpu")
    x = torch.zeros(nc, dtype=torch.float64)
    with pytest.raises(ValueError):
        K.ell_spmv(cols, vals, x[:-1], nc)                 # wrong length
    with pytest.raises(ValueError):
        K.ell_spmv(cols, vals, torch.zeros(nc, 2, 2,
                                           dtype=torch.float64), nc)
    with pytest.raises(ValueError):
        K.ell_spmv(cols[:, :-1], vals, x, nc)              # cols vs vals
    with pytest.raises(TypeError):
        K.ell_spmv(cols, vals, x.float(), nc)              # dtype mismatch
    with pytest.raises(TypeError):
        K.ell_spmv(cols.long(), vals, x, nc)               # int64 cols
    with pytest.raises(TypeError):
        K.ell_spmv(cols, vals.half(), x.half(), nc)        # no f16 kernel
    with pytest.raises(ValueError):
        K.ell_spmv(cols, vals, x.to("meta"), nc)           # device mismatch
    with pytest.raises(ValueError):
        K.ell_spmv(cols.to("meta"), vals.to("meta"), x.to("meta"), nc)


def test_cpu_tensors_take_the_plain_version_without_counting():
    cols, vals, nc = _random_ell(torch.float32, "cpu")
    x = torch.randn(nc, 3, dtype=torch.float32)
    before = dict(K.launches)
    y = ELL(cols, vals, nc).mv(x)
    assert K.launches == before
    torch.testing.assert_close(y, K.ell_spmv_plain(cols, vals, x, nc),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("nrhs", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain(cuda, dtype, nrhs):
    cols, vals, nc = _random_ell(dtype, cuda, n=1031, K=19, n_cols=517)
    shape = (nc,) if nrhs == 1 else (nc, nrhs)
    x = torch.randn(shape, dtype=dtype, device=cuda)
    name = "f32" if dtype == torch.float32 else "f64"
    before = dict(K.launches)
    y = K.ell_spmv(cols, vals, x, nc)
    torch.cuda.synchronize()
    assert K.launches[name] == before[name] + 1
    ref = K.ell_spmv_plain(cols, vals, x, nc)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) <= tol
    if nrhs > 1:
        # one pass over the matrix serves every column, in the same order
        for j in range(nrhs):
            yj = K.ell_spmv(cols, vals, x[:, j].contiguous(), nc)
            assert torch.equal(y[:, j], yj)


@pytest.mark.gpu
def test_ell_mv_on_cuda_launches_the_kernel(cuda):
    W = TaylorHood(tmesh.cavity_mesh(1))
    cd = W.V.cell_dofs
    rng = np.random.default_rng(3)
    port = pattern_from_dofmaps(cd, cd, W.n2, W.n2, device="cpu").assemble(
        torch.as_tensor(rng.standard_normal((cd.shape[0], 6, 6))))
    ell = ELL(port.cols.to(cuda), port.vals.to(cuda), port.n_cols)
    x = rng.standard_normal(port.n_cols)
    K.reset_launches()
    y = ell.mv(torch.as_tensor(x, device=cuda))
    torch.cuda.synchronize()
    assert K.launches == {"f32": 0, "f64": 1}
    ref = port.mv(torch.as_tensor(x))
    assert _relerr(y.cpu().numpy(), ref.numpy()) <= 1e-12


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    cols, vals, nc = _random_ell(torch.float32, cuda)
    x = torch.randn(nc, 2, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        K.ell_spmv(cols, vals, x.t().contiguous().t(), nc)
    with pytest.raises(ValueError):
        K.ell_spmv(cols, vals, torch.randn(nc, K.MAX_RHS + 1, device=cuda),
                   nc)
    with pytest.raises(ValueError):
        K.ell_spmv(cols.cpu(), vals, x[:, 0].contiguous(), nc)


# ---- the velocity-block product ----------------------------------------- #

def _jax_block(jpat, A1, R, x):
    """``y[a] = A1 x[a] + sum_b R[a, b] x[b]`` composed, as the JAX package
    composes it, from single ELL products (the Pallas kernel, interpreted)."""
    import jax.numpy as jnp
    d = x.shape[0]
    mv = lambda v, xa: _jax_pallas(jpat.matrix(jnp.asarray(v)),
                                   jnp.asarray(xa))
    ys = [mv(A1, x[a]) for a in range(d)]
    if R is not None:
        for a in range(d):
            for b in range(d):
                ys[a] = ys[a] + mv(R[a, b], x[b])
    return np.stack(ys)


def _block_patterns(which):
    """(JAX pattern, port pattern) of the cavity's P2 pattern at level 0 or
    1, or of the random pattern."""
    from fenapack_tpu.ops.sparse import SparsityPattern as JPattern, \
        pattern_from_dofmaps as jpattern
    if which == "random":
        _, rows, cols, n = _random_pattern()
        return (JPattern(rows, cols, n, n),
                SparsityPattern(rows, cols, n, n, device="cpu"))
    V = TaylorHood(tmesh.cavity_mesh(which)).V
    args = (V.cell_dofs, V.cell_dofs, V.dim, V.dim)
    return jpattern(*args), pattern_from_dofmaps(*args, device="cpu")


@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("which", [0, 1, "random"])
def test_block_plain_matches_jax_composition(which, np_dtype, d, with_R):
    pytest.importorskip("jax")
    jpat, pat = _block_patterns(which)
    np.testing.assert_array_equal(pat.cols.numpy(), np.asarray(jpat.cols))
    rng = np.random.default_rng(7)
    n, K = pat.value_shape
    # values on the pattern's own slots only: padding slots hold zero
    live = np.zeros(n * K, dtype=bool)
    live[pat._upos] = True
    live = live.reshape(n, K)
    A1 = (rng.standard_normal((n, K)) * live).astype(np_dtype)
    R = ((rng.standard_normal((d, d, n, K)) * live).astype(np_dtype)
         if with_R else None)
    x = rng.standard_normal((d, pat.n_cols)).astype(np_dtype)
    blk = pat.block_matrix(torch.as_tensor(A1),
                           None if R is None else torch.as_tensor(R))
    y = blk.mv(torch.as_tensor(x))
    assert y.shape == (d, n) and y.dtype == DTYPES[np_dtype]
    assert _relerr(y.numpy(), _jax_block(jpat, A1, R, x)) <= TOL[np_dtype]


def _random_block(dtype, device, d, with_R, n=300, K=7, n_cols=300, seed=5):
    cols, A1, _ = _random_ell(dtype, "cpu", n=n, K=K, n_cols=n_cols,
                              seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    R = torch.randn(d, d, n, K, generator=g, dtype=dtype) if with_R else None
    x = torch.randn(d, n_cols, generator=g, dtype=dtype)
    y0 = torch.randn(d, n, generator=g, dtype=dtype)
    to = lambda t: None if t is None else t.to(device)
    return to(cols), to(A1), to(R), to(x), to(y0)


@pytest.mark.parametrize("with_y0", [False, True], ids=["", "y0"])
@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_plain_is_the_composition_of_single_products(dtype, with_R,
                                                           with_y0):
    """Bit for bit what the velocity matvecs computed from single products:
    A1's product, then the term between (the outer matvec's pressure
    gradient), then each reaction product added in turn."""
    d = 2
    cols, A1, R, x, y0 = _random_block(dtype, "cpu", d, with_R)
    if not with_y0:
        y0 = None
    n_cols = x.shape[1]
    ys = [K.ell_spmv_plain(cols, A1, x[a], n_cols) for a in range(d)]
    if y0 is not None:
        ys = [ys[a] + y0[a] for a in range(d)]
    if R is not None:
        for a in range(d):
            for b in range(d):
                ys[a] = ys[a] + K.ell_spmv_plain(cols, R[a, b], x[b], n_cols)
    y = K.ell_block_spmv(cols, A1, R, x, n_cols, y0)
    assert torch.equal(y, torch.stack(ys))
    assert torch.equal(y.reshape(-1), torch.cat(ys))


def test_block_wrapper_rejects_bad_arguments():
    cols, A1, R, x, y0 = _random_block(torch.float64, "cpu", 2, True)
    nc = x.shape[1]
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R[:1], x, nc)             # R not (d, d)
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R[..., :-1], x, nc)       # R vs cols
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R.transpose(0, 1), x, nc)  # strided R
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R, x.t().contiguous().t(), nc)
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, None, x.reshape(-1), nc)  # flat x
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, None, x[:, :-1], nc)      # wrong length
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, None, torch.zeros(
            K.MAX_DIM + 1, nc, dtype=torch.float64), nc)     # d > 3
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R, x, nc, y0[:, :-1])     # y0 shape
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1[:, :-1], None, x, nc)      # cols vs A1
    with pytest.raises(TypeError):
        K.ell_block_spmv(cols, A1, R.float(), x, nc)         # mixed dtypes
    with pytest.raises(TypeError):
        K.ell_block_spmv(cols.long(), A1, R, x, nc)          # int64 cols
    with pytest.raises(TypeError):
        K.ell_block_spmv(cols, A1.half(), None, x.half(), nc)
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R, x.to("meta"), nc)      # mixed devices
    with pytest.raises(ValueError):
        K.ell_block_spmv(*(t.to("meta") for t in (cols, A1, R, x)), nc)


def test_block_cpu_tensors_take_the_plain_version_without_counting():
    cols, A1, R, x, y0 = _random_block(torch.float32, "cpu", 3, True)
    before = (dict(K.launches), dict(K.block_launches))
    y = ELLBlock(cols, A1, R, x.shape[1]).mv(x)
    assert (K.launches, K.block_launches) == before
    assert torch.equal(y, K.ell_block_spmv_plain(cols, A1, R, x, x.shape[1]))
    K.block_launches["f32"] += 1
    K.reset_launches()
    assert K.block_launches == {"f32": 0, "f64": 0} == K.launches


@pytest.mark.gpu
@pytest.mark.parametrize("with_y0", [False, True], ids=["", "y0"])
@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_kernel_matches_plain(cuda, dtype, d, with_R, with_y0):
    """Odd n*K: the planes of R start off the 16-byte grid, and the last
    tile is ragged; several tiles per block at the largest size."""
    name = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n, Kw in ((1031, 19), (70001, 19), (517, 8), (5, 3)):
        cols, A1, R, x, y0 = _random_block(dtype, cuda, d, with_R, n=n,
                                           K=Kw, n_cols=n)
        if not with_y0:
            y0 = None
        before = dict(K.block_launches)
        y = K.ell_block_spmv(cols, A1, R, x, n, y0)
        torch.cuda.synchronize()
        assert K.block_launches[name] == before[name] + 1
        ref = K.ell_block_spmv_plain(cols, A1, R, x, n, y0)
        assert y.shape == ref.shape == (d, n)
        assert float((y - ref).abs().max() / ref.abs().max()) <= tol
        # a view that starts off the 16-byte grid
        if n > 5:
            y1 = K.ell_block_spmv(cols[1:], A1[1:], None, x, n)
            ref1 = K.ell_block_spmv_plain(cols[1:], A1[1:], None, x, n)
            assert float((y1 - ref1).abs().max() / ref1.abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_ragged_and_unaligned_tiles(cuda, dtype):
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n, Kw in ((70001, 19), (16641, 7), (517, 8), (3, 5), (40, 700)):
        cols, vals, nc = _random_ell(dtype, cuda, n=n, K=Kw, n_cols=n)
        x = torch.randn(n, dtype=dtype, device=cuda)
        for c, v in ((cols, vals), (cols[1:], vals[1:])):
            y = K.ell_spmv(c, v, x, n)
            torch.cuda.synchronize()
            ref = K.ell_spmv_plain(c, v, x, n)
            assert float((y - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.gpu
def test_block_mv_on_cuda_launches_one_kernel(cuda):
    cols, A1, R, x, _ = _random_block(torch.float64, cuda, 2, True)
    K.reset_launches()
    y = ELLBlock(cols, A1, R, x.shape[1]).mv(x)
    torch.cuda.synchronize()
    assert K.block_launches == {"f32": 0, "f64": 1}
    assert K.launches == {"f32": 0, "f64": 0}
    ref = K.ell_block_spmv_plain(cols, A1, R, x, x.shape[1])
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-12


@pytest.mark.gpu
def test_block_kernel_raises_instead_of_falling_back(cuda):
    cols, A1, R, x, y0 = _random_block(torch.float32, cuda, 2, True)
    nc = x.shape[1]
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R.transpose(0, 1), x, nc)
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols.cpu(), A1, R, x, nc)
    with pytest.raises(ValueError):
        K.ell_block_spmv(cols, A1, R, x, nc, y0.cpu())
    # a row too wide for any tile of the single product to fit in shared
    # memory: the launch is refused and the wrapper raises, it does not
    # take the plain version; the block product stages no tile and takes
    # such rows
    wide = 30000
    c = torch.zeros(4, wide, dtype=torch.int32, device=cuda)
    v = torch.ones(4, wide, dtype=torch.float32, device=cuda)
    before = dict(K.launches)
    with pytest.raises(RuntimeError):
        K.ell_spmv(c, v, torch.ones(4, device=cuda), 4)
    assert K.launches == before
    y = K.ell_block_spmv(c, v, None, torch.ones(2, 4, device=cuda), 4)
    assert torch.equal(y, torch.full((2, 4), float(wide), device=cuda))


def test_each_source_builds_into_its_own_library(monkeypatch):
    """Every ``csrc/*.cu`` is one library named by a hash of its source and
    the nvcc flags (nothing is built on import or here)."""
    from fenapack_tpu_torch.ops import kernels
    assert {"bsr_spmv", "ell_spmv"} <= set(kernels.SOURCES)
    paths = {n: kernels.library_path(n) for n in kernels.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for n, p in paths.items():
        assert os.path.basename(p).startswith(f"lib{n}-")
        assert os.path.dirname(p).endswith(os.path.join("build", "kernels"))
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-G"])
    assert kernels.library_path("ell_spmv") != paths["ell_spmv"]


def test_layout_bytes_of_each_product():
    """``measure`` counts the bytes each product must move: an ELL product
    its values and columns (every slot) with x and y per right-hand side,
    the block product its columns once and every plane once, of every slot
    or, given row lengths, of the rows' own entries."""
    from fenapack_tpu_torch import measure
    cols, vals, nc = _random_ell(torch.float64, "cpu")
    _, A1, R, _, _ = _random_block(torch.float64, "cpu", 2, True, n=40,
                                   n_cols=40)
    lens = torch.arange(40, dtype=torch.int32) % 7
    n, k_slots = vals.shape
    for k in (1, 2):
        assert measure.ell_bytes(vals, nc, k) == \
            n * k_slots * (8 + 4) + (nc + n) * k * 8
    # cols once, A1 + 4 planes of R, 2 components of x and y (and y0)
    newton = 40 * 7 * (4 + 5 * 8) + 2 * (40 + 40) * 8
    picard = 40 * 7 * (4 + 8) + 2 * (40 + 2 * 40) * 8
    entries = int(lens.sum())                  # 115 of the 280 slots
    ragged = entries * (4 + 5 * 8) + 2 * (40 + 40) * 8
    assert measure.ell_block_bytes(A1, R, 2, 40) == newton
    assert measure.ell_block_bytes(A1, None, 2, 40, y0=True) == picard
    assert measure.ell_block_bytes(A1, R, 2, 40, row_len=lens) == ragged
    assert measure.bound(newton, 0, torch.float64) == (
        pytest.approx(newton / measure.HBM_BPS * 1e3), "bytes")


def test_spmv_spans_name_each_product():
    """With spans on, every product of the three layouts is one span named
    by its layout, and the products give what they give with spans off."""
    from fenapack_tpu_torch.ops.sparse import BlockELL
    from fenapack_tpu_torch.utils import timing
    cols, vals, nc = _random_ell(torch.float64, "cpu")
    bcols, A1, R, xb, _ = _random_block(torch.float64, "cpu", 2, True,
                                        n=40, n_cols=40)
    nbr = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    bsr = BlockELL(nbr, torch.randn(2, 4, 8, dtype=torch.float64), 8, 8)
    x, x8 = torch.randn(nc, dtype=torch.float64), torch.randn(
        8, dtype=torch.float64)
    ops = [lambda: ELL(cols, vals, nc).mv(x),
           lambda: ELLBlock(bcols, A1, R, 40).mv(xb),
           lambda: bsr.mv(x8)]
    off = [op() for op in ops]
    with timing.tracing() as rec:
        on = [op() for op in ops]
    assert [s.name for s in rec.spans] == ["spmv.ell", "spmv.ell_block",
                                           "spmv.bsr"]
    assert all(s.parent == -1 and s.end_ns >= s.start_ns for s in rec.spans)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
