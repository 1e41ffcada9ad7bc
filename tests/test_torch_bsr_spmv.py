"""BSR SpMV (kernels K1/K2): the plain PyTorch version against the JAX
package's ``BlockELL.mv`` (its XLA formula, the reference the Pallas kernel
tests compare with), the wrapper's checks, and, on a CUDA GPU only, the
hand-written kernel against the plain version.

Tolerances (max |y - y_ref| / max |y_ref|): float32 1e-5, float64 1e-12;
the two sides sum in different orders."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import interop
from fenapack_tpu_torch.ops import bsr_spmv as K
from fenapack_tpu_torch.ops.sparse import pattern_from_dofmaps

TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the BSR kernel has no CPU mode")
    return torch.device("cuda")


def _relerr(y, ref):
    y, ref = np.asarray(y, dtype=np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


def _dofmaps(rng, square):
    """Random cell dofmaps: square (400 cells x 6 over 512 dofs) or
    rectangular (3 test dofs over 300, 6 trial dofs over 513)."""
    if square:
        cd = rng.integers(0, 512, size=(400, 6))
        return cd, cd, 512, 512
    return (rng.integers(0, 300, size=(400, 3)),
            rng.integers(0, 513, size=(400, 6)), 300, 513)


def _jax_op(block, np_dtype, square, seed=0):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.ops.sparse import pattern_from_dofmaps as jpattern
    rng = np.random.default_rng(seed)
    rows, cols, nr, nc = _dofmaps(rng, square)
    pat = jpattern(rows, cols, nr, nc, block=block)
    vals = rng.standard_normal((rows.shape[0], rows.shape[1], cols.shape[1]))
    op = pat.assemble(jnp.asarray(vals.astype(np_dtype)))
    port = interop.operator({"nbr": np.asarray(op.nbr),
                             "tiles": np.asarray(op.tiles),
                             "n_rows": nr, "n_cols": nc}, device="cpu")
    return op, port, rng


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_plain_matches_jax_blockell(block, np_dtype, square):
    import jax.numpy as jnp
    op, port, rng = _jax_op(block, np_dtype, square)
    nc = port.n_cols
    x = rng.standard_normal(nc).astype(np_dtype)
    X = rng.standard_normal((nc, 2)).astype(np_dtype)
    y = port.mv(torch.as_tensor(x))
    Y = port.mv(torch.as_tensor(X))
    assert y.dtype == DTYPES[np_dtype] and y.shape == (port.n_rows,)
    assert Y.shape == (port.n_rows, 2)
    assert _relerr(y.numpy(), np.asarray(op.mv(jnp.asarray(x)))) <= \
        TOL[np_dtype]
    assert _relerr(Y.numpy(), np.asarray(op.mv(jnp.asarray(X)))) <= \
        TOL[np_dtype]
    # a column of the multi-RHS product is the single-RHS product
    for j in range(2):
        yj = port.mv(torch.as_tensor(np.ascontiguousarray(X[:, j])))
        assert _relerr(Y[:, j].numpy(), yj.numpy()) <= TOL[np_dtype]


@pytest.mark.parametrize("block", [8, 32])
def test_port_pattern_assembly_matches_jax_tiles(block):
    """The port's own pattern and assembly give the JAX package's tiles."""
    op, _, _ = _jax_op(block, np.float64, square=False)
    rng = np.random.default_rng(0)
    rows, cols, nr, nc = _dofmaps(rng, square=False)
    vals = rng.standard_normal((rows.shape[0], rows.shape[1], cols.shape[1]))
    pat = pattern_from_dofmaps(rows, cols, nr, nc, block=block,
                               device="cpu")
    tiles = pat.assemble_values(torch.as_tensor(vals))
    np.testing.assert_allclose(tiles.numpy(), np.asarray(op.tiles),
                               rtol=0, atol=1e-13)


def _random_bsr(block, dtype, device, nb=19, m=5, seed=1, n_cols=None):
    g = torch.Generator().manual_seed(seed)
    n_cols = n_cols or nb * block - 3
    nbr = torch.randint(0, -(-n_cols // block), (nb, m), generator=g,
                        dtype=torch.int32)
    tiles = torch.randn(nb, block, m * block, generator=g, dtype=dtype)
    return nbr.to(device), tiles.to(device), nb * block - 5, n_cols


def test_wrapper_rejects_bad_arguments():
    nbr, tiles, nr, nc = _random_bsr(8, torch.float64, "cpu")
    x = torch.zeros(nc, dtype=torch.float64)
    with pytest.raises(ValueError):
        K.bsr_spmv(nbr, tiles, x[:-1], nr, nc)            # wrong length
    with pytest.raises(TypeError):
        K.bsr_spmv(nbr, tiles, x.float(), nr, nc)         # dtype mismatch
    with pytest.raises(TypeError):
        K.bsr_spmv(nbr.long(), tiles, x, nr, nc)          # int64 nbr
    with pytest.raises(ValueError):
        K.bsr_spmv(nbr[:, :-1], tiles, x, nr, nc)         # nbr vs tiles
    with pytest.raises(ValueError):
        K.bsr_spmv(nbr, tiles, x, tiles.shape[0] * 8 + 1, nc)


def test_cpu_tensors_take_the_plain_version_without_counting():
    nbr, tiles, nr, nc = _random_bsr(16, torch.float32, "cpu")
    x = torch.randn(nc, 3, dtype=torch.float32)
    before = dict(K.launches)
    y = K.bsr_spmv(nbr, tiles, x, nr, nc)
    assert K.launches == before
    torch.testing.assert_close(y, K.bsr_spmv_plain(nbr, tiles, x, nr, nc),
                               rtol=0, atol=0)


def test_plain_version_of_a_dense_matrix():
    """The plain version against a dense product built from the layout's
    definition: tiles[I, i, j*b + c] = A[I*b + i, nbr[I, j]*b + c]."""
    b = 8
    nbr, tiles, nr, nc = _random_bsr(b, torch.float64, "cpu", nb=6, m=3,
                                     seed=4)
    # repeated neighbour slots (the layout's padding) add up like any other
    t4 = tiles.reshape(6, b, 3, b)
    A = torch.zeros(6 * b, -(-nc // b) * b, dtype=torch.float64)
    for I in range(6):
        for j in range(3):
            c0 = int(nbr[I, j]) * b
            A[I * b:(I + 1) * b, c0:c0 + b] += t4[I, :, j]
    x = torch.randn(nc, dtype=torch.float64)
    y = K.bsr_spmv_plain(nbr, tiles, x, nr, nc)
    ref = (A[:, :nc] @ x)[:nr]
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("nrhs", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("block", [8, 16, 32])
def test_kernel_matches_plain(cuda, block, dtype, nrhs):
    nbr, tiles, nr, nc = _random_bsr(block, dtype, cuda, nb=57, m=7)
    shape = (nc,) if nrhs == 1 else (nc, nrhs)
    x = torch.randn(shape, dtype=dtype, device=cuda)
    before = dict(K.launches)
    y = K.bsr_spmv(nbr, tiles, x, nr, nc)
    torch.cuda.synchronize()
    name = "f32" if dtype == torch.float32 else "f64"
    assert K.launches[name] == before[name] + 1
    ref = K.bsr_spmv_plain(nbr, tiles, x, nr, nc)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - ref).abs().max() / ref.abs().max()) <= tol
    if nrhs > 1:
        # one pass over the tiles serves every column, in the same order
        for j in range(nrhs):
            yj = K.bsr_spmv(nbr, tiles, x[:, j].contiguous(), nr, nc)
            assert torch.equal(y[:, j], yj)


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    nbr, tiles, nr, nc = _random_bsr(32, torch.float32, cuda)
    x = torch.randn(nc, 2, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        K.bsr_spmv(nbr, tiles, x.t().contiguous().t(), nr, nc)
    with pytest.raises(ValueError):
        K.bsr_spmv(nbr, tiles, torch.randn(nc, K.MAX_RHS + 1, device=cuda),
                   nr, nc)
    with pytest.raises(ValueError):
        K.bsr_spmv(nbr.cpu(), tiles, x[:, 0].contiguous(), nr, nc)
