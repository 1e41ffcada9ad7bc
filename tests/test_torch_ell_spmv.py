"""ELL SpMV (kernel K3): the plain PyTorch version against the JAX
package's Pallas ELL kernel run as its own tests run it (``PallasSpMV`` in
interpret mode) and against its ``ELL.mv`` with two right-hand sides, the
wrapper's checks, and, on a CUDA GPU only, the hand-written kernel against
the plain version.

Tolerances (max |y - y_ref| / max |y_ref|): float32 1e-5, float64 1e-12;
the two sides sum in different orders."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)

from fenapack_tpu_torch import interop
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.dofmap import TaylorHood
from fenapack_tpu_torch.ops import ell_spmv as K
from fenapack_tpu_torch.ops.sparse import ELL, SparsityPattern, \
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


def test_trace_sums_the_bound_of_each_product():
    """``trace`` tallies, per kernel, the launches of the products the
    operators issue and their bound (bytes over the HBM rate), and maps the
    kernels' device events to the same names."""
    from fenapack_tpu_torch import measure, trace
    from fenapack_tpu_torch.ops import sparse
    cols, vals, nc = _random_ell(torch.float64, "cpu")
    ell, mv = ELL(cols, vals, nc), sparse.ell_spmv
    with trace._bounds() as tally:
        ell.mv(torch.randn(nc, dtype=torch.float64))
        ell.mv(torch.randn(nc, 2, dtype=torch.float64))
    assert sparse.ell_spmv is mv
    one, two = (measure.ell_bytes(vals, nc, k) / measure.HBM_BPS
                for k in (1, 2))
    assert dict(tally).keys() == {"ell_f64"}
    assert tally["ell_f64"][0] == 2
    assert tally["ell_f64"][1] == pytest.approx(one + two, rel=1e-12)
    # the names the profiler gives them on the card
    assert trace._kernel_of("void (anonymous namespace)::ell_spmv_kernel<"
                            "double, 1>(int const*, double const*, double c"
                            ) == "ell_f64"
    assert trace._kernel_of("void (anonymous namespace)::bsr_spmv_kernel<"
                            "float, 2>(int const*, float const*)") == "bsr_f32"
    assert trace._kernel_of("void at::native::elementwise_kernel") is None
