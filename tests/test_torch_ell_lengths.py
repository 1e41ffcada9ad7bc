"""Row lengths of the ELL layout and the K3 block product that reads them.

The patterns of ``fenapack_tpu_torch.ops.sparse`` carry each row's entry
count (``row_len``): it equals the entries per row on the port's 2D (level
1) and 3D (tet, level 0) Taylor-Hood patterns and on the multigrid
restrictions, the padding past it holds column 0 and, once assembled, value
0, and it survives ``with_vals``, ``block_matrix`` and the pattern cache.
Every layout's ``block_matrix`` gives the velocity block: in BSR the single
products composed in the solvers' order, bit for bit.
The block product's wrapper checks the lengths; its plain version ignores
them (padding adds zero), so CPU results are the same bits with and without
them and equal the JAX package's composition of Pallas ELL products
(interpret mode) at 3D level 0, d = 3: float64 within 1e-12, float32 within
1e-5 (max |y - y_ref| / max |y_ref|; the two sides sum in different
orders).  On a CUDA GPU only: the kernel against the plain version at
ragged lengths, and repeats equal bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import measure
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem import mesh3d as tmesh3d
from fenapack_tpu_torch.fem.dofmap import TaylorHood
from fenapack_tpu_torch.ops import ell_spmv as K
from fenapack_tpu_torch.ops.sparse import ELLBlock, pattern_from_dofmaps
from fenapack_tpu_torch.solvers import gmg

TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}
# (test space, trial space) of the Taylor-Hood operators: P2 velocity, P1
# pressure, D and B^T
PAIRS = {"p2": ("V", "V"), "p1": ("Q", "Q"), "div": ("Q", "V"),
         "divT": ("V", "Q")}
MESHES = {"2d-l1": lambda: tmesh.cavity_mesh(1),
          "3d-l0": lambda: tmesh3d.backward_step_mesh3d(0, length=3.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the ELL kernel has no CPU mode")
    return torch.device("cuda")


def _relerr(y, ref):
    y, ref = np.asarray(y, dtype=np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


def _pattern(mesh_name, pair):
    W = TaylorHood(MESHES[mesh_name]())
    test, trial = (getattr(W, s) for s in PAIRS[pair])
    return test, trial, pattern_from_dofmaps(
        test.cell_dofs, trial.cell_dofs, test.dim, trial.dim, device="cpu")


def _check_lengths(ell, counts):
    """``ell.row_len`` is ``counts``; every slot past it holds column 0
    and value 0."""
    n, Kw = ell.cols.shape
    assert ell.row_len.dtype == torch.int32
    assert ell.row_len.shape == (n,) and ell.row_len.device.type == "cpu"
    np.testing.assert_array_equal(ell.row_len.numpy(), counts)
    pad = np.arange(Kw)[None, :] >= counts[:, None]
    assert pad.any() or counts.min() == Kw
    assert not ell.cols.numpy()[pad].any()
    assert not ell.vals.numpy()[pad].any()
    # the row's own slots: seeded random sums, none of them zero
    assert np.abs(ell.vals.numpy()[~pad]).min() > 0


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_lengths_match_the_pattern(mesh_name, pair):
    test, trial, pat = _pattern(mesh_name, pair)
    counts = np.bincount(pat._urow, minlength=pat.n_rows)
    # the entries per row straight from the cells' dofs
    keys = np.unique(np.repeat(test.cell_dofs, trial.cell_dofs.shape[1],
                               axis=1).ravel().astype(np.int64) * trial.dim
                     + np.tile(trial.cell_dofs,
                               (1, test.cell_dofs.shape[1])).ravel())
    np.testing.assert_array_equal(
        counts, np.bincount(keys // trial.dim, minlength=test.dim))
    assert pat.K == counts.max()
    rng = np.random.default_rng(3)
    vals = rng.uniform(0.5, 1.5, (test.cell_dofs.shape[0],
                                  test.cell_dofs.shape[1],
                                  trial.cell_dofs.shape[1]))
    _check_lengths(pat.assemble(torch.as_tensor(vals)), counts)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_lengths_of_the_multigrid_restrictions(mesh_name):
    """The restrictions, stored as ELL transposes of the prolongations: the
    P2 and P1 transfers between two levels and the P1 -> P2 embedding."""
    coarse = MESHES[mesh_name]()
    hier = gmg.build_hierarchy(coarse, 1)
    W = TaylorHood(coarse)
    transfers = [gmg.P2Transfer(coarse, hier.fine, torch.float64,
                                device="cpu"),
                 gmg.P1Transfer(hier.parents[0], coarse.num_vertices,
                                torch.float64, device="cpu"),
                 gmg.PCoarseTransfer(W, device="cpu")]
    for t in transfers:
        ell = t._PT
        assert ell.cols.shape[0] == t.n_coarse
        # every weight kept is nonzero: the row's entries are its nonzeros
        _check_lengths(ell, (ell.vals.numpy() != 0).sum(axis=1))


def test_lengths_survive_with_vals_block_matrix_and_the_cache(tmp_path,
                                                              monkeypatch):
    monkeypatch.setenv("FENAPACK_CACHE", str(tmp_path))
    W = TaylorHood(MESHES["3d-l0"]())
    cd, n = W.V.cell_dofs, W.V.dim
    built = pattern_from_dofmaps(cd, cd, n, n, device="cpu")
    assert len(list(tmp_path.iterdir())) == 1
    cached = pattern_from_dofmaps(cd, cd, n, n, device="cpu")
    assert torch.equal(cached.row_len, built.row_len)
    assert torch.equal(cached.cols, built.cols)
    vals = torch.ones(built.value_shape, dtype=torch.float64)
    ell = cached.matrix(vals)
    assert ell.row_len is cached.row_len
    assert ell.with_vals(2 * vals).row_len is cached.row_len
    blk = cached.block_matrix(vals, torch.zeros((3, 3) + tuple(vals.shape),
                                                dtype=torch.float64))
    assert isinstance(blk, ELLBlock) and blk.row_len is cached.row_len


@pytest.fixture(scope="module")
def velocity_patterns():
    """The P2 velocity pattern of the level-1 cavity in the ELL layout and
    in the BSR layout at b = 8 and 32, each by its tile size (None: ELL),
    and the seeded element values to assemble."""
    cd = TaylorHood(MESHES["2d-l1"]()).V
    pats = {b: pattern_from_dofmaps(cd.cell_dofs, cd.cell_dofs, cd.dim,
                                    cd.dim, block=b, device="cpu")
            for b in (None, 8, 32)}
    rng = np.random.default_rng(11)
    elems = torch.as_tensor(rng.standard_normal(
        (10,) + cd.cell_dofs.shape + (cd.cell_dofs.shape[1],)))
    return pats, elems


def _composed(pat, A1, R, x, y0):
    """``y[a] = A1 x[a] + y0[a] + sum_b R[a, b] x[b]`` composed of the
    pattern's single products, as the solvers composed the BSR block before
    every pattern gave one: A1's products, then ``y0``, then the reaction
    products in (a, b) order."""
    d = x.shape[0]
    ys = [pat.matrix(A1).mv(x[a]) for a in range(d)]
    if y0 is not None:
        ys = [ys[a] + y0[a] for a in range(d)]
    if R is not None:
        for a in range(d):
            for b in range(d):
                ys[a] = ys[a] + pat.matrix(R[a, b]).mv(x[b])
    return torch.cat(ys).view(d, -1)


@pytest.mark.parametrize("y0_as", [None, "tensor", "sequence"])
@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("block", [None, 8, 32], ids=["ell", "bsr8", "bsr32"])
def test_block_matrix_of_every_layout_is_the_composed_block(
        velocity_patterns, block, d, with_R, y0_as):
    """``pattern.block_matrix(A1, R).mv(x, y0)`` on every layout: in BSR
    the single products composed in the solvers' order, bit for bit; in
    ELL the one-pass block product, within the float64 tolerance of the
    composition; ``y0`` given as a tensor or as a sequence of vectors."""
    pats, elems = velocity_patterns
    pat = pats[block]
    A1 = pat.assemble_values(elems[0])
    R = (torch.stack([pat.assemble_values(elems[1 + i % 9])
                      for i in range(d * d)]).reshape(
                          (d, d) + tuple(A1.shape)) if with_R else None)
    g = torch.Generator().manual_seed(d)
    x = torch.randn(d, pat.n_cols, generator=g, dtype=torch.float64)
    y0 = (None if y0_as is None else
          torch.randn(d, pat.n_rows, generator=g, dtype=torch.float64))
    given = list(y0) if y0_as == "sequence" else y0
    y = pat.block_matrix(A1, R).mv(x, given)
    ref = _composed(pat, A1, R, x, y0)
    assert y.shape == (d, pat.n_rows)
    if block is None:
        assert _relerr(y.numpy(), ref.numpy()) <= TOL[np.float64]
    else:
        assert torch.equal(y, ref)


def _random_lengths(dtype, device, d, with_R, n=300, Kw=9, n_cols=257,
                    seed=5):
    """A random block product whose rows hold 0..K entries (every length
    present), values and columns zero past them, as the layout has it."""
    g = torch.Generator().manual_seed(seed)
    row_len = torch.randint(0, Kw + 1, (n,), generator=g, dtype=torch.int32)
    every = min(n, Kw + 1)
    row_len[:every] = torch.arange(every, dtype=torch.int32)
    live = torch.arange(Kw)[None, :] < row_len[:, None]
    cols = torch.randint(0, n_cols, (n, Kw), generator=g,
                         dtype=torch.int32) * live
    A1 = torch.randn(n, Kw, generator=g, dtype=dtype) * live
    R = (torch.randn(d, d, n, Kw, generator=g, dtype=dtype) * live
         if with_R else None)
    x = torch.randn(d, n_cols, generator=g, dtype=dtype)
    y0 = torch.randn(d, n, generator=g, dtype=dtype)
    to = lambda t: None if t is None else t.to(device).contiguous()
    return (to(cols), to(A1), to(R), to(x), to(y0), to(row_len))


def test_block_wrapper_rejects_bad_lengths():
    cols, A1, R, x, y0, row_len = _random_lengths(torch.float64, "cpu", 2,
                                                  True)
    nc, Kw = x.shape[1], cols.shape[1]
    run = lambda lengths: K.ell_block_spmv(cols, A1, R, x, nc, y0,
                                           row_len=lengths)
    run(row_len)
    with pytest.raises(ValueError):                     # a negative length
        run(torch.where(row_len == 3, -1, row_len))
    with pytest.raises(ValueError):                     # a length above K
        run(torch.where(row_len == 3, Kw + 1, row_len))
    with pytest.raises(TypeError):                      # int64 lengths
        run(row_len.long())
    with pytest.raises(ValueError):                     # another device
        run(row_len.to("meta"))
    with pytest.raises(ValueError):                     # one per row
        run(row_len[:-1])
    with pytest.raises(ValueError):
        run(row_len[:, None])
    # a tensor checked once is checked again after it changes
    lengths = row_len.clone()
    run(lengths)
    lengths[7] = Kw + 1
    with pytest.raises(ValueError):
        run(lengths)


@pytest.mark.parametrize("with_y0", [False, True], ids=["", "y0"])
@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_plain_with_lengths_is_plain_without(dtype, d, with_R,
                                                   with_y0):
    cols, A1, R, x, y0, row_len = _random_lengths(dtype, "cpu", d, with_R)
    y0 = y0 if with_y0 else None
    before = measure.launch_counts()["ell_block_spmv"]
    y = K.ell_block_spmv(cols, A1, R, x, x.shape[1], y0, row_len=row_len)
    assert measure.launch_counts()["ell_block_spmv"] == before
    assert torch.equal(y, K.ell_block_spmv(cols, A1, R, x, x.shape[1], y0))
    assert torch.equal(y, ELLBlock(cols, A1, R, x.shape[1], row_len).mv(
        x, y0))


@pytest.fixture(scope="module")
def step3d_l0():
    """(JAX pattern, port pattern) of the level-0 3D step's P2 velocity."""
    pytest.importorskip("jax")
    from fenapack_tpu.ops.sparse import pattern_from_dofmaps as jpattern
    V = TaylorHood(MESHES["3d-l0"]()).V
    args = (V.cell_dofs, V.cell_dofs, V.dim, V.dim)
    return jpattern(*args), pattern_from_dofmaps(*args, device="cpu")


def _jax_block(jpat, A1, R, x, y0):
    """``y[a] = A1 x[a] + y0[a] + sum_b R[a, b] x[b]`` composed, as the
    JAX package's velocity matvecs compose it, from single ELL products
    (the Pallas kernel, interpreted)."""
    import jax.numpy as jnp
    from fenapack_tpu.ops.pallas_spmv import PallasSpMV
    mv = lambda v, xa: np.asarray(PallasSpMV(
        jpat.matrix(jnp.asarray(v)), tile_r=64, interpret=True)(
            jnp.asarray(xa)))
    d = x.shape[0]
    ys = [mv(A1, x[a]) for a in range(d)]
    if y0 is not None:
        ys = [ys[a] + y0[a] for a in range(d)]
    if R is not None:
        for a in range(d):
            for b in range(d):
                ys[a] = ys[a] + mv(R[a, b], x[b])
    return np.stack(ys)


@pytest.mark.parametrize("with_y0", [False, True], ids=["", "y0"])
@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_block_with_lengths_matches_jax_composition_3d(step3d_l0, np_dtype,
                                                       with_R, with_y0):
    jpat, pat = step3d_l0
    np.testing.assert_array_equal(pat.cols.numpy(), np.asarray(jpat.cols))
    d, (n, Kw) = 3, pat.value_shape
    assert pat.row_len.numpy().min() < Kw          # ragged rows
    rng = np.random.default_rng(9)
    live = np.arange(Kw)[None, :] < pat.row_len.numpy()[:, None]
    A1 = (rng.standard_normal((n, Kw)) * live).astype(np_dtype)
    R = ((rng.standard_normal((d, d, n, Kw)) * live).astype(np_dtype)
         if with_R else None)
    x = rng.standard_normal((d, pat.n_cols)).astype(np_dtype)
    y0 = rng.standard_normal((d, n)).astype(np_dtype) if with_y0 else None
    t = lambda a: None if a is None else torch.as_tensor(a)
    blk = pat.block_matrix(t(A1), t(R))
    assert blk.row_len is pat.row_len
    y = blk.mv(t(x), t(y0))
    assert y.shape == (d, n) and y.dtype == DTYPES[np_dtype]
    assert torch.equal(y, K.ell_block_spmv(pat.cols, t(A1), t(R), t(x),
                                           pat.n_cols, t(y0)))
    assert _relerr(y.numpy(), _jax_block(jpat, A1, R, x, y0)) <= \
        TOL[np_dtype]


def test_bounds_count_the_entries_of_rows_with_lengths():
    """``measure`` counts a block product given row lengths by its rows'
    own entries (each read once), not by the padded slots, and reads the
    count again after the lengths change."""
    cols, A1, R, x, y0, row_len = _random_lengths(torch.float64, "cpu", 2,
                                                  True, n=40, Kw=7,
                                                  n_cols=40)
    nnz = int(row_len.sum())
    assert nnz < A1.numel()
    newton = nnz * (4 + 5 * 8) + 2 * (40 + 40) * 8
    picard = nnz * (4 + 8) + 2 * (40 + 2 * 40) * 8
    assert measure.ell_block_bytes(A1, R, 2, 40, row_len=row_len) == newton
    assert measure.ell_block_bytes(A1, None, 2, 40, y0=True,
                                   row_len=row_len) == picard
    assert measure.ell_block_flops(A1, R, 2, row_len) == 2 * nnz * 6
    assert measure.ell_block_flops(A1, R, 2) == 2 * A1.numel() * 6
    lengths = row_len.clone()
    assert measure.ell_entries(A1, lengths) == nnz
    lengths[lengths > 0] -= 1
    assert measure.ell_entries(A1, lengths) == nnz - int((row_len > 0).sum())
    assert K.length_stats(lengths) == (0, 6, measure.ell_entries(A1,
                                                                 lengths))


# ---- on a CUDA GPU ------------------------------------------------------ #

@pytest.mark.gpu
@pytest.mark.parametrize("with_y0", [False, True], ids=["", "y0"])
@pytest.mark.parametrize("with_R", [True, False], ids=["newton", "picard"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_kernel_matches_plain_at_ragged_lengths(cuda, dtype, d, with_R,
                                                      with_y0):
    """Rows of every length from 0 to K (1 and K among them), K of 7, 19
    and 85, row counts that divide no tile; the padding past each length
    holds NaN on the card, which the kernel must not read; repeats equal
    bit for bit; without lengths the kernel agrees too."""
    name = "f32" if dtype == torch.float32 else "f64"
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for n, Kw in ((1031, 7), (70001, 19), (24313, 85), (3, 85)):
        cols, A1, R, x, y0, row_len = _random_lengths(
            dtype, cuda, d, with_R, n=n, Kw=Kw, n_cols=n + 11, seed=n)
        y0 = y0 if with_y0 else None
        ref = K.ell_block_spmv_plain(cols, A1, R, x, n + 11, y0)
        pad = torch.arange(Kw, device=cuda)[None, :] >= row_len[:, None]
        nanA1 = A1.masked_fill(pad, float("nan"))
        nanR = None if R is None else R.masked_fill(pad, float("nan"))
        before = measure.launch_counts()["ell_block_spmv"]
        y = K.ell_block_spmv(cols, nanA1, nanR, x, n + 11, y0,
                             row_len=row_len)
        torch.cuda.synchronize()
        after = measure.launch_counts()["ell_block_spmv"]
        assert after[name] == before[name] + 1
        assert y.shape == ref.shape == (d, n)
        assert float((y - ref).abs().max() / ref.abs().max()) <= tol
        again = K.ell_block_spmv(cols, nanA1, nanR, x, n + 11, y0,
                                 row_len=row_len)
        assert torch.equal(y, again)
        whole = K.ell_block_spmv(cols, A1, R, x, n + 11, y0)
        assert float((whole - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.gpu
def test_block_mv_of_a_pattern_launches_one_kernel_with_lengths(cuda):
    W = TaylorHood(MESHES["3d-l0"]())
    cd, n = W.V.cell_dofs, W.V.dim
    pat = pattern_from_dofmaps(cd, cd, n, n, device=cuda)
    assert pat.row_len.device.type == "cuda"
    rng = np.random.default_rng(2)
    vals = torch.as_tensor(rng.standard_normal(cd.shape + (cd.shape[1],)),
                           device=cuda)
    A1 = pat.assemble_values(vals)
    R = torch.stack([pat.assemble_values(vals * (a + 1))
                     for a in range(9)]).reshape((3, 3) + tuple(A1.shape))
    x = torch.as_tensor(rng.standard_normal((3, n)), device=cuda)
    measure.reset_launches()
    y = pat.block_matrix(A1, R).mv(x)
    torch.cuda.synchronize()
    assert measure.launch_counts()["ell_block_spmv"] == {"f32": 0, "f64": 1}
    ref = K.ell_block_spmv_plain(pat.cols, A1, R, x, n)
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-12
