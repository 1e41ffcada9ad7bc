"""Assembly of the PyTorch port against the JAX package at level 0 with the
main path's layout (BSR b = 32, high-precision operators in the block
layout, RCM dof order: the block layout's default in both packages).  In f64 the two sides differ only in summation
order: every comparison holds at 1e-12 relative (max-norm)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import interop
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.assemble import NSAssembler

NU = 0.02
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def pair():
    """(port assembler, JAX assembler, random wind, random pressure)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    ta = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu",
                     block_size=32, hi_block=True)
    ja = JAsm(jmesh.backward_step_mesh(0), NU, dtype=jnp.float64,
              block_size=32, hi_block=True)
    assert ta.W.reorder and ja.W.reorder
    rng = np.random.default_rng(7)
    w = rng.standard_normal(2 * ta.n2)
    p = rng.standard_normal(ta.n1)
    return ta, ja, w, p


def _op_arrays(op):
    return {"nbr": np.asarray(op.nbr), "tiles": np.asarray(op.tiles),
            "n_rows": op.n_rows, "n_cols": op.n_cols}


@pytest.mark.parametrize("name", ["L", "Mp", "Ap", "D", "DT"])
def test_constant_operators_match_jax(pair, name):
    ta, ja, _, _ = pair
    for hi in (True, False):
        ct = ta.const_hi if hi else ta.const
        cj = ja.const_hi if hi else ja.const
        ot, oj = getattr(ct, name), getattr(cj, name)
        ot, oj = (ot, oj) if name in ("D", "DT") else ((ot,), (oj,))
        assert len(ot) == len(oj)
        for a, b in zip(ot, oj):
            assert a.tiles.dtype == torch.float64
            tiles = a.dense_tiles()
            assert tuple(tiles.shape) == tuple(b.tiles.shape)
            np.testing.assert_array_equal(a.nbr[:, :b.nbr.shape[1]].numpy(),
                                          np.asarray(b.nbr))
            assert _rel(tiles.numpy(), b.tiles) <= TOL


def test_jax_constants_carried_across_by_interop(pair):
    ta, ja, w, _ = pair
    c = ja.const_hi
    ct = interop.const_operators(
        {"L": _op_arrays(c.L), "Mp": _op_arrays(c.Mp), "Ap": _op_arrays(c.Ap),
         "D": [_op_arrays(e) for e in c.D],
         "DT": [_op_arrays(e) for e in c.DT]}, device="cpu")
    x = torch.as_tensor(w[:ta.n2])
    assert _rel(ct.L.mv(x).numpy(), ta.const_hi.L.mv(x).numpy()) <= TOL
    assert _rel(ct.D[1].mv(x).numpy(), ta.const_hi.D[1].mv(x).numpy()) <= TOL
    idx = interop.pattern_index({"nbr": np.asarray(ja.pat_p2.nbr),
                                 "entry_pos": np.asarray(ja.pat_p2.entry_pos),
                                 "diag_pos": np.asarray(ja.pat_p2.diag_pos)},
                                device="cpu")
    pat = ta.pat_p2
    assert torch.equal(idx["nbr"], pat.neighbours)
    assert np.array_equal(idx["entry_pos"].numpy(),
                          pat.dense_positions(pat.entry_pos.numpy()))
    assert np.array_equal(idx["diag_pos"].numpy(),
                          pat.dense_positions(pat.diag_pos.numpy()))
    s = interop.state(np.concatenate([w, np.zeros(ta.n1)]), device="cpu")
    assert s.dtype == torch.float64 and s.shape == (2 * ta.n2 + ta.n1,)


@pytest.mark.parametrize("hi", [True, False])
def test_picard_matrix_values_match_jax(pair, hi):
    import jax.numpy as jnp
    ta, ja, w, _ = pair
    vt = ta.picard_matrix_values(torch.as_tensor(w), hi=hi)
    vj = ja.picard_matrix_values(jnp.asarray(w), hi=hi)
    assert vt.dtype == torch.float64
    assert _rel(ta._pats(hi)[0].dense_tiles(vt).numpy(), vj) <= TOL


def test_picard_values_with_f32_integrals_match_jax(pair):
    """``compute32`` (the hi operator of the main path): convection
    integrals in f32, cast up.  Both sides round the same f64 inputs to f32;
    what remains is f32 summation order, so 1e-6 relative."""
    import jax.numpy as jnp
    ta, ja, w, _ = pair
    vt = ta.picard_matrix_values(torch.as_tensor(w), hi=True, compute32=True)
    vj = ja.picard_matrix_values(jnp.asarray(w), hi=True, compute32=True)
    assert vt.dtype == torch.float64
    assert _rel(ta.pat_p2_hi.dense_tiles(vt).numpy(), vj) <= 1e-6


def test_picard_values_from_an_f32_wind_match_jax(pair):
    """The preconditioner's wind is f32: both packages promote it to the
    assembler's f64 before the integrals."""
    import jax.numpy as jnp
    ta, ja, w, _ = pair
    w32 = w.astype(np.float32)
    vt = ta.picard_matrix_values(torch.as_tensor(w32), hi=False)
    vj = ja.picard_matrix_values(jnp.asarray(w32), hi=False)
    assert vt.dtype == torch.float64
    assert _rel(ta.pat_p2.dense_tiles(vt).numpy(), vj) <= TOL


@pytest.mark.parametrize("surface", [True, False])
def test_kp_values_match_jax(pair, surface):
    import jax.numpy as jnp
    ta, ja, w, _ = pair
    vt = ta.kp_values(torch.as_tensor(w), surface=surface)
    vj = ja.kp_values(jnp.asarray(w), surface=surface)
    assert _rel(ta.pat_p1.dense_tiles(vt).numpy(), vj) <= TOL


def test_residual_matches_jax(pair):
    import jax.numpy as jnp
    ta, ja, w, p = pair
    rut, rpt = ta.residual(torch.as_tensor(w), torch.as_tensor(p))
    ruj, rpj = ja.residual(jnp.asarray(w), jnp.asarray(p))
    assert _rel(rut.numpy(), ruj) <= TOL
    assert _rel(rpt.numpy(), rpj) <= TOL


def test_f32_level_assembler_matches_jax():
    """A velocity multigrid level: f32 assembler, quadrature degree 4,
    f32 block constants; f32 summation order bounds the agreement."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    ta = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu",
                     dtype=torch.float32, quad_degree=4, block_size=32)
    ja = JAsm(jmesh.backward_step_mesh(0), NU, dtype=jnp.float32,
              quad_degree=4, block_size=32)
    w = np.random.default_rng(2).standard_normal(2 * ta.n2)
    w = w.astype(np.float32)
    vt = ta.picard_matrix_values(torch.as_tensor(w))
    vj = ja.picard_matrix_values(jnp.asarray(w))
    assert vt.dtype == torch.float32
    assert _rel(ta.pat_p2.dense_tiles(vt).numpy(), vj) <= 1e-5
    assert _rel(ta.const.Ap.dense_tiles().numpy(), ja.const.Ap.tiles) <= 1e-6


def test_p1_only_assembler_matches_jax():
    """The pressure multigrid level assembler (P1 space only)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    ta = NSAssembler(tmesh.backward_step_mesh(1), 1.0, device="cpu",
                     quad_degree=2, block_size=32, p1_only=True)
    ja = JAsm(jmesh.backward_step_mesh(1), 1.0, dtype=jnp.float64,
              quad_degree=2, block_size=32, p1_only=True)
    assert ta.const.L is None and ta.pat_p2 is None
    for name in ("Ap", "Mp"):
        assert _rel(getattr(ta.const, name).dense_tiles().numpy(),
                    getattr(ja.const, name).tiles) <= TOL
