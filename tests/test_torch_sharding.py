"""The row-sharded path of the PyTorch port (``parallel/sharding.py``, the
JAX package's GSPMD path) and the alignment padding it needs, on the CPU.

The chain of references: the padded JAX assembler and one padded JAX Oseen
solve hold the padded port on one device; the padded port on one device
holds the unpadded port and the sharded port (``ShardedOseen`` on 4 rank
processes, within ``tests/test_parallel.py``'s own bounds: 1e-8 and 2
iterations for Picard, 1e-6, 3 and under 400 for the SUPG multigrid
step).  Every rank's state is equal bit for bit, and a second step of the
same sharded solver repeats the first.  The ring path takes a padded
assembler with the unpadded counts, and the step's Picard counts on a
padded assembler stay inside the scipy oracle's band."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)

from fenapack_tpu_torch import spmd_demo
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.fem.dofmap import DirichletBC, TaylorHood
from fenapack_tpu_torch.models import LidDrivenCavity, StepFlow2D
from fenapack_tpu_torch.parallel.comm import RankPool, run_ranks
from fenapack_tpu_torch.parallel.sharding import (ShardedOseen,
                                                  make_device_mesh)
from fenapack_tpu_torch.parallel.spmd_pcd import SPMDPCDSolver
from fenapack_tpu_torch.solvers.config import SolverConfig, overrides
from fenapack_tpu_torch.solvers.nonlinear import NonlinearSolver

NU = 0.02
# the JAX package's default subsolves (dense velocity block and Ap)
LU = {"pcd.variant": "BRM2", "velocity.method": "lu", "pcd.ap.method": "lu"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _real(w, asm):
    """The real dofs of a padded state ``[u_x; u_y; p]``."""
    w, n2 = np.asarray(w), asm.n2
    return np.concatenate([w[:asm.n2_real], w[n2:n2 + asm.n2_real],
                           w[2 * n2:2 * n2 + asm.n1_real]])


def _step_nl(row_align, **asm_kw):
    asm = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu",
                      row_align=row_align, **asm_kw)
    bcs = [DirichletBC.velocity(asm.W, [tmesh.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [tmesh.INFLOW],
                                spmd_demo.step_inflow)]
    return NonlinearSolver(asm, bcs, overrides(SolverConfig(), LU),
                           pcd_marker=tmesh.OUTFLOW)


def _first_solve(nl):
    """The first Picard update from the initial state: ``(w1, iters)``."""
    w0 = nl.initial_state()
    F = nl.residual_of(w0)[0].to(nl.oseen.dtype)
    res, _ = nl.oseen.solve(w0[:nl.n_u], -F)
    return (w0 + res.x).numpy(), int(res.iters)


# --------------------------------------------------------------------- #
# the padded layouts against the JAX package
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_padded():
    """The JAX package's padded step assembler (row_align 8) and solver."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.fem.dofmap import DirichletBC as JBC
    from fenapack_tpu.solvers.config import (SolverConfig as JCfg,
                                             overrides as jover)
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver as JNL
    ja = JAsm(jmesh.backward_step_mesh(0), NU, dtype=jnp.float64,
              row_align=8)
    jb = [JBC.velocity(ja.W, [jmesh.WALL],
                       lambda x: np.zeros((x.shape[0], 2))),
          JBC.velocity(ja.W, [jmesh.INFLOW], spmd_demo.step_inflow)]
    return JNL(ja, jb, jover(JCfg(), {"pcd.variant": "BRM2"}))


@pytest.mark.parametrize("align", [8, 5])
def test_taylor_hood_alignment_matches_jax(align):
    """Padded sizes and real sizes of ``TaylorHood(align=)`` (with and
    without the RCM order) equal the JAX package's."""
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.dofmap import TaylorHood as JTH
    for reorder in (False, True):
        t = TaylorHood(tmesh.backward_step_mesh(0), align=align,
                       reorder=reorder)
        j = JTH(jmesh.backward_step_mesh(0), align=align, reorder=reorder)
        assert (t.n2, t.n1, t.V.dim, t.Q.dim) == (j.n2, j.n1, j.V.dim,
                                                  j.Q.dim)
        assert t.n2 % align == 0 and t.n1 % align == 0
        np.testing.assert_array_equal(t.V.cell_dofs, j.V.cell_dofs)


def test_padded_assembler_layout_matches_jax(jax_padded):
    """``NSAssembler(row_align=8)`` at step l0: sizes, active masks, the
    phantom cells and every padded constant operator (``vals``, ``cols``)
    equal the JAX package's; the residual at a seeded state within
    1e-12."""
    import jax.numpy as jnp
    ja = jax_padded.asm
    ta = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu",
                     row_align=8)
    assert (ta.n2, ta.n1, ta.n2_real, ta.n1_real, ta.nc, ta.nc_real) == (
        ja.n2, ja.n1, ja.n2_real, ja.n1_real, ja.nc, ja.nc_real)
    np.testing.assert_array_equal(ta.p_active.numpy(),
                                  np.asarray(ja.p_active))
    np.testing.assert_array_equal(ta.u_active.numpy(),
                                  np.asarray(ja.u_active))
    for name in ("L", "Mp", "Ap", "M2", "D", "DT"):
        ot, oj = getattr(ta.const, name), getattr(ja.const, name)
        ot, oj = (ot, oj) if name in ("D", "DT") else ((ot,), (oj,))
        for a, b in zip(ot, oj):
            np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))
            assert _rel(a.vals.numpy(), b.vals) <= 1e-12, name
    rng = np.random.default_rng(3)
    u = rng.standard_normal(2 * ta.n2) * ta.u_active.numpy()
    p = rng.standard_normal(ta.n1) * ta.p_active.numpy()
    rut, rpt = ta.residual(torch.as_tensor(u), torch.as_tensor(p))
    ruj, rpj = ja.residual(jnp.asarray(u), jnp.asarray(p))
    assert _rel(rut.numpy(), ruj) <= 1e-12
    assert _rel(rpt.numpy(), rpj) <= 1e-12


def test_phantom_cells_contribute_nothing():
    """With a cell axis that does not divide (row_align 5 at step l0), the
    phantom cells carry zero geometry and every assembled value of the
    real rows equals the unpadded assembler's bit for bit."""
    a = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu")
    b = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu",
                    row_align=5)
    assert b.nc > b.nc_real == a.nc and b.nc % 5 == 0
    assert float(b.adet[b.nc_real:].abs().max()) == 0.0
    assert float(b.h_cell[b.nc_real:].abs().max()) == 0.0
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.standard_normal(2 * a.n2))
    ub = torch.zeros(2 * b.n2, dtype=torch.float64)
    ub[:a.n2], ub[b.n2:b.n2 + a.n2] = u[:a.n2], u[a.n2:]
    for f in (lambda s, w: s.convection_values(w),
              lambda s, w: s.supg_values(w),
              lambda s, w: s.newton_reaction_values(w)[1, 0],
              lambda s, w: s.kp_values(w, surface=True)):
        va, vb = f(a, u), f(b, ub)
        assert torch.equal(vb[:va.shape[0]], va)
        assert float(vb[va.shape[0]:].abs().max()) == 0.0


def test_padded_solve_matches_jax(jax_padded):
    """One Oseen solve at step l0 on a row_align 8 assembler (BRM2, f64,
    dense subsolves): the JAX package's count, x within 1e-10."""
    import jax.numpy as jnp
    jnl = jax_padded
    w0j = jnl.initial_state()
    resj = jnl.oseen.solve(w0j[:jnl.n_u], -jnl._residual(w0j))
    nl = _step_nl(8)
    w0 = nl.initial_state()
    np.testing.assert_array_equal(w0.numpy(), np.asarray(w0j))
    F = nl.residual_of(w0)[0]
    res, _ = nl.oseen.solve(w0[:nl.n_u], -F)
    assert int(res.iters) == int(resj.iters)
    assert _rel(res.x.numpy(), np.asarray(resj.x)) <= 1e-10
    assert nl.oseen.has_p_pad and jnp.asarray(resj.x).shape == res.x.shape


# --------------------------------------------------------------------- #
# padded against unpadded in the port
# --------------------------------------------------------------------- #

def test_padded_step_solve_matches_unpadded():
    """Step l0, the first Picard solve: the same count, the real dofs
    within 1e-12, the padding rows zero."""
    w1, k1 = _first_solve(_step_nl(1))
    nl8 = _step_nl(8)
    w8, k8 = _first_solve(nl8)
    assert k8 == k1
    assert _rel(_real(w8, nl8.asm), w1) <= 1e-12
    pad = np.ones_like(w8, dtype=bool)
    pad[np.concatenate([nl8.asm._u_active_np, nl8.asm._p_active_np]) > 0] \
        = False
    assert pad.sum() > 0 and np.all(w8[pad] == 0.0)


def test_padded_enclosed_cavity_matches_unpadded():
    """The enclosed cavity at l0 (Re 50, BRM2 without PCD Dirichlet rows:
    the pressure-mean projections over the real dofs), two Picard steps:
    the same counts, the real dofs within 1e-12."""
    model = LidDrivenCavity(level=0, nu=0.02, device="cpu")
    runs = []
    for align in (1, 8):
        nl = model.solver("BRM2", asm=model.assembler(row_align=align))
        r = nl.solve(rtol=0.0, max_steps=2)
        runs.append((r.linear_iters, _real(r.w.numpy(), nl.asm), nl))
    assert runs[1][2].oseen.has_p_pad and runs[1][2].oseen._nullspace
    assert runs[0][0] == runs[1][0]
    assert _rel(runs[1][1], runs[0][1]) <= 1e-12


@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_padded_step_picard_matches_oracle_counts(variant):
    """``tests/test_solver.py::test_picard_matches_oracle_counts`` on a
    row_align 8 assembler: step level 0, Picard, dense LU subsolves, f64,
    to 1e-3; per-step counts within max(1, 10%) of the exact-LU scipy
    oracle's."""
    from tests.reference_fem.driver import build_step_problem, solve_oracle
    mesh, W, bcs_o = build_step_problem(level=0)
    oracle = solve_oracle(mesh, W, bcs_o, nu=0.02, variant=variant,
                          linearization="picard", max_nl=5, rtol_nl=1e-3)
    model = StepFlow2D(level=0, device="cpu")
    nl = model.solver(variant, asm=model.assembler(row_align=8))
    assert nl.oseen.has_p_pad
    res = nl.solve(rtol=1e-3, max_steps=5)
    assert len(res.linear_iters) >= len(oracle.linear_iters) - 1
    for a, b in zip(res.linear_iters, oracle.linear_iters):
        assert abs(a - b) <= max(1, 0.1 * b), (res.linear_iters,
                                               oracle.linear_iters)
    assert max(res.lin_rel) <= 1e-8


# --------------------------------------------------------------------- #
# ShardedOseen on 4 rank processes
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout=300.0) as pool:
        yield pool


def _sharded(pool, spec):
    """Every rank's run of two steps of one sharded solver; the ranks'
    states equal bit for bit and the second step equal to the first."""
    res = pool.run(spmd_demo.rank_gspmd, spec, 2)
    r0 = res[0]
    assert all(r["digests"] == r0["digests"] for r in res)
    assert r0["digests"][0] == r0["digests"][1]
    assert all(np.array_equal(r["w"], r0["w"]) for r in res)
    assert r0["counts"]["allgather"] > 0 and r0["counts"]["allreduce"] > 0
    return r0


CASES = {
    # tests/test_parallel.py::build: step l0, BRM2, dense subsolves, 1e-8
    "picard": (spmd_demo.gspmd_spec(0, row_align=8, rtol=1e-8,
                                    maxiter=100), 1e-8, 2),
    # tests/test_parallel.py::test_sharded_supg_high_re_step: config 5 at
    # step l1, Re 2000, both multigrids, 1e-6 under 400
    "supg": (spmd_demo.gspmd_spec(1, nu=1e-3, supg=True, row_align=8),
             1e-6, 3),
}


def _against_single_device(pool, spec, tol, dk):
    """The sharded step of ``spec`` (:func:`_sharded`) against the
    unsharded step on the same padded assembler: the real dofs within
    ``tol`` (relative, 2-norm) and the counts within ``dk``."""
    ref = spmd_demo.gspmd_single(spec, "cpu")
    r0 = _sharded(pool, spec)
    nl = spmd_demo.build_gspmd(spec, "cpu")
    err = np.linalg.norm(_real(r0["w"], nl.asm) - _real(ref["w"], nl.asm)) \
        / np.linalg.norm(_real(ref["w"], nl.asm))
    assert err < tol, err
    assert abs(r0["iters"] - ref["iters"]) <= dk
    return r0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_single_device(pool4, case):
    spec, tol, dk = CASES[case]
    r0 = _against_single_device(pool4, spec, tol, dk)
    assert r0["iters"] < (400 if spec["supg"] else spec["maxiter"])
    # the collectives of a step: three all-reduces per FGMRES iteration
    # (the Gram-Schmidt projections and norms), one per norm of b and F
    assert r0["counts"]["allreduce"] == 3 * r0["iters"] + 2


def test_sharded_block_layout_constructs_and_steps(pool4):
    """``tests/test_parallel.py::test_sharded_block_layout_constructs_and_
    steps``: the BSR layout (b = 32, f32 compute constants), whose block
    rows do not divide by the 4 ranks, so every rank holds each BSR
    operator whole and keeps its rows of each product, of the row sums and
    of the diagonal; the step is finite within 100 iterations and, in f32,
    within 1e-4 and 3 iterations of the unsharded step (measured: 1.6e-5,
    28 = 28).  ``chip_smoke.py`` holds the owned block rows of row_align
    128 at step l2 to 3 iterations and, with f32 dense inverses computed
    two ways, 1e-3 and twice one device's true residual."""
    spec = spmd_demo.gspmd_spec(0, row_align=8, block=True, rtol=1e-8,
                                maxiter=100)
    r0 = _against_single_device(pool4, spec, 1e-4, 3)
    assert np.all(np.isfinite(r0["w"]))
    assert 0 < r0["iters"] <= 100


def _sharded_values(comm, wind):
    """The rank's rows of A1, R, Kp (with the surface term) and SUPG from
    the sharded assembly (the rank's cells, partials summed at the owners
    in rank order)."""
    nl = _step_nl(8)
    asm = nl.asm
    ShardedOseen(nl, make_device_mesh(comm.size))
    w = torch.as_tensor(wind)
    return [v.numpy() for v in (
        asm.picard_matrix_values(w), asm.newton_reaction_values(w),
        asm.kp_values(w, surface=True), asm.supg_values(w))]


def test_sharded_assembly_differs_only_in_the_order_of_its_sums():
    """Each rank's rows of the per-step operators (4 thread ranks, step l0,
    a seeded wind) against the single-device values: equal to rounding
    (the partial sums of the ranks' cells meet in rank order), and the
    ranks' rows make up the whole array."""
    asm = _step_nl(8).asm
    wind = np.random.default_rng(5).standard_normal(2 * asm.n2) \
        * asm._u_active_np
    w = torch.as_tensor(wind)
    whole = [v.numpy() for v in (
        asm.picard_matrix_values(w), asm.newton_reaction_values(w),
        asm.kp_values(w, surface=True), asm.supg_values(w))]
    out = run_ranks(_sharded_values, 4, wind, device="cpu", threads=True,
                    timeout=120.0)
    for k, ref in enumerate(whole):
        got = np.concatenate([o[k] for o in out], axis=-2)
        assert got.shape == ref.shape
        # measured: 1.1e-16 (A1), 6.3e-17 (R), 1.2e-16 (Kp), 4.9e-17
        # (SUPG) of the largest value; 0.1-4.8% of the slots differ
        assert _rel(got, ref) <= 1e-15, k


def _mesh_checks(comm):
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_device_mesh(4)
    with pytest.raises(ValueError, match="in a group of 2 ranks"):
        make_device_mesh(1)
    mesh = make_device_mesh(2)
    assert mesh.comm is comm
    with pytest.raises(ValueError, match=r"assembler row_align=1 must be a "
                       r"multiple of the device mesh size 2; build the "
                       r"NSAssembler with row_align=<n_devices>"):
        ShardedOseen(_step_nl(1), mesh)
    return mesh.size, mesh.axis, str(mesh.device)


def test_device_mesh_and_alignment_are_checked():
    """``make_device_mesh`` on 2 thread ranks raises on a group smaller
    than asked (and, here, larger), and outside a rank group asks for the
    card; ``ShardedOseen`` raises on a row_align the mesh does not divide,
    with the JAX package's message."""
    out = run_ranks(_mesh_checks, 2, device="cpu", threads=True,
                    timeout=60.0)
    assert out == [(2, "dd", "cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_device_mesh()


# --------------------------------------------------------------------- #
# the ring path on a padded assembler
# --------------------------------------------------------------------- #

def _ring_solve(comm, row_align):
    asm = NSAssembler(tmesh.backward_step_mesh(0), NU, device="cpu",
                      reorder=True, row_align=row_align)
    bcs = [DirichletBC.velocity(asm.W, [tmesh.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [tmesh.INFLOW],
                                spmd_demo.step_inflow)]
    nl = NonlinearSolver(asm, bcs, overrides(SolverConfig(), {
        "pcd.variant": "BRM2", "krylov.rtol": 1e-6, "krylov.maxiter": 120,
        "pcd.ap.method": "chebyshev", "pcd.ap.bounds": (0.02, 2.0),
        "velocity.method": "minres"}),
        pcd_marker=tmesh.OUTFLOW)
    sp = SPMDPCDSolver(nl.oseen, comm, cheb_velocity_iters=10, maxiter=120,
                       rtol=1e-6)
    w = nl.initial_state()
    F = nl.residual_of(w)[0]
    x, k, _ = sp.solve(sp.build_operands(w[:nl.n_u]),
                       sp.pack(-F[:nl.n_u], -F[nl.n_u:]))
    u, p = sp.unpack(x)
    return int(k), _real(np.concatenate([u, p]), asm)


def test_ring_path_takes_a_padded_assembler():
    """The ring path (2 thread ranks, step l0, Chebyshev Ap over fixed
    bounds: power bounds would start from a vector of the padded length)
    on a row_align 8 assembler: the unpadded assembler's count, x within
    1e-10."""
    out = {ra: run_ranks(_ring_solve, 2, ra, device="cpu", threads=True,
                         timeout=120.0) for ra in (1, 8)}
    assert out[8][0][0] == out[8][1][0] == out[1][0][0]
    assert _rel(out[8][0][1], out[1][0][1]) <= 1e-10
