"""Solvers of the PyTorch port against the JAX package: FGMRES on a small
nonsymmetric system, single applications of the preconditioner's parts at
level 1 in f64 (agreement to 1e-10 relative, max-norm), and the main-path
Picard + Anderson(6) solve at level 1 end to end (f32 preconditioner, f64
outer FGMRES): per-step outer counts within 1, totals within 3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import bench
from fenapack_tpu_torch.solvers.krylov import fgmres

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_solver(level, dtype):
    """The JAX package's main-path solver (``bench.py::build`` with the
    f64 BSR operators in place of the df32 Pallas matvec, an f64 Krylov
    basis in place of the double-single one, and every level in its RCM
    order, as the port's main path runs)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler
    from fenapack_tpu.fem.dofmap import DirichletBC
    from fenapack_tpu.solvers import gmg
    from fenapack_tpu.solvers.config import SolverConfig, overrides
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver
    pdt = jnp.dtype(dtype)
    hier = gmg.build_hierarchy(jmesh.backward_step_mesh(0), level)
    asm = NSAssembler(hier.fine, 0.02, dtype=jnp.float64, block_size=32,
                      hi_block=True,
                      block_dtype=pdt if dtype == "float32" else None)

    def inflow(x):
        v = np.zeros((x.shape[0], 2))
        v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
        return v

    bcs = [DirichletBC.velocity(asm.W, [jmesh.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [jmesh.INFLOW], inflow)]
    cfg = overrides(SolverConfig(), {
        "dtype": dtype, "pcd.variant": "BRM2", "krylov.hi_krylov": True,
        "krylov.rtol": 2e-6, "krylov.maxiter": 48, "krylov.recycle": 0,
        "krylov.hi_matvec": False, "krylov.df32_matvec": False,
        "krylov.ds_basis": False, "velocity.method": "gmg",
        "velocity.smooth_iters": 3, "velocity.cycles": 2,
        "pcd.ap.method": "gmg"})
    ap_h = gmg.PressureHierarchy(hier, pdt, pcd_markers=[jmesh.OUTFLOW],
                                 block_size=32, reorder=True, fine_asm=asm)
    v_h = gmg.VelocityHierarchy(hier, 0.02, pdt,
                                bc_markers=[jmesh.WALL, jmesh.INFLOW],
                                fine_asm=asm, block_size=32)
    return NonlinearSolver(asm, bcs, cfg, ap_hierarchy=ap_h,
                           velocity_hierarchy=v_h)


# --------------------------------------------------------------------- #
# FGMRES
# --------------------------------------------------------------------- #

def _small_system(n=80, seed=0):
    rng = np.random.default_rng(seed)
    A = 4.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    A += np.diag(rng.uniform(0.0, 3.0, n))           # nonsymmetric, varied
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("reorth_eta", [0.0, 0.707])
def test_fgmres_matches_jax(reorth_eta):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.solvers.krylov import fgmres as jfgmres
    A, b = _small_system()
    dinv = 1.0 / np.diag(A)
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    rt = fgmres(lambda x: At @ x, lambda r: dt * r, torch.as_tensor(b),
                maxiter=60, rtol=1e-10, reorth_eta=reorth_eta)
    rj = jfgmres(lambda x: Aj @ x, lambda r: dj * r, jnp.asarray(b),
                 maxiter=60, rtol=1e-10, reorth_eta=reorth_eta)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    assert _rel(rt.x.numpy(), rj.x) <= TOL
    np.testing.assert_allclose(rt.resnorms, np.asarray(rj.resnorms),
                               rtol=1e-8, atol=1e-300)
    assert np.linalg.norm(b - A @ rt.x.numpy()) <= 1e-10 * np.linalg.norm(b)
    # |b|, one Hessenberg column an iteration, y's copy to the device
    assert rt.host_syncs == rt.iters + 2


def test_fgmres_converged_flag_is_honest():
    """Hitting the Krylov cap is not convergence, in both packages."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.solvers.krylov import fgmres as jfgmres
    A, b = _small_system(seed=1)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    rt = fgmres(lambda x: At @ x, lambda r: r, torch.as_tensor(b),
                maxiter=5, rtol=1e-12)
    rj = jfgmres(lambda x: Aj @ x, lambda r: r, jnp.asarray(b), maxiter=5,
                 rtol=1e-12)
    assert not rt.converged and not bool(rj.converged)
    assert rt.iters == int(rj.iters) == 5
    assert _rel(rt.x.numpy(), rj.x) <= TOL


def test_fgmres_zero_rhs_and_flexible_pc():
    A, b = _small_system(n=40, seed=2)
    At = torch.as_tensor(A)
    zero = torch.zeros(40, dtype=torch.float64)
    r0 = fgmres(lambda x: At @ x, lambda r: r, zero)
    assert r0.converged and r0.iters == 0 and not torch.any(r0.x)
    # a preconditioner that changes from call to call (flexible GMRES)
    calls = []

    def pc(r):
        calls.append(1)
        return r / (3.0 + len(calls) % 3)
    res = fgmres(lambda x: At @ x, pc, torch.as_tensor(b), maxiter=40,
                 rtol=1e-10, reorth_eta=0.707)
    assert res.converged
    assert np.linalg.norm(b - A @ res.x.numpy()) <= 1e-9 * np.linalg.norm(b)


# --------------------------------------------------------------------- #
# preconditioner parts at level 1, f64
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def l1_f64():
    """(port solver, JAX solver, wind) at level 1 with f64 everywhere."""
    nj = _jax_solver(1, "float64")
    nt = bench.build(1, device="cpu", dtype="float64")
    rng = np.random.default_rng(11)
    w0 = np.asarray(nj.initial_state())
    assert _rel(nt.initial_state().numpy(), w0) == 0.0
    wind = w0[:nj.n_u] + 0.1 * rng.standard_normal(nj.n_u)
    return nt, nj, wind, rng


def test_pcd_brm2_apply_matches_jax(l1_f64):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_f64
    x = rng.standard_normal(nj.asm.n1)
    kpt = nt.asm.pat_p1.matrix(nt.asm.kp_values(torch.as_tensor(wind),
                                                surface=True))
    kpj = nj.asm.pat_p1.matrix(nj.asm.kp_values(jnp.asarray(wind),
                                                surface=True))
    zt = nt.oseen.pcd_apply()(kpt, torch.as_tensor(x))
    zj = nj.oseen.pcd_apply(kpj, jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= TOL


def test_pressure_vcycle_matches_jax(l1_f64):
    import jax.numpy as jnp
    nt, nj, _, rng = l1_f64
    x = rng.standard_normal(nj.asm.n1) * (1.0 - np.asarray(nj.oseen.pcd_mask))
    zt = nt.oseen._ap_factory()(torch.as_tensor(x))
    zj = nj.oseen.ap_solve(jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= TOL


def test_velocity_vcycle_matches_jax(l1_f64):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_f64
    r = rng.standard_normal(nj.n_u) * np.asarray(nj.oseen.free_u)
    A1t, Rt = nt.oseen._operator_values(torch.as_tensor(wind))
    A1j, _ = nj.oseen._operator_values(jnp.asarray(wind))
    assert Rt is None                       # Picard: no reaction blocks
    assert _rel(A1t.numpy(), A1j) <= 1e-12
    zt = nt.oseen._velocity_solver(A1t, torch.as_tensor(wind))(
        torch.as_tensor(r))
    zj = nj.oseen._velocity_solver(A1j, None, wind=jnp.asarray(wind))(
        jnp.asarray(r))
    assert _rel(zt.numpy(), zj) <= TOL


def test_fieldsplit_apply_matches_jax(l1_f64):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_f64
    r = rng.standard_normal(nj.n)
    pct = nt.oseen._pipeline(torch.as_tensor(wind))
    _, pcj = nj.oseen._pipeline(jnp.asarray(wind))
    assert _rel(pct(torch.as_tensor(r)).numpy(), pcj(jnp.asarray(r))) <= TOL


def test_high_precision_matvec_matches_jax(l1_f64):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_f64
    x = rng.standard_normal(nj.n)
    A1t, Rt = nt.oseen._operator_values_raw(torch.as_tensor(wind), hi=True)
    A1j, Rj = nj.oseen._operator_values_raw(jnp.asarray(wind), hi=True)
    assert Rt is None and Rj is None
    assert _rel(A1t.numpy(), A1j) <= 1e-6        # f32 convection integrals
    yt = nt.oseen._matvec_factory(torch.as_tensor(np.array(A1j)),
                                  hi=True)(torch.as_tensor(x))
    yj = nj.oseen._matvec_factory(A1j, Rj, hi=True)(jnp.asarray(x))
    assert _rel(yt.numpy(), yj) <= 1e-12


# --------------------------------------------------------------------- #
# the slice end to end at level 1
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def l1_main_path():
    """One level-1 main-path solve in each package, shared by the tests
    below: (port result, JAX state, JAX per-step counts, JAX residuals)."""
    import jax.numpy as jnp
    nj = _jax_solver(1, "float32")
    full_j = nj.make_full_solve(rtol=1e-5, rtol_lin=1e-8, max_steps=25,
                                anderson=6)
    w, k, iters, res = full_j(nj.initial_state().astype(jnp.float64))
    k = int(k)
    iters_j = [int(i) for i in np.asarray(iters)[:k]]
    res_j = np.asarray(res)[:k + 1]

    nt = bench.build(1, device="cpu")
    full_t = nt.make_full_solve(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN,
                                max_steps=bench.MAX_STEPS,
                                anderson=bench.ANDERSON)
    rt = full_t(nt.initial_state().to(torch.float64))
    return rt, np.asarray(w), iters_j, res_j


def test_main_path_level1_matches_jax(l1_main_path):
    rt, _, iters_j, _ = l1_main_path
    assert rt.converged
    assert len(rt.iters) == len(iters_j), (rt.iters, iters_j)
    assert all(abs(a - b) <= 1 for a, b in zip(rt.iters, iters_j)), \
        (rt.iters, iters_j)
    assert abs(sum(rt.iters) - sum(iters_j)) <= 3


def test_main_path_level1_reaches_both_tolerances(l1_main_path):
    rt, _, _, res_j = l1_main_path
    assert rt.res[-1] / rt.res[0] <= 1e-5
    assert res_j[-1] / res_j[0] <= 1e-5
    assert max(rt.lin_rel) <= 1e-8


def test_main_path_level1_state_matches_jax(l1_main_path):
    rt, w, _, _ = l1_main_path
    assert _rel(rt.w.numpy(), w) <= 1e-5


# --------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_pcd_variants_match_jax(variant):
    """The BRM1/BRM2 formulas with the same (diagonal) subsolves and Kp."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.solvers.pcd import make_pcd_apply as jmake
    from fenapack_tpu_torch.ops.sparse import pattern_from_dofmaps
    from fenapack_tpu_torch.solvers.pcd import make_pcd_apply
    from fenapack_tpu.ops.sparse import pattern_from_dofmaps as jpattern
    rng = np.random.default_rng(5)
    cd = rng.integers(0, 90, size=(60, 3))
    vals = rng.standard_normal((60, 3, 3))
    kpt = pattern_from_dofmaps(cd, cd, 90, 90, block=16, device="cpu"
                               ).assemble(torch.as_tensor(vals))
    kpj = jpattern(cd, cd, 90, 90, block=16).assemble(jnp.asarray(vals))
    a, m = rng.uniform(1, 2, 90), rng.uniform(1, 2, 90)
    mask = (rng.uniform(size=90) < 0.2).astype(np.float64)
    x = rng.standard_normal(90)
    zt = make_pcd_apply(variant, lambda r: torch.as_tensor(a) * r,
                        lambda r: torch.as_tensor(m) * r,
                        torch.as_tensor(mask))(kpt, torch.as_tensor(x))
    zj = jmake(variant, lambda r: jnp.asarray(a) * r,
               lambda r: jnp.asarray(m) * r, jnp.asarray(mask))(
        kpj, jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= 1e-13


def test_power_bounds_and_chebyshev_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.ops import subsolve as jsub
    from fenapack_tpu_torch.ops import subsolve
    rng = np.random.default_rng(8)
    B = rng.standard_normal((50, 50))
    A = B @ B.T / 50 + np.eye(50)                   # SPD
    dinv = 1.0 / np.diag(A)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    bt = subsolve.power_bounds(lambda v: At @ v, torch.as_tensor(dinv), 50)
    bj = jsub.power_bounds(lambda v: Aj @ v, jnp.asarray(dinv), 50)
    np.testing.assert_allclose(bt, bj, rtol=1e-10)
    b = rng.standard_normal(50)
    st = subsolve.chebyshev_solver(lambda v: At @ v, torch.as_tensor(dinv),
                                   *bt, iters=6)
    sj = jsub.chebyshev_solver(lambda v: Aj @ v, jnp.asarray(dinv), *bj,
                               iters=6)
    assert _rel(st(torch.as_tensor(b)).numpy(), sj(jnp.asarray(b))) <= TOL


def test_mp_chebyshev_subsolve_matches_jax(l1_f64):
    import jax.numpy as jnp
    nt, nj, _, rng = l1_f64
    x = rng.standard_normal(nj.asm.n1)
    zt = nt.oseen._mp_factory()(torch.as_tensor(x))
    zj = nj.oseen.mp_solve(jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= TOL


def test_transfers_block_and_gather_paths_match_jax():
    """P1/P2 prolongation and restriction at level 1: the BSR path (the
    main path), the gather path and the JAX package's gather path."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.solvers import gmg as jgmg
    from fenapack_tpu_torch.fem import mesh as tmesh
    from fenapack_tpu_torch.solvers import gmg
    ht = gmg.build_hierarchy(tmesh.backward_step_mesh(0), 1)
    hj = jgmg.build_hierarchy(jmesh.backward_step_mesh(0), 1)
    c, f = ht.meshes
    rng = np.random.default_rng(9)
    pairs = [
        (gmg.P1Transfer(ht.parents[0], c.num_vertices, torch.float64,
                        device="cpu", block_size=32),
         gmg.P1Transfer(ht.parents[0], c.num_vertices, torch.float64,
                        device="cpu"),
         jgmg.P1Transfer(hj.parents[0], c.num_vertices, jnp.float64)),
        (gmg.P2Transfer(c, f, torch.float64, device="cpu", block_size=32),
         gmg.P2Transfer(c, f, torch.float64, device="cpu"),
         jgmg.P2Transfer(hj.meshes[0], hj.meshes[1], jnp.float64))]
    for blk, gat, jt in pairs:
        xc = rng.standard_normal(jt.n_coarse)
        rf = rng.standard_normal(jt.n_fine)
        ref_p = np.asarray(jt.prolong(jnp.asarray(xc)))
        ref_r = np.asarray(jt.restrict(jnp.asarray(rf)))
        for t in (blk, gat):
            p = t.prolong(torch.as_tensor(xc)).numpy()
            r = t.restrict(torch.as_tensor(rf)).numpy()
            assert _rel(p, ref_p) <= 1e-14 and _rel(r, ref_r) <= 1e-14


def test_config_carries_only_what_the_port_reads():
    """The main-path configuration, and options of the JAX package that the
    port does not carry raise instead of being ignored."""
    from fenapack_tpu_torch.solvers.config import SolverConfig, overrides
    nt = bench.build(0, device="cpu")
    cfg = nt.oseen.config
    assert (cfg.dtype, cfg.pcd.variant, cfg.pcd.ap.method) == \
        ("float32", "BRM2", "gmg")
    assert (cfg.krylov.maxiter, cfg.velocity.smooth_iters,
            cfg.velocity.cycles) == (bench.MAXITER, 3, 2)
    for key in ("krylov.split_assembly", "pcd.ap.smoother",
                "krylov.ds_basis", "krylov.df32_matvec"):
        with pytest.raises((TypeError, AttributeError)):
            overrides(SolverConfig(), {key: 1})
    # SUPG, GCRO-DR, the factorization-free velocity sweeps and the
    # multi-round refinement's options are carried since they were ported
    c = overrides(SolverConfig(), {"krylov.recycle": 8, "system_supg": True,
                                   "jpc_supg": True, "velocity.iters": 30,
                                   "krylov.hi_krylov": False,
                                   "krylov.hi_matvec": True})
    assert (c.krylov.recycle, c.system_supg, c.jpc_supg,
            c.velocity.iters, c.krylov.hi_krylov,
            c.krylov.hi_matvec) == (8, True, True, 30, False, True)
    # the port's default is the single-round f64 solve
    assert cfg.krylov.hi_krylov and not cfg.krylov.hi_matvec
