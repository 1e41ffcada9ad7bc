"""The port's distributed Oseen solve and its drivers
(``fenapack_tpu_torch.parallel.spmd_pcd``, ``spmd_demo``) on the CPU in
f64: against the JAX package's ``SPMDPCDSolver`` where that is cheap, else
against the port's single-device operators and its own 1-rank run.

  * the distributed matvec against ``OseenSolver._matvec_factory``
    (Picard and Newton, 1e-12);
  * one Oseen solve at step l0 (Chebyshev Ap, minimal-residual velocity)
    against JAX's: the same count, x within 1e-8, true residual < 5e-6;
  * 3 Picard steps (pressure multigrid) with 1, 2 and 4 ranks: counts
    within 1 of each other, every rank's state equal bit for bit;
    ``solve_fused`` equal to ``solve``; one Newton step with the velocity
    multigrid (``newton=True``) on 1 and 4 ranks (step l1);
  * theta and BDF2 steps of ``SPMDUnsteadySolver`` against the 1-rank run;
    ``bc_fn`` refused; the preconditioner apply of BRM1 and of the
    enclosed cavity on 2 ranks against 1;
  * one Oseen solve on the 3D duct at level 0 (one hop for 2 ranks), 2
    ranks against 1;
  * ``spmd_demo.main`` with 2 rank processes at l0, both paths by
    default and ``--path gspmd`` alone; the default device is ``cuda``.

Light runs use thread ranks; the multi-step runs use rank processes
(``RankPool``), whose collectives are several times faster here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import spmd_demo
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.fem.dofmap import DirichletBC
from fenapack_tpu_torch.parallel.comm import Comm, RankPool, run_ranks
from fenapack_tpu_torch.parallel.spmd_pcd import (SPMDPCDSolver,
                                                  SPMDUnsteadySolver)
from fenapack_tpu_torch.solvers.config import SolverConfig, overrides
from fenapack_tpu_torch.solvers.nonlinear import NonlinearSolver
from fenapack_tpu_torch.solvers.unsteady import UnsteadySolver

# the settings of tests/test_spmd_pcd.py's solver
OVER = {"pcd.variant": "BRM2", "dtype": "float64", "krylov.rtol": 1e-6,
        "krylov.maxiter": 120, "velocity.bounds": (0.05, 1.97),
        "pcd.ap.method": "chebyshev", "velocity.method": "minres"}


def _threads(fn, size):
    return run_ranks(fn, size, device="cpu", threads=True, timeout=120.0)


def _step(level=0, linearization="picard"):
    asm = NSAssembler(tmesh.backward_step_mesh(level), 0.02, device="cpu",
                      reorder=True)
    bcs = [DirichletBC.velocity(asm.W, [tmesh.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [tmesh.INFLOW],
                                spmd_demo.step_inflow)]
    return NonlinearSolver(asm, bcs, overrides(SolverConfig(), OVER),
                           pcd_marker=tmesh.OUTFLOW,
                           linearization=linearization)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout=300.0) as pool:
        yield pool


@pytest.mark.parametrize("linearization", ["picard", "newton"])
def test_matvec_matches_single_device(linearization):
    nl = _step(0, linearization)
    rng = np.random.default_rng(0)
    w = nl.initial_state()
    w[:nl.n_u] += 0.3 * torch.as_tensor(rng.standard_normal(nl.n_u))
    x = torch.as_tensor(rng.standard_normal(nl.n))
    o = nl.oseen
    ref = o._matvec_factory(*o._operator_values(w[:nl.n_u]))(x).numpy()

    def body(comm):
        sp = SPMDPCDSolver(o, comm)
        ops = sp.build_operands(w[:nl.n_u])
        mv, _ = sp._local_ops(ops)
        x_dm = sp.pack(x[:nl.n_u], x[nl.n_u:])
        y = sp.gather(mv(sp.local(x_dm)))
        return np.concatenate(sp.unpack(y))
    out = _threads(body, 4)
    assert _rel(out[0], ref) < 1e-12
    assert all(np.array_equal(o_, out[0]) for o_ in out)


def test_oseen_solve_matches_jax(pool4):
    """Step l0, the first Picard system, Chebyshev Ap on a ring: the JAX
    package's count (4 devices), x within 1e-8, true residual < 5e-6."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.fem.dofmap import DirichletBC as JBC
    from fenapack_tpu.solvers.config import (SolverConfig as JCfg,
                                             overrides as jover)
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver as JNL
    from fenapack_tpu.parallel.spmd_pcd import SPMDPCDSolver as JSP

    ja = JAsm(jmesh.backward_step_mesh(0), 0.02, dtype=jnp.float64,
              reorder=True)
    jb = [JBC.velocity(ja.W, [jmesh.WALL],
                       lambda x: np.zeros((x.shape[0], 2))),
          JBC.velocity(ja.W, [jmesh.INFLOW], spmd_demo.step_inflow)]
    jover_ = {k: v for k, v in OVER.items()
              if k not in ("pcd.ap.method", "velocity.method")}
    jnl = JNL(ja, jb, jover(JCfg(), jover_))
    jsp = JSP(jnl.oseen, Mesh(np.array(jax.devices()[:4]), ("dd",)),
              cheb_velocity_iters=10, maxiter=120, rtol=1e-6)
    w = jnl.initial_state()
    F = jnl._residual(w)
    b = jsp.pack(np.asarray(-F[:jnl.n_u]), np.asarray(-F[jnl.n_u:]))
    x_j, k_j, _ = jsp.solve(jsp.build_operands(w[:jnl.n_u]), b)

    x_j = np.concatenate(jsp.unpack(np.asarray(x_j)))
    out = pool4.run(spmd_demo.rank_oseen, spmd_demo.spec_of(
        0, ap="cheb", vgmg=False, cheb_velocity_iters=10))
    assert all(np.array_equal(o["x"], out[0]["x"]) for o in out)
    assert out[0]["iters"] == int(k_j)
    assert _rel(out[0]["x"], x_j) < 1e-8
    assert out[0]["lin_rel"] < 5e-6


# --------------------------------------------------------------------- #
# nonlinear runs on rank processes
# --------------------------------------------------------------------- #

def _one_rank(spec):
    return spmd_demo.rank_run(Comm(None, 0, 1, "cpu"), spec)


def _same_state(res):
    """Every rank's state equal bit for bit after every step."""
    return (all(r["digests"] == res[0]["digests"] for r in res)
            and len(res[0]["digests"]) == len(res[0]["iters"]))


PICARD = spmd_demo.spec_of(0, max_steps=3, rtol=0.0)


@pytest.fixture(scope="module")
def picard_runs(pool4):
    """The 3 Picard steps with 1, 2 and 4 ranks."""
    return {1: [_one_rank(PICARD)],
            2: run_ranks(spmd_demo.rank_run, 2, PICARD, device="cpu",
                         timeout=300.0),
            4: pool4.run(spmd_demo.rank_run, PICARD)}


def test_picard_counts_across_rank_counts(picard_runs):
    counts = {n: r[0]["iters"] for n, r in picard_runs.items()}
    assert len(counts[1]) == 3
    for n in (2, 4):
        assert max(abs(a - b) for a, b in zip(counts[n], counts[1])) <= 1, \
            counts
        assert _same_state(picard_runs[n])
        assert _rel(picard_runs[n][0]["w"], picard_runs[1][0]["w"]) < 1e-6
    assert max(picard_runs[4][0]["lin_rel"]) < 5e-6
    assert picard_runs[4][0]["counts"]["exchange"] > 0


def test_solve_fused_equals_solve(pool4, picard_runs):
    fused = pool4.run(spmd_demo.rank_run, dict(PICARD, fused=True))
    ref = picard_runs[4][0]
    assert fused[0]["iters"] == ref["iters"]
    assert _same_state(fused)
    assert _rel(fused[0]["w"], ref["w"]) < 1e-12


def test_newton_velocity_gmg_1_vs_4_ranks(pool4):
    """One Newton step (after one Picard step) with the Newton velocity
    multigrid on the level-1 step: 4 ranks against 1."""
    spec = spmd_demo.spec_of(1, nls="newton", vgmg=True, max_steps=1,
                             rtol=0.0, warm=1)
    four = pool4.run(spmd_demo.rank_run, spec)
    one = _one_rank(spec)
    assert abs(four[0]["iters"][0] - one["iters"][0]) <= 1, (
        four[0]["iters"], one["iters"])
    assert _same_state(four)
    assert _rel(four[0]["w"], one["w"]) < 1e-6
    assert four[0]["lin_rel"][0] < 5e-6


# --------------------------------------------------------------------- #
# unsteady and 3D, thread ranks
# --------------------------------------------------------------------- #

def _channel(scheme, theta=1.0, bc_fn=None):
    asm = NSAssembler(tmesh.channel_mesh(0, length=4.0), 0.02, device="cpu",
                      reorder=True)
    bcs = [DirichletBC.velocity(asm.W, [tmesh.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [tmesh.INFLOW],
                                spmd_demo.step_inflow)]
    return UnsteadySolver(asm, bcs, overrides(SolverConfig(), OVER),
                          dt=0.1, theta=theta, scheme=scheme,
                          pcd_marker=tmesh.OUTFLOW, bc_fn=bc_fn)


@pytest.mark.parametrize("scheme,fused", [("theta", False), ("bdf2", True)])
def test_unsteady_matches_one_rank(scheme, fused):
    us = _channel(scheme, theta=0.5 if scheme == "theta" else 1.0)

    def body(comm):
        s = SPMDUnsteadySolver(us, comm, rtol_lin=1e-8)
        r = (s.solve_fused if fused else s.solve)(0.2)
        return r.linear_iters, r.w.numpy()
    two = _threads(body, 2)
    one = _threads(body, 1)[0]
    assert len(one[0]) == 2
    assert max(abs(a - b) for a, b in zip(two[0][0], one[0])) <= 1
    assert np.array_equal(two[0][1], two[1][1])
    assert _rel(two[0][1], one[1]) < 1e-6


def test_unsteady_refuses_bc_fn():
    us = _channel("theta", bc_fn=lambda t: np.zeros(1))
    with pytest.raises(ValueError, match="bc_fn"):
        SPMDUnsteadySolver(us, Comm(None, 0, 1, "cpu"))


def test_duct_oseen_solve_two_ranks():
    """The 3D duct at level 0 (4,356 dofs, every field ring one hop for 2
    ranks): one Newton-system solve with SUPG, 2 ranks against 1."""
    spec = spmd_demo.spec_of(0, problem="duct", ap="cheb", vgmg=False)
    p = spmd_demo.build_problem(spec, "cpu")
    nl = p["nl"]

    def body(comm):
        sp = SPMDPCDSolver(nl.oseen, comm, maxiter=150)
        w = nl.initial_state()
        F = nl.residual_of(w)[0]
        b = sp.pack(-F[:nl.n_u], -F[nl.n_u:])
        x, k, _ = sp.solve(sp.build_operands(w[:nl.n_u]), b)
        return (np.concatenate(sp.unpack(x)), k, sp.true_relres(x, b),
                sp._rings["a1"].ring.halo)
    two = _threads(body, 2)
    one = _threads(body, 1)[0]
    assert 0 < two[0][3] <= nl.n_u // 3 // 2
    assert abs(two[0][1] - one[1]) <= 1
    assert two[0][2] < 5e-6 and one[2] < 5e-6
    assert _rel(two[0][0], one[0]) < 1e-6


@pytest.mark.parametrize("variant,enclosed", [("BRM1", False),
                                               ("BRM2", True)])
def test_pc_apply_matches_one_rank(variant, enclosed):
    """The distributed preconditioner apply on 2 ranks against 1 rank for
    the branches the solves above do not take: BRM1 (step l0) and the
    enclosed cavity (l0, the constant pressure mode projected out through
    all-reduced sums)."""
    from fenapack_tpu_torch.models import LidDrivenCavity, StepFlow2D
    model = (LidDrivenCavity if enclosed else StepFlow2D)(level=0,
                                                         device="cpu")
    asm = model.assembler(reorder=True)
    nl = NonlinearSolver(asm, model.bcs(asm), overrides(
        SolverConfig(), dict(OVER, **{"pcd.variant": variant})),
        pcd_marker=model.pcd_marker_for(variant), enclosed=enclosed)
    rng = np.random.default_rng(2)
    w = nl.initial_state()
    w[:nl.n_u] += 0.3 * torch.as_tensor(rng.standard_normal(nl.n_u))
    r = torch.as_tensor(rng.standard_normal(nl.n))

    def body(comm):
        sp = SPMDPCDSolver(nl.oseen, comm)
        _, pc = sp._local_ops(sp.build_operands(w[:nl.n_u]))
        z = sp.gather(pc(sp.local(sp.pack(r[:nl.n_u], r[nl.n_u:]))))
        return np.concatenate(sp.unpack(z))
    two = _threads(body, 2)
    one = _threads(body, 1)[0]
    assert np.array_equal(two[0], two[1])
    assert _rel(two[0], one) < 1e-10
    if enclosed:
        assert abs(one[nl.n_u:].mean()) < 1e-12 * np.abs(one).max()


# --------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------- #

def test_demo_main_two_rank_processes(capsys):
    res = spmd_demo.main(["-l", "0", "-n", "2", "--device", "cpu",
                          "--max-steps", "2"])
    out = capsys.readouterr().out
    assert "[ring]  2 devices: full picard solve" in out
    assert "2 ranks on the CPU, gloo" in out
    assert "per FGMRES iteration" in out
    assert len(res) == 2 and len(res[0]["iters"]) == 2
    assert res[0]["counts"]["exchange"] > 0


def test_demo_refuses_gspmd_and_defaults_to_cuda(capsys):
    """``--path gspmd`` is no longer refused: one sharded step at l0 on 2
    rank processes on the CPU, the same state on both ranks; ``--device``
    still defaults to the card and ``--path`` to both paths."""
    res = spmd_demo.main(["--path", "gspmd", "-l", "0", "-n", "2",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[gspmd] 2 devices: one sharded nonlinear step" in out
    assert "2 ranks on the CPU, gloo" in out and "[ring]" not in out
    assert len(res) == 2 and res[0]["digest"] == res[1]["digest"]
    assert 0 < res[0]["iters"] < 80 and res[0]["size"] == 2
    args = spmd_demo.parser().parse_args([])
    assert args.device == "cuda"
    assert args.path == "both"
    # the JAX demo's velocity subsolve unless --supg or --vgmg
    assert not args.vgmg


# --------------------------------------------------------------------- #
# the JAX reference counts of chip_smoke.py's DUCT_JAX_ITERS
# --------------------------------------------------------------------- #

def jax_duct_counts(n_dev: int):
    """The JAX package's counts of the 3D duct's three fused Newton steps
    on ``n_dev`` virtual CPU devices in f64: stage 2 of
    ``__graft_entry__.py`` (``channel_mesh3d(1, length=2)`` refined once,
    29,988 dofs) with x64 enabled.  About 150 s on four cores; run as
    ``python tests/test_torch_spmd_pcd.py [n_dev]``."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from fenapack_tpu.fem import mesh3d, mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.fem.dofmap import DirichletBC as JBC
    from fenapack_tpu.solvers import gmg as jgmg
    from fenapack_tpu.solvers.config import SolverConfig as JCfg, \
        overrides as jover
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver as JNL
    from fenapack_tpu.parallel.spmd_pcd import SPMDNonlinearSolver
    from fenapack_tpu.parallel.spmd_gmg import SPMDPressureGMG, \
        SPMDVelocityGMG
    nu = 0.02
    hier = jgmg.build_hierarchy(mesh3d.channel_mesh3d(1, length=2.0), 1)
    asm = JAsm(hier.fine, nu, dtype=jnp.float64, quad_degree=4,
               reorder=True)
    bcs = [JBC.velocity(asm.W, [jmesh.WALL],
                        lambda x: np.zeros((x.shape[0], 3))),
           JBC.velocity(asm.W, [jmesh.INFLOW], spmd_demo.duct_inflow)]
    nl = JNL(asm, bcs, jover(JCfg(), {
        "pcd.variant": "BRM2", "dtype": "float64", "system_supg": True,
        "krylov.rtol": 1e-6, "krylov.maxiter": 150}),
        linearization="newton")
    dmesh = Mesh(np.array(jax.devices("cpu")[:n_dev]), ("dd",))
    ph = jgmg.PressureHierarchy(hier, jnp.float64,
                                pcd_markers=[jmesh.OUTFLOW])
    vh = jgmg.VelocityHierarchy(hier, nu, jnp.float64,
                                bc_markers=[jmesh.WALL, jmesh.INFLOW])
    snl = SPMDNonlinearSolver(
        nl, dmesh, maxiter=150, rtol_lin=1e-6,
        ap_gmg=SPMDPressureGMG(ph, dmesh, dtype=jnp.float64,
                               smooth_iters=2, cycles=2),
        velocity_gmg=SPMDVelocityGMG(vh, dmesh, dtype=jnp.float64,
                                     smooth_iters=4, cycles=2, supg=True,
                                     newton=True))
    out = snl.solve_fused(max_steps=3, rtol=0.0, damping=0.8)
    return out.linear_iters, out.nonlinear_res


if __name__ == "__main__":
    import os
    import sys
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               f"force_host_platform_device_count={n}")
    print(jax_duct_counts(n))
