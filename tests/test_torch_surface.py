"""The rest of the port's single-device surface against the JAX package on
the CPU: the body-force load (``NSAssembler.set_body_force``) and the
method of manufactured solutions through it, ``save_vtk``, ``Timings``,
``env_overrides``, the bench's ``stage_breakdown``, the two entry points
``navier_stokes_pcd`` and ``unsteady_channel``, and the step level-0
Picard counts against the live scipy oracle (BRM1 and BRM2).

The MMS problem is ``tests/test_mms.py``'s: the exact Navier-Stokes
solution ``u = (sin(pi x) cos(pi y), -cos(pi x) sin(pi y))``, ``p = sin(pi
x) sin(pi y)`` on the unit square, nu = 1, enclosed flow, dense LU
subsolves; its rates at n = 8 and 16 are held to that test's assertions.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import bench, navier_stokes_pcd, unsteady_channel
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem import mesh3d as tmesh3d
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.fem.dofmap import DirichletBC
from fenapack_tpu_torch.models import StepFlow2D
from fenapack_tpu_torch.solvers.config import (SolverConfig, env_overrides,
                                               overrides)
from fenapack_tpu_torch.solvers.nonlinear import NonlinearSolver
from fenapack_tpu_torch.utils.io import save_vtk
from fenapack_tpu_torch.utils.timing import Timings

NU = 1.0


def u_exact(x):
    s_x, c_x = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
    s_y, c_y = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
    return np.stack([s_x * c_y, -c_x * s_y], axis=1)


def p_exact(x):
    return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])


def body_force(x):
    """``-nu lap(u) + (u . grad) u + grad p`` of the exact solution."""
    s_x, c_x = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
    s_y, c_y = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
    pi = np.pi
    f1 = (2 * NU * pi**2 * s_x * c_y + 0.5 * pi * np.sin(2 * pi * x[:, 0])
          + pi * c_x * s_y)
    f2 = (-2 * NU * pi**2 * c_x * s_y + 0.5 * pi * np.sin(2 * pi * x[:, 1])
          + pi * s_x * c_y)
    return np.stack([f1, f2], axis=1)


def _mark_all(mesh):
    mesh.mark_boundary({tmesh.WALL: lambda x: np.ones(x.shape[0], bool)},
                       overwrite=True)
    return mesh


def _force3(x):
    f = np.zeros((x.shape[0], 3))
    f[:, :2] = body_force(x[:, :2])
    return f


# --------------------------------------------------------------------- #
# the body force and the manufactured solution
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dim", [2, 3])
def test_body_force_load_matches_jax(dim):
    """The load ``int f . v`` equal to the JAX package's to 1e-14 on the
    2D MMS mesh (8 x 8) and on a 3D box at level 0 (3 x 3 x 3 tets,
    quadrature degree 4), and ``residual`` lowered by exactly it."""
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem import mesh3d as jmesh3d
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    if dim == 2:
        mt = _mark_all(tmesh.rectangle_mesh(0.0, 0.0, 1.0, 1.0, 8, 8))
        mj = jmesh.rectangle_mesh(0.0, 0.0, 1.0, 1.0, 8, 8)
        f, kw = body_force, {}
    else:
        mt = _mark_all(tmesh3d.box_mesh(0, 0, 0, 1, 1, 1, 3, 3, 3))
        mj = jmesh3d.box_mesh(0, 0, 0, 1, 1, 1, 3, 3, 3)
        f, kw = _force3, {"quad_degree": 4}
    mj.mark_boundary({jmesh.WALL: lambda x: np.ones(x.shape[0], bool)},
                     overwrite=True)
    at = NSAssembler(mt, NU, device="cpu", **kw)
    aj = JAsm(mj, NU, **kw)
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal(dim * at.n2))
    p = torch.as_tensor(rng.standard_normal(at.n1))
    ru0, _ = at.residual(u, p)
    at.set_body_force(f)
    aj.set_body_force(f)
    load, ref = at._load_u.numpy(), np.asarray(aj._load_u)
    assert load.shape == ref.shape == (dim * at.n2,)
    assert np.abs(load - ref).max() <= 1e-14 * np.abs(ref).max()
    assert at._load_u.dtype == torch.float64
    ru1, _ = at.residual(u, p)
    assert torch.equal(ru1, ru0 - at._load_u)


def _mms_errors(n):
    asm = NSAssembler(_mark_all(tmesh.rectangle_mesh(0.0, 0.0, 1.0, 1.0,
                                                     n, n)), NU, device="cpu")
    asm.set_body_force(body_force)
    bcs = [DirichletBC.velocity(asm.W, [tmesh.WALL], u_exact)]
    cfg = overrides(SolverConfig(), {
        "pcd.variant": "BRM2", "krylov.rtol": 1e-10, "krylov.maxiter": 200,
        "velocity.method": "lu", "pcd.ap.method": "lu"})
    nl = NonlinearSolver(asm, bcs, cfg, pcd_marker=None, enclosed=True)
    res = nl.solve(rtol=1e-8, max_steps=30)
    assert res.converged
    w = res.w.numpy()
    n2 = asm.n2
    ue = u_exact(asm.W.V.dof_coords())
    err_u = np.sqrt(np.mean((np.stack([w[:n2], w[n2:2 * n2]]) - ue.T) ** 2))
    ph, pe = w[2 * n2:], p_exact(asm.W.Q.dof_coords())
    err_p = np.sqrt(np.mean(((ph - ph.mean()) - (pe - pe.mean())) ** 2))
    return err_u, err_p


def test_mms_spatial_convergence():
    """The assertions of ``tests/test_mms.py::test_mms_spatial_convergence``:
    P2 velocity error ratio > 6 and P1 pressure ratio > 3 from n = 8 to
    16, and an accurate coarse solve."""
    eu8, ep8 = _mms_errors(8)
    eu16, ep16 = _mms_errors(16)
    assert eu8 / eu16 > 6.0, (eu8, eu16)
    assert ep8 / ep16 > 3.0, (ep8, ep16)
    assert eu8 < 5e-3 and ep8 < 5e-2, (eu8, ep8)


# --------------------------------------------------------------------- #
# save_vtk, Timings, env_overrides
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dim", [2, 3])
def test_save_vtk_equals_jax(dim, tmp_path):
    """The same state written by both packages gives the same bytes (2D
    step level 0; 3D box 2 x 2 x 2), with POINTS and CELLS of the mesh."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem import mesh3d as jmesh3d
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.utils.io import save_vtk as jsave_vtk
    if dim == 2:
        mt, mj, kw = (tmesh.backward_step_mesh(0), jmesh.backward_step_mesh(0),
                      {})
    else:
        mt = tmesh3d.box_mesh(0, 0, 0, 1, 1, 1, 2, 2, 2)
        mj = jmesh3d.box_mesh(0, 0, 0, 1, 1, 1, 2, 2, 2)
        kw = {"quad_degree": 4}
    at, aj = NSAssembler(mt, 0.02, device="cpu", **kw), JAsm(mj, 0.02, **kw)
    w = np.random.default_rng(dim).standard_normal(dim * at.n2 + at.n1)
    save_vtk(str(tmp_path / "port.vtk"), at, torch.as_tensor(w))
    jsave_vtk(str(tmp_path / "jax.vtk"), aj, jnp.asarray(w))
    port = (tmp_path / "port.vtk").read_bytes()
    assert port == (tmp_path / "jax.vtk").read_bytes()
    txt = port.decode()
    assert f"POINTS {mt.num_vertices} float" in txt
    assert f"CELLS {mt.num_cells} {(dim + 2) * mt.num_cells}" in txt


def test_timings_report_matches_jax():
    pytest.importorskip("jax")
    from fenapack_tpu.utils.timing import Timings as JTimings
    t, tj = Timings("cpu"), JTimings()
    for _ in range(3):
        with t("assembly"):
            pass
    with t("solve"):
        pass
    assert dict(t.count) == {"assembly": 3, "solve": 1}
    assert all(v >= 0.0 for v in t.total.values())
    for name, (tot, cnt) in {"assembly": (1.25, 3), "solve": (0.5, 1)}.items():
        t.total[name], t.count[name] = tot, cnt
        tj.total[name], tj.count[name] = tot, cnt
    rep = t.report()
    assert rep == tj.report()
    assert rep.splitlines()[1].split() == ["assembly", "3", "1.250",
                                           "416.67"]


def test_env_overrides(monkeypatch):
    monkeypatch.setenv("FENAPACK_CFG", "krylov.hi_krylov=False, "
                       "krylov.maxiter=60,pcd.variant=BRM1,"
                       "krylov.ir_attainable=1e-7")
    c = env_overrides(SolverConfig())
    assert (c.krylov.hi_krylov, c.krylov.maxiter, c.pcd.variant,
            c.krylov.ir_attainable) == (False, 60, "BRM1", 1e-7)
    monkeypatch.setenv("FENAPACK_CFG", "")
    assert env_overrides(SolverConfig()) == SolverConfig()
    # a TPU workaround the port does not carry
    monkeypatch.setenv("FENAPACK_CFG", "krylov.split_assembly=True")
    with pytest.raises(TypeError):
        env_overrides(SolverConfig())


# --------------------------------------------------------------------- #
# the bench's stage breakdown
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("hi_krylov", [True, False])
def test_stage_breakdown_on_cpu(hi_krylov):
    """The seven keys of the JAX package's ``bench.py::stage_breakdown``,
    finite, every stage time > 0 (the host clock on the CPU), for the
    default f64 outer matvec and for the rounds' f32 one."""
    nl = bench.build(0, device="cpu",
                     over={"krylov.hi_krylov": hi_krylov})
    w = nl.initial_state().to(torch.float64)
    sb = bench.stage_breakdown(nl, w, 1.0, 100, n_apply=3)
    assert list(sb) == ["per_outer_iter_ms", "outer_matvec_ms",
                        "pc_apply_ms", "pc_velocity_solve_ms",
                        "pc_pcd_apply_ms", "pc_bt_mv_ms",
                        "krylov_algebra_and_loop_ms"]
    assert all(np.isfinite(v) for v in sb.values())
    assert all(v > 0 for k, v in sb.items()
               if k != "krylov_algebra_and_loop_ms")
    assert sb["per_outer_iter_ms"] == 10.0


def test_bench_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.run(0, device="cpu")


def test_ir_modes_on_cpu():
    """The IR A/B's two modes at step level 0: the benchmark's solver as
    it is (one f64 round per solve) and with ``bench.IR_ROUNDS`` (the
    multi-round refinement), each converging with every solve at a true
    1e-8."""
    modes = bench.ir_modes(0, device="cpu", warmup_steps=1)
    assert list(modes) == [m for m, _ in bench.IR_MODES]
    for mode, (nl, full, w0) in modes.items():
        k = nl.oseen.config.krylov
        assert k.hi_krylov == (mode == "hi_krylov")
        if mode == "rounds":
            assert (k.rtol, k.recycle, k.maxiter) == (2e-6, 16, 120)
        r = full(w0)
        assert r.converged and max(r.lin_rel) <= bench.RTOL_LIN
        assert all(n == 1 for n in r.rounds) == (mode == "hi_krylov")


def test_ir_ab_refuses_the_cpu():
    from fenapack_tpu_torch import ir_ab
    with pytest.raises(RuntimeError, match="CUDA device"):
        ir_ab.main(["--pairs", "1"])


# --------------------------------------------------------------------- #
# the entry points
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("argv", [
    ["-l", "0"],
    ["-l", "1", "--ls", "iterative", "--dtype", "mixed"],
])
def test_navier_stokes_pcd_runs_on_cpu(argv, capsys, tmp_path):
    navier_stokes_pcd.main(argv + ["--device", "cpu", "--vtk",
                                   str(tmp_path / "w.vtk")])
    out = capsys.readouterr().out
    assert "converged: True" in out, out
    assert "FGMRES iters per step: [" in out and "wall time:" in out
    assert "nonlinear solve" in out           # the Timings table
    assert (tmp_path / "w.vtk").exists()


def test_unsteady_channel_runs_and_resumes_on_cpu(capsys, tmp_path,
                                                  monkeypatch):
    """BDF2 on the level-0 channel, VTK files into the working directory,
    then a resume from the checkpoint for one more step."""
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "state.npz")
    base = ["-l", "0", "--dt", "0.1", "--scheme", "bdf2", "--device", "cpu",
            "--checkpoint", ck]
    unsteady_channel.main(base + ["--t-end", "0.4", "--vtk-every", "2"])
    out = capsys.readouterr().out
    assert out.count("fgmres iters") == 4 and "wall:" in out, out
    assert sorted(os.listdir(tmp_path)) == ["channel_0002.vtk",
                                            "channel_0004.vtk", "state.npz"]
    unsteady_channel.main(base + ["--t-end", "0.5", "--fused"])
    out = capsys.readouterr().out
    assert "resumed from" in out and out.count("fgmres iters") == 1, out
    assert "t= 0.500" in out and "wall:" in out


@pytest.mark.parametrize("mod", [navier_stokes_pcd, unsteady_channel])
def test_entry_points_default_to_cuda(mod):
    assert mod.parser().parse_args([]).device == "cuda"


def test_unsteady_scan_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        unsteady_channel.main(["--scan", "--device", "cpu"])
    assert e.value.code == 2
    assert "--scan is not ported" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# the step against the live scipy oracle
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_step_picard_matches_oracle_counts(variant):
    """``tests/test_solver.py::test_picard_matches_oracle_counts`` for the
    port: step level 0, Picard, dense LU subsolves, f64, to 1e-3; per-step
    counts within max(1, 10%) of the exact-LU scipy oracle's."""
    from tests.reference_fem.driver import build_step_problem, solve_oracle
    mesh, W, bcs_o = build_step_problem(level=0)
    oracle = solve_oracle(mesh, W, bcs_o, nu=0.02, variant=variant,
                          linearization="picard", max_nl=5, rtol_nl=1e-3)
    res = StepFlow2D(level=0, device="cpu").solver(variant).solve(
        rtol=1e-3, max_steps=5)
    assert len(res.linear_iters) >= len(oracle.linear_iters) - 1
    for a, b in zip(res.linear_iters, oracle.linear_iters):
        assert abs(a - b) <= max(1, 0.1 * b), (res.linear_iters,
                                               oracle.linear_iters)
    assert max(res.lin_rel) <= 1e-8
