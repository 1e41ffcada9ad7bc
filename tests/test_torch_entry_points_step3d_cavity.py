"""The ``step3d`` and ``cavity`` entry points of the PyTorch port at their JAX
demos' surface, against the JAX package run on the same inputs on the CPU
(the cylinder and the repairs: ``test_torch_entry_points.py``).

  * ``step3d``: level 1 with ``--supg --nu 2e-3`` against the JAX demo's
    build (the count equal, states 1e-8), and with ``--dtype float32`` on
    the length-1 step (counts within 1 per step, states 1e-5: the f32
    preconditioner sums in another order).
  * ``cavity``: ``main`` at level 0, Re 50, Picard with BRM1 and BRM2, and a
    continuation to Re 200: every count equal to the JAX demo's path,
    states within 1e-8; the VTK file parses.
"""
import contextlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:              # the limit below only saves time
    threadpool_limits = None

from fenapack_tpu_torch import cavity, step3d
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.utils import default_dtype

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_host_thread():
    """numpy's and scipy's BLAS (the host-side setup of both packages) and
    OpenMP on one thread as well: spinning BLAS threads slow a test many
    times over while the other workers hold the cores."""
    with (threadpool_limits(limits=1) if threadpool_limits
          else contextlib.nullcontext()):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax():
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(ROOT, "demos"))


# --------------------------------------------------------------------- #
# step3d
# --------------------------------------------------------------------- #

def _jax_step3d(argv, steps):
    """The JAX demo's build at level 1 (``--block 0``, the single-round f64
    solve) with ``argv``: ``steps`` Picard steps at the demo's linear
    tolerance."""
    import demo_step3d
    os.environ["FENAPACK_CFG"] = "krylov.hi_krylov=True"
    try:
        return demo_step3d.build(demo_step3d.make_parser().parse_args(
            ["-l", "1", "--block", "0"] + argv)).solve_fused(
            rtol=step3d.RTOL, rtol_lin=1e-7, max_steps=steps)
    finally:
        del os.environ["FENAPACK_CFG"]


def test_step3d_supg_matches_jax_demo(capsys):
    """``step3d -l 1 --supg --nu 2e-3`` through ``main`` against the JAX
    demo's build: the first Picard step at the demo's linear tolerance
    ``max(rtol / 100, 1e-8)``, the same count, states within 1e-8."""
    _jax()
    argv = ["--supg", "--nu", "2e-3"]
    out = step3d.main(["-l", "1", "--device", "cpu", "--max-steps", "1"]
                      + argv)
    assert "rtol_lin=1e-07" in capsys.readouterr().out
    rt, rj = out["result"], _jax_step3d(argv, 1)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    cfg = out["solver"].oseen.config
    assert cfg.system_supg and cfg.krylov.rtol == 1e-8


def test_step3d_float32_counts_match_jax():
    """``step3d -l 1 --length 1 --dtype float32``: two Picard steps within
    one count of the JAX demo's (its f32 preconditioner sums in another
    order) and states within 1e-5, each solve at the demo's linear
    tolerance."""
    _jax()
    argv = ["--dtype", "float32", "--length", "1.0"]
    out = step3d.main(["-l", "1", "--device", "cpu", "--max-steps", "2"]
                      + argv)
    rt, o = out["result"], out["solver"].oseen
    rj = _jax_step3d(argv, 2)
    jits = [int(i) for i in rj.linear_iters]
    assert len(rt.linear_iters) == len(jits) == 2
    assert all(abs(a - b) <= 1 for a, b in zip(rt.linear_iters, jits))
    assert _rel(rt.w.numpy(), rj.w) <= 1e-5
    assert max(rt.lin_rel) <= 1e-7
    assert (o.config.dtype, o.config.krylov.rtol) == ("float32", 2e-6)
    assert o.velocity_hierarchy.dtype == torch.float32
    assert out["solver"].asm.dtype == torch.float64


def test_step3d_command_line_surface():
    nl = step3d.build(1, device="cpu", gmg_levels=1, dtype="float32",
                      velocity_iters=12, maxiter=500)
    o = nl.oseen
    assert (o.config.dtype, o.config.krylov.maxiter,
            o.config.velocity.iters) == ("float32", 120, 12)
    assert len(o.velocity_hierarchy.asms) == 2
    assert o.velocity_hierarchy.dtype == torch.float32
    assert default_dtype("cuda", cuda="float32") == "float32"
    assert step3d.build(0, device="cpu", velocity="lu",
                        maxiter=500).oseen.config.krylov.maxiter == 100


# --------------------------------------------------------------------- #
# cavity
# --------------------------------------------------------------------- #

def _jax_cavity_demo(level, Res, pcd, nls="picard", rtol=1e-5):
    """The JAX demo's loop (``demos/demo_cavity.py``): per stage the
    counts, and the last state."""
    from fenapack_tpu.fem import mesh as jm
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.fem.dofmap import DirichletBC as JBC
    from fenapack_tpu.solvers.config import SolverConfig as JCfg
    from fenapack_tpu.solvers.config import overrides as joverrides
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver as JNL
    mesh = jm.cavity_mesh(level)

    def lid(x):
        v = np.zeros((x.shape[0], 2))
        v[:, 0] = 1.0
        return v

    w, its = None, []
    for Re in Res:
        asm = JAsm(mesh, 1.0 / Re)
        bcs = [JBC.velocity(asm.W, [jm.WALL],
                            lambda x: np.zeros((x.shape[0], 2))),
               JBC.velocity(asm.W, [jm.INFLOW], lid)]
        cfg = joverrides(JCfg(), {"pcd.variant": pcd, "dtype": "float64"})
        res = JNL(asm, bcs, cfg, linearization=nls, enclosed=True).solve(
            w0=w, rtol=rtol, damping=1.0)
        w = res.w
        its.append([int(i) for i in res.linear_iters])
    return its, w


@pytest.mark.parametrize("argv,Res,pcd", [
    (["--Re", "50", "--pcd", "BRM1"], [50.0], "BRM1"),
    (["--Re", "50", "--pcd", "BRM2"], [50.0], "BRM2"),
    (["--Re", "200", "--continuation"], [100.0, 200.0], "BRM2"),
], ids=["BRM1 Re 50", "BRM2 Re 50", "BRM2 Re 100 -> 200"])
def test_cavity_main_matches_jax_demo(tmp_path, capsys, argv, Res, pcd):
    """``cavity -l 0`` through ``main`` against the JAX demo's loop on the
    same stages: every stage's per-step counts equal, the last states
    within 1e-8; the VTK file parses to the mesh."""
    _jax()
    vtk = tmp_path / "cavity.vtk"
    out = cavity.main(["-l", "0", "--device", "cpu", "--vtk", str(vtk)]
                      + argv)
    assert capsys.readouterr().out.count("=== cavity l=0") == len(Res)
    its, w = _jax_cavity_demo(0, Res, pcd)
    assert [r.linear_iters for r in out["results"]] == its
    assert _rel(out["results"][-1].w.numpy(), w) <= 1e-8
    assert all(r.converged for r in out["results"])
    o = out["solver"].oseen
    assert (o.config.velocity.method, o.config.pcd.ap.method) == ("lu",
                                                                 "lu")
    mesh = tmesh.cavity_mesh(0)
    txt = vtk.read_text()
    assert f"POINTS {mesh.num_vertices} float" in txt
    assert f"CELLS {mesh.num_cells} {4 * mesh.num_cells}" in txt


def test_cavity_stages():
    assert cavity.reynolds_stages(500.0, False) == [500.0]
    assert cavity.reynolds_stages(500.0, True) == [100.0, 200.0, 400.0,
                                                   500.0]
    assert cavity.reynolds_stages(400.0, True) == [100.0, 200.0, 400.0]
