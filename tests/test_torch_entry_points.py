"""The cylinder's entry point of the PyTorch port at its JAX demo's
surface, and the two repairs the entry points rest on, against the JAX
package run on the same inputs on the CPU in f64 (``step3d`` and
``cavity``: ``test_torch_entry_points_step3d_cavity.py``).

  * ``UnsteadySolver`` takes ``pcd_marker`` as a required keyword: omitted
    it raises; with the outflow rows the JAX demo's channel case
    (``demos/demo_unsteady_channel.py``: ``channel_mesh(0, 2.0)``, nu 0.1,
    dense LU subsolves, dt 0.1, five implicit-Euler steps) gives the JAX
    package's counts and state (1e-8, relative).
  * ``SolverConfig()`` equals the JAX package's field by field except the
    named differences; ``krylov.atol`` stops an Oseen solve where the JAX
    package's does.
  * ``cylinder``: the exact loop of 2D-2 (two BDF2 steps at dt 0.0125,
    three Picard iterations each, the dense cap lowered in both packages)
    through ``main`` against the JAX package's
    ``UnsteadySolver.solve(picard_iters=3)`` with the JAX demo's host
    recording: counts equal, states and the ``(t, c_D, c_L, dP)`` rows
    within 1e-8; 2D-1 by Picard, the first step, count equal to the JAX
    demo's and states within 1e-8; the ``--ls direct`` configuration equal
    to the demo's.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import cylinder
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.fem.dofmap import DirichletBC
from fenapack_tpu_torch.solvers import gmg as tgmg
from fenapack_tpu_torch.solvers.config import (SolverConfig, env_overrides,
                                               overrides)
from fenapack_tpu_torch.solvers.oseen import OseenSolver
from fenapack_tpu_torch.solvers.unsteady import UnsteadySolver
from fenapack_tpu_torch.utils import default_dtype

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's counts of the demo's channel case (five steps)
CHANNEL_ITERS = [15, 15, 15, 14, 14]
# SolverConfig fields whose defaults differ on purpose: (port, JAX)
INTENDED = {"krylov.hi_krylov": (True, False)}
# the JAX package's TPU workarounds, not carried by the port
JAX_ONLY = {"krylov.split_assembly", "krylov.df32_matvec", "krylov.ds_basis",
            "pcd.ap.smoother", "pcd.mp.smoother"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax():
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(ROOT, "demos"))


def _flat(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def _inflow(x):
    v = np.zeros((x.shape[0], 2))
    v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
    return v


def _channel(pkg):
    """(assembler, bcs) of the demo's channel case in ``pkg``'s modules."""
    if pkg == "port":
        asm = NSAssembler(tmesh.channel_mesh(0, length=2.0), 0.1,
                          device="cpu")
        m, bc = tmesh, DirichletBC
    else:
        from fenapack_tpu.fem import mesh as m
        from fenapack_tpu.fem.assemble import NSAssembler as JAsm
        from fenapack_tpu.fem.dofmap import DirichletBC as bc
        asm = JAsm(m.channel_mesh(0, length=2.0), 0.1)
    return asm, [bc.velocity(asm.W, [m.WALL],
                             lambda x: np.zeros((x.shape[0], 2))),
                 bc.velocity(asm.W, [m.INFLOW], _inflow)]


# --------------------------------------------------------------------- #
# the two repairs
# --------------------------------------------------------------------- #

def test_unsteady_pcd_marker_is_required_and_outflow_matches_jax():
    _jax()
    from fenapack_tpu.solvers.config import SolverConfig as JCfg
    from fenapack_tpu.solvers.unsteady import UnsteadySolver as JUS
    asm, bcs = _channel("port")
    with pytest.raises(TypeError, match="pcd_marker"):
        UnsteadySolver(asm, bcs, SolverConfig(), dt=0.1)
    rt = UnsteadySolver(asm, bcs, SolverConfig(), dt=0.1,
                        pcd_marker=tmesh.OUTFLOW).solve(0.5)
    ja, jb = _channel("jax")
    rj = JUS(ja, jb, JCfg(), dt=0.1).solve(0.5)
    assert rt.linear_iters == CHANNEL_ITERS
    assert [int(i) for i in rj.linear_iters] == CHANNEL_ITERS
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8


def test_solver_config_defaults_match_jax(monkeypatch):
    _jax()
    from fenapack_tpu.solvers.config import SolverConfig as JCfg
    port, jax_ = _flat(SolverConfig()), _flat(JCfg())
    assert set(jax_) - set(port) == JAX_ONLY
    assert set(port) <= set(jax_)
    diff = {k: (port[k], jax_[k]) for k in port if port[k] != jax_[k]}
    assert diff == INTENDED
    assert (port["velocity.method"], port["pcd.ap.method"]) == ("lu", "lu")
    monkeypatch.setenv("FENAPACK_CFG", "krylov.atol=1e-3")
    assert env_overrides(SolverConfig()).krylov.atol == 1e-3


def test_krylov_atol_stops_the_oseen_solve_where_jax_does():
    """The first Picard system of the step at level 0 (LU subsolves): an
    absolute floor of 1e-4 |b| ends FGMRES early, at the JAX package's
    iteration, with the estimate below the floor."""
    _jax()
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jm
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.fem.dofmap import DirichletBC as JBC
    from fenapack_tpu.solvers.config import SolverConfig as JCfg
    from fenapack_tpu.solvers.config import overrides as joverrides
    from fenapack_tpu.solvers.oseen import OseenSolver as JOseen
    from fenapack_tpu_torch.solvers.nonlinear import NonlinearSolver
    ta = NSAssembler(tmesh.backward_step_mesh(0), 0.02, device="cpu")
    tb = [DirichletBC.velocity(ta.W, [tmesh.WALL],
                               lambda x: np.zeros((x.shape[0], 2))),
          DirichletBC.velocity(ta.W, [tmesh.INFLOW], _inflow)]
    ja = JAsm(jm.backward_step_mesh(0), 0.02)
    jb = [JBC.velocity(ja.W, [jm.WALL], lambda x: np.zeros((x.shape[0], 2))),
          JBC.velocity(ja.W, [jm.INFLOW], _inflow)]
    nl = NonlinearSolver(ta, tb, SolverConfig(), pcd_marker=tmesh.OUTFLOW)
    w = nl.initial_state()
    b = -nl.residual_of(w)[0]
    bnorm = float(torch.linalg.norm(b))
    its = {}
    for atol in (0.0, 1e-4 * bnorm):
        cfg = {"krylov.atol": atol}
        o = OseenSolver(ta, tb, overrides(SolverConfig(), cfg),
                        pcd_marker=tmesh.OUTFLOW)
        rt, _ = o.solve(w[:o.n_u], b)
        rj = JOseen(ja, jb, joverrides(JCfg(), cfg)).solve(
            jnp.asarray(w[:o.n_u].numpy()), jnp.asarray(b.numpy()))
        its[atol] = int(rt.iters)
        assert its[atol] == int(rj.iters)
        assert rt.resnorms[its[atol]] <= max(1e-8 * bnorm, atol)
    assert its[1e-4 * bnorm] < its[0.0]


# --------------------------------------------------------------------- #
# cylinder
# --------------------------------------------------------------------- #

def _jax_record(asm, n_u, dt, re, rows):
    """The JAX demo's ``record`` (``demos/demo_cylinder.py``): the host
    functionals with the backward difference as du/dt."""
    from fenapack_tpu.fem import mesh as jm
    from fenapack_tpu.utils.functionals import boundary_reaction, eval_p1
    prev = {"u": None}
    coeff = 2.0 / (cylinder.UBAR[re] ** 2 * cylinder.D)

    def record(k, t, w):
        u = w[:n_u]
        du_dt = None if prev["u"] is None else (u - prev["u"]) / dt
        prev["u"] = u
        F = boundary_reaction(asm, u, w[n_u:], [jm.CYLINDER], du_dt=du_dt)
        dp = eval_p1(asm, np.asarray(w[n_u:]), [(0.15, 0.2), (0.25, 0.2)])
        rows.append((t, coeff * F[0], coeff * F[1], dp[0] - dp[1]))
    return record


def test_cylinder_exact_loop_matches_jax(tmp_path, capsys, monkeypatch):
    """``cylinder --unsteady -l 0 --dtype float64`` to t = 2 dt: the exact
    loop against the JAX package's with the demo's recording.  The dense
    cap is lowered in both packages below the level-0 P1 bottom (4,764
    dofs): its inverse, rebuilt for each of the six Picard solves, takes 6 s
    on one CPU thread; the bottom becomes minimal-residual sweeps."""
    _jax()
    import demo_cylinder
    from fenapack_tpu.solvers.unsteady import UnsteadySolver as JUS
    monkeypatch.setattr(tgmg, "DENSE_MAX", 4096)
    monkeypatch.setenv("FENAPACK_GMG_DENSE_MAX", "4096")
    dt = 0.0125
    hist = tmp_path / "hist.csv"
    out = cylinder.main(["-l", "0", "--unsteady", "--dtype", "float64",
                         "--t-end", str(2 * dt), "--device", "cpu",
                         "--hist", str(hist)])
    assert "DFG 2D-2:" in capsys.readouterr().out
    rt, us = out["result"], out["solver"]
    assert us.oseen.pcd_marker == tmesh.OUTFLOW and us.scheme == "bdf2"
    asm, bcs, cfg, ap_h, v_h, _ = demo_cylinder.build(
        0, 100, "float64", ls="iterative", unsteady=True)
    rows = []
    rj = JUS(asm, bcs, cfg, dt=dt, scheme="bdf2", ap_hierarchy=ap_h,
             velocity_hierarchy=v_h).solve(
        2 * dt, picard_iters=3,
        callback=_jax_record(asm, 2 * asm.n2, dt, 100, rows))
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    ref = np.array(rows)
    assert out["hist"].shape == ref.shape == (2, 4)
    assert np.abs(out["hist"] - ref).max() <= 1e-8 * np.abs(ref).max()
    assert np.allclose(np.loadtxt(hist, delimiter=",", skiprows=1),
                       out["hist"], rtol=1e-9, atol=0.0)


def test_cylinder_picard_2d1_counts_match_jax():
    """2D-1 by Picard at level 0 (``--nls picard``: the port's ``build``
    against the JAX demo's): the first step's count equal, states within
    1e-8.  Each package inverts the 4,764-dof P1 bottom once (6 s)."""
    _jax()
    import demo_cylinder
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver as JNL
    rt = cylinder.build(0, 20, device="cpu", nls="picard").solve(
        rtol=cylinder.RTOL, max_steps=1)
    asm, bcs, cfg, ap_h, v_h, _ = demo_cylinder.build(
        0, 20, "float64", ls="iterative", nls="picard")
    rj = JNL(asm, bcs, cfg, linearization="picard", ap_hierarchy=ap_h,
             velocity_hierarchy=v_h).solve(rtol=cylinder.RTOL, max_steps=1)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    assert max(rt.lin_rel) <= 1e-8


def test_cylinder_direct_configuration_matches_demo():
    """``--ls direct``: dense LU subsolves without hierarchies, the demo's
    configuration and boundary data (solved on the card only: the level-0
    velocity block is 18,572 x 18,572)."""
    _jax()
    import demo_cylinder
    nl = cylinder.build(0, 20, device="cpu", ls="direct")
    asm, bcs, cfg, ap_h, v_h, _ = demo_cylinder.build(0, 20, "float64",
                                                      ls="direct")
    o = nl.oseen
    assert ap_h is None and v_h is None
    assert o.ap_hierarchy is None and o.velocity_hierarchy is None
    port, jax_ = _flat(o.config), _flat(cfg)
    assert {k: (port[k], jax_[k]) for k in port
            if port[k] != jax_[k]} == INTENDED
    assert (o.pcd_marker, o.linearization, nl.n) == (
        tmesh.OUTFLOW, "newton", 2 * asm.n2 + asm.n1)
    mask, vals = o.bc_mask_u.numpy(), o.bc_vals_u.numpy()
    from fenapack_tpu.fem.dofmap import merge_bcs as jmerge
    jmask, jvals = jmerge(bcs, 2 * asm.n2)
    assert np.array_equal(mask, jmask) and np.abs(vals - jvals).max() == 0.0


def test_cylinder_command_line_surface():
    ap = cylinder.parser()
    a = ap.parse_args([])
    assert (a.level, a.nls, a.ls, a.dtype, a.rtol, a.t_end, a.dt,
            a.maxiter, a.device) == (1, "newton", "iterative", None, 1e-6,
                                     8.0, 0.0125, None, "cuda")
    assert default_dtype("cpu") == "float64"
    assert default_dtype("cuda") == "mixed"
    assert default_dtype("cpu", cuda="float32") == "float64"
    assert default_dtype("cuda", cuda="float32") == "float32"
    nl = cylinder.build(0, 20, device="cpu", dtype="mixed", maxiter=60)
    o = nl.oseen
    assert (o.config.dtype, o.config.krylov.maxiter) == ("float32", 60)
    assert nl.asm.dtype == torch.float64
    assert o.velocity_hierarchy.dtype == torch.float32
