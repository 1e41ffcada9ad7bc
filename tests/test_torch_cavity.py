"""The lid-driven cavity slice of the PyTorch port (Newton, enclosed-flow
PCD, ELL layout, f64) against the JAX package and the scipy oracle's golden
counts, on the CPU.

  * At level 1, from one random wind made with numpy: the Newton reaction
    values (1e-12 relative, max-norm; 1e-6 with f32 integrals), the Newton
    system matvec on values carried across by ``interop`` (1e-12), the
    enclosed PCD-BRM2 apply with pressure multigrid, the pure-Neumann
    pressure V-cycle and one Newton velocity V-cycle (1e-10).
  * The oracle: cavity level 0, Picard, Re 50, LU subsolves, BRM1 and BRM2:
    per-step counts inside the golden 10% band and within 1 of the JAX
    package's.
  * The slice end to end: ``LidDrivenCavity(level=1)``, Newton, BRM2,
    multigrid subsolves, Reynolds continuation 100 -> 200 in both packages:
    per-step counts within 1, final states within 1e-8 relative.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)

from fenapack_tpu_torch import interop
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.models import LidDrivenCavity, StepFlow2D

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_counts.json")
# the slice's multigrid and Krylov settings, in both packages
MG = {"velocity.smooth_iters": 3, "velocity.cycles": 2,
      "krylov.maxiter": 200}
TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_cavity(level, nu, pcd="BRM2", linearization="newton",
                gmg_subsolves=True, **over):
    pytest.importorskip("jax")
    from fenapack_tpu.models import LidDrivenCavity as JCavity
    return JCavity(level=level, nu=nu).solver(
        pcd, linearization=linearization, gmg_subsolves=gmg_subsolves,
        **over)


def _port_cavity(level, nu, pcd="BRM2", linearization="newton",
                 gmg_subsolves=True, **over):
    return LidDrivenCavity(level=level, nu=nu, device="cpu").solver(
        pcd, linearization=linearization, gmg_subsolves=gmg_subsolves,
        **over)


# --------------------------------------------------------------------- #
# mesh and model entry points
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("level", [0, 1])
def test_cavity_mesh_matches_jax(level):
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh as jmesh
    mt, mj = tmesh.cavity_mesh(level), jmesh.cavity_mesh(level)
    for name in ("vertices", "cells", "edges", "boundary_facets",
                 "facet_markers"):
        np.testing.assert_array_equal(getattr(mt, name), getattr(mj, name))
    assert set(np.unique(mt.facet_markers)) == {tmesh.WALL, tmesh.INFLOW}


def test_model_entry_points_default_to_the_card():
    assert LidDrivenCavity().device == "cuda"
    assert StepFlow2D().device == "cuda"
    p = LidDrivenCavity(level=0, device="cpu")
    assert p.enclosed() and p.pcd_marker_for("BRM2") is None
    assert p.pcd_marker_for("BRM1") == tmesh.INFLOW
    from fenapack_tpu_torch.solvers.unsteady import UnsteadySolver
    assert isinstance(p.solver("BRM2", unsteady=0.1), UnsteadySolver)
    with pytest.raises(NotImplementedError):
        LidDrivenCavity(dim=3, device="cpu").mesh()


def test_model_solver_configuration():
    nl = _port_cavity(1, 0.01, **MG)
    o = nl.oseen
    cfg = o.config
    assert (cfg.dtype, cfg.pcd.variant, cfg.velocity.method,
            cfg.pcd.ap.method) == ("float64", "BRM2", "gmg", "gmg")
    assert (cfg.velocity.smooth_iters, cfg.velocity.cycles,
            cfg.krylov.maxiter, cfg.krylov.rtol) == (3, 2, 200, 1e-8)
    assert o.linearization == "newton" and nl.enclosed
    assert not o.has_pcd_bcs and o.pcd_mask is None and o._nullspace
    assert o.ap_hierarchy.pcd_markers == ()
    assert all(lev.mask is None for lev in o.ap_hierarchy.levels)
    assert len(o.velocity_hierarchy.asms) == 2
    # the ELL layout in f64, int32 columns, as the JAX models build it
    assert nl.asm.block_size is None
    assert nl.asm.pat_p2.cols.dtype == torch.int32
    assert nl.asm.const.L.vals.dtype == torch.float64
    lu = _port_cavity(0, 0.02, pcd="BRM1", linearization="picard",
                      gmg_subsolves=False).oseen
    assert (lu.config.velocity.method, lu.config.pcd.ap.method) == \
        ("lu", "lu")
    assert lu.has_pcd_bcs and not lu._nullspace


# --------------------------------------------------------------------- #
# parts of the Newton / enclosed-flow solver at level 1, f64
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def l1_newton():
    """(port solver, JAX solver, wind, rng) at level 1, Re 100."""
    nj = _jax_cavity(1, 0.01, **MG)
    nt = _port_cavity(1, 0.01, **MG)
    rng = np.random.default_rng(21)
    w0 = np.asarray(nj.initial_state())
    assert _rel(nt.initial_state().numpy(), w0) == 0.0
    wind = w0[:nj.n_u] + 0.1 * rng.standard_normal(nj.n_u)
    return nt, nj, wind, rng


@pytest.mark.parametrize("compute32", [False, True])
def test_newton_reaction_values_match_jax(l1_newton, compute32):
    """f64 integrals agree to summation order (1e-12); with ``compute32``
    both sides round the same f64 inputs to f32 (1e-6)."""
    import jax.numpy as jnp
    nt, nj, wind, _ = l1_newton
    Rt = nt.asm.newton_reaction_values(torch.as_tensor(wind),
                                       compute32=compute32)
    Rj = nj.asm.newton_reaction_values(jnp.asarray(wind),
                                       compute32=compute32)
    assert Rt.dtype == torch.float64
    assert tuple(Rt.shape) == tuple(Rj.shape) == (2, 2) + tuple(
        nt.asm.pat_p2.value_shape)
    assert _rel(Rt.numpy(), Rj) <= (1e-6 if compute32 else 1e-12)


def test_newton_system_matvec_matches_jax(l1_newton):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_newton
    A1t, Rt = nt.oseen._operator_values(torch.as_tensor(wind))
    A1j, Rj = nj.oseen._operator_values(jnp.asarray(wind))
    assert _rel(A1t.numpy(), A1j) <= 1e-12 and _rel(Rt.numpy(), Rj) <= 1e-12
    x = rng.standard_normal(nj.n)
    yj = nj.oseen._matvec_factory(A1j, Rj)(jnp.asarray(x))
    # the JAX package's own values, carried across
    yt = nt.oseen._matvec_factory(
        torch.as_tensor(np.array(A1j)),
        interop.reaction_values(np.asarray(Rj), device="cpu"))(
        torch.as_tensor(x))
    assert _rel(yt.numpy(), yj) <= 1e-12
    assert _rel(nt.oseen._matvec_factory(A1t, Rt)(torch.as_tensor(x)),
                yj) <= 1e-12


def test_enclosed_pcd_brm2_apply_matches_jax(l1_newton):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_newton
    x = rng.standard_normal(nj.asm.n1)
    kpt = nt.asm.pat_p1.matrix(nt.asm.kp_values(torch.as_tensor(wind),
                                                surface=True))
    kpj = nj.asm.pat_p1.matrix(nj.asm.kp_values(jnp.asarray(wind),
                                                surface=True))
    zt = nt.oseen.pcd_apply()(kpt, torch.as_tensor(x))
    zj = nj.oseen.pcd_apply(kpj, jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= TOL
    assert abs(float(zt.mean())) <= 1e-12 * float(zt.abs().max())


def test_enclosed_pressure_vcycle_matches_jax(l1_newton):
    """The pure-Neumann hierarchy: coarse solve by the inverse of Ap + 1/n."""
    import jax.numpy as jnp
    nt, nj, _, rng = l1_newton
    x = rng.standard_normal(nj.asm.n1)
    x -= x.mean()
    zt = nt.oseen._ap_factory()(torch.as_tensor(x))
    zj = nj.oseen.ap_solve(jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= TOL


def test_newton_velocity_vcycle_matches_jax(l1_newton):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_newton
    r = rng.standard_normal(nj.n_u) * np.asarray(nj.oseen.free_u)
    A1t, Rt = nt.oseen._operator_values(torch.as_tensor(wind))
    A1j, Rj = nj.oseen._operator_values(jnp.asarray(wind))
    zt = nt.oseen._velocity_solver(A1t, torch.as_tensor(wind), R=Rt)(
        torch.as_tensor(r))
    zj = nj.oseen._velocity_solver(A1j, Rj, wind=jnp.asarray(wind))(
        jnp.asarray(r))
    assert _rel(zt.numpy(), zj) <= TOL


def test_newton_fieldsplit_apply_matches_jax(l1_newton):
    import jax.numpy as jnp
    nt, nj, wind, rng = l1_newton
    r = rng.standard_normal(nj.n)
    pct = nt.oseen._pipeline(torch.as_tensor(wind))
    _, pcj = nj.oseen._pipeline(jnp.asarray(wind))
    assert _rel(pct(torch.as_tensor(r)).numpy(), pcj(jnp.asarray(r))) <= TOL


@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_dense_lu_subsolves_match_jax(variant):
    """The LU path of the oracle configuration: the masked (BRM1) or
    nullspace-shifted (BRM2) dense Ap inverse and the dense Picard velocity
    block, through one fieldsplit apply at level 0."""
    nj = _jax_cavity(0, 0.02, pcd=variant, linearization="picard",
                     gmg_subsolves=False)
    import jax.numpy as jnp
    nt = _port_cavity(0, 0.02, pcd=variant, linearization="picard",
                      gmg_subsolves=False)
    rng = np.random.default_rng(4)
    wind = np.asarray(nj.initial_state())[:nj.n_u] + \
        0.1 * rng.standard_normal(nj.n_u)
    r = rng.standard_normal(nj.n)
    pct = nt.oseen._pipeline(torch.as_tensor(wind))
    _, pcj = nj.oseen._pipeline(jnp.asarray(wind))
    assert _rel(pct(torch.as_tensor(r)).numpy(), pcj(jnp.asarray(r))) <= TOL


# --------------------------------------------------------------------- #
# oracle: cavity level 0, Picard, Re 50, LU subsolves
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_cavity_oracle_counts(variant):
    with open(GOLDEN) as f:
        golden = json.load(f)[f"cavity/l0/{variant}/picard"]["linear_iters"]
    kw = dict(pcd=variant, linearization="picard", gmg_subsolves=False)
    rt = _port_cavity(0, 0.02, **kw).solve(rtol=1e-4,
                                           max_steps=len(golden) + 2)
    rj = _jax_cavity(0, 0.02, **kw).solve(rtol=1e-4,
                                          max_steps=len(golden) + 2)
    assert rt.converged and rj.converged
    assert len(rt.linear_iters) == len(rj.linear_iters) == len(golden)
    for ours, ref in zip(rt.linear_iters, golden):
        assert abs(ours - ref) <= max(1, 0.1 * ref), (rt.linear_iters,
                                                      golden)
    assert all(abs(a - b) <= 1 for a, b in zip(rt.linear_iters,
                                                rj.linear_iters)), \
        (rt.linear_iters, rj.linear_iters)
    assert max(rt.lin_rel) <= 1e-8


def test_step_newton_converges_quadratically():
    """The Newton path on the step (PCD Dirichlet rows on the outflow, LU
    subsolves): the JAX package's ``test_newton_quadratic`` checks."""
    res = StepFlow2D(level=0, device="cpu").solver(
        "BRM2", linearization="newton").solve(rtol=1e-10, max_steps=10)
    assert res.converged
    r = res.nonlinear_res
    assert r[-1] < 1e-9 * r[0] and len(r) <= 8
    assert max(res.lin_rel) <= 1e-8


# --------------------------------------------------------------------- #
# the slice end to end at level 1
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def l1_continuation():
    """Newton BRM2 with multigrid, Re 100 -> 200, each stage warm from the
    last, in both packages: (port results, JAX results, port solver)."""
    rt, rj = [], []
    wt = wj = None
    for Re in (100.0, 200.0):
        nt = _port_cavity(1, 1.0 / Re, **MG)
        nj = _jax_cavity(1, 1.0 / Re, **MG)
        rt.append(nt.solve(wt, rtol=1e-5, max_steps=30))
        rj.append(nj.solve(wj, rtol=1e-5, max_steps=30))
        wt, wj = rt[-1].w, rj[-1].w
    return rt, rj, nt


def test_slice_level1_counts_match_jax(l1_continuation):
    rt, rj, _ = l1_continuation
    for a, b in zip(rt, rj):
        assert a.converged and b.converged
        assert len(a.linear_iters) == len(b.linear_iters), \
            (a.linear_iters, b.linear_iters)
        assert all(abs(x - y) <= 1 for x, y in zip(a.linear_iters,
                                                    b.linear_iters)), \
            (a.linear_iters, b.linear_iters)
        assert max(a.linear_iters) < MG["krylov.maxiter"]


def test_slice_level1_state_matches_jax(l1_continuation):
    rt, rj, _ = l1_continuation
    for a, b in zip(rt, rj):
        assert _rel(a.w.numpy(), np.asarray(b.w)) <= 1e-8


def test_slice_level1_physics(l1_continuation):
    """Every linear solve at true relative residual <= 1e-8, the velocity
    bounded by the lid speed, and the discrete divergence of the enclosed
    flow at round-off (the JAX package's cavity checks)."""
    rt, _, nt = l1_continuation
    assert all(max(r.lin_rel) <= 1e-8 for r in rt)
    w = rt[-1].w
    n2 = nt.asm.n2
    assert float(w[:2 * n2].abs().max()) <= 1.0 + 1e-6
    div = sum(nt.asm.const.D[a].mv(w[a * n2:(a + 1) * n2]) for a in range(2))
    assert float(div.abs().max()) < 1e-9


def test_slice_modules_do_not_load_jax():
    """The cavity slice's modules and ``chip_smoke.py`` import no JAX and
    nothing of the JAX package."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, chip_smoke, fenapack_tpu_torch.cavity, "
            "fenapack_tpu_torch.measure, fenapack_tpu_torch.trace, "
            "fenapack_tpu_torch.models, fenapack_tpu_torch.ops.ell_spmv\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('fenapack_tpu.') "
            "or m == 'fenapack_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
