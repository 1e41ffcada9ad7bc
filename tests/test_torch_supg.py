"""SUPG streamline diffusion in the PyTorch port (``supg_values``, the
stabilized residual, ``system_supg`` and ``jpc_supg``) against the JAX
package, on the CPU in f64.

  * assembler: ``supg_values`` and ``residual(supg=True)`` on the level-0
    step at nu = 1e-3 from a random masked wind made with numpy (1e-12
    relative, max-norm), and the stabilized boundary reaction (1e-10);
    zero at low Peclet; symmetric positive semi-definite.
  * the high-Re path: two damped (0.7) Picard steps at Re 2000 on the
    level-1 step with the stabilized system and velocity multigrid, the
    settings of ``tests/test_system_supg.py``: per-step counts equal, states
    within 1e-7; three steps of the config-5 path ``solve_fused`` (solves
    to 1e-8) with GCRO-DR spaces of 0 and 16 against the JAX package's
    single-round solve: counts within 1, states within 1e-7 (2-norm
    relative).
  * ``jpc_supg`` alone: one Oseen solve, counts equal, and the system
    matvec stays unstabilized.
  * theta = 0.5 with ``system_supg`` on the level-1 channel: the fine
    multigrid level carries theta SUPG and the coarse level SUPG unscaled,
    as the JAX package does (``fenapack_tpu/solvers/gmg.py:760``); counts
    equal.
  * the unsteady residual includes the streamline diffusion.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)

from fenapack_tpu_torch.models import Channel2D, StepFlow2D
from fenapack_tpu_torch.solvers import gmg as tgmg

# the settings of tests/test_system_supg.py::build
HIGH_RE = {"krylov.maxiter": 400, "krylov.rtol": 1e-6, "system_supg": True,
           "velocity.smooth_iters": 3, "velocity.cycles": 2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(problem, **kw):
    """The same problem built by the port (on the CPU) and by the JAX
    package."""
    pytest.importorskip("jax")
    import fenapack_tpu.models as jm
    pkw = {k: v for k, v in kw.items() if k != "solver"}
    skw = kw.get("solver", {})
    port = problem(device="cpu", **pkw).solver("BRM2", **skw)
    jax_ = getattr(jm, problem.__name__)(**pkw).solver("BRM2", **skw)
    return port, jax_


def _masked_wind(nl, rng, scale=0.5):
    """The initial state's velocity plus a random field on the free dofs."""
    w = nl.initial_state().numpy()
    free = nl.oseen.free_u.numpy()
    w[:nl.n_u] += scale * rng.standard_normal(nl.n_u) * free
    w[nl.n_u:] = rng.standard_normal(nl.n - nl.n_u)
    return w


# --------------------------------------------------------------------- #
# assembler
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def step_l0():
    return _pair(StepFlow2D, level=0, nu=1e-3)


def test_supg_values_match_jax(step_l0):
    import jax.numpy as jnp
    nt, nj = step_l0
    w = _masked_wind(nt, np.random.default_rng(0))
    u = w[:nt.n_u]
    vt = nt.asm.supg_values(torch.as_tensor(u))
    vj = nj.asm.supg_values(jnp.asarray(u))
    assert float(vt.abs().max()) > 0            # Pe > 1 somewhere
    assert _rel(vt.numpy(), vj) <= 1e-12
    # the hi set's pattern is the same ELL pattern here
    assert _rel(nt.asm.supg_values(torch.as_tensor(u), hi=True).numpy(),
                vj) <= 1e-12


def test_supg_residual_matches_jax(step_l0):
    import jax.numpy as jnp
    nt, nj = step_l0
    w = _masked_wind(nt, np.random.default_rng(1))
    u, p = w[:nt.n_u], w[nt.n_u:]
    rut, rpt = nt.asm.residual(torch.as_tensor(u), torch.as_tensor(p),
                               supg=True)
    ruj, rpj = nj.asm.residual(jnp.asarray(u), jnp.asarray(p), supg=True)
    assert _rel(rut.numpy(), ruj) <= 1e-12 and _rel(rpt.numpy(), rpj) <= 1e-12
    # it differs from the Galerkin residual by the SUPG operator times u
    ru0 = nt.asm.residual(torch.as_tensor(u), torch.as_tensor(p))[0]
    S = nt.asm.pat_p2.matrix(nt.asm.supg_values(torch.as_tensor(u)))
    su = torch.cat([S.mv(c) for c in nt.asm.split_u(torch.as_tensor(u))])
    assert _rel((rut - ru0).numpy(), su.numpy()) <= 1e-10
    assert _rel(su.numpy(), np.zeros(1)) > 0
    # the boundary reaction of a stabilized state takes the same residual
    from fenapack_tpu.utils.functionals import boundary_reaction as jbr
    from fenapack_tpu_torch.fem.mesh import WALL
    from fenapack_tpu_torch.utils.functionals import boundary_reaction
    Ft = boundary_reaction(nt.asm, torch.as_tensor(u), torch.as_tensor(p),
                           [WALL], supg=True)
    assert _rel(Ft, jbr(nj.asm, jnp.asarray(u), jnp.asarray(p), [WALL],
                        supg=True)) <= 1e-10
    assert _rel(Ft, boundary_reaction(nt.asm, torch.as_tensor(u),
                                      torch.as_tensor(p), [WALL])) > 1e-8


def test_supg_vanishes_at_low_peclet():
    nl = StepFlow2D(level=0, nu=10.0, device="cpu").solver("BRM2")
    u = torch.ones(nl.n_u, dtype=torch.float64)
    assert float(nl.asm.supg_values(u).abs().max()) == 0.0


def test_supg_is_spsd(step_l0):
    nt, _ = step_l0
    asm = nt.asm
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(nt.n_u))
    S = asm.pat_p2.to_dense(asm.supg_values(u)).numpy()
    assert np.abs(S - S.T).max() < 1e-12
    assert np.abs(S).max() > 0.0
    assert np.linalg.eigvalsh(S).min() > -1e-10


# --------------------------------------------------------------------- #
# the stabilized system at Re 2000
# --------------------------------------------------------------------- #

def test_re2000_damped_picard_matches_jax():
    """Two damped (0.7) Picard steps at Re 2000 on the level-1 step with
    the stabilized system, velocity multigrid (3 Jacobi sweeps, 2 cycles)
    and pressure multigrid: per-step counts equal the JAX package's,
    states within 1e-7, and |F| falls."""
    nt, nj = _pair(StepFlow2D, level=1, nu=1e-3,
                   solver=dict(gmg_subsolves=True, **HIGH_RE))
    rt = nt.solve(rtol=1e-12, max_steps=2, damping=0.7)
    rj = nj.solve(rtol=1e-12, max_steps=2, damping=0.7)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert all(i < 400 for i in rt.linear_iters)
    assert _rel(rt.w.numpy(), rj.w) <= 1e-7
    assert np.allclose(rt.nonlinear_res, rj.nonlinear_res, rtol=1e-9)
    assert rt.nonlinear_res[1] < rt.nonlinear_res[0]
    assert max(rt.lin_rel) <= 1e-6


def _highre_fused_pair(recycle):
    """Three damped (0.7) Picard steps of the config-5 path at Re 2000 on
    the level-1 step, each one solve to 1e-8 (cap 1000), in the port
    (``highre.build``) and in the JAX package (the same settings, its
    single-round solve ``krylov.hi_krylov``)."""
    pytest.importorskip("jax")
    from fenapack_tpu.models import StepFlow2D as JStep
    from fenapack_tpu_torch import highre
    kw = dict(rtol=1e-12, rtol_lin=highre.RTOL_LIN, max_steps=3,
              damping=highre.DAMPING)
    seen = []
    rt = highre.build(1, highre.NU, device="cpu", recycle=recycle
                      ).solve_fused(callback=lambda *a: seen.append(a), **kw)
    rj = JStep(level=1, nu=highre.NU).solver(
        "BRM2", linearization="picard", gmg_subsolves=True, **highre.CFG,
        **{"velocity.smoother": "jacobi", "krylov.recycle": recycle,
           "krylov.hi_krylov": True}).solve_fused(**kw)
    assert [s[0] for s in seen] == [0, 1, 2]
    assert [s[2] for s in seen] == rt.linear_iters
    return rt, rj


def _check_fused_pair(rt, rj):
    ji = [int(i) for i in rj.linear_iters]
    assert len(rt.linear_iters) == len(ji) == 3
    assert all(abs(a - b) <= 1 for a, b in zip(rt.linear_iters, ji)), (
        rt.linear_iters, ji)
    # each solve stops at 1e-8 relative residual, so the max-norm gap of the
    # states reaches ~1e-7 after three steps; the 2-norm gap is ~6e-8
    d = np.linalg.norm(rt.w.numpy() - rj.w) / np.linalg.norm(rj.w)
    assert d <= 1e-7, d
    assert max(rt.lin_rel) <= 1e-8
    assert rt.nonlinear_res[-1] < rt.nonlinear_res[0]


def test_re2000_solve_fused_damped():
    """The config-5 path ``solve_fused`` without recycling: per-step
    counts within 1 of the JAX package's (equality expected: [43, 174,
    270]) and states within 1e-7 (2-norm relative)."""
    _check_fused_pair(*_highre_fused_pair(0))


def test_re2000_solve_fused_recycled_matches_jax():
    """The same three steps with a GCRO-DR space of 16 threaded from step
    to step: per-step counts within 1 of the JAX package's (equality
    expected: [43, 181, 244]) and states within 1e-7 (2-norm relative)."""
    _check_fused_pair(*_highre_fused_pair(16))


def test_jpc_supg_oseen_solve_matches_jax():
    """SUPG in the preconditioner's velocity operator alone: one Oseen
    solve at Re 500 on the level-1 step with velocity multigrid, counts
    equal the JAX package's; the system matvec is the Galerkin one."""
    import jax.numpy as jnp
    over = {"krylov.maxiter": 200, "krylov.rtol": 1e-8, "jpc_supg": True,
            "velocity.smooth_iters": 3, "velocity.cycles": 2}
    nt, nj = _pair(StepFlow2D, level=1, nu=2e-3,
                   solver=dict(gmg_subsolves=True, **over))
    w = nt.initial_state()
    F = nt.residual_of(w)[0]
    rt, mv = nt.oseen.solve(w[:nt.n_u], -F)
    rj = nj.oseen.solve(jnp.asarray(w.numpy()[:nt.n_u]),
                        -jnp.asarray(F.numpy()))
    assert rt.converged and rt.iters == int(rj.iters)
    assert _rel(rt.x.numpy(), rj.x) <= 1e-6
    # the system operator is unstabilized: the matvec equals the Galerkin
    # operator's, and the preconditioner differs from the plain one's
    plain = nt.oseen._matvec_factory(*nt.oseen._operator_values(w[:nt.n_u]))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(nt.n))
    assert _rel(mv(x).numpy(), plain(x).numpy()) == 0.0
    pc = nt.oseen._pipeline(w[:nt.n_u])
    nt.oseen.config = dataclasses.replace(nt.oseen.config, jpc_supg=False)
    pc0 = nt.oseen._pipeline(w[:nt.n_u])
    assert _rel(pc(x).numpy(), pc0(x).numpy()) > 1e-6


def test_theta_system_supg_levels_and_counts_match_jax():
    """theta = 0.5, system_supg, the level-1 channel at nu = 1e-3 with
    two-level velocity multigrid: the fine level is ``theta (A1 + S) +
    M/dt``, the coarse level ``theta A1 + M/dt + S`` (S unscaled), as in
    the JAX package; two steps of ``solve`` with two Picard iterations
    each take the JAX package's counts."""
    over = dict(gmg_subsolves=True, unsteady=0.25, theta=0.5,
                **{"system_supg": True, "krylov.maxiter": 200,
                   "velocity.smooth_iters": 3, "velocity.cycles": 2})
    ut, uj = _pair(Channel2D, level=1, length=2.0, nu=1e-3, solver=over)
    o, vh = ut.oseen, ut.oseen.velocity_hierarchy
    rng = np.random.default_rng(4)
    wind = torch.as_tensor(_masked_wind(ut, rng)[:ut.n_u])
    vals = tgmg.velocity_gmg_values(
        vh, wind, o.bc_mask_u, o.dtype, fine_values=o._operator_values(wind),
        theta=0.5, inv_dt=4.0, supg=True)
    fine, coarse = vh.asms[1], vh.asms[0]
    n2f = fine.n2
    wc = torch.cat([vh.transfers[0].inject(c)
                    for c in (wind[:n2f], wind[n2f:])])
    want_f = (0.5 * (fine.picard_matrix_values(wind)
                     + fine.supg_values(wind)) + 4.0 * fine.const.M2.vals)
    want_c = (0.5 * coarse.picard_matrix_values(wc)
              + 4.0 * coarse.const.M2.vals + coarse.supg_values(wc))
    assert _rel(vals["levels"][1][0].numpy(), want_f.numpy()) <= 1e-13
    assert _rel(vals["levels"][0][0].numpy(), want_c.numpy()) <= 1e-13
    rt = ut.solve(0.5, picard_iters=2)
    rj = uj.solve(0.5, picard_iters=2)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-7


def test_unsteady_residual_includes_supg():
    """At u_old == u and 1/dt -> 0 the theta-scheme residual is the steady
    stabilized one (the analogue of the JAX package's
    ``test_unsteady_residual_includes_supg``), and both equal the JAX
    package's."""
    import jax.numpy as jnp
    over = {"system_supg": True}
    (st, sj), (ut, uj) = (
        _pair(Channel2D, level=0, length=2.0, nu=5e-4, solver=over),
        _pair(Channel2D, level=0, length=2.0, nu=5e-4,
              solver=dict(unsteady=1e12, theta=1.0, **over)))
    rng = np.random.default_rng(1)
    w = st.initial_state().numpy()
    w[:st.n_u] += 0.01 * rng.standard_normal(st.n_u) * st.oseen.free_u.numpy()
    wt = torch.as_tensor(w)
    F_steady = st.residual_of(wt)[0].numpy()
    F_unsteady = ut._residual(wt, wt[:st.n_u]).numpy()
    assert np.abs(F_steady - F_unsteady).max() <= 1e-9
    assert _rel(F_steady, sj._residual(jnp.asarray(w))) <= 1e-11
    assert _rel(F_unsteady, uj._residual(jnp.asarray(w),
                                         jnp.asarray(w[:st.n_u]))) <= 1e-11
    # the Galerkin residual differs
    plain = Channel2D(level=0, length=2.0, nu=5e-4, device="cpu").solver(
        "BRM2")
    assert _rel(plain.residual_of(wt)[0].numpy(), F_steady) > 1e-6
