"""Unsteady time stepping of the PyTorch port (theta scheme and BDF2, the
``Mp/dt`` term of the PCD apply, the minimal-residual smoother and the
bottom levels of the velocity and pressure multigrid) against the JAX
package, on the CPU in f64, on the straight channel ``channel_mesh(0, 2.0)``
and its refinement.

  * host: the channel and obstacle meshes array-equal.
  * assembler: ``mass2_values``, ``grad_p``, ``residual(u, None)``,
    ``supg_p1_values`` from one random state made with numpy (1e-12
    relative, max-norm).
  * multigrid: ``_minres_smooth`` on a level operator (1e-10), the P1 <-> P2
    transfer (1e-14, adjoint), one velocity V-cycle with the p-coarse bottom
    level and with the minimal-residual bottom sweeps, and the pressure
    V-cycle with the Chebyshev coarse solve (1e-9; the dense cap lowered in
    both packages).
  * PCD apply with theta = 0.5, inv_dt = 4 (1e-10); theta and BDF2 residuals
    (1e-11).
  * the time loops: ``solve`` and ``solve_fused`` against the JAX package's
    (counts equal, states 1e-8); the device functional (1e-8).
  * the physics checks of the JAX package's unsteady tests, on the port
    alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fenapack_tpu_torch as ft
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.models import Channel2D, ObstacleChannel2D
from fenapack_tpu_torch.solvers import gmg as tgmg
from fenapack_tpu_torch.solvers.pcd import make_pcd_apply
from fenapack_tpu_torch.utils import functionals as tfun

MINRES = {"velocity.smooth_iters": 3, "velocity.cycles": 2,
          "velocity.smoother": "minres"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _port(level=0, nu=0.1, pcd="BRM2", **kw):
    return Channel2D(level=level, length=2.0, nu=nu, device="cpu").solver(
        pcd, **kw)


def _jax(level=0, nu=0.1, pcd="BRM2", **kw):
    pytest.importorskip("jax")
    from fenapack_tpu.models import Channel2D as JChannel
    return JChannel(level=level, length=2.0, nu=nu).solver(pcd, **kw)


def _cap(monkeypatch, cap):
    """Lower the dense-coarse cap in both packages."""
    monkeypatch.setattr(tgmg, "DENSE_MAX", cap)
    monkeypatch.setenv("FENAPACK_GMG_DENSE_MAX", str(cap))


# --------------------------------------------------------------------- #
# host meshes and models
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name,args", [("channel_mesh", (0, 2.0)),
                                       ("obstacle_channel_mesh", (0,))])
def test_channel_meshes_match_jax(name, args):
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh as jmesh
    mt, mj = getattr(tmesh, name)(*args), getattr(jmesh, name)(*args)
    for f in ("vertices", "cells", "edges", "cell_edges", "boundary_facets",
              "facet_cells", "facet_markers"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
    assert {tmesh.WALL, tmesh.INFLOW, tmesh.OUTFLOW} == set(
        np.unique(mt.facet_markers))


def test_models_unsteady_plumbing():
    assert Channel2D().device == "cuda" == ObstacleChannel2D().device
    us = _port(unsteady=0.25, theta=0.5)
    assert isinstance(us, ft.UnsteadySolver)
    assert (us.dt, us.theta, us.scheme) == (0.25, 0.5, "theta")
    assert (us.oseen.theta, us.oseen.inv_dt) == (0.5, 4.0)
    assert us.oseen.pcd_marker == tmesh.OUTFLOW and not us.enclosed
    b = _port(unsteady=0.1, scheme="bdf2", gmg_subsolves=True, level=1,
              **MINRES)
    assert (b.oseen.theta, b.oseen.inv_dt) == (1.0, 15.0)
    assert b.oseen.config.velocity.smoother == "minres"
    assert len(b.oseen.velocity_hierarchy.asms) == 2
    assert isinstance(_port(), ft.NonlinearSolver)
    with pytest.raises(ValueError):
        _port(unsteady=0.1, scheme="bdf3")
    assert ObstacleChannel2D(device="cpu").mesh().num_cells == \
        tmesh.obstacle_channel_mesh(0).num_cells


# --------------------------------------------------------------------- #
# assembler pieces
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def asm_pair():
    """(port assembler, JAX assembler, u, p) on the channel at nu = 1e-3
    (cell Peclet numbers above 1), a random state made with numpy."""
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    at = ft.NSAssembler(tmesh.channel_mesh(0, 2.0), 1e-3, device="cpu")
    aj = JAsm(jmesh.channel_mesh(0, 2.0), 1e-3)
    rng = np.random.default_rng(5)
    return at, aj, rng.standard_normal(2 * at.n2), rng.standard_normal(at.n1)


def test_mass2_values_match_jax(asm_pair):
    at, aj, _, _ = asm_pair
    assert _rel(at.mass2_values().numpy(), aj.mass2_values()) <= 1e-12
    assert _rel(at.const.M2.vals.numpy(), aj.const.M2.vals) <= 1e-12
    assert at.mass2(hi=True) is at.const_hi.M2
    # a block-sparse set keeps no M2 and assembles it on demand
    ab = ft.NSAssembler(at.mesh, 1e-3, device="cpu", block_size=8,
                        hi_block=True, reorder=False)
    assert ab.const.M2 is None and ab.const_hi.M2 is None
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(at.n2))
    assert _rel(ab.mass2(hi=False).mv(x).numpy(),
                at.const.M2.mv(x).numpy()) <= 1e-12


def test_grad_p_and_convection_residual_match_jax(asm_pair):
    import jax.numpy as jnp
    at, aj, u, p = asm_pair
    assert _rel(at.grad_p(torch.as_tensor(p)).numpy(),
                aj.grad_p(jnp.asarray(p))) <= 1e-12
    rut, rpt = at.residual(torch.as_tensor(u), None)
    ruj, rpj = aj.residual(jnp.asarray(u), None)
    assert _rel(rut.numpy(), ruj) <= 1e-12 and _rel(rpt.numpy(), rpj) <= 1e-12
    # with the pressure: the convection part plus the gradient
    full = at.residual(torch.as_tensor(u), torch.as_tensor(p))[0]
    assert _rel(full.numpy(), (rut + at.grad_p(torch.as_tensor(p))).numpy()
                ) <= 1e-15


def test_supg_p1_values_match_jax(asm_pair):
    import jax.numpy as jnp
    at, aj, u, _ = asm_pair
    vt = at.supg_p1_values(torch.as_tensor(u))
    assert float(vt.abs().max()) > 0            # Pe > 1 somewhere
    assert _rel(vt.numpy(), aj.supg_p1_values(jnp.asarray(u))) <= 1e-12
    assert _rel(at.h_cell.numpy(), aj.h_cell) == 0.0


# --------------------------------------------------------------------- #
# multigrid pieces
# --------------------------------------------------------------------- #

def test_minres_smooth_matches_jax(asm_pair):
    """Three minimal-residual steps on the Picard operator of the channel
    from the same right-hand side and start: 1e-10 relative."""
    import jax.numpy as jnp
    from fenapack_tpu.solvers.gmg import _minres_smooth as jsmooth
    at, aj, u, _ = asm_pair
    A1t = at.pat_p2.matrix(at.picard_matrix_values(torch.as_tensor(u)))
    A1j = aj.pat_p2.matrix(aj.picard_matrix_values(jnp.asarray(u)))
    rng = np.random.default_rng(6)
    b, x0 = rng.standard_normal(at.n2), rng.standard_normal(at.n2)
    dt_ = 1.0 / A1t.diag_from(at.pat_p2.diag_pos)
    dj = 1.0 / A1j.diag_from(aj.pat_p2.diag_pos)
    xt = tgmg._minres_smooth(A1t.mv, dt_, 3, torch.as_tensor(b),
                             torch.as_tensor(x0))
    xj = jsmooth(A1j.mv, dj, 3, jnp.asarray(b), jnp.asarray(x0))
    assert _rel(xt.numpy(), xj) <= 1e-10
    # it reduces the residual of a nonsymmetric operator
    r0 = np.linalg.norm(b - A1t.mv(torch.as_tensor(x0)).numpy())
    assert np.linalg.norm(b - A1t.mv(xt).numpy()) < r0


def test_pcoarse_transfer_matches_jax(asm_pair):
    import jax.numpy as jnp
    from fenapack_tpu.solvers.gmg import PCoarseTransfer as JP
    at, aj, u, p = asm_pair
    tt, tj = tgmg.PCoarseTransfer(at.W, device="cpu"), JP(aj.W, jnp.float64)
    assert (tt.n_coarse, tt.n_fine) == (at.n1, at.n2)
    x, y = torch.as_tensor(p), torch.as_tensor(u[:at.n2])
    assert _rel(tt.prolong(x).numpy(), tj.prolong(jnp.asarray(p))) <= 1e-14
    assert _rel(tt.restrict(y).numpy(),
                tj.restrict(jnp.asarray(u[:at.n2]))) <= 1e-14
    # <P x, y> = <x, P^T y>
    lhs, rhs = float(tt.prolong(x) @ y), float(x @ tt.restrict(y))
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)
    # vertex dofs copy, midpoint dofs average their edge's endpoints
    assert _rel(tt.prolong(x)[:at.n1].numpy(), p) == 0.0


@pytest.mark.parametrize("cap,kw", [
    (100, dict(linearization="newton")),
    (100, dict(unsteady=0.1, scheme="bdf2")),
    (100, dict(unsteady=0.25, theta=0.5, linearization="newton")),
    (60, dict()),
], ids=["pcoarse-newton", "pcoarse-bdf2", "pcoarse-theta-newton",
        "sweeps-picard"])
def test_velocity_vcycle_bottom_levels_match_jax(monkeypatch, cap, kw):
    """One velocity V-cycle (two cycles, three minimal-residual steps) on
    the level-1 channel with the dense cap lowered: at 100 the base level
    (2 n2 = 306 > 100 >= 2 n1 = 90) gets the P1 bottom level, at 60 neither
    space fits and the bottom is minimal-residual sweeps.  1e-9."""
    import jax.numpy as jnp
    _cap(monkeypatch, cap)
    over = dict(level=1, nu=0.01, gmg_subsolves=True, **MINRES, **kw)
    nt, nj = _port(**over), _jax(**over)
    vh = nt.oseen.velocity_hierarchy
    assert tgmg._velocity_gmg_plan(vh, 2) == ((cap == 100), False)
    rng = np.random.default_rng(7)
    wind = nt.initial_state().numpy()[:nt.n_u] \
        + 0.1 * rng.standard_normal(nt.n_u)
    r = rng.standard_normal(nt.n_u) * nt.oseen.free_u.numpy()
    A1t, Rt = nt.oseen._operator_values(torch.as_tensor(wind))
    A1j, Rj = nj.oseen._operator_values(jnp.asarray(wind))
    assert _rel(A1t.numpy(), A1j) <= 1e-12
    zt = nt.oseen._velocity_solver(A1t, torch.as_tensor(wind), R=Rt)(
        torch.as_tensor(r))
    zj = nj.oseen._velocity_solver(A1j, Rj, wind=jnp.asarray(wind))(
        jnp.asarray(r))
    assert _rel(zt.numpy(), zj) <= 1e-9


def test_pcoarse_values_combine_theta_then_supg(monkeypatch):
    """The p-coarse values: nu (Ap + Kp) theta-combined with nu Mp, then the
    streamline diffusion added unscaled; the inverse is the stacked P1
    block's."""
    _cap(monkeypatch, 100)
    us = _port(level=1, nu=0.01, gmg_subsolves=True, unsteady=0.25,
               theta=0.5, **MINRES)
    o, vh = us.oseen, us.oseen.velocity_hierarchy
    wind = us.initial_state()[:us.n_u]
    vals = tgmg.velocity_gmg_values(vh, wind, o.bc_mask_u, o.dtype,
                                    theta=0.5, inv_dt=4.0)
    a0, n2f = vh.asms[0], vh.asms[1].n2
    w0 = torch.cat([vh.transfers[0].inject(c)
                    for c in (wind[:n2f], wind[n2f:])])
    want = (0.5 * 0.01 * (a0.const.Ap.vals + a0.kp_values(w0))
            + 4.0 * 0.01 * a0.const.Mp.vals + a0.supg_p1_values(w0))
    assert _rel(vals["p1_vals"].numpy(), want.numpy()) <= 1e-14
    assert tuple(vals["coarse_inv"].shape) == (2 * a0.n1, 2 * a0.n1)


def test_pressure_chebyshev_coarse_solve_matches_jax(monkeypatch):
    """The pressure base level (45 dofs) above a cap of 40: Chebyshev with
    power-iteration bounds instead of the dense inverse.  1e-9."""
    import jax.numpy as jnp
    _cap(monkeypatch, 40)
    over = dict(level=1, nu=0.1, gmg_subsolves=True)
    nt, nj = _port(**over), _jax(**over)
    x = np.random.default_rng(8).standard_normal(nt.asm.n1)
    zt = nt.oseen._ap_factory()(torch.as_tensor(x))
    zj = nj.oseen.ap_solve(jnp.asarray(x))
    assert _rel(zt.numpy(), zj) <= 1e-9


@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_unsteady_pcd_apply_matches_jax(variant):
    """theta = 0.5, inv_dt = 4 with LU subsolves: 1e-10."""
    import jax.numpy as jnp
    over = dict(pcd=variant, unsteady=0.25, theta=0.5)
    ut, uj = _port(**over), _jax(**over)
    assert (uj.oseen.theta, uj.oseen.inv_dt) == (0.5, 4.0)
    rng = np.random.default_rng(9)
    wind = ut.initial_state().numpy()[:ut.n_u] \
        + 0.1 * rng.standard_normal(ut.n_u)
    x = rng.standard_normal(ut.asm.n1)
    surf = variant == "BRM2"
    kpt = ut.asm.pat_p1.matrix(ut.asm.kp_values(torch.as_tensor(wind),
                                                surface=surf))
    kpj = uj.asm.pat_p1.matrix(uj.asm.kp_values(jnp.asarray(wind),
                                                surface=surf))
    zt = ut.oseen.pcd_apply()(kpt, torch.as_tensor(x))
    assert _rel(zt.numpy(), uj.oseen.pcd_apply(kpj, jnp.asarray(x))) <= 1e-10
    # and it differs from the steady apply
    steady = make_pcd_apply(variant, ut.oseen._ap_factory(),
                            ut.oseen._mp_factory(), ut.oseen.pcd_mask)
    assert _rel(steady(kpt, torch.as_tensor(x)).numpy(), zt.numpy()) > 1e-3


@pytest.mark.parametrize("scheme,theta", [("theta", 1.0), ("theta", 0.5),
                                          ("bdf2", 1.0)])
def test_unsteady_residuals_match_jax(scheme, theta):
    import jax.numpy as jnp
    over = dict(unsteady=0.25, theta=theta, scheme=scheme)
    ut, uj = _port(**over), _jax(**over)
    rng = np.random.default_rng(10)
    w, u_old, u_prev = (rng.standard_normal(ut.n),
                        rng.standard_normal(ut.n_u),
                        rng.standard_normal(ut.n_u))
    Ft = ut._residual(torch.as_tensor(w), torch.as_tensor(u_old))
    Fj = uj._residual(jnp.asarray(w), jnp.asarray(u_old))
    assert _rel(Ft.numpy(), Fj) <= 1e-11
    if scheme == "bdf2":
        Ft = ut._residual_full(torch.as_tensor(w), torch.as_tensor(u_old),
                               torch.as_tensor(u_prev))
        Fj = uj._residual_full(jnp.asarray(w), jnp.asarray(u_old),
                               jnp.asarray(u_prev))
        assert _rel(Ft.numpy(), Fj) <= 1e-11
    # Dirichlet rows are zeroed
    assert float((Ft[:ut.n_u] * ut.oseen.bc_mask_u).abs().max()) == 0.0


# --------------------------------------------------------------------- #
# time loops against the JAX package
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("scheme,theta", [("theta", 1.0), ("theta", 0.5),
                                          ("bdf2", 1.0)])
def test_solve_matches_jax(scheme, theta):
    """Four steps of dt = 0.25 with two Picard iterations each: per-step
    counts equal, states within 1e-8 relative."""
    over = dict(unsteady=0.25, theta=theta, scheme=scheme)
    rt = _port(**over).solve(1.0, picard_iters=2, keep_history=True)
    rj = _jax(**over).solve(1.0, picard_iters=2)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    assert np.allclose(rt.step_res, rj.step_res, rtol=1e-6, atol=1e-12)
    assert rt.times == rj.times and len(rt.history) == 4
    assert _rel(rt.history[-1], rt.w.numpy()) == 0.0


@pytest.mark.parametrize("scheme", ["theta", "bdf2"])
def test_solve_fused_matches_jax(scheme):
    """The semi-implicit loop on high-precision solves against the JAX
    package's (built with ``krylov.hi_krylov``, its single-round solve):
    counts equal, states within 1e-8."""
    over = dict(unsteady=0.25, scheme=scheme)
    rt = _port(**over).solve_fused(1.0, rtol_lin=1e-10)
    rj = _jax(**over, **{"krylov.hi_krylov": True}).solve_fused(
        1.0, rtol_lin=1e-10)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    assert max(rt.lin_rel) <= 1e-10 and rt.functionals is None


@pytest.mark.parametrize("scheme", ["theta", "bdf2"])
def test_solve_fused_matches_plain_loop(scheme):
    """``solve_fused`` has the semantics of ``solve(picard_iters=1)``."""
    over = dict(unsteady=0.25, scheme=scheme, **{"krylov.rtol": 1e-10})
    r1 = _port(**over).solve(1.0, picard_iters=1)
    r2 = _port(**over).solve_fused(1.0, rtol_lin=1e-10)
    assert np.abs(r1.w.numpy() - r2.w.numpy()).max() <= 1e-7
    assert len(r1.linear_iters) == len(r2.linear_iters) == 4


@pytest.mark.parametrize("scheme", ["steady", "theta", "bdf2"])
def test_device_functional_matches_jax(scheme):
    """Wall force and two pressure probes from random states: 1e-8."""
    import jax.numpy as jnp
    from fenapack_tpu.utils.functionals import make_device_functional as jmk
    ut, uj = _port(unsteady=0.25), _jax(unsteady=0.25)
    pts = [(0.7, 0.3), (1.5, 0.8)]
    dt = None if scheme == "steady" else 0.25
    ftn = tfun.make_device_functional(ut.asm, [tmesh.WALL], points=pts,
                                      scheme=scheme, dt=dt)
    fj = jmk(uj.asm, [tmesh.WALL], points=pts, scheme=scheme, dt=dt)
    rng = np.random.default_rng(11)
    w, uo, up = (rng.standard_normal(ut.n), rng.standard_normal(ut.n_u),
                 rng.standard_normal(ut.n_u))
    vt = ftn(*(torch.as_tensor(a) for a in (w, uo, up)))
    assert isinstance(vt, torch.Tensor) and tuple(vt.shape) == (4,)
    assert _rel(vt.numpy(), fj(*(jnp.asarray(a) for a in (w, uo, up)))) <= 1e-8
    # the host functionals agree with the device one
    du = {"steady": None, "theta": (w[:ut.n_u] - uo) / 0.25,
          "bdf2": (1.5 * w[:ut.n_u] - 2 * uo + 0.5 * up) / 0.25}[scheme]
    F = tfun.boundary_reaction(
        ut.asm, torch.as_tensor(w[:ut.n_u]), torch.as_tensor(w[ut.n_u:]),
        [tmesh.WALL], du_dt=None if du is None else torch.as_tensor(du))
    pe = tfun.eval_p1(ut.asm, w[ut.n_u:], pts)
    assert _rel(np.concatenate([F, pe]), vt.numpy()) <= 1e-10
    with pytest.raises(ValueError):
        tfun.make_device_functional(ut.asm, [tmesh.WALL], scheme="bdf2")


def test_solve_fused_returns_functionals():
    us = _port(unsteady=0.25, scheme="bdf2")
    fn = tfun.make_device_functional(us.asm, [tmesh.WALL],
                                     points=[(1.0, 0.5)], scheme="bdf2",
                                     dt=0.25)
    r = us.solve_fused(0.75, functional=fn, keep_history=True)
    assert tuple(r.functionals.shape) == (3, 3)
    h = [torch.as_tensor(x) for x in r.history]
    n_u = us.n_u
    du = (1.5 * h[2][:n_u] - 2.0 * h[1][:n_u] + 0.5 * h[0][:n_u]) / 0.25
    F = tfun.boundary_reaction(us.asm, h[2][:n_u], h[2][n_u:], [tmesh.WALL],
                               du_dt=du)
    assert _rel(F, r.functionals[-1, :2].numpy()) <= 1e-10


def test_bc_fn_solve_matches_jax_and_fused_refuses():
    """A ramped inflow through ``bc_fn`` on the exact loop: counts equal
    and states 1e-8; the semi-implicit loop refuses it."""
    from fenapack_tpu_torch.fem.dofmap import DirichletBC

    def make(asm_W, Dbc):
        def bc_fn(t):
            s = min(t, 0.5) / 0.5

            def prof(x):
                v = np.zeros((x.shape[0], 2))
                v[:, 0] = s * 4 * x[:, 1] * (1 - x[:, 1])
                return v
            return [Dbc.velocity(asm_W, [tmesh.WALL],
                                 lambda x: np.zeros((x.shape[0], 2))),
                    Dbc.velocity(asm_W, [tmesh.INFLOW], prof)]
        return bc_fn

    ut = _port(unsteady=0.25)
    ut.bc_fn = make(ut.asm.W, DirichletBC)
    assert float(ut.initial_state().abs().max()) == 0.0
    rt = ut.solve(0.75, picard_iters=2)
    with pytest.raises(ValueError, match="bc_fn"):
        ut.solve_fused(0.5)
    with pytest.raises(TypeError):
        ut.bc_fn = lambda t: np.zeros(3)
        ut.solve(0.25)
    pytest.importorskip("jax")
    from fenapack_tpu.fem.dofmap import DirichletBC as JBC
    uj = _jax(unsteady=0.25)
    uj.bc_fn = make(uj.asm.W, JBC)
    rj = uj.solve(0.75, picard_iters=2)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8


def test_checkpoint_round_trip(tmp_path):
    us = _port(unsteady=0.25)
    r = us.solve(0.5)
    path = str(tmp_path / "sub" / "state.npz")
    ft.save_checkpoint(path, r.w, t=0.5, meta={"scheme": "theta", "k": 2})
    w, t, meta = ft.load_checkpoint(path)
    assert t == 0.5 and meta == {"scheme": "theta", "k": 2}
    assert _rel(w, r.w.numpy()) == 0.0
    # resuming from the checkpoint continues the same trajectory
    r2 = us.solve(0.25, torch.as_tensor(w))
    r3 = us.solve(0.75)
    assert _rel(r2.w.numpy(), r3.w.numpy()) <= 1e-12


# --------------------------------------------------------------------- #
# physics, on the port alone
# --------------------------------------------------------------------- #

def _poiseuille_error(us, w):
    asm = us.asm
    xy = asm.W.V.dof_coords()
    ux, uy = w[:asm.n2].numpy(), w[asm.n2:2 * asm.n2].numpy()
    return max(np.abs(ux - 4 * xy[:, 1] * (1 - xy[:, 1])).max(),
               np.abs(uy).max())


@pytest.mark.parametrize("scheme,bound", [("theta", 60), ("bdf2", 120)])
def test_relaxes_to_poiseuille(scheme, bound):
    """The steady state of the channel is Poiseuille flow, whatever the
    scheme, and the per-step solves stay cheap."""
    us = _port(unsteady=0.25, scheme=scheme)
    r = us.solve(3.0, picard_iters=2)
    assert _poiseuille_error(us, r.w) < 2e-3
    assert max(r.linear_iters) < bound, r.linear_iters


def test_crank_nicolson_pressure_is_physical():
    """Poiseuille with u_max = 1 in a unit channel has dp/dx = -8 nu: a
    pressure folded into the theta weight would converge to p / theta."""
    nu, L = 0.1, 2.0
    us = _port(nu=nu, unsteady=0.25, theta=0.5)
    r = us.solve(4.0, picard_iters=2)
    x = us.asm.W.Q.dof_coords()[:, 0]
    p = r.w[us.n_u:].numpy()
    assert np.abs(p - 8 * nu * (L - x)).max() < 0.05 * 8 * nu * L


def test_mass_term_strengthens_pcd():
    """Dropping ``Mp/dt`` from the PCD apply while the system keeps M/dt
    costs iterations on a mass-dominated (small dt) step."""
    good = _port(nu=0.02, unsteady=0.01)
    _, it_good, _ = good.step(good.initial_state())
    bad = _port(nu=0.02, unsteady=0.01)
    o = bad.oseen
    o.pcd_apply = lambda: make_pcd_apply("BRM2", o._ap_factory(),
                                         o._mp_factory(), o.pcd_mask)
    _, it_bad, _ = bad.step(bad.initial_state())
    assert it_good < it_bad, (it_good, it_bad)


def test_bdf2_is_second_order():
    """The velocity error at T = 0.5 against dt = 1/32 shrinks at least
    3.5x per halving of dt for BDF2 and less than 3x for implicit Euler."""
    def u_at_T(scheme, dt):
        us = _port(unsteady=dt, scheme=scheme, **{"krylov.rtol": 1e-10})
        return us.solve(0.5, picard_iters=4).w[:us.n_u].numpy()

    ref = u_at_T("bdf2", 1.0 / 32)
    e2 = [np.linalg.norm(u_at_T("bdf2", dt) - ref) for dt in (0.25, 0.125)]
    e1 = [np.linalg.norm(u_at_T("theta", dt) - ref) for dt in (0.25, 0.125)]
    assert e2[0] / e2[1] > 3.5, e2
    assert e1[0] / e1[1] < 3.0, e1
    assert e2[1] < 0.5 * e1[1], (e2, e1)


def test_obstacle_channel_unsteady():
    """Flow past the square obstacle: implicit Euler with per-step PCD
    solves stays cheap, conserves mass and goes around the obstacle."""
    us = ObstacleChannel2D(level=0, device="cpu").solver(
        "BRM2", unsteady=0.2, **{"krylov.maxiter": 150})
    r = us.solve(0.6, picard_iters=1)
    assert max(r.linear_iters) < 150, r.linear_iters
    asm, w = us.asm, r.w
    n2 = asm.n2
    div = sum(asm.const.D[a].mv(w[a * n2:(a + 1) * n2]) for a in range(2))
    assert float(div.abs().max()) < 1e-9
    assert float(w[:2 * n2].abs().max()) < 2.0
    xy = asm.W.V.dof_coords()
    wake = (xy[:, 0] > 2.0) & (xy[:, 0] < 3.0)
    assert float(w[:n2][torch.as_tensor(wake)].abs().max()) > 0.3
