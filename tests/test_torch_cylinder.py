"""The DFG cylinder slice of the PyTorch port (snapped hierarchy, p-coarse
bottom level at the real dense cap, minimal-residual smoother, drag/lift
functionals) against the JAX package, on the CPU in f64.

  * host: ``cylinder_channel_mesh(0)`` and the snapped level-1 hierarchy
    array-equal; the P2 transfer's midpoint stencil of the snapped pair
    (1e-14), whose weights near the circle are no longer the nested-mesh
    3/8, 3/4, -1/8.
  * functionals: wall friction of Couette flow (+-nu L to 1e-12) and point
    evaluation of a linear field (1e-12), as the JAX package's own tests.
  * the slice: level 0 is 20,954 dofs and its full Newton solve takes a
    minute, so one linear solve of it (the first Newton step) is compared:
    iteration count within 1, solution within 1e-7 relative, built once
    for the module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)

import fenapack_tpu_torch as ft
from fenapack_tpu_torch import cylinder
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.models import CylinderChannel2D
from fenapack_tpu_torch.solvers import gmg as tgmg
from fenapack_tpu_torch.utils import functionals as tfun

MESH_FIELDS = ("vertices", "cells", "edges", "cell_edges", "boundary_facets",
               "facet_cells", "facet_markers")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# --------------------------------------------------------------------- #
# host: mesh, snapped hierarchy, transfers
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def hier_pair():
    """The snapped level-1 hierarchy in the port and in the JAX package."""
    pytest.importorskip("jax")
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.solvers import gmg as jgmg
    ht = tgmg.build_hierarchy(tmesh.cylinder_channel_mesh(0), 1,
                              snap=tmesh.snap_to_circle)
    hj = jgmg.build_hierarchy(jmesh.cylinder_channel_mesh(0), 1,
                              snap=jmesh.snap_to_circle)
    return ht, hj


def test_cylinder_hierarchy_matches_jax(hier_pair):
    ht, hj = hier_pair
    for mt, mj in zip(ht.meshes, hj.meshes):
        for f in MESH_FIELDS:
            np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
    np.testing.assert_array_equal(ht.parents[0], hj.parents[0])
    assert tmesh.CYLINDER == 4
    # the model's mesh is the hierarchy's fine mesh
    m1 = CylinderChannel2D(level=1, device="cpu").mesh()
    np.testing.assert_array_equal(m1.vertices, ht.fine.vertices)
    np.testing.assert_array_equal(m1.cells, ht.fine.cells)


def test_cylinder_mesh_geometry(hier_pair):
    """Markers present, snapped vertices on the circle at every level, no
    degenerate cell; an unsnapped refinement leaves chord midpoints inside
    the circle."""
    ht, _ = hier_pair
    for mesh in ht.meshes:
        on = mesh.facet_markers == tmesh.CYLINDER
        assert on.sum() >= 20
        assert (mesh.facet_markers == tmesh.INFLOW).any()
        assert (mesh.facet_markers == tmesh.OUTFLOW).any()
        vids = np.unique(mesh.edges[mesh.boundary_facets[on]])
        d = np.linalg.norm(mesh.vertices[vids] - [0.2, 0.2], axis=1)
        assert np.abs(d - 0.05).max() < 1e-12
        assert tmesh.triangle_quality(mesh).min() > 0.05
    plain = tgmg.build_hierarchy(ht.meshes[0], 1).fine
    vids = np.unique(plain.edges[plain.boundary_facets[
        plain.facet_markers == tmesh.CYLINDER]])
    d = np.linalg.norm(plain.vertices[vids] - [0.2, 0.2], axis=1)
    assert d.min() < 0.05 - 1e-5


def test_snapped_p2_transfer_matches_jax(hier_pair):
    import jax.numpy as jnp
    from fenapack_tpu.solvers.gmg import P2Transfer as JP2
    ht, hj = hier_pair
    tt = tgmg.P2Transfer(ht.meshes[0], ht.meshes[1], torch.float64,
                         device="cpu")
    tj = JP2(hj.meshes[0], hj.meshes[1], jnp.float64)
    np.testing.assert_array_equal(tt.mid_dofs.numpy(), np.asarray(tj.mid_dofs))
    assert _rel(tt.mid_w.numpy(), tj.mid_w) <= 1e-14
    # nested meshes give weights from {0, 3/8, 3/4, -1/8, 1/2, 1/4}; the
    # snapped edges near the circle do not
    nested = np.array([0.0, 0.375, 0.75, -0.125, 0.5, 0.25, 1.0])
    off = np.abs(tt.mid_w.numpy()[..., None] - nested).min(axis=-1)
    assert (off.max(axis=1) > 1e-6).sum() >= 20
    assert (off.max(axis=1) < 1e-12).sum() > 0.9 * off.shape[0]
    x = np.random.default_rng(2).standard_normal(tt.n_coarse)
    assert _rel(tt.prolong(torch.as_tensor(x)).numpy(),
                tj.prolong(jnp.asarray(x))) <= 1e-14


# --------------------------------------------------------------------- #
# functionals
# --------------------------------------------------------------------- #

def test_boundary_reaction_couette_wall_friction():
    """Couette flow u = (y, 0), p = 0 on [0, L] x [0, 1] is an exact
    discrete state with zero convection and zero traction on the ends: the
    fluid drags the bottom wall with (+nu L, 0) and the top wall with
    (-nu L, 0)."""
    nu, L = 0.1, 2.0
    mesh = tmesh.rectangle_mesh(0.0, 0.0, L, 1.0, 8, 4)
    tol, BOT, TOP = 1e-9, 7, 8
    mesh.mark_boundary({
        tmesh.WALL: lambda x: np.ones(x.shape[0], dtype=bool),
        tmesh.INFLOW: lambda x: x[:, 0] < tol,
        tmesh.OUTFLOW: lambda x: x[:, 0] > L - tol,
        BOT: lambda x: x[:, 1] < tol,
        TOP: lambda x: x[:, 1] > 1.0 - tol,
    })
    asm = ft.NSAssembler(mesh, nu, device="cpu")
    u = torch.as_tensor(np.concatenate([asm.W.V.dof_coords()[:, 1],
                                        np.zeros(asm.n2)]))
    p = torch.zeros(asm.n1, dtype=torch.float64)
    Fb = tfun.boundary_reaction(asm, u, p, [BOT])
    Ft = tfun.boundary_reaction(asm, u, p, [TOP])
    assert abs(Fb[0] - nu * L) < 1e-12 and abs(Ft[0] + nu * L) < 1e-12
    assert abs(Fb[1]) < 1e-12 and abs(Ft[1]) < 1e-12


def test_eval_p1_interpolates_linears_exactly(hier_pair):
    asm = ft.NSAssembler(hier_pair[0].meshes[0], 0.001, device="cpu",
                         p1_only=True)
    xy = asm.W.Q.dof_coords()
    vals = 2.0 * xy[:, 0] - 3.0 * xy[:, 1] + 1.0
    pts = [(0.15, 0.2), (0.25, 0.2), (1.0, 0.3), (2.1, 0.05)]
    want = np.array([2 * x - 3 * y + 1 for x, y in pts])
    assert np.abs(tfun.eval_p1(asm, vals, pts) - want).max() < 1e-12
    idx, wts = tfun.p1_point_weights(asm, pts)
    assert idx.shape == wts.shape == (4, 3)
    assert np.abs(wts.sum(axis=1) - 1.0).max() < 1e-12
    # a point inside the hole takes the nearest vertex's value
    inside = tfun.eval_p1(asm, vals, [(0.2, 0.2)])
    assert np.abs(xy[np.argmin(np.abs(vals - inside[0]))] - 0.2).max() < 0.06


def test_summarize_recovers_the_strouhal_number():
    """A synthetic lift signal of frequency 3: St = f D / Ubar = 0.3."""
    dt = 0.00625
    t = dt * (1 + np.arange(1280))
    vals = np.stack([1.6 + 0.02 * np.sin(12 * np.pi * t),
                     0.5 * np.sin(6 * np.pi * t + 0.3), 2.5 + 0 * t,
                     0.0 * t], axis=1) / cylinder.coeff(100)
    vals[:, 2:] *= cylinder.coeff(100)
    hist = cylinder.history(torch.as_tensor(vals), dt)
    assert hist.shape == (1280, 4) and abs(hist[-1, 0] - 8.0) < 1e-12
    s = cylinder.summarize(hist)
    assert abs(s["St"] - 0.3) < 2e-3
    assert abs(s["c_Dmax"] - 1.62) < 1e-3 and abs(s["c_Lmax"] - 0.5) < 1e-3
    assert cylinder.summarize(hist[:3])["St"] is None


# --------------------------------------------------------------------- #
# the slice at level 0: one linear solve, port against JAX
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def first_newton_step():
    """The first Newton step's linear solve of DFG 2D-1 at level 0 in both
    packages, from the port's right-hand side: (port solver, port result,
    true relative residual, JAX result)."""
    nt = cylinder.build(0, 20, device="cpu")
    w0 = nt.initial_state()
    b = -nt.residual_of(w0)[0]
    rt, matvec = nt.oseen.solve(w0[:nt.n_u], b)
    rel = float(torch.linalg.norm(b - matvec(rt.x))) / rt.bnorm
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.models import CylinderChannel2D as JCyl
    nj = JCyl(level=0, nu=cylinder.NU, u_mean=0.2).solver(
        "BRM2", linearization="newton", gmg_subsolves=True, **cylinder.CFG)
    assert _rel(w0.numpy(), nj.initial_state()) == 0.0
    rj = nj.oseen.solve(jnp.asarray(w0.numpy()[:nt.n_u]),
                        jnp.asarray(b.numpy()))
    return nt, rt, rel, rj


def test_cylinder_slice_configuration(first_newton_step):
    nt = first_newton_step[0]
    assert CylinderChannel2D().device == "cuda"
    o, cfg = nt.oseen, nt.oseen.config
    assert nt.n == 20954 and o.linearization == "newton"
    assert (cfg.velocity.smoother, cfg.velocity.smooth_iters,
            cfg.velocity.cycles, cfg.pcd.ap.method, cfg.pcd.variant) == \
        ("minres", 3, 2, "gmg", "BRM2")
    assert o.pcd_marker == tmesh.OUTFLOW and not nt.enclosed
    # the base mesh is over the dense cap, its P1 space is not
    vh = o.velocity_hierarchy
    assert tgmg.DENSE_MAX == 8192
    assert 2 * vh.asms[0].n2 > 8192 >= 2 * vh.asms[0].n1
    assert tgmg._velocity_gmg_plan(vh, 2) == (True, False)
    assert nt.asm.pat_p2.cols.dtype == torch.int32
    # no-slip on the walls and on the cylinder
    cyl = nt.asm.W.V.facet_dofs([tmesh.CYLINDER])
    assert float(o.bc_mask_u[torch.as_tensor(cyl.astype(np.int64))].min()) == 1


def test_cylinder_first_newton_solve_counts_match_jax(first_newton_step):
    _, rt, rel, rj = first_newton_step
    assert rt.converged and rel <= 1e-8
    assert abs(rt.iters - int(rj.iters)) <= 1, (rt.iters, int(rj.iters))
    # the JAX package's record for this step: 44
    assert abs(rt.iters - 44) <= 1


def test_cylinder_first_newton_solution_matches_jax(first_newton_step):
    _, rt, _, rj = first_newton_step
    assert _rel(rt.x.numpy(), rj.x) <= 1e-7


def test_cylinder_coefficients_match_jax(first_newton_step):
    """c_D, c_L and dP of the state after the first Newton step, against
    the JAX package's functionals on the same state: 1e-8."""
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    from fenapack_tpu.utils.functionals import (boundary_reaction as jbr,
                                                eval_p1 as jev)
    nt, rt, _, _ = first_newton_step
    w = nt.initial_state() + rt.x
    cd, cl, dp = cylinder.coefficients(nt.asm, w, 20)
    aj = JAsm(jmesh.cylinder_channel_mesh(0), cylinder.NU)
    wj = jnp.asarray(w.numpy())
    F = jbr(aj, wj[:nt.n_u], wj[nt.n_u:], [jmesh.CYLINDER])
    pj = jev(aj, w.numpy()[nt.n_u:], cylinder.PROBES)
    want = (cylinder.coeff(20) * F[0], cylinder.coeff(20) * F[1],
            pj[0] - pj[1])
    assert _rel([cd, cl, dp], want) <= 1e-8
    assert abs(cylinder.coeff(20) - 500.0) < 1e-9
    assert abs(cylinder.coeff(100) - 20.0) < 1e-12
    assert 3.0 < cd < 8.0          # one Newton step from rest: Stokes-like


def test_cylinder_ell_operators_cover_the_path(first_newton_step):
    nt = first_newton_step[0]
    ops = {name: (pat, vals) for name, pat, vals in
           cylinder.ell_operators(nt)}
    assert {"P1 bottom operator", "A1 velocity level 0",
            "R01 velocity level 0", "D0", "Bt1", "Ap pressure level 0",
            "Mp", "Kp", "M2"} <= set(ops)
    pat1, p1 = ops["P1 bottom operator"]
    assert tuple(p1.shape) == tuple(pat1.value_shape) and pat1.n_rows == \
        nt.asm.n1
    us = cylinder.build(0, 100, device="cpu", unsteady=True)
    assert (us.scheme, us.dt, us.oseen.inv_dt) == ("bdf2", 0.025, 60.0)
    assert us.oseen.linearization == "picard"
    # the stepper's Picard operator carries 1.5/dt M2 and no reaction block
    wind = us.initial_state()[:us.n_u]
    A1s, R = us.oseen._operator_values(wind)
    A1 = us.asm.picard_matrix_values(wind)
    assert R is None
    assert _rel(A1s.numpy(),
                (A1 + 60.0 * us.asm.const.M2.vals).numpy()) <= 1e-14
