"""The plain reference on the CPU: its rules, its meshes against the
program's, and its readings of states the program solved at small
sizes."""
import numpy as np
import pytest
import torch

from pcdbench.force import body_force
from pcdbench.reference import judge, quadrature, step


@pytest.mark.parametrize("dim,degree", [(2, 5), (3, 4)])
def test_rules_integrate_monomials_exactly(dim, degree):
    from math import factorial
    pts, w = quadrature.rule(dim, degree)
    for p in range(degree + 1):
        for q in range(degree + 1 - p):
            if dim == 2:
                exact = factorial(p) * factorial(q) / factorial(p + q + 2)
                got = np.sum(w * pts[:, 0] ** p * pts[:, 1] ** q)
                assert got == pytest.approx(exact, rel=1e-13, abs=1e-15)
            else:
                r = degree - p - q
                exact = (factorial(p) * factorial(q) * factorial(r)
                         / factorial(p + q + r + 3))
                got = np.sum(w * pts[:, 0] ** p * pts[:, 1] ** q
                             * pts[:, 2] ** r)
                assert got == pytest.approx(exact, rel=1e-13, abs=1e-15)


def test_match_is_one_to_one():
    pts = np.array([[0.0, 0.0], [0.5, 0.25], [1.0, -1.0]])
    perm = judge.match(pts, pts[[2, 0, 1]])
    assert perm.tolist() == [2, 0, 1]
    with pytest.raises(ValueError):
        judge.match(pts, pts[[0, 0, 1]])
    with pytest.raises(ValueError):
        judge.match(pts, pts + 1e-3)


@pytest.mark.parametrize("spec", [
    dict(domain="step2d", level=0, length=5.0),
    dict(domain="step3d", level=2, length=3.0)])
def test_meshes_are_the_programs(spec):
    from fenapack_tpu_torch.fem import mesh as meshmod, mesh3d
    from fenapack_tpu_torch.fem.dofmap import TaylorHood
    from fenapack_tpu_torch.solvers import gmg
    base = (meshmod.backward_step_mesh(0, length=spec["length"])
            if spec["domain"] == "step2d"
            else mesh3d.backward_step_mesh3d(0, length=spec["length"]))
    W = TaylorHood(gmg.build_hierarchy(base, spec["level"]).fine)
    m, dirichlet, g = step.build(spec)
    judge.match(m.nodes, W.V.dof_coords())
    judge.match(m.vertices, W.Q.dof_coords())
    assert g[:, 0].max() == 1.0 and dirichlet.sum() > 0


def _solved(which, loaded=True):
    from fenapack_tpu_torch import bench, step3d
    if which == "step2d":
        nl = bench.build(0, device="cpu")
        spec = dict(domain="step2d", level=0, length=5.0, nu=0.02,
                    quad_degree=5)
        kw = dict(anderson=6, max_steps=25)
    else:
        nl = step3d.build(1, length=3.0, device="cpu")
        spec = dict(domain="step3d", level=1, length=3.0, nu=0.05,
                    quad_degree=4)
        kw = dict(anderson=0, max_steps=20)
    f = body_force(2 ** 33 + 5, nl.asm.dim, 0.01, 4, 2)
    if loaded:
        nl.asm.set_body_force(f)
    w0 = nl.initial_state().to(torch.float64)
    r = nl.make_full_solve(rtol=1e-5, rtol_lin=1e-8, **kw)(w0)
    j = judge.Judge(spec, f, device="cpu")
    j.layout(nl.asm.W.V.dof_coords(), nl.asm.W.Q.dof_coords())
    return nl, r, j, w0


@pytest.mark.parametrize("which", ["step2d", "step3d"])
def test_readings_of_a_solved_state(which):
    nl, r, j, w0 = _solved(which)
    assert r.converged
    got = j.readings(r.w.numpy())
    # the program's own nonlinear residual, measured again
    assert got["res_rel"] == pytest.approx(r.res[-1] / r.res[0], rel=1e-8)
    assert got["bc_err"] == 0.0
    assert got["cont_rel"] < 1e-11
    start = j.readings(w0.numpy())
    assert start["res_rel"] == pytest.approx(1.0, rel=1e-12)
    # float32 rounding of the answer fails the continuity reading
    assert j.readings(r.w.float().double().numpy())["cont_rel"] > 1e-9
    # a state solved without the load is far off
    _, r0, _, _ = _solved(which, loaded=False)
    assert r0.converged
    assert j.readings(r0.w.numpy())["res_rel"] > 1e-4
