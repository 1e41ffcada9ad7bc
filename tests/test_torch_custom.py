"""The custom-form solver of the PyTorch port (``solvers/custom.py``,
``custom_forms.py``) and the lumped mass subsolve, on the CPU in f64.

One problem function (``custom_forms.problem``) takes either package's
mini-UFL modules, so the port and the JAX package solve the same forms:

  * ``PCDNewtonSolver`` on the level-0 step with the default dense
    subsolves, BRM2 and BRM1: the JAX package's per-step counts and state;
    the enclosed cavity (no PCD rows: the pressure nullspace): residual,
    matvec and preconditioner against the JAX package, then the port's
    Picard steps;
  * the golden bands of ``tests/test_custom_solver.py``: the non-factored
    ``fp`` form (BRM1), ``gp`` at scale 1.0 and the sign-flipped ``gp``
    that must degrade the counts;
  * one preconditioner apply on a seeded vector with the "lumped" and
    "chebyshev" pressure subsolves and the "jacobi" and "chebyshev"
    velocity sweeps, against the JAX package (1e-12);
  * a body force through ``coefficients=`` against the JAX package's
    ``NSAssembler.set_body_force`` residual;
  * the entry point on the CPU, and on the card by default;
  * ``OseenSolver`` with the lumped Mp: the JAX package's counts.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import custom_forms
from fenapack_tpu_torch.models import StepFlow2D
from fenapack_tpu_torch.solvers.custom import PCDAssembler, PCDNewtonSolver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_counts.json")
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _jax_modules():
    pytest.importorskip("jax")
    from fenapack_tpu.fem import forms as JF
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.dofmap import DirichletBC, TaylorHood
    return JF, jmesh, DirichletBC, TaylorHood


def _port_modules():
    from fenapack_tpu_torch.fem import forms as TF
    from fenapack_tpu_torch.fem import mesh as tmesh
    from fenapack_tpu_torch.fem.dofmap import DirichletBC, TaylorHood
    return TF, tmesh, DirichletBC, TaylorHood


def _jax_solver(variant, over=None, **kw):
    """The JAX package's ``PCDKrylovSolver`` for the same problem, with its
    default subsolves and the dotted overrides ``over``."""
    from fenapack_tpu.solvers.config import SolverConfig, overrides
    from fenapack_tpu.solvers.custom import PCDAssembler as JAsm
    from fenapack_tpu.solvers.custom import PCDKrylovSolver as JKrylov
    asm = JAsm(**custom_forms.problem(*_jax_modules(), 0, variant=variant,
                                      **kw))
    return JKrylov(asm, overrides(SolverConfig(), {
        "pcd.variant": variant, "krylov.rtol": 1e-8, **(over or {})}))


def _port_solver(variant, over=None, **kw):
    return custom_forms.build(0, variant=variant, device="cpu", **kw,
                              **(over or {}))


def _solve(solver, newton_cls, max_steps=15):
    return newton_cls(solver).solve(rtol=1e-5, max_steps=max_steps)


# --------------------------------------------------------------------- #
# solves against the JAX package and the golden bands
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("variant", ["BRM1", "BRM2"])
def test_custom_counts_match_jax(variant, golden):
    from fenapack_tpu.solvers.custom import PCDNewtonSolver as JNewton
    xj, _, itj, convj = _solve(_jax_solver(variant), JNewton)
    xt, rest, itt, convt = _solve(_port_solver(variant), PCDNewtonSolver)
    assert convj and convt
    assert itt == itj, (itt, itj)
    assert _rel(xt.numpy(), xj) <= 1e-10
    ref = golden[f"step2d/l0/{variant}/picard"]
    assert len(itt) in (ref["nonlinear_steps"] - 1, ref["nonlinear_steps"])
    assert sum(itt) <= 1.1 * ref["total"]
    assert rest[-1] <= 1e-5 * rest[0]


def test_custom_fp_form_converges(golden):
    """The non-factored Fp apply (-Mp^{-1} Fp Ap^{-1}, BRM1) converges
    within the band of the JAX package's test."""
    s = _port_solver("BRM1", use_fp=True)
    assert s.asm._kp is None and s.asm._fp is not None
    _, _, iters, converged = _solve(s, PCDNewtonSolver)
    assert converged
    assert sum(iters) <= 1.5 * golden["step2d/l0/BRM1/picard"]["total"]


def test_gp_form_is_wired(golden):
    """gp at scale 1.0 (J's up-block) stays in the golden band; the
    sign-flipped gp degrades the preconditioner, so gp really feeds the
    fieldsplit."""
    ref = golden["step2d/l0/BRM2/picard"]
    s = _port_solver("BRM2", gp_scale=1.0)
    assert s._gp_op is not None
    _, _, iters, converged = _solve(s, PCDNewtonSolver)
    assert converged
    assert sum(iters) <= 1.1 * ref["total"]
    _, _, iters_bad, _ = _solve(_port_solver("BRM2", gp_scale=-1.0),
                                PCDNewtonSolver, max_steps=4)
    assert sum(iters_bad[:3]) > 1.3 * sum(iters[:3])


def _cavity_problem(F, meshmod, DirichletBC, TaylorHood, nu=0.02):
    """The level-0 lid-driven cavity as custom forms, BRM2 without PCD
    Dirichlet rows: the enclosed flow's pressure nullspace."""
    mesh = meshmod.cavity_mesh(0)
    W = TaylorHood(mesh)
    (u, p) = F.TrialFunctions(W)
    (v, q) = F.TestFunctions(W)
    w = F.Coefficient(W, "w")
    u_, p_ = F.split(w)

    def lid(x):
        val = np.zeros((x.shape[0], 2))
        val[:, 0] = 1.0
        return val

    J = (nu * F.inner(F.grad(u), F.grad(v)) * F.dx
         + F.inner(F.dot(F.grad(u), u_), v) * F.dx
         - p * F.div(v) * F.dx - q * F.div(u) * F.dx)
    L = (nu * F.inner(F.grad(u_), F.grad(v)) * F.dx
         + F.inner(F.dot(F.grad(u_), u_), v) * F.dx
         - p_ * F.div(v) * F.dx - q * F.div(u_) * F.dx)
    bcs = [DirichletBC.velocity(W, [meshmod.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(W, [meshmod.INFLOW], lid)]
    return dict(a=J, L=L, bcs=bcs, w=w,
                mp=(1.0 / nu) * p * q * F.dx,
                ap=F.inner(F.grad(p), F.grad(q)) * F.dx,
                kp=(1.0 / nu) * F.dot(F.grad(p), u_) * q * F.dx)


def test_enclosed_custom_matches_jax():
    """No PCD rows: the Ap inverse with the constant shift and the pressure
    mean removed from the residual, against the JAX package at one iterate
    (residual, matvec, preconditioner apply); then the port's Picard steps
    keep the pressure mean at zero and reduce |F|."""
    import jax.numpy as jnp
    from fenapack_tpu.solvers.config import SolverConfig, overrides
    from fenapack_tpu.solvers.custom import PCDAssembler as JAsm
    from fenapack_tpu.solvers.custom import PCDKrylovSolver as JKrylov
    from fenapack_tpu.solvers.custom import PCDNewtonSolver as JNewton
    from fenapack_tpu_torch.solvers.custom import (DEFAULT_CONFIG,
                                                   PCDKrylovSolver)
    js = JKrylov(JAsm(**_cavity_problem(*_jax_modules())),
                 overrides(SolverConfig(), {"krylov.rtol": 1e-8}))
    ts = PCDKrylovSolver(PCDAssembler(**_cavity_problem(*_port_modules()),
                                      device="cpu"), DEFAULT_CONFIG)
    assert ts._nullspace and js._nullspace
    rng = np.random.default_rng(13)
    tn = PCDNewtonSolver(ts)
    x = tn.initial_state().numpy()
    x = x + 0.1 * rng.standard_normal(x.shape[0]) * (
        1.0 - np.concatenate([ts.bc_mask_u.numpy(), np.zeros(ts.W.dim_p)]))
    r = rng.standard_normal(x.shape[0])
    assert _rel(tn.residual(torch.as_tensor(x)).numpy(),
                JNewton(js)._residual(jnp.asarray(x))) <= TOL
    mt, pt = ts.system(torch.as_tensor(x))
    mj, pj = _jax_apply(js, jnp.asarray(x), jnp.asarray(r))
    assert _rel(mt(torch.as_tensor(r)).numpy(), mj) <= TOL
    assert _rel(pt(torch.as_tensor(r)).numpy(), pj) <= TOL
    xt, rt, itt, _ = _solve(ts, PCDNewtonSolver, max_steps=3)
    assert len(itt) == 3 and max(itt) < ts.config.krylov.maxiter
    assert rt[-1] < 0.1 * rt[0]
    assert abs(float(xt[ts.n_u:].mean())) <= 1e-12


# --------------------------------------------------------------------- #
# single preconditioner applies against the JAX package
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def iterate():
    """A random iterate with the boundary values and a residual-like
    vector, from one seed."""
    rng = np.random.default_rng(21)
    s = _port_solver("BRM2")
    x = PCDNewtonSolver(s).initial_state().numpy()
    x = x + 0.1 * rng.standard_normal(x.shape[0]) * (
        1.0 - np.concatenate([s.bc_mask_u.numpy(), np.zeros(s.W.dim_p)]))
    return x, rng.standard_normal(x.shape[0])


def _jax_apply(js, x, r):
    """The JAX solver's matvec and preconditioner at ``x`` applied to
    ``r``, built from its pieces as its ``_solve_impl`` does (one jit: the
    eager build compiles every operation on its own)."""
    import jax
    from fenapack_tpu.solvers.fieldsplit import make_fieldsplit_upper

    def apply(x, r):
        blocks = js.asm.system_matrix(x)
        matvec, Auu = js._block_matvec(blocks)
        a_solve = js._velocity_solver(Auu, js.asm.pc_matrix(x))
        bt = js.asm.fc.pattern("u", "p").matrix(blocks["up"]).mv
        pc = make_fieldsplit_upper(js.n_u, a_solve, js._pcd_apply(x), bt,
                                   js.free_u)
        return matvec(r), pc(r)
    return [np.asarray(v) for v in jax.jit(apply)(x, r)]


@pytest.mark.parametrize("variant,over,kw", [
    ("BRM2", {"pcd.mp.method": "lumped"}, {}),
    ("BRM1", {"pcd.ap.method": "chebyshev"}, {}),
    ("BRM2", {"velocity.method": "jacobi"}, {}),
    ("BRM2", {"velocity.method": "chebyshev"}, {}),
    ("BRM1", {"pcd.mp.method": "lumped"}, {"use_fp": True}),
], ids=["lumped-mp", "chebyshev-ap", "jacobi-velocity", "chebyshev-velocity",
        "fp-lumped-mp"])
def test_single_apply_matches_jax(iterate, variant, over, kw):
    import jax.numpy as jnp
    x, r = iterate
    ts = _port_solver(variant, over, **kw)
    js = _jax_solver(variant, over, **kw)
    mt, pt = ts.system(torch.as_tensor(x))
    mj, pj = _jax_apply(js, jnp.asarray(x), jnp.asarray(r))
    assert _rel(mt(torch.as_tensor(r)).numpy(), mj) <= TOL
    assert _rel(pt(torch.as_tensor(r)).numpy(), pj) <= TOL


def test_jacobi_and_lumped_inverse_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.ops import subsolve as jsub
    from fenapack_tpu.ops.sparse import ELL as JELL
    from fenapack_tpu_torch.ops import subsolve
    from fenapack_tpu_torch.ops.sparse import ELL
    rng = np.random.default_rng(2)
    cols = rng.integers(0, 40, size=(40, 5)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, size=(40, 5))
    vals[7] = 0.0                                   # an empty row
    dt = ELL(torch.as_tensor(cols), torch.as_tensor(vals), 40)
    dj = JELL(jnp.asarray(cols), jnp.asarray(vals), 40)
    lt, lj = subsolve.lumped_inverse(dt), jsub.lumped_inverse(dj)
    assert float(lt[7]) == 1.0
    assert _rel(lt.numpy(), lj) <= 1e-15
    # the block-sparse layout (the step benchmark's Mp), rows padded to
    # whole tiles
    from fenapack_tpu.ops.sparse import pattern_from_dofmaps as jpattern
    from fenapack_tpu_torch.ops.sparse import pattern_from_dofmaps
    cd = rng.integers(0, 90, size=(60, 3))
    ev = rng.uniform(0.5, 1.5, size=(60, 3, 3))
    bt = pattern_from_dofmaps(cd, cd, 90, 90, block=16,
                              device="cpu").assemble(torch.as_tensor(ev))
    bj = jpattern(cd, cd, 90, 90, block=16).assemble(jnp.asarray(ev))
    lt, lj = subsolve.lumped_inverse(bt), jsub.lumped_inverse(bj)
    assert lt.shape == (90,)
    assert _rel(lt.numpy(), lj) <= 1e-15
    diag, b = rng.uniform(1, 2, 40), rng.standard_normal(40)
    assert _rel(subsolve.make_jacobi(torch.as_tensor(diag))(
        torch.as_tensor(b)).numpy(),
        jsub.make_jacobi(jnp.asarray(diag))(jnp.asarray(b))) <= 1e-15


# --------------------------------------------------------------------- #
# a body force through coefficients=
# --------------------------------------------------------------------- #

def test_custom_coefficients_body_force():
    """A polynomial body force (P2-representable, quadrature-exact) as an
    extra coefficient: the residual matches the JAX package's factored
    ``set_body_force`` residual and its custom assembler's."""
    JF, jmesh, JBC, JTH = _jax_modules()
    import jax
    import jax.numpy as jnp
    from fenapack_tpu.fem.assemble import NSAssembler as JNS
    from fenapack_tpu.solvers.custom import PCDAssembler as JAsm
    nu = 1.0

    def poly_force(x):
        return np.stack([x[:, 0] ** 2, x[:, 0] * x[:, 1]], axis=1)

    def forms(F, meshmod, TaylorHood):
        mesh = meshmod.rectangle_mesh(0.0, 0.0, 1.0, 1.0, 4, 4)
        mesh.mark_boundary({meshmod.WALL: lambda x: np.ones(x.shape[0],
                                                            bool)},
                           overwrite=True)
        W = TaylorHood(mesh)
        (u, p) = F.TrialFunctions(W)
        (v, q) = F.TestFunctions(W)
        w, f = F.Coefficient(W, "w"), F.Coefficient(W, "f")
        u_, p_ = F.split(w)
        f_u, _ = F.split(f)
        L = (nu * F.inner(F.grad(u_), F.grad(v)) * F.dx
             + F.inner(F.dot(F.grad(u_), u_), v) * F.dx
             - p_ * F.div(v) * F.dx - q * F.div(u_) * F.dx
             + (-1.0) * F.dot(f_u, v) * F.dx)
        J = (nu * F.inner(F.grad(u), F.grad(v)) * F.dx
             - p * F.div(v) * F.dx - q * F.div(u) * F.dx)
        fvals = np.zeros(W.dim)
        fv = poly_force(W.V.dof_coords())
        fvals[:W.n2], fvals[W.n2:2 * W.n2] = fv[:, 0], fv[:, 1]
        return mesh, W, dict(a=J, L=L, bcs=[], w=w,
                             coefficients={"f": fvals})

    TF, tmesh, _, TTH = _port_modules()
    _, W, targs = forms(TF, tmesh, TTH)
    jm, _, jargs = forms(JF, jmesh, JTH)
    x = np.random.default_rng(7).standard_normal(W.dim) * 0.1
    got = PCDAssembler(**targs, device="cpu").rhs_vector(
        torch.as_tensor(x)).numpy()
    jargs["coefficients"] = {"f": jnp.asarray(jargs["coefficients"]["f"])}
    # the JAX side under one jit each (eager, every operation compiles)
    jcustom = np.asarray(jax.jit(JAsm(**jargs).rhs_vector)(jnp.asarray(x)))
    asm = JNS(jm, nu)
    asm.set_body_force(poly_force)
    n_u = 2 * asm.n2
    ru, rp = jax.jit(asm.residual)(jnp.asarray(x[:n_u]),
                                   jnp.asarray(x[n_u:]))
    ref = np.concatenate([np.asarray(ru), np.asarray(rp)])
    assert _rel(got, jcustom) <= TOL
    assert _rel(got, ref) <= 1e-11


# --------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------- #

def test_entry_point_converges_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "fenapack_tpu_torch.custom_forms", "-l", "0",
         "--rtol", "1e-3", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "converged: True" in proc.stdout
    assert "K3 launches 0" in proc.stdout             # plain products


def test_entry_point_defaults_to_the_card():
    """Without a card the entry point fails unless the CPU is asked for."""
    import inspect
    assert inspect.signature(PCDAssembler).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        custom_forms.main(["-l", "0"])


# --------------------------------------------------------------------- #
# OseenSolver with the lumped Mp
# --------------------------------------------------------------------- #

def test_oseen_lumped_mp_counts_match_jax():
    """Step level 0, Picard, BRM2, dense velocity and Ap inverses, Mp by
    its lumped inverse: the JAX package's per-step counts."""
    pytest.importorskip("jax")
    from fenapack_tpu.models import StepFlow2D as JStep
    over = {"pcd.mp.method": "lumped"}
    rt = StepFlow2D(level=0, device="cpu").solver(
        "BRM2", **over).solve(rtol=1e-5, max_steps=15)
    rj = JStep(level=0).solver("BRM2", **over).solve(rtol=1e-5,
                                                     max_steps=15)
    assert rt.converged and rj.converged
    assert rt.linear_iters == [int(i) for i in rj.linear_iters], (
        rt.linear_iters, rj.linear_iters)
    assert max(rt.lin_rel) <= 1e-8
