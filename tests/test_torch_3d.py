"""The 3D slice of the PyTorch port (BASELINE config 4: tet Taylor-Hood
assembly, the factorization-free velocity sweeps, 1:8 multigrid, the
``step3d`` entry point) against the JAX package, on the CPU in f64.

  * assembly on the duct at level 0: every constant operator, and at a
    random wind the convection, the Newton reaction blocks, Kp with and
    without the BRM2 surface term (triangle faces), the P2 and P1
    streamline diffusion, all within 1e-12 relative (max-norm); the plain
    d = 3 block product against the JAX package's composition of single
    ELL products (1e-12).
  * solves on the duct at level 0 with dense velocity and Ap inverses:
    Picard with BRM2 and BRM1, and with the "jacobi", "chebyshev" and
    "minres" velocity sweeps, the same per-step counts as the JAX package
    (BRM2's first step within one: its solve stops on the edge); the
    port's counts against an exact-PCD FGMRES written in scipy
    (``tests/test_3d_oracle.py``); three implicit-Euler steps (theta = 1),
    the same counts.
  * the GMG path: ``step3d.build(1)`` (14,104 dofs) against the JAX demo's
    ``demos/demo_step3d.py -l 1 --block 0`` built with its single-round
    solve (``krylov.hi_krylov``): two Picard steps, the same counts, states
    within 1e-8 (2-norm, relative).
"""
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import step3d
from fenapack_tpu_torch.fem import mesh3d as tmesh3d
from fenapack_tpu_torch.models import Duct3D
from fenapack_tpu_torch.ops import ell_spmv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NU = 0.1
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_duct():
    pytest.importorskip("jax")
    from fenapack_tpu.models import Duct3D as JDuct
    return JDuct


@pytest.fixture(scope="module")
def asm_pair():
    """(port assembler, JAX assembler, random wind) on the level-0 duct."""
    JDuct = _jax_duct()
    ta = Duct3D(level=0, nu=NU, device="cpu").assembler()
    ja = JDuct(level=0, nu=NU).assembler()
    u = np.random.default_rng(11).standard_normal(3 * ta.n2)
    return ta, ja, u


# --------------------------------------------------------------------- #
# assembly
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["L", "Mp", "Ap", "D", "DT", "M2"])
def test_duct_constant_operators_match_jax(asm_pair, name):
    ta, ja, _ = asm_pair
    assert (ta.dim, ta.nq, ta.nb2, ta.nb1) == (3, 27, 10, 4)
    ot, oj = getattr(ta.const, name), getattr(ja.const, name)
    ot, oj = (ot, oj) if name in ("D", "DT") else ((ot,), (oj,))
    assert len(ot) == len(oj)
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a.cols.numpy(), np.asarray(b.cols))
        assert _rel(a.vals.numpy(), b.vals) <= TOL


@pytest.mark.parametrize("name", ["convection", "newton", "kp", "kp_surface",
                                  "supg", "supg_p1"])
def test_duct_wind_operators_match_jax(asm_pair, name):
    import jax.numpy as jnp
    ta, ja, u = asm_pair
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    calls = {
        "convection": lambda a, w: a.convection_values(w),
        "newton": lambda a, w: a.newton_reaction_values(w),
        "kp": lambda a, w: a.kp_values(w),
        "kp_surface": lambda a, w: a.kp_values(w, surface=True),
        "supg": lambda a, w: a.supg_values(w),
        "supg_p1": lambda a, w: a.supg_p1_values(w),
    }
    got, ref = calls[name](ta, ut).numpy(), np.asarray(calls[name](ja, uj))
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL
    if name == "kp_surface":      # the duct's inflow face carries the term
        assert ta.n_inflow_facets == 8
        assert _rel(got, np.asarray(ja.kp_values(uj))) > 1e-3


def test_block_product_d3_matches_jax_composition(asm_pair):
    """The plain block product at d = 3 with the Newton reaction blocks and
    a y0 term against the JAX package's composition of single ELL products
    (``fenapack_tpu/solvers/gmg.py`` velocity level matvec)."""
    import jax.numpy as jnp
    ta, ja, u = asm_pair
    A1 = ta.picard_matrix_values(torch.as_tensor(u))
    R = ta.newton_reaction_values(torch.as_tensor(u))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, ta.n2))
    y0 = rng.standard_normal((3, ta.n2))
    got = ell_spmv.ell_block_spmv(ta.pat_p2.cols, A1, R, torch.as_tensor(x),
                                  ta.n2, torch.as_tensor(y0)).numpy()
    pj = ja.pat_p2
    A1j, Rj = np.asarray(A1.numpy()), np.asarray(R.numpy())
    ref = []
    for a in range(3):
        y = pj.matrix(jnp.asarray(A1j)).mv(jnp.asarray(x[a])) + y0[a]
        for b in range(3):
            y = y + pj.matrix(jnp.asarray(Rj[a, b])).mv(jnp.asarray(x[b]))
        ref.append(np.asarray(y))
    assert _rel(got, np.stack(ref)) <= TOL


# --------------------------------------------------------------------- #
# solves on the duct
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def brm2_pair():
    """Picard with BRM2 and dense subsolves to 1e-6 on the level-0 duct,
    in both packages (``tests/test_3d.py::test_duct_solve_physics``).  The
    JAX package's dense inverses run on a LAPACK at one thread per core,
    the width it takes unlimited: on one thread their last bits move counts
    2-4 by one."""
    from threadpoolctl import threadpool_limits

    JDuct = _jax_duct()
    rt = Duct3D(level=0, nu=NU, device="cpu").solver("BRM2").solve(
        rtol=1e-6, max_steps=15)
    with threadpool_limits(limits=len(os.sched_getaffinity(0)),
                           user_api="blas"):
        rj = JDuct(level=0, nu=NU).solver("BRM2").solve(rtol=1e-6,
                                                        max_steps=15)
    return rt, rj


def test_duct_brm2_counts_match_jax(brm2_pair):
    """BRM2 with dense subsolves: the same counts as the JAX package from
    the second Picard step on, and the first within one.  The duct's first
    solve ends at a residual estimate of 1.94e-9 against the stop at
    2.00e-9 (1e-8 |b|), so the last bits of the dense inverse decide
    between 25 and 26 iterations there (the port takes 25 on four threads,
    26 on one; the JAX package 25)."""
    rt, rj = brm2_pair
    assert rt.converged
    ji = [int(i) for i in rj.linear_iters]
    assert rt.linear_iters[1:] == ji[1:], (rt.linear_iters, ji)
    assert abs(rt.linear_iters[0] - ji[0]) <= 1, (rt.linear_iters, ji)
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    nl = Duct3D(level=0, nu=NU, device="cpu").solver("BRM2")
    assert step3d.divergence(nl, rt.w) < 1e-10
    assert float(rt.w[:nl.n_u].abs().max()) < 1.05


@pytest.mark.parametrize("velocity,over,rtol", [
    ("lu", {"pcd.variant": "BRM1"}, 1e-5),
    ("jacobi", {"velocity.method": "jacobi", "velocity.iters": 30,
                "krylov.maxiter": 300}, 1e-5),
    ("chebyshev", {"velocity.method": "chebyshev", "velocity.iters": 30,
                   "krylov.maxiter": 300}, 1e-5),
    ("chebyshev", {"velocity.method": "chebyshev", "velocity.iters": 30,
                   "velocity.bounds": (0.3, 2.2), "krylov.maxiter": 300},
     1e-5),
    ("minres", {"velocity.method": "minres", "velocity.iters": 32,
                "krylov.maxiter": 300}, 1e-5),
], ids=["brm1", "jacobi-velocity", "chebyshev-velocity",
        "chebyshev-velocity-bounds", "minres-velocity"])
def test_duct_counts_match_jax(velocity, over, rtol):
    """BRM1 (``tests/test_3d.py::test_duct_brm1``) and the factorization-free
    velocity sweeps (``test_velocity_jacobi_subsolve``): Jacobi, Chebyshev
    at the default bounds (0.1, 2.0) and at given ones, and the iterated
    minimal-residual sweeps.  The same per-step counts as the JAX package,
    states within 1e-8."""
    JDuct = _jax_duct()
    pcd = over.pop("pcd.variant", "BRM2")
    rt = Duct3D(level=0, nu=NU, device="cpu").solver(pcd, **over).solve(
        rtol=rtol, max_steps=10)
    rj = JDuct(level=0, nu=NU).solver(pcd, **over).solve(rtol=rtol,
                                                         max_steps=10)
    assert rt.converged
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8


def _csr(pat, vals, shape):
    v = np.asarray(vals).reshape(-1)[pat._upos]
    return sp.csr_matrix((v, (pat._urow, pat._ucol)), shape=shape)


def _mask_sym(A, mask):
    free = sp.diags(1.0 - mask)
    return free @ A @ free + sp.diags(mask)


@pytest.mark.parametrize("variant", ["BRM2", "BRM1"])
def test_duct_counts_match_scipy_exact_pcd(variant):
    """``tests/test_3d_oracle.py`` with the port in place of the JAX
    package: along the Picard trajectory of an exact-PCD FGMRES written in
    scipy (``tests/reference_fem/oracle.py``), the port's Oseen solve with
    dense subsolves on the same system takes, in total, the oracle's count
    within the band that test allows (max(2, 10%))."""
    sys.path.insert(0, ROOT)
    from tests.reference_fem.oracle import fgmres
    nl = Duct3D(level=0, nu=NU, device="cpu").solver(
        variant, **{"krylov.rtol": 1e-8, "krylov.maxiter": 200,
                    "pcd.mp.method": "lu"})
    o, asm = nl.oseen, nl.asm
    d, n2, n1, n_u = 3, asm.n2, asm.n1, nl.n_u
    bc_mask_u = o.bc_mask_u.numpy()
    free_u = 1.0 - bc_mask_u
    mask_full = np.concatenate([bc_mask_u, np.zeros(n1)])
    c = asm.const
    D = [_csr(asm.pat_div, c.D[a].vals, (n1, n2)) for a in range(d)]
    DT = [_csr(asm.pat_divT, c.DT[a].vals, (n2, n1)) for a in range(d)]
    Mp_lu = spla.splu(_csr(asm.pat_p1, c.Mp.vals, (n1, n1)).tocsc())
    pcd_mask = o.pcd_mask.numpy()
    Ap_lu = spla.splu(_mask_sym(_csr(asm.pat_p1, c.Ap.vals, (n1, n1)),
                                pcd_mask).tocsc())
    free_p = 1.0 - pcd_mask

    def pcd_apply(kp, r_p):
        if variant == "BRM2":
            w1 = Mp_lu.solve(r_p)
            return -(w1 + Ap_lu.solve(free_p * (kp @ w1)))
        return -Mp_lu.solve(r_p + kp @ Ap_lu.solve(free_p * r_p))

    w = nl.initial_state().numpy()
    iters_scipy, iters_port, r0 = [], [], None
    for _ in range(12):
        F = nl.residual_of(torch.as_tensor(w))[0].numpy()
        rn = np.linalg.norm(F)
        r0 = rn if r0 is None else r0
        if rn <= 1e-5 * r0:
            break
        wind = torch.as_tensor(w[:n_u])
        A1 = _csr(asm.pat_p2, o._operator_values(wind)[0], (n2, n2))
        J = sp.bmat([[A1 if a == b else None for b in range(d)] + [DT[a]]
                     for a in range(d)] + [D + [None]], format="csr")
        Jm = _mask_sym(J, mask_full).tocsr()
        Auu = spla.splu(Jm[:n_u, :n_u].tocsc())
        kp = _csr(asm.pat_p1, asm.kp_values(wind, surface=variant == "BRM2"),
                  (n1, n1))

        def fs_apply(r):
            z_p = pcd_apply(kp, r[n_u:])
            rhs = free_u * (r[:n_u] - np.concatenate(
                [DT[a] @ z_p for a in range(d)]))
            return np.concatenate([free_u * Auu.solve(rhs)
                                   + bc_mask_u * r[:n_u], z_p])

        dx, k_scipy, _ = fgmres(lambda x: Jm @ x, -F, fs_apply, rtol=1e-8,
                                maxiter=200)
        iters_scipy.append(k_scipy)
        res, _ = o.solve(wind, torch.as_tensor(-F))
        assert res.converged
        iters_port.append(int(res.iters))
        w = w + dx
    assert len(iters_scipy) >= 3
    total_s, total_p = sum(iters_scipy), sum(iters_port)
    assert abs(total_p - total_s) <= max(2, 0.1 * total_s), (
        iters_port, iters_scipy)


def test_duct_implicit_euler_counts_match_jax():
    """Three implicit-Euler steps (theta = 1, dt 0.25) on the duct with
    dense subsolves (``tests/test_3d.py::test_duct_unsteady_relaxes_to_
    steady``), ``solve_fused`` against the JAX package's single-round
    solve: the same counts, states within 1e-8, mass conserved."""
    JDuct = _jax_duct()
    rt = Duct3D(level=0, nu=NU, device="cpu").solver(
        "BRM2", unsteady=0.25, theta=1.0).solve_fused(0.75, rtol_lin=1e-8)
    rj = JDuct(level=0, nu=NU).solver(
        "BRM2", unsteady=0.25, theta=1.0,
        **{"krylov.hi_krylov": True}).solve_fused(0.75, rtol_lin=1e-8)
    assert len(rt.linear_iters) == 3
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert _rel(rt.w.numpy(), rj.w) <= 1e-8
    nl = Duct3D(level=0, nu=NU, device="cpu").solver("BRM2")
    assert step3d.divergence(nl, rt.w) < 1e-9


# --------------------------------------------------------------------- #
# the GMG path of config 4
# --------------------------------------------------------------------- #

def test_step3d_l1_matches_jax_demo(monkeypatch):
    """``step3d.build(1)`` against the JAX demo's build (``-l 1 --block
    0``: ELL in f64, velocity multigrid 3 Jacobi x 2 cycles over l0-l1 with
    the dense l0 inverse, Ap by pressure multigrid with the outflow rows,
    cap 120), both with the single-round f64 solve: two Picard steps, each
    to 1e-8, the same counts, states within 1e-8."""
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(ROOT, "demos"))
    import demo_step3d
    monkeypatch.setenv("FENAPACK_CFG", "krylov.hi_krylov=True")
    kw = dict(rtol=1e-12, rtol_lin=step3d.RTOL_LIN, max_steps=2)
    nt = step3d.build(1, device="cpu")
    assert nt.n == 14104 and nt.asm.mesh.num_cells == 2688
    rt = nt.solve_fused(**kw)
    rj = demo_step3d.build(demo_step3d.make_parser().parse_args(
        ["-l", "1", "--block", "0"])).solve_fused(**kw)
    assert rt.linear_iters == [int(i) for i in rj.linear_iters]
    assert max(rt.lin_rel) <= 1e-8 and max(rt.linear_iters) < 120
    assert np.linalg.norm(rt.w.numpy() - rj.w) <= 1e-8 * np.linalg.norm(rj.w)
    assert rt.nonlinear_res[-1] < rt.nonlinear_res[0]
    assert isinstance(nt.asm.mesh, tmesh3d.TetMesh)
