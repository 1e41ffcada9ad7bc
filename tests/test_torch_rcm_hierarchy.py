"""Per-level RCM dof order of the multigrid hierarchies against the JAX
package: the 2D step at levels 0-1 in the main path's block layout (b = 32,
f64), the assembler in the block layout's default order (RCM in both
packages), the pressure hierarchy with ``reorder=True`` and the velocity
hierarchy following the fine assembler, as ``bench.build`` builds them.

Every level's ranks and tile layouts are equal; the transfers (as dense
matrices), the level operators, the wind's injection and the velocity
V-cycle's bottom inverse agree to 1e-12; three Picard + Anderson(6) steps
take the same FGMRES counts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import bench
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.solvers import gmg

TOL = 1e-12
STEPS = 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_main_path():
    """The JAX package's counterpart of ``bench.build(1, dtype="float64")``
    on reordered levels (f64 BSR operators, f64 Krylov basis), with its
    pressure and velocity hierarchies."""
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler
    from fenapack_tpu.fem.dofmap import DirichletBC
    from fenapack_tpu.solvers import gmg as jgmg
    from fenapack_tpu.solvers.config import SolverConfig, overrides
    from fenapack_tpu.solvers.nonlinear import NonlinearSolver
    hier = jgmg.build_hierarchy(jmesh.backward_step_mesh(0), 1)
    asm = NSAssembler(hier.fine, bench.NU, dtype=jnp.float64,
                      block_size=bench.BLOCK, hi_block=True)

    def inflow(x):
        v = np.zeros((x.shape[0], 2))
        v[:, 0] = 4 * x[:, 1] * (1 - x[:, 1])
        return v

    bcs = [DirichletBC.velocity(asm.W, [jmesh.WALL],
                                lambda x: np.zeros((x.shape[0], 2))),
           DirichletBC.velocity(asm.W, [jmesh.INFLOW], inflow)]
    cfg = overrides(SolverConfig(), {
        "dtype": "float64", "pcd.variant": bench.VARIANT,
        "krylov.hi_krylov": True, "krylov.rtol": 2e-6,
        "krylov.maxiter": bench.MAXITER, "krylov.recycle": 0,
        "krylov.hi_matvec": False, "krylov.df32_matvec": False,
        "krylov.ds_basis": False, "velocity.method": "gmg",
        "velocity.smooth_iters": 3, "velocity.cycles": 2,
        "pcd.ap.method": "gmg"})
    ap_h = jgmg.PressureHierarchy(hier, jnp.float64,
                                  pcd_markers=[jmesh.OUTFLOW],
                                  block_size=bench.BLOCK, reorder=True,
                                  fine_asm=asm)
    v_h = jgmg.VelocityHierarchy(hier, bench.NU, jnp.float64,
                                 bc_markers=[jmesh.WALL, jmesh.INFLOW],
                                 fine_asm=asm, block_size=bench.BLOCK)
    return NonlinearSolver(asm, bcs, cfg, ap_hierarchy=ap_h,
                           velocity_hierarchy=v_h), ap_h, v_h


@pytest.fixture(scope="module")
def pair():
    """(port solver, JAX solver, a wind, the JAX hierarchies) at level 1
    in f64."""
    pytest.importorskip("jax")
    nj, ap_j, v_j = _jax_main_path()
    nt = bench.build(1, device="cpu", dtype="float64")
    rng = np.random.default_rng(3)
    wind = (np.asarray(nj.initial_state())[:nj.n_u]
            + 0.1 * rng.standard_normal(nj.n_u))
    return nt, nj, wind, (ap_j, v_j)


def _hierarchies(pair):
    """(port, JAX, space) of the pressure and the velocity hierarchy."""
    o, (ap_j, v_j) = pair[0].oseen, pair[3]
    return ((o.ap_hierarchy, ap_j, "Q"), (o.velocity_hierarchy, v_j, "V"))


def _levels(h):
    return ([lev.asm for lev in h.levels] if hasattr(h, "levels")
            else h.asms)


def test_levels_are_reordered_as_in_jax(pair):
    """Every level's ranks and BSR layouts are the JAX package's."""
    nt = pair[0]
    for ht, hj, space in _hierarchies(pair):
        assert ht.reorder and len(_levels(ht)) == len(_levels(hj)) == 2
        for at, aj in zip(_levels(ht), _levels(hj)):
            np.testing.assert_array_equal(getattr(at.W, space).rank,
                                          getattr(aj.W, space).rank)
            pt = at.pat_p1 if space == "Q" else at.pat_p2
            pj = aj.pat_p1 if space == "Q" else aj.pat_p2
            np.testing.assert_array_equal(pt.neighbours.numpy(),
                                          np.asarray(pj.nbr))
    # the fine levels are the solvers' own assemblers
    assert nt.oseen.velocity_hierarchy.asms[-1] is nt.asm
    assert nt.oseen.ap_hierarchy.levels[-1].asm is nt.asm


def _dense_torch(fn, n, gather=False, chunk=1024):
    """The matrix of the linear map ``fn`` on vectors of length ``n``,
    from the unit vectors, a chunk of columns at a time."""
    eye = torch.eye(n, dtype=torch.float64)
    f = torch.func.vmap(fn, in_dims=1, out_dims=1) if gather else fn
    return torch.cat([f(eye[:, s:s + chunk]) for s in range(0, n, chunk)],
                     dim=1).numpy()


def _dense_jax(fn, n, chunk=1024):
    import jax
    import jax.numpy as jnp
    f = jax.vmap(fn, in_axes=1, out_axes=1)
    eye = jnp.eye(n, dtype=jnp.float64)
    return np.concatenate([np.asarray(f(eye[:, s:s + chunk]))
                           for s in range(0, n, chunk)], axis=1)


@pytest.mark.parametrize("kind", ["P1", "P2"])
def test_transfers_match_jax(pair, kind):
    """Prolongation and restriction as dense matrices, the main path's BSR
    transfer and the gather path on the same ranks."""
    (pt, pj, _), (vt, vj, _) = _hierarchies(pair)
    ht, hj = (pt, pj) if kind == "P1" else (vt, vj)
    tt, tj = ht.transfers[0], hj.transfers[0]
    (ct, ft) = _levels(ht)
    space = "Q" if kind == "P1" else "V"
    ranks = dict(rank_fine=getattr(ft.W, space).rank,
                 rank_coarse=getattr(ct.W, space).rank)
    if kind == "P1":
        gather = gmg.P1Transfer(ht.hier.parents[0],
                                ht.hier.meshes[0].num_vertices,
                                torch.float64, device="cpu", **ranks)
    else:
        gather = gmg.P2Transfer(*ht.hier.meshes, torch.float64,
                                device="cpu", **ranks)
    nc, nf = tj.n_coarse, tj.n_fine
    P = _dense_jax(tj.prolong, nc)
    R = _dense_jax(tj.restrict, nf)
    np.testing.assert_array_equal(R, P.T)
    for t, is_gather in ((tt, False), (gather, True)):
        assert _rel(_dense_torch(t.prolong, nc, gather=is_gather), P) <= TOL
        assert _rel(_dense_torch(t.restrict, nf), R) <= TOL


def test_level_operators_match_jax(pair):
    """Ap on every pressure level; every velocity level's Picard operator
    from the injected wind, the injected winds and the bottom level's
    dense inverse."""
    import jax.numpy as jnp
    from fenapack_tpu.solvers import gmg as jgmg
    nt, nj, wind = pair[:3]
    (pt, pj, _), (vt, vj, _) = _hierarchies(pair)
    for lt, lj in zip(pt.levels, pj.levels):
        assert _rel(lt.Ap.dense_tiles().numpy(), lj.Ap.tiles) <= TOL
    wf = wind[:vt.asms[-1].n2]
    assert _rel(vt.transfers[0].inject(torch.as_tensor(wf)).numpy(),
                vj.transfers[0].inject(jnp.asarray(wf))) == 0.0
    vals_t = gmg.velocity_gmg_values(vt, torch.as_tensor(wind),
                                     nt.oseen.bc_mask_u, torch.float64)
    vals_j = jgmg.velocity_gmg_values(vj, jnp.asarray(wind), False,
                                      nj.oseen.bc_mask_u, jnp.float64)
    for at, (A1t, Rt), (A1j, Rj) in zip(vt.asms, vals_t["levels"],
                                        vals_j["levels"]):
        assert Rt is None and Rj is None
        assert _rel(at.pat_p2.dense_tiles(A1t).numpy(), A1j) <= TOL
    assert _rel(vals_t["coarse_inv"].numpy(), vals_j["coarse_inv"]) <= 1e-10


def test_pcoarse_bottom_level_matches_jax(pair, monkeypatch):
    """The p-coarse bottom level (the base mesh's P1 space) on reordered
    levels: with the dense cap below the base P2 block, one velocity
    V-cycle agrees with the JAX package's."""
    import jax.numpy as jnp
    nt, nj, wind = pair[:3]
    cap = 1000
    vh = nt.oseen.velocity_hierarchy
    assert 2 * vh.asms[0].n2 > cap >= 2 * vh.asms[0].n1
    monkeypatch.setattr(gmg, "DENSE_MAX", cap)
    monkeypatch.setenv("FENAPACK_GMG_DENSE_MAX", str(cap))
    r = (np.random.default_rng(4).standard_normal(nj.n_u)
         * np.asarray(nj.oseen.free_u))
    A1t, _ = nt.oseen._operator_values(torch.as_tensor(wind))
    A1j, _ = nj.oseen._operator_values(jnp.asarray(wind))
    zt = nt.oseen._velocity_solver(A1t, torch.as_tensor(wind))(
        torch.as_tensor(r))
    zj = nj.oseen._velocity_solver(A1j, None, wind=jnp.asarray(wind))(
        jnp.asarray(r))
    assert _rel(zt.numpy(), zj) <= 1e-10


def test_picard_counts_match_jax(pair):
    """Three Picard steps with Anderson(6) mixing in f64: the same FGMRES
    count at every step, and states within the linear tolerance."""
    import jax.numpy as jnp
    nt, nj = pair[:2]
    kw = dict(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN, max_steps=STEPS,
              anderson=bench.ANDERSON)
    w, k, iters, _ = nj.make_full_solve(**kw)(
        nj.initial_state().astype(jnp.float64))
    rt = nt.make_full_solve(**kw)(nt.initial_state().to(torch.float64))
    assert rt.iters == [int(i) for i in np.asarray(iters)[:int(k)]]
    assert len(rt.iters) == STEPS
    assert _rel(rt.w.numpy(), w) <= 1e-6


def test_mismatched_orders_raise():
    """A hierarchy refuses a fine assembler in the other order, and a
    solver refuses a hierarchy whose levels are not in its order."""
    from fenapack_tpu_torch.fem.assemble import NSAssembler
    from fenapack_tpu_torch.solvers.config import SolverConfig, overrides
    from fenapack_tpu_torch.solvers.nonlinear import NonlinearSolver
    hier = gmg.build_hierarchy(tmesh.backward_step_mesh(0), 1)
    asm = NSAssembler(hier.fine, bench.NU, device="cpu",
                      block_size=bench.BLOCK)
    assert asm.W.reorder
    with pytest.raises(ValueError, match="orderings must match"):
        gmg.VelocityHierarchy(hier, bench.NU, torch.float64, device="cpu",
                              fine_asm=asm, reorder=False)
    natural = gmg.PressureHierarchy(hier, torch.float64, device="cpu",
                                    pcd_markers=[tmesh.OUTFLOW])
    assert not natural.reorder
    cfg = overrides(SolverConfig(), {"pcd.ap.method": "gmg"})
    with pytest.raises(ValueError, match="ordering mismatch"):
        NonlinearSolver(asm, [], cfg, pcd_marker=tmesh.OUTFLOW,
                        ap_hierarchy=natural)
