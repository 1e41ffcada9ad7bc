"""GCRO-DR recycling in the PyTorch port (``fgmres_dr``,
``refresh_recycle``, the recycle space threaded through the time loop)
against the JAX package, on the CPU in f64.

The operator of ``tests/test_recycle.py``: the Jacobi-preconditioned
pressure Laplacian of the level-1 step with one Dirichlet row, built in both
packages.  Checks: the first solve with an empty space takes the plain
FGMRES path (counts equal in both packages), the harvested space's
invariants (C C^T = I, C = A U, invalid rows exactly zero), a second
right-hand side deflated by the space (fewer iterations than plain FGMRES,
within 1 of the JAX package's count), the partial bootstrap from 8-iteration
solves, the re-binding to a shifted operator, and ``solve_fused`` on the
level-0 channel with a space of 12 (trajectory within 1e-7 of the
unrecycled one, fewer iterations from step 2 on, counts within 1 of the JAX
package's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# test workers share the machine's cores: one PyTorch thread each
torch.set_num_threads(1)

import fenapack_tpu_torch as ft
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.models import Channel2D
from fenapack_tpu_torch.solvers.krylov import (empty_recycle, fgmres,
                                               fgmres_dr, refresh_recycle)

K = 12


def _rel_res(mv, x, b):
    return float(torch.linalg.norm(b - mv(x)) / torch.linalg.norm(b))


def _check_space(rec, mv, n_valid):
    """The invariants of a recycle space with ``n_valid`` leading valid
    rows."""
    valid = rec.valid.numpy()
    assert np.all(valid[:n_valid] == 1.0) and np.all(valid[n_valid:] == 0.0)
    C, U = rec.C, rec.U
    assert np.abs((C @ C.T).numpy() - np.diag(valid)).max() < 1e-10
    AU = torch.stack([mv(u) for u in U])
    assert float((AU - C).abs().max()) < 1e-8
    assert bool((U[n_valid:] == 0).all())
    assert bool((C[n_valid:] == 0).all())


@pytest.fixture(scope="module")
def operator():
    """``(mv, pc, n)`` of the port: the pinned pressure Laplacian of the
    level-1 step and its Jacobi preconditioner."""
    asm = ft.NSAssembler(tmesh.backward_step_mesh(1), 0.02, device="cpu")
    Ap = asm.const.Ap
    n = Ap.shape[0]
    mask = torch.zeros(n, dtype=torch.float64)
    mask[0] = 1.0
    free = 1.0 - mask
    dinv = 1.0 / torch.where(mask > 0, torch.ones_like(mask),
                             Ap.diag_from(asm.pat_p1.diag_pos))
    return (lambda x: free * Ap.mv(free * x) + mask * x,
            lambda r: dinv * r, n)


@pytest.fixture(scope="module")
def jax_operator():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    asm = JAsm(jmesh.backward_step_mesh(1), 0.02, dtype=jnp.float64)
    Ap = asm.const.Ap
    mask = jnp.zeros(Ap.shape[0]).at[0].set(1.0)
    free = 1.0 - mask
    dinv = 1.0 / jnp.where(mask > 0, 1.0, Ap.diag_from(asm.pat_p1.diag_pos))
    return (lambda x: free * Ap.mv(free * x) + mask * x,
            lambda r: dinv * r)


def test_first_solve_takes_the_plain_path(operator, jax_operator):
    """An empty space: the same iterations as ``fgmres`` and as the JAX
    package's ``fgmres_dr``; the harvested space is full and keeps its
    invariants."""
    import jax.numpy as jnp
    from fenapack_tpu.solvers.krylov import empty_recycle as jempty
    from fenapack_tpu.solvers.krylov import fgmres_dr as jfgmres_dr
    mv, pc, n = operator
    b = np.random.default_rng(2).standard_normal(n)
    bt = torch.as_tensor(b)
    plain = fgmres(mv, pc, bt, maxiter=400, rtol=1e-10)
    res, rec = fgmres_dr(mv, pc, bt, empty_recycle(K, n, torch.float64,
                                                   "cpu"),
                         maxiter=400, rtol=1e-10)
    jmv, jpc = jax_operator
    jres, _ = jfgmres_dr(jmv, jpc, jnp.asarray(b), jempty(K, n, jnp.float64),
                         maxiter=400, rtol=1e-10)
    assert res.iters == plain.iters == int(jres.iters)
    # the head's read, one column an iteration, and four copies to the
    # device: y, B y, and the next space's W and mask
    assert res.converged and res.host_syncs == res.iters + 5
    assert _rel_res(mv, res.x, bt) < 1e-9
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() \
        <= 1e-8 * np.abs(np.asarray(jres.x)).max()
    _check_space(rec, mv, K)


def test_recycling_cuts_iterations(operator, jax_operator):
    """A second right-hand side deflated by the first solve's space: fewer
    iterations than plain FGMRES, within 1 of the JAX package's count, at
    the same true residual."""
    import jax.numpy as jnp
    from fenapack_tpu.solvers.krylov import empty_recycle as jempty
    from fenapack_tpu.solvers.krylov import fgmres_dr as jfgmres_dr
    mv, pc, n = operator
    rng = np.random.default_rng(3)
    b1, b2 = rng.standard_normal(n), rng.standard_normal(n)
    _, rec = fgmres_dr(mv, pc, torch.as_tensor(b1),
                       empty_recycle(K, n, torch.float64, "cpu"),
                       maxiter=400, rtol=1e-8)
    res, _ = fgmres_dr(mv, pc, torch.as_tensor(b2), rec, maxiter=400,
                       rtol=1e-8)
    plain = fgmres(mv, pc, torch.as_tensor(b2), maxiter=400, rtol=1e-8)
    jmv, jpc = jax_operator
    _, jrec = jfgmres_dr(jmv, jpc, jnp.asarray(b1), jempty(K, n, jnp.float64),
                         maxiter=400, rtol=1e-8)
    jres, _ = jfgmres_dr(jmv, jpc, jnp.asarray(b2), jrec, maxiter=400,
                         rtol=1e-8)
    assert _rel_res(mv, res.x, torch.as_tensor(b2)) < 3e-8
    assert res.iters < plain.iters, (res.iters, plain.iters)
    assert abs(res.iters - int(jres.iters)) <= 1, (res.iters,
                                                   int(jres.iters))


def test_partial_bootstrap_from_short_solves(operator):
    """Solves shorter than the space fill it in part (per-direction
    validity); invalid rows stay exactly zero, a second short solve grows
    it, and the partly filled space already cuts iterations."""
    mv, pc, n = operator
    rng = np.random.default_rng(5)
    b = torch.as_tensor(rng.standard_normal(n))
    res, rec = fgmres_dr(mv, pc, b, empty_recycle(K, n, torch.float64, "cpu"),
                         maxiter=8, rtol=1e-14)
    nv1 = int(rec.valid.sum())
    assert 0 < nv1 <= 8, nv1
    _check_space(rec, mv, nv1)
    res, rec = fgmres_dr(mv, pc, b - mv(res.x), rec, maxiter=8, rtol=1e-14)
    nv2 = int(rec.valid.sum())
    assert nv2 > nv1, (nv1, nv2)
    _check_space(rec, mv, nv2)
    b2 = torch.as_tensor(rng.standard_normal(n))
    res2, _ = fgmres_dr(mv, pc, b2, rec, maxiter=400, rtol=1e-8)
    plain = fgmres(mv, pc, b2, maxiter=400, rtol=1e-8)
    assert _rel_res(mv, res2.x, b2) < 3e-8
    assert res2.iters < plain.iters, (res2.iters, plain.iters)


def test_refresh_tracks_operator_change(operator):
    """``refresh_recycle`` re-binds the space to a shifted operator, and the
    deflated solve of that operator reaches its tolerance."""
    mv, pc, n = operator
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(n))
    _, rec = fgmres_dr(mv, pc, b, empty_recycle(K, n, torch.float64, "cpu"),
                       maxiter=400, rtol=1e-8)
    mv2 = lambda x: mv(x) + 0.05 * x
    rec2 = refresh_recycle(mv2, rec)
    _check_space(rec2, mv2, K)
    assert float((torch.stack([mv(u) for u in rec2.U]) - rec2.C).abs().max()
                 ) > 1e-3
    res, _ = fgmres_dr(mv2, pc, b, rec2, maxiter=400, rtol=1e-8)
    assert _rel_res(mv2, res.x, b) < 3e-8


@pytest.mark.parametrize("scheme", ["theta", "bdf2"])
def test_solve_fused_recycles_across_time_steps(scheme):
    """The level-0 channel, dt 0.25 to t = 2, a space of 12 threaded through
    the time steps: the trajectory within 1e-7 of the unrecycled one, fewer
    iterations from step 2 on, and per-step counts within 1 of the JAX
    package's (its single-round solve, ``krylov.hi_krylov``)."""
    pytest.importorskip("jax")
    from fenapack_tpu.models import Channel2D as JChannel
    kw = dict(unsteady=0.25, scheme=scheme)
    mk = lambda **o: Channel2D(level=0, length=2.0, device="cpu").solver(
        "BRM2", **kw, **o)
    r1 = mk().solve_fused(2.0, rtol_lin=1e-10)
    us = mk(**{"krylov.recycle": 12})
    assert us.oseen.initial_recycle().U.shape == (12, us.n)
    r2 = us.solve_fused(2.0, rtol_lin=1e-10)
    assert np.abs(r1.w.numpy() - r2.w.numpy()).max() <= 1e-7
    assert sum(r2.linear_iters[1:]) < sum(r1.linear_iters[1:]), (
        r1.linear_iters, r2.linear_iters)
    assert max(r2.lin_rel) <= 1e-10
    rj = JChannel(level=0, length=2.0).solver(
        "BRM2", **kw, **{"krylov.recycle": 12,
                         "krylov.hi_krylov": True}).solve_fused(
        2.0, rtol_lin=1e-10)
    ji = [int(i) for i in rj.linear_iters]
    assert len(ji) == len(r2.linear_iters) and all(
        abs(a - b) <= 1 for a, b in zip(r2.linear_iters, ji)), (
        r2.linear_iters, ji)
