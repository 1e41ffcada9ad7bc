"""The high-precision solves of the PyTorch port against the JAX package on
the CPU: the multi-round mixed-precision refinement of ``make_ir_solve``
(the JAX package's ``krylov.hi_krylov=False`` loop, with ``hi_matvec`` and
with GCRO-DR across rounds and solves), ``solve_ir`` in both modes,
``make_true_residual``, ``solve_batch``, ``solve_anderson`` and
``make_full_solve`` on the rounds.

The problem is the step at level 0 as ``tests/test_ir.py`` builds it: ELL
operators, dense LU velocity and Ap subsolves, PCD-BRM2, an f64 assembler
and residual, the preconditioner in f32 (``krylov.rtol`` 2e-6, ``maxiter``
80) or f64.  The port's default is the single-round f64 solve
(``krylov.hi_krylov=True``), so the port's side sets ``hi_krylov=False``
where the JAX side takes its default.  Each JAX build is made once per
module and shared.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch.models import StepFlow2D

F32 = {"dtype": "float32", "krylov.rtol": 2e-6, "krylov.maxiter": 80}
F64 = {"dtype": "float64", "krylov.rtol": 1e-8}
# solve_ir's rounds in f64 to 2e-6 each: several rounds per solve; the
# operator's convection integrals in f64 (``krylov.hi_ops_f32`` off: the f32
# integrals of the two packages agree to ~1e-9 only, and
# ``make_true_residual`` is compared to 1e-12 on the same build)
SIR = {"dtype": "float64", "krylov.rtol": 2e-6, "krylov.maxiter": 80,
       "krylov.hi_ops_f32": False}
MODES = {
    "rounds": {},
    "hi_matvec": {"krylov.hi_matvec": True},
    "recycle": {"krylov.recycle": 4},
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@functools.lru_cache(maxsize=None)
def _pair(key):
    """(port solver, JAX solver) of the level-0 step for the overrides
    ``dict(key)``.  The port's ``hi_krylov`` is set to the JAX package's
    value (False unless the key sets it)."""
    pytest.importorskip("jax")
    from tests.test_solver import make_step_solver
    over = dict(key)
    nj = make_step_solver(0, "BRM2", **over)
    port_over = {"krylov.hi_krylov": False, **over}
    p = StepFlow2D(level=0, device="cpu")
    asm = p.assembler(block_dtype=torch.float32
                      if over["dtype"] == "float32" else None)
    nt = p.solver("BRM2", asm=asm, **port_over)
    assert _rel(nt.initial_state().numpy(), nj.initial_state()) == 0.0
    return nt, nj


def _key(*dicts):
    out = {}
    for d in dicts:
        out.update(d)
    return tuple(sorted(out.items()))


def _rhs(nt, nj):
    """The first Picard linearization's right-hand side -F (the port's f64
    residual, handed to both packages) and the wind."""
    import jax.numpy as jnp
    F, _ = nt.residual_of(nt.initial_state().to(torch.float64))
    wind = nt.initial_state()[:nt.n_u]
    return -F, jnp.asarray(-F.numpy()), wind, nj.initial_state()[:nj.n_u]


# --------------------------------------------------------------------- #
# the multi-round refinement of make_ir_solve
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", sorted(MODES))
def test_multi_round_ir_matches_jax(mode):
    """Two consecutive linear solves (the first two Picard steps, the
    recycle space threaded through under ``recycle``): the total outer
    iterations of each within 2 of the JAX package's, and every true
    residual <= 1.1e-8 |F|."""
    import jax.numpy as jnp
    nt, nj = _pair(_key(F32, MODES[mode]))
    ir_t = nt.oseen.make_ir_solve(rtol=1e-8)
    ir_j = nj.oseen.make_ir_solve(rtol=1e-8)
    recycle = "krylov.recycle" in MODES[mode]
    wt = nt.initial_state().to(torch.float64)
    wj = nj.initial_state().astype(jnp.float64)
    # the JAX solve takes its empty space explicitly: one compiled program
    rec_t, rec_j = None, (nj.initial_recycle() if recycle else None)
    counts_t, counts_j = [], []
    for _ in range(2):
        F, fn = nt.residual_of(wt)
        x, it, rn, res, rec_t = ir_t(wt[:nt.n_u], -F, rec_t)
        assert float(rn) <= 1.1e-8 * float(fn), (float(rn), float(fn))
        assert res.rounds >= 2 and res.converged and res.bnorm == float(fn)
        assert (rec_t is not None) == recycle
        counts_t.append(int(it))
        wt = wt + x
        Fj = nj._residual(wj)
        if recycle:
            xj, itj, rnj, rec_j = ir_j(wj[:nj.n_u], -Fj, rec_j)
        else:
            xj, itj, rnj = ir_j(wj[:nj.n_u], -Fj)
        counts_j.append(int(itj))
        wj = wj + xj
    assert all(abs(a - b) <= 2 for a, b in zip(counts_t, counts_j)), \
        (counts_t, counts_j)
    assert _rel(wt.numpy(), wj) <= 1e-6


# --------------------------------------------------------------------- #
# solve_ir, make_true_residual
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("hi_krylov", [False, True])
def test_solve_ir_matches_jax(hi_krylov):
    """The host-loop refinement in both modes, f64 rounds to 2e-6 each: as
    many rounds as the JAX package's, each entry of the true-residual
    history within 1e-6 |b| of its (the entries after the first are
    residuals of solves to 2e-6 and below, so rounding decides their
    relative digits: 4.5341e-7 against 4.5344e-7), the last <= 1.5e-8 |b|,
    totals within 2, and x within 1e-6 of the JAX package's and of
    ``make_ir_solve``'s (the JAX package's ``test_host_ir_matches_fused``)."""
    nt, nj = _pair(_key(SIR, {"krylov.hi_krylov": hi_krylov}))
    bt, bj, wind_t, wind_j = _rhs(nt, nj)
    x, tot, hist = nt.oseen.solve_ir(wind_t, bt, rtol=1e-8)
    xj, totj, histj = nj.oseen.solve_ir(wind_j, bj, rtol=1e-8)
    bn = float(torch.linalg.norm(bt))
    assert len(hist) == len(histj), (hist, histj)
    assert hist[0] == bn
    assert max(abs(a - b) for a, b in zip(hist, histj)) <= 1e-6 * bn, \
        (hist, histj)
    assert hist[-1] <= 1.5e-8 * bn
    assert abs(tot - totj) <= 2, (tot, totj)
    assert _rel(x.numpy(), xj) <= 1e-6
    xf = nt.oseen.make_ir_solve(rtol=1e-8)(wind_t, bt)[0]
    assert float(torch.linalg.norm(x - xf) / torch.linalg.norm(xf)) < 1e-6


def test_true_residual_matches_jax():
    """``make_true_residual`` at a random wind, x and b, equal to the JAX
    package's to 1e-12 (the convection integrals in f64, see ``SIR``)."""
    import jax.numpy as jnp
    nt, nj = _pair(_key(SIR, {"krylov.hi_krylov": False}))
    rng = np.random.default_rng(5)
    wind = np.asarray(nj.initial_state(), np.float64)[:nj.n_u] + \
        0.1 * rng.standard_normal(nj.n_u)
    x, b = rng.standard_normal(nj.n), rng.standard_normal(nj.n)
    r, rn = nt.oseen.make_true_residual()(
        torch.as_tensor(wind), torch.as_tensor(x), torch.as_tensor(b))
    rj, rnj = nj.oseen.make_true_residual()(
        jnp.asarray(wind), jnp.asarray(x), jnp.asarray(b))
    assert r.dtype == torch.float64
    assert _rel(r.numpy(), rj) <= 1e-12
    assert abs(float(rn) - float(rnj)) <= 1e-12 * float(rnj)


# --------------------------------------------------------------------- #
# solve_batch
# --------------------------------------------------------------------- #

def test_solve_batch_matches_single_solves_and_jax():
    """Every column of the batch equals its own ``solve`` bit for bit, and
    is within 1e-8 of the JAX package's ``solve_batch`` (the right-hand
    sides of its ``test_batched_rhs_solve``: -F, -F/2 and a seeded random
    one)."""
    import jax.numpy as jnp
    nt, nj = _pair(_key(F64))
    bt, bj, wind_t, wind_j = _rhs(nt, nj)
    rnd = np.random.default_rng(0).standard_normal(nt.n) * 1e-2
    B = torch.stack([bt, bt * 0.5, torch.as_tensor(rnd)])
    X, iters, conv = nt.oseen.solve_batch(wind_t, B)
    assert X.shape == B.shape and iters.shape == conv.shape == (3,)
    assert conv.all()
    for i in range(3):
        single, _ = nt.oseen.solve(wind_t, B[i].clone())
        assert torch.equal(X[i], single.x), i
        assert int(iters[i]) == single.iters
    Xj, itj, cvj = nj.oseen.solve_batch(
        wind_j, jnp.stack([bj, bj * 0.5, jnp.asarray(rnd)]))
    assert [int(i) for i in itj] == [int(i) for i in iters]
    for i in range(3):
        assert float(np.linalg.norm(X[i].numpy() - np.asarray(Xj[i]))
                     / np.linalg.norm(np.asarray(Xj[i]))) <= 1e-8


# --------------------------------------------------------------------- #
# solve_anderson, make_full_solve on the rounds
# --------------------------------------------------------------------- #

def test_solve_anderson_matches_jax():
    """Anderson(3) Picard in f64 to 1e-5 (the JAX package's
    ``test_anderson.py`` build): the same number of steps, per-step counts
    within 1, states within 1e-8."""
    import jax.numpy as jnp
    nt, nj = _pair(_key(F64))
    rt = nt.solve_anderson(m=3, rtol=1e-5)
    rj = nj.solve_anderson(m=3, rtol=1e-5)
    assert rt.converged and rj.converged
    assert len(rt.linear_iters) == len(rj.linear_iters), \
        (rt.linear_iters, rj.linear_iters)
    assert all(abs(a - b) <= 1 for a, b in zip(rt.linear_iters,
                                                rj.linear_iters)), \
        (rt.linear_iters, rj.linear_iters)
    assert max(rt.lin_rel) <= 1.1e-8
    assert float(np.linalg.norm(rt.w.numpy() - np.asarray(rj.w))
                 / np.linalg.norm(np.asarray(rj.w))) <= 1e-8
    assert rt.w.dtype == torch.float64 and rj.w.dtype == jnp.float64


def test_full_solve_on_rounds_matches_jax():
    """``make_full_solve`` with the multi-round refinement (f32 rounds, as
    the JAX package's ``test_full_solve_matches_fused_loop`` builds it):
    per-step counts within 2 of the JAX package's, every step two rounds
    or more, every solve at a true 1e-8."""
    import jax.numpy as jnp
    nt, nj = _pair(_key(F32))
    rt = nt.make_full_solve(rtol=1e-5, rtol_lin=1e-8, max_steps=25)()
    w, k, iters, _ = nj.make_full_solve(rtol=1e-5, rtol_lin=1e-8,
                                        max_steps=25)(
        nj.initial_state().astype(jnp.float64))
    its_j = [int(i) for i in np.asarray(iters)[:int(k)]]
    assert rt.converged
    assert len(rt.iters) == len(its_j), (rt.iters, its_j)
    assert all(abs(a - b) <= 2 for a, b in zip(rt.iters, its_j)), \
        (rt.iters, its_j)
    assert min(rt.rounds) >= 2 and max(rt.lin_rel) <= 1e-8
    assert _rel(rt.w.numpy(), w) <= 1e-5
