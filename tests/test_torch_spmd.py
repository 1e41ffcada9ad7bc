"""The port's ring-path building blocks (``fenapack_tpu_torch.parallel``:
``comm``, ``spmd``, ``spmd_gmg``) against the JAX package's
``fenapack_tpu.parallel`` on the CPU in f64, and against the port's own
single-device operators.

Ranks are threads of this process, one gloo group on a shared HashStore;
the JAX side runs on a 4-device submesh of conftest's 8 virtual CPU
devices.

  * the reordered assembler (``NSAssembler(reorder=True)``): RCM ranks equal
    to the JAX package's, and A1, D, Kp values equal to 1e-13 (step l0);
  * the ring layout (``halo``, ``cols_ext``) of A1, D_0, B^T_0, Kp and Mp
    equal to JAX's, host only;
  * the ring SpMV against the port's ELL product (1e-14) on JAX's ring
    layout of the same operator; the all-gather fallback; ``pdot``,
    ``pnorm`` and ``psum_minres_smooth`` against single-device sums and the
    single-device smoother;
  * ``spmd_fgmres``: JAX's count, x within 1e-10;
  * the distributed pressure V-cycle against JAX's (step l1, 1e-10);
  * a rank that raises makes ``run_ranks`` raise within its timeout.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.ops.sparse import ELL
from fenapack_tpu_torch.parallel import spmd
from fenapack_tpu_torch.parallel.comm import Comm, run_ranks
from fenapack_tpu_torch.parallel.spmd_pcd import _FieldRing
from fenapack_tpu_torch.solvers import gmg as tgmg

N = 4


def _ranks(fn, size=N, timeout=60.0):
    return run_ranks(fn, size, device="cpu", threads=True, timeout=timeout)


def _jax_mesh():
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:N]), ("dd",))


@pytest.fixture(scope="module")
def step_l0():
    """The reordered step at level 0 in both packages, and a wind."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.assemble import NSAssembler as JAsm
    ta = NSAssembler(tmesh.backward_step_mesh(0), 0.02, device="cpu",
                     reorder=True)
    ja = JAsm(jmesh.backward_step_mesh(0), 0.02, dtype=jnp.float64,
              reorder=True)
    rng = np.random.default_rng(0)
    wind = rng.standard_normal(2 * ta.n2)
    return ta, ja, wind


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_reordered_assembler_matches_jax(step_l0):
    import jax.numpy as jnp
    ta, ja, wind = step_l0
    np.testing.assert_array_equal(ta.W.V.rank, np.asarray(ja.W.V.rank))
    np.testing.assert_array_equal(ta.W.Q.rank, np.asarray(ja.W.Q.rank))
    assert (ta.n2_real, ta.n1_real) == (ja.n2_real, ja.n1_real)
    np.testing.assert_array_equal(ta.pat_p2.cols.numpy(),
                                  np.asarray(ja.pat_p2.cols))
    w_t, w_j = torch.as_tensor(wind), jnp.asarray(wind)
    assert _rel(ta.picard_matrix_values(w_t),
                ja.picard_matrix_values(w_j)) < 1e-13
    assert _rel(ta.kp_values(w_t, surface=True),
                ja.kp_values(w_j, surface=True)) < 1e-13
    for a in range(2):
        assert _rel(ta.const.D[a].vals, ja.const.D[a].vals) < 1e-13


def _ring_pair(ta, ja, name):
    """(port _FieldRing, JAX _FieldRing) of one operator, 4 ranks."""
    import jax.numpy as jnp
    from fenapack_tpu.parallel import spmd_pcd as jpcd
    n2, n1 = ta.n2_real, ta.n1_real
    n2p, n1p = -(-n2 // N) * N, -(-n1 // N) * N
    comm = Comm(None, 0, N, "cpu")
    if name == "A1":
        used = jpcd._pattern_used(ja.pat_p2)
        tv = torch.zeros(ta.pat_p2.value_shape, dtype=torch.float64)
        jv = jnp.zeros(ja.pat_p2.value_shape)
        args_t = (ta.pat_p2.matrix(tv), n2, n2p, n2, n2p)
        args_j = (ja.pat_p2.matrix(jv), n2, n2p, n2, n2p)
        kw = dict(diag_identity_pad=True, used=used)
    elif name == "Kp":
        used = jpcd._pattern_used(ja.pat_p1)
        tv = torch.zeros(ta.pat_p1.value_shape, dtype=torch.float64)
        jv = jnp.zeros(ja.pat_p1.value_shape)
        args_t = (ta.pat_p1.matrix(tv), n1, n1p, n1, n1p)
        args_j = (ja.pat_p1.matrix(jv), n1, n1p, n1, n1p)
        kw = dict(used=used)
    else:
        op_t = {"D0": ta.const.D[0], "DT0": ta.const.DT[0],
                "Mp": ta.const.Mp}[name]
        op_j = {"D0": ja.const.D[0], "DT0": ja.const.DT[0],
                "Mp": ja.const.Mp}[name]
        sizes = {"D0": (n1, n1p, n2, n2p), "DT0": (n2, n2p, n1, n1p),
                 "Mp": (n1, n1p, n1, n1p)}[name]
        args_t, args_j = (op_t,) + sizes, (op_j,) + sizes
        kw = dict(diag_identity_pad=name == "Mp")
    rt = _FieldRing(*args_t, comm, torch.float64, **kw)
    rj = jpcd._FieldRing(*args_j, N, "dd", jnp.float64, **kw)
    return rt, rj


@pytest.mark.parametrize("name", ["A1", "D0", "DT0", "Kp", "Mp"])
def test_ring_layout_matches_jax(step_l0, name):
    ta, ja, _ = step_l0
    rt, rj = _ring_pair(ta, ja, name)
    assert rt.ring.halo == rj.ring.halo
    assert rt.ring.halo <= rt.ring.c_loc
    np.testing.assert_array_equal(rt.ring.cols_ext,
                                  np.asarray(rj.ring.cols_ext))


def _padded_ap(ta):
    """The pressure Laplacian padded to a multiple of the rank count
    (identity rows), as host ELL arrays ``(cols, vals, n)``."""
    nr = ta.n1_real
    n = -(-nr // N) * N
    c = ta.const.Ap
    valid = c.vals.numpy() != 0
    nc = np.zeros((n, c.cols.shape[1]), dtype=np.int32)
    nv = np.zeros((n, c.cols.shape[1]))
    nc[:nr] = np.where(valid, c.cols.numpy(), 0)
    nv[:nr] = np.where(valid, c.vals.numpy(), 0.0)
    for i in range(nr, n):
        nc[i, 0], nv[i, 0] = i, 1.0
    return nc, nv, n


def test_ring_spmv_matches_ell_and_jax(step_l0):
    """The ring product of the padded pressure Laplacian against the port's
    ELL product (1e-14), on a layout (``halo``, ``cols_ext``) equal to the
    one JAX's ``make_ring_spmv`` builds.  The JAX product itself is not
    run: its values follow from that layout (the JAX SPMD calls of these
    tests go to FGMRES and the two multigrids)."""
    import jax.numpy as jnp
    from fenapack_tpu.ops.sparse import ELL as JELL
    from fenapack_tpu.parallel import spmd as jspmd
    ta, _, _ = step_l0
    nc, nv, n = _padded_ap(ta)
    x = np.random.default_rng(1).standard_normal(n)
    ell = ELL(torch.as_tensor(nc), torch.as_tensor(nv), n)
    ref = ell.mv(torch.as_tensor(x)).numpy()
    rh_t = spmd.RingHaloELL(ell, N)
    rh_j = jspmd.RingHaloELL(JELL(cols=jnp.asarray(nc), vals=jnp.asarray(nv),
                                  n_cols=n), N, "dd")
    assert rh_t.halo == rh_j.halo > 0
    np.testing.assert_array_equal(rh_t.cols_ext, np.asarray(rh_j.cols_ext))

    def body(comm):
        f = spmd.make_ring_spmv(ell, comm)
        loc = n // comm.size
        y = f(torch.as_tensor(x[comm.rank * loc:(comm.rank + 1) * loc]))
        return y.numpy(), dict(comm.counts)
    out = _ranks(body)
    got = np.concatenate([o[0] for o in out])
    assert out[0][1]["exchange"] == 1
    assert _rel(got, ref) < 1e-14


def test_allgather_fallback(step_l0):
    """A scrambled order is not one hop: the layout falls back to the
    all-gather product, which still computes A x."""
    from fenapack_tpu_torch.parallel.spmd_gmg import _HostELL, \
        _ring_or_gather
    ta, _, _ = step_l0
    nc, nv, n = _padded_ap(ta)
    perm = np.random.default_rng(2).permutation(n)
    inv = np.argsort(perm)
    pc = inv[nc[perm]].astype(np.int32)
    pv = nv[perm]
    with pytest.raises(ValueError, match="one-hop"):
        spmd.RingHaloELL(_HostELL(pc, pv, n), N)
    assert _ring_or_gather(_HostELL(pc, pv, n), N).kind == "allgather"
    ell = ELL(torch.as_tensor(pc), torch.as_tensor(pv), n)
    x = np.random.default_rng(3).standard_normal(n)
    ref = ell.mv(torch.as_tensor(x)).numpy()

    def body(comm):
        f = spmd.make_spmd_spmv(ell, comm)
        loc = n // comm.size
        return f(torch.as_tensor(x[comm.rank * loc:(comm.rank + 1) * loc])
                 ).numpy()
    assert _rel(np.concatenate(_ranks(body)), ref) < 1e-14


def test_reductions_match_single_device(step_l0):
    ta, _, _ = step_l0
    nc, nv, n = _padded_ap(ta)
    ell = ELL(torch.as_tensor(nc), torch.as_tensor(nv), n)
    rng = np.random.default_rng(4)
    a, b, x0 = (rng.standard_normal(n) for _ in range(3))
    diag = np.where(nc == np.arange(n)[:, None], nv, 0.0).sum(axis=1)
    dinv = 1.0 / np.where(diag != 0, diag, 1.0)
    mv = lambda v: ell.mv(v)
    T = lambda v: torch.as_tensor(v)
    ref_x = tgmg._minres_smooth(mv, T(dinv), 4, T(b), T(x0)).numpy()

    def body(comm):
        loc = n // comm.size
        s = slice(comm.rank * loc, (comm.rank + 1) * loc)
        f = spmd.make_ring_spmv(ell, comm)
        dot = spmd.make_spmd_dot(comm)
        x = spmd.psum_minres_smooth(comm, f, T(dinv[s]), 4, T(b[s]),
                                    T(x0[s]))
        return (float(dot(T(a[s]), T(b[s]))),
                float(spmd.pnorm(comm, T(a[s]))), x.numpy())
    out = _ranks(body)
    assert all(o[0] == out[0][0] and o[1] == out[0][1] for o in out)
    assert abs(out[0][0] - a @ b) <= 1e-12 * np.abs(a) @ np.abs(b)
    assert abs(out[0][1] - np.linalg.norm(a)) <= 1e-14 * np.linalg.norm(a)
    # the 4 x 4 Gram system (ridge 1e-7 of its trace) amplifies the
    # reduction-order roundoff of the distributed sums
    assert _rel(np.concatenate([o[2] for o in out]), ref_x) < 1e-9


def test_spmd_fgmres_matches_jax(step_l0):
    """The masked pressure Laplacian (PCD row 0 and the padding pinned)
    with Jacobi: the JAX package's count, x within 1e-10."""
    import jax
    import jax.numpy as jnp
    from fenapack_tpu.parallel import spmd as jspmd
    ta, _, _ = step_l0
    nc, nv, n = _padded_ap(ta)
    mask = np.zeros(n)
    mask[ta.n1_real:] = 1.0
    mask[0] = 1.0
    free = 1.0 - mask
    diag = np.where(nc == np.arange(n)[:, None], nv, 0.0).sum(axis=1)
    dinv = 1.0 / np.where(mask > 0, 1.0, diag)
    b = np.random.default_rng(5).standard_normal(n)
    ell = ELL(torch.as_tensor(nc), torch.as_tensor(nv), n)

    def body(comm):
        loc = n // comm.size
        s = slice(comm.rank * loc, (comm.rank + 1) * loc)
        T = lambda v: torch.as_tensor(v[s])
        f = spmd.make_ring_spmv(ell, comm)
        fr, mk, di = T(free), T(mask), T(dinv)

        def make_ops(_):
            return (lambda x: fr * f(fr * x) + mk * x), (lambda r: di * r)
        x, k, res = spmd.spmd_fgmres(comm, make_ops, None, T(b),
                                     maxiter=200, rtol=1e-8)
        return x.numpy(), k
    out = _ranks(body)
    x_t = np.concatenate([o[0] for o in out])
    assert len({o[1] for o in out}) == 1

    from fenapack_tpu.ops.sparse import ELL as JELL
    rh = jspmd.RingHaloELL(JELL(cols=jnp.asarray(nc), vals=jnp.asarray(nv),
                                n_cols=n), N, "dd")
    dm = _jax_mesh()
    rows = jspmd.NamedSharding(dm, jspmd.P("dd"))
    operands = jax.device_put({"vals": jnp.asarray(nv), "cols": rh.cols_ext,
                               "free": jnp.asarray(free),
                               "mask": jnp.asarray(mask),
                               "dinv": jnp.asarray(dinv)}, rows)

    def make_ops(o):
        def matvec_local(x_loc):
            y = rh.mv_local(o["vals"], o["cols"], o["free"] * x_loc)
            return o["free"] * y + o["mask"] * x_loc
        return matvec_local, (lambda r_loc: o["dinv"] * r_loc)
    x_j, k_j, _ = jspmd.spmd_fgmres(dm, make_ops, operands,
                                    jax.device_put(jnp.asarray(b), rows),
                                    maxiter=200, rtol=1e-8)
    assert out[0][1] == int(k_j)
    assert _rel(x_t, x_j) < 1e-10


def test_pressure_vcycle_matches_jax():
    """The distributed pressure V-cycle (step l1, 2 levels, smoothing 2,
    cycles 2) against the JAX package's on the same right-hand side in the
    multigrid's own order: 1e-10."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.solvers import gmg as jgmg
    from fenapack_tpu.parallel.spmd_gmg import SPMDPressureGMG as JP
    from fenapack_tpu_torch.parallel.spmd_gmg import SPMDPressureGMG

    th = tgmg.build_hierarchy(tmesh.backward_step_mesh(0), 1)
    tph = tgmg.PressureHierarchy(th, torch.float64, device="cpu",
                                 pcd_markers=[tmesh.OUTFLOW])
    jh = jgmg.build_hierarchy(jmesh.backward_step_mesh(0), 1)
    jph = jgmg.PressureHierarchy(jh, jnp.float64,
                                 pcd_markers=[jmesh.OUTFLOW])
    jsp = JP(jph, _jax_mesh(), dtype=jnp.float64, smooth_iters=2, cycles=2)
    n_pad = jsp.levels[-1].n_pad
    b = np.random.default_rng(6).standard_normal(n_pad)
    b[jsp.levels[-1].n_real:] = 0.0
    x_j = np.asarray(jsp.make_solver()(jnp.asarray(b)))

    def body(comm):
        sp = SPMDPressureGMG(tph, comm, smooth_iters=2, cycles=2)
        loc = sp.levels[-1].ring.n_loc
        x = sp.solve_local(torch.as_tensor(
            b[comm.rank * loc:(comm.rank + 1) * loc]))
        return x.numpy(), sp.fine_rank, [lv.ring.halo for lv in sp.levels]
    out = _ranks(body)
    np.testing.assert_array_equal(out[0][1], jsp.fine_rank)
    assert out[0][2] == [lv.ring.halo for lv in jsp.levels]
    assert _rel(np.concatenate([o[0] for o in out]), x_j) < 1e-10


def test_ring_exchange_ends_and_counts():
    def body(comm):
        x = torch.arange(6, dtype=torch.float64) + 10 * comm.rank
        (l1, r1), (l2, r2) = comm.ring_exchange([(x, 2), (2 * x[None], 1)])
        return (l1.tolist(), r1.tolist(), l2.tolist(), r2.tolist(),
                comm.counts["exchange"])
    out = _ranks(body, size=3)
    assert out[0][:2] == ([0.0, 0.0], [10.0, 11.0])
    assert out[1][:2] == ([4.0, 5.0], [20.0, 21.0])
    assert out[2][:2] == ([14.0, 15.0], [0.0, 0.0])
    assert out[1][2:] == ([[10.0]], [[40.0]], 1)


def test_raising_rank_fails_the_launcher():
    """A rank that raises while the others wait in a collective: the
    launcher raises (naming the rank) within its timeout, not hangs."""
    def body(comm):
        if comm.rank == 1:
            raise ValueError("rank one fails")
        comm.allreduce_sum(torch.ones(2, dtype=torch.float64))
        return comm.rank
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 raised"):
        run_ranks(body, 3, device="cpu", threads=True, timeout=5.0)
    assert time.monotonic() - t0 < 5.0 + 3.0


def _velocity_hierarchy(level, nu=1e-3):
    return tgmg.VelocityHierarchy(
        tgmg.build_hierarchy(tmesh.backward_step_mesh(0), level), nu,
        torch.float64, device="cpu", bc_markers=[tmesh.WALL, tmesh.INFLOW])


def _vcycle(vh, wind, b, **kw):
    """``run_ranks`` body: the rank's block of one distributed velocity
    V-cycle of ``b`` (fine u-space device-major) at ``wind``, the levels'
    layout kinds and halos."""
    from fenapack_tpu_torch.parallel.spmd_gmg import SPMDVelocityGMG

    def body(comm):
        tv = SPMDVelocityGMG(vh, comm, **kw)
        n = tv.d * tv.lv[-1]["loc"]
        x = tv.solve_local(torch.as_tensor(b[comm.rank * n:
                                             (comm.rank + 1) * n]),
                           tv.build_operands(wind))
        return (x.numpy(), [lv["ring"].kind for lv in tv.lv],
                [lv["ring"].halo for lv in tv.lv])
    return body


VGMG = dict(smooth_iters=4, cycles=2, supg=True, newton=True)


def test_velocity_vcycle_matches_jax():
    """The distributed velocity V-cycle with SUPG and the Newton reaction
    (step l1, Re 1000: two ring levels, the P2 transfer, the coupled dense
    coarse inverse from the wind; smoothing 4, cycles 2) against the JAX
    package's ``SPMDVelocityGMG`` on the same wind and right-hand side, in
    the fine level's u-space device-major order: 1e-10."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.solvers import gmg as jgmg
    from fenapack_tpu.parallel.spmd import shard_map
    from fenapack_tpu.parallel.spmd_gmg import SPMDVelocityGMG as JV

    jvh = jgmg.VelocityHierarchy(
        jgmg.build_hierarchy(jmesh.backward_step_mesh(0), 1), 1e-3,
        jnp.float64, bc_markers=[jmesh.WALL, jmesh.INFLOW])
    dm = _jax_mesh()
    jv = JV(jvh, dm, dtype=jnp.float64, **VGMG)
    lvf = jv.lv[-1]
    rng = np.random.default_rng(7)
    wind = rng.uniform(-1.0, 1.0, 2 * lvf["n2"])
    b = rng.standard_normal(2 * lvf["n_pad"])
    ops = jv.build_operands(wind)
    run = shard_map(lambda o, b_loc: jv.solve_local(b_loc, o), mesh=dm,
                    in_specs=(jv.operand_specs(ops), P("dd")),
                    out_specs=P("dd"))
    x_j = np.asarray(jax.jit(run)(ops, jnp.asarray(b)))
    out = _ranks(_vcycle(_velocity_hierarchy(1), wind, b, **VGMG))
    assert out[0][1] == [type(lv["ring"]).__name__.replace(
        "RingHaloELL", "ring").replace("RowBlockELL", "allgather")
        for lv in jv.lv]
    assert out[0][2] == [lv["ring"].halo for lv in jv.lv]
    assert _rel(np.concatenate([o[0] for o in out]), x_j) < 1e-10


def test_velocity_vcycle_three_levels_one_vs_four_ranks():
    """The same V-cycle on the step l2 (three levels: the restriction onto
    a level above the coarsest re-gathers its right-hand side and its
    correction): 4 ranks against 1, 1e-10."""
    vh = _velocity_hierarchy(2)
    n2 = vh.asms[-1].n2_real
    rng = np.random.default_rng(8)
    wind = rng.uniform(-1.0, 1.0, 2 * n2)
    n_pad = -(-n2 // N) * N
    bs = rng.standard_normal((2, n_pad))       # (component, RCM order)
    bs[:, n2:] = 0.0
    dm = lambda v: v.reshape(2, N, -1).transpose(1, 0, 2).reshape(-1)
    four = _ranks(_vcycle(vh, wind, dm(bs), **VGMG))
    one = _ranks(_vcycle(vh, wind, bs[:, :n2].reshape(-1), **VGMG),
                 size=1)[0]
    assert len(four[0][1]) == 3
    x4 = np.concatenate([o[0] for o in four]).reshape(N, 2, -1)
    x4 = x4.transpose(1, 0, 2).reshape(2, n_pad)[:, :n2]
    assert _rel(x4.reshape(-1), one[0]) < 1e-10
