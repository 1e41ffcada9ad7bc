"""The fieldsplit preconditioner replayed as CUDA graphs
(``solvers/fieldsplit.py``: ``PCGraphs``).

On the CPU the pipelines run eagerly, as before graphs existed.  A stub
capturer (the graph API's observable behaviour: capture runs the Python and
keeps its output tensor, replay rewrites that tensor and adds no count of
its own) checks the bookkeeping: one warm-up per solver, one capture per
pipeline, shape and dtype, the counter deltas that replays add and capture
does not (every counter of ``timing.counts``, the kernel launches among
them), and the release of a pipeline's graphs.  The GPU-marked tests run
the real graphs on a card against the eager apply.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch import bench, measure
from fenapack_tpu_torch.solvers.fieldsplit import (PCGraphs,
                                                   make_fieldsplit_upper)
from fenapack_tpu_torch.utils import timing

K2 = timing.LAUNCH + "bsr_spmv.f32"     # the launch counter of the toy


class StubGraph:
    def __init__(self, fn, out, log):
        self.fn, self.out, self.log = fn, out, log

    def replay(self):
        # a replay runs no Python of the products: their counts are
        # taken back
        saved = dict(timing.counts)
        y = self.fn()
        timing.counts.update(saved)
        self.out.copy_(y)
        self.log["replays"] += 1

    def reset(self):
        self.fn = None
        self.log["resets"] += 1


class StubCapturer:
    def __init__(self):
        self.log = {"warm": 0, "captures": 0, "replays": 0, "resets": 0}

    def warm(self, fn):
        self.log["warm"] += 1
        return fn()

    def capture(self, fn):
        self.log["captures"] += 1
        out = fn()
        return StubGraph(fn, out, self.log), out


def _counted(fn):
    """``fn()`` and what it added to every counter of ``timing.counts``."""
    c0 = dict(timing.counts)
    y = fn()
    return y, {k: n - c0[k] for k, n in timing.counts.items()}


def _toy(graphs, n_u=6, n_p=3, seed=0):
    """A fieldsplit over dense blocks whose products count a launch and a
    BSR read of 10 slots, 4 nonzeros and 7 vector entries each, as a
    kernel's wrapper would."""
    g = torch.Generator().manual_seed(seed)
    A = torch.rand(n_u, n_u, generator=g) + n_u * torch.eye(n_u)
    S = torch.rand(n_p, n_p, generator=g) + n_p * torch.eye(n_p)
    Bt = torch.rand(n_u, n_p, generator=g)

    def product(M):
        def mv(x):
            timing.launched("bsr_spmv", "f32")
            timing.bsr_read(slots=10, nnz=4, nnz_f32=4, vec_f32=7)
            return M @ x
        return mv
    free = torch.ones(n_u)
    free[0] = 0.0
    return make_fieldsplit_upper(n_u, product(A), product(S), product(Bt),
                                 free, graphs)


@pytest.fixture(scope="module")
def step0():
    return bench.build(0, device="cpu")


def test_cpu_pipeline_runs_eagerly(step0):
    """On CPU tensors no graphs: the apply is the fieldsplit's formula on
    the input cast to f32, cast back, and only ``pc_applies`` counts."""
    o = step0.oseen
    w = step0.initial_state()
    pc = o._pipeline(w[:o.n_u].to(o.dtype))
    assert pc.graphs is None and o._pc_graphs is None
    r = torch.randn(o.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    z, d = _counted(lambda: pc(r))
    x = r.to(torch.float32)
    r_u, r_p = x[:pc.n_u], x[pc.n_u:]
    z_p = pc.schur_solve(r_p)
    rhs = pc.free_u * (r_u - pc.bt_mv(z_p))
    z_u = pc.free_u * pc.a_solve(rhs) + (1.0 - pc.free_u) * r_u
    ref = torch.cat([z_u, z_p]).to(torch.float64)
    assert z.dtype == torch.float64 and torch.equal(z, ref)
    assert d["pc_applies"] == 1 and d["pc_graph_replays"] == 0
    # a linear solve counts one apply an iteration, no replay
    ir = o.make_ir_solve(bench.RTOL_LIN)
    F = step0.residual_of(w)[0]
    (_, iters, _, _, _), d = _counted(lambda: ir(w[:o.n_u], -F))
    assert iters > 0 and d["pc_applies"] == iters
    assert d["pc_graph_replays"] == 0


@pytest.mark.parametrize("device, ranks, graphed", [
    ("cpu", 1, False), ("cuda", 1, True), ("cuda", 2, False)])
def test_graphs_for_layout(device, ranks, graphed):
    """Graphs on a CUDA device and one rank; eager on the CPU and in the
    row-sharded layouts."""
    g = PCGraphs.for_layout(torch.device(device), ranks)
    assert isinstance(g, PCGraphs) if graphed else g is None


def test_stub_capture_bookkeeping():
    cap = StubCapturer()
    graphs = PCGraphs(cap)
    pc = _toy(graphs)
    eager = _toy(None)
    r = torch.randn(9, generator=torch.Generator().manual_seed(2))
    z_ref, d_ref = _counted(lambda: eager(r))
    assert d_ref[K2] == 3 and d_ref["pc_graph_replays"] == 0
    # the first apply on the solver is the warm-up: eager, once
    z, d = _counted(lambda: pc(r))
    assert torch.equal(z, z_ref) and cap.log["warm"] == 1
    assert cap.log["captures"] == 0 and d == d_ref
    # then one capture of the three parts, whose replay serves the apply
    for i in range(3):
        z, d = _counted(lambda: pc(r))
        assert torch.equal(z, z_ref) and z is not pc._graphs[
            ((9,), torch.float32)].out
        assert cap.log["captures"] == 3 and cap.log["warm"] == 1
        assert d[K2] == 3 and d["pc_applies"] == 1
        assert d["bsr_slots"] == 30 and d["bsr_nnz"] == 12
        assert d["bsr_nnz_f32"] == 12 and d["bsr_vec_f32"] == 21
        assert d["pc_graph_replays"] == (1 if i else 0)
    # another dtype: its own graphs, the output in the input's dtype
    z64, d = _counted(lambda: pc(r.double()))
    assert cap.log["captures"] == 6 and d[K2] == 3
    assert z64.dtype == torch.float64 and torch.equal(z64,
                                                      z_ref.double())
    assert cap.log["resets"] == 0 and len(pc._graphs) == 2
    # a new pipeline releases the old one's graphs when it captures
    pc2 = _toy(graphs, seed=3)
    eager2 = _toy(None, seed=3)
    z2 = pc2(r)
    assert torch.equal(z2, eager2(r)) and cap.log["warm"] == 1
    assert cap.log["resets"] == 6 and not pc._graphs
    assert cap.log["captures"] == 9
    # and the released pipeline captures again, releasing the new one
    z, d = _counted(lambda: pc(r))
    assert torch.equal(z, z_ref) and d["pc_graph_replays"] == 0
    assert cap.log["captures"] == 12 and cap.log["resets"] == 9
    assert not pc2._graphs


def test_capture_restores_and_replay_adds_the_eager_counts():
    """A capture leaves every counter as it found it; each replay adds
    exactly what the eager apply adds (launches and BSR reads included),
    and one graph replay besides."""
    cap = StubCapturer()
    graphs = PCGraphs(cap)
    pc, eager = _toy(graphs), _toy(None)
    r = torch.randn(9, generator=torch.Generator().manual_seed(4))
    _, d_eager = _counted(lambda: eager(r))
    assert d_eager[K2] == 3 and d_eager["bsr_nnz"] == 12
    pc(r)                                               # the warm-up
    _, d = _counted(lambda: graphs._capture(pc, r))
    assert cap.log["captures"] == 3 and not any(d.values())
    # the apply that captures replays at once: no replay counted
    _, d = _counted(lambda: pc(r))
    assert cap.log["captures"] == 6 and d == d_eager
    for _ in range(2):
        _, d = _counted(lambda: pc(r))
        assert d.pop("pc_graph_replays") == 1
        assert d == {k: n for k, n in d_eager.items()
                     if k != "pc_graph_replays"}


def test_stub_graphs_on_the_main_path(step0, monkeypatch):
    """The step solve at level 0 through stub graphs: the counts, the
    state and the BSR reads of the eager solve, one capture a Picard step
    and a replay for every other apply."""
    o = step0.oseen
    full = step0.make_full_solve(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN,
                                 max_steps=bench.MAX_STEPS,
                                 anderson=bench.ANDERSON)
    w0 = step0.initial_state().to(torch.float64)
    with timing.tracing():
        eager, d_eager = _counted(lambda: full(w0))
    cap = StubCapturer()
    graphs = PCGraphs(cap)
    monkeypatch.setattr(o, "_pc_graphs", graphs)
    with timing.tracing():
        graphed, d = _counted(lambda: full(w0))
    assert graphed.iters == eager.iters and torch.equal(graphed.w, eager.w)
    n_it, n_steps = sum(eager.iters), len(eager.iters)
    assert d["pc_applies"] == d_eager["pc_applies"] == n_it
    assert cap.log["warm"] == 1 and cap.log["captures"] == 3 * n_steps
    assert d["pc_graph_replays"] == n_it - n_steps - 1
    for k in ("bsr_slots", "bsr_nnz", "bsr_nnz_f32", "bsr_vec_f32",
              "bsr_nnz_f64", "bsr_vec_f64", "host_syncs"):
        assert d[k] == d_eager[k], k


def test_a_dropped_pipeline_leaves_no_cycle(step0):
    """A pipeline and its velocity V-cycle are freed when dropped, without
    the cyclic collector: a graphed solve runs too little Python to call
    it often, and a cycle would hold each step's level operators."""
    o = step0.oseen
    w = step0.initial_state()[:o.n_u].to(o.dtype)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        for _ in range(2):
            pc = o._pipeline(w)
            pc(torch.ones(o.n, dtype=torch.float64))
            del pc
        gc.collect()
        ours = [f.__qualname__ for f in gc.garbage
                if getattr(f, "__module__", "").startswith(
                    "fenapack_tpu_torch")]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert ours == []


# ---- on the card --------------------------------------------------------- #

@pytest.fixture(scope="module")
def step1_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: graphs capture the kernels' launches")
    return bench.build(1, device="cuda")


def _winds(nl, k):
    g = torch.Generator().manual_seed(5)
    w = nl.initial_state()[:nl.n_u]
    return [(w + 0.1 * torch.randn(w.shape, generator=g, dtype=w.dtype)
             .to(w.device)).to(nl.oseen.dtype) for _ in range(k)]


@pytest.mark.gpu
def test_graphs_equal_eager_bitwise(step1_cuda):
    o = step1_cuda.oseen
    g = torch.Generator().manual_seed(6)
    replays0 = timing.counts["pc_graph_replays"]
    for wind in _winds(step1_cuda, 2):
        pc = o._pipeline(wind)
        assert pc.graphs is o._pc_graphs is not None
        eager = make_fieldsplit_upper(pc.n_u, pc.a_solve, pc.schur_solve,
                                      pc.bt_mv, pc.free_u)
        for _ in range(5):
            r = torch.randn(o.n, generator=g, dtype=torch.float64).cuda()
            assert torch.equal(pc(r), eager(r))
    assert timing.counts["pc_graph_replays"] > replays0


@pytest.mark.gpu
def test_graphed_solve_counts_equal_eager(step1_cuda, monkeypatch):
    nl = step1_cuda
    full = nl.make_full_solve(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN,
                              max_steps=bench.MAX_STEPS,
                              anderson=bench.ANDERSON)
    w0 = nl.initial_state().to(torch.float64)
    l0 = measure.launch_counts()["bsr_spmv"]
    graphed = full(w0)
    l1 = measure.launch_counts()["bsr_spmv"]
    monkeypatch.setattr(nl.oseen, "_pc_graphs", None)
    eager = full(w0)
    l2 = measure.launch_counts()["bsr_spmv"]
    assert graphed.converged and graphed.iters == eager.iters
    assert torch.equal(graphed.w, eager.w)
    assert {k: l1[k] - l0[k] for k in l0} == {k: l2[k] - l1[k] for k in l0}


@pytest.mark.gpu
def test_rebuilt_pipelines_hold_no_more_memory(step1_cuda):
    o = step1_cuda.oseen
    r = torch.randn(o.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7)).cuda()
    held = []
    for wind in _winds(step1_cuda, 6):
        pc = o._pipeline(wind)
        for _ in range(2):
            pc(r)
        del pc
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert max(held[1:]) <= held[1], held
