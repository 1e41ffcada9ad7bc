"""The spans and counters of the solve path (``utils/timing.py``) on one
level-0 step solve of the main path (Picard, Anderson(6), f64 FGMRES
around the f32 fieldsplit, BSR layout), on the CPU: nothing recorded and
the same state with spans off, the tree of spans with spans on, and the
counters against the solve's own counts."""
import collections

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fenapack_tpu_torch import bench, measure
from fenapack_tpu_torch.utils import timing


@pytest.fixture(scope="module")
def solves():
    """One solve with spans off and one with spans on, each with the
    counters' change over it."""
    nl = bench.build(0, device="cpu")
    full = nl.make_full_solve(rtol=bench.RTOL_NL, rtol_lin=bench.RTOL_LIN,
                              max_steps=bench.MAX_STEPS,
                              anderson=bench.ANDERSON)
    w0 = nl.initial_state().to(torch.float64)

    def counted(fn):
        c0 = measure.host_counts()
        r = fn()
        c1 = measure.host_counts()
        return r, {k: c1[k] - c0[k] for k in c1}

    with timing.tracing() as rec:
        on, on_counts = counted(lambda: full(w0))
    off, off_counts = counted(lambda: full(w0))
    return rec, on, on_counts, off, off_counts


def test_spans_off_record_nothing_and_change_nothing(solves):
    rec, on, _, off, _ = solves
    n = len(rec.spans)
    assert timing.span("pc") is timing.span("solve")     # the shared no-op
    with timing.span("pc"):
        pass
    assert len(rec.spans) == n and timing._recorder is None
    assert off.iters == on.iters and off.res == on.res
    assert torch.equal(off.w, on.w)


def test_spans_form_the_solve_tree(solves):
    rec, on, _, _, _ = solves
    spans = rec.spans
    count = collections.Counter(s.name for s in spans)
    assert count["solve"] == 1 and spans[0].name == "solve"
    assert count["picard.step"] == on.steps == len(on.iters)
    assert count["residual"] == len(on.res)
    assert count["oseen.build"] == count["fgmres"] == on.steps
    assert count["anderson"] == on.steps
    assert count["fgmres.iter"] == count["pc"] == sum(on.iters)
    assert count["fgmres.matvec"] == count["fgmres.host"] == sum(on.iters)
    assert count["spmv.bsr"] > 0
    children = collections.defaultdict(list)
    for i, s in enumerate(spans):
        assert s.request == spans[0].request
        if s.name != "solve":
            p = spans[s.parent]
            assert 0 <= s.parent < i
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        children[s.parent].append(s.name)
    for i, s in enumerate(spans):
        if s.name == "pc":
            kids = [n for n in children[i] if not n.startswith("spmv.")]
            assert sorted(kids) == ["pc.bt", "pc.pcd", "pc.velocity"]
        if s.name == "fgmres.iter":
            assert spans[s.parent].name == "fgmres"
    for n, (c, host, self_s) in timing.span_table(spans).items():
        assert c == count[n] and host >= self_s >= 0.0


def test_host_sync_counter_is_the_results_count(solves):
    _, on, on_counts, off, off_counts = solves
    assert on_counts["host_syncs"] == on.host_syncs
    assert off_counts["host_syncs"] == off.host_syncs == on.host_syncs
    # at least the |b| read and one column per iteration of every solve
    assert on.host_syncs > sum(on.iters) + len(on.iters)


def test_one_true_residual_per_linear_solve(solves):
    _, on, on_counts, _, off_counts = solves
    assert on_counts["true_residuals"] == off_counts["true_residuals"] \
        == len(on.iters)


def test_self_time_is_the_time_outside_the_child_spans():
    S = timing.Span
    rows = [S("solve", 0, 100, -1, 1), S("pc", 10, 50, 0, 1),
            S("pc.pcd", 20, 30, 1, 1), S("pc", 60, 90, 0, 1)]
    t = timing.span_table(rows)
    assert t["solve"] == [1, pytest.approx(100e-9), pytest.approx(30e-9)]
    assert t["pc"] == [2, pytest.approx(70e-9), pytest.approx(60e-9)]
    assert t["pc.pcd"] == [1, pytest.approx(10e-9), pytest.approx(10e-9)]
