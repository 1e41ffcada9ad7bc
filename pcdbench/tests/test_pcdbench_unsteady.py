"""The unsteady cell (``cylinder-dfg-l2.2d2-span``): its readers silent where
there is nothing to read, the K3 least time, the harness end to end at
level 0 on the CPU, and the readings that set its limits.

Level 0 with one lead step and a span of two; the dense cap is lowered
below the level-0 P1 bottom, whose inverse, rebuilt for every Picard
solve, would take seconds on one thread."""
import io
import json
import os
import shutil
import types
from contextlib import redirect_stdout

import pytest
import torch

from conftest import ROOT
from pcdbench import roofline, spans
from pcdbench import run as harness
from pcdbench.metrics import ell_spmv_roofline as ell_reader

HERE = os.path.join(ROOT, "pcdbench")
CELL = "cylinder-dfg-l2.2d2-span"
CONFIG = "cylinder-dfg2d2-l2"
SPAN_READERS = ("picard_iters_per_step", "fgmres_iters_per_step",
                "host_syncs_per_step", "step_residual_ms")


def _reader(name):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"),
                               "reader_" + name)


def _cfg():
    cfg = harness.load_json(os.path.join(HERE, "configs", CONFIG + ".json"))
    cfg["level"] = cfg["problem"]["level"] = 0
    cfg["size"]["dofs"] = 20954
    cfg["solve"].update(lead_steps=1, span_steps=2)
    return cfg


@pytest.fixture
def small_cap(monkeypatch):
    from fenapack_tpu_torch.solvers import gmg
    monkeypatch.setattr(gmg, "DENSE_MAX", 4096)


def _ctx(profile=None, **extra):
    return {"profile": profile, "window": types.SimpleNamespace(records=[]),
            **extra}


@pytest.mark.parametrize("name", SPAN_READERS + ("ell_spmv_roofline",))
def test_silent_without_a_traced_run(name):
    assert _reader(name).read(_ctx()) is None


@pytest.mark.parametrize("counts", [
    {"host_syncs": 40},                                   # no such counters
    {"host_syncs": 40, "unsteady_steps": 0, "unsteady_picard_iters": 0},
])
@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_silent_where_no_time_step_ran(name, counts):
    """A program without the time stepper's counters (the parent of the
    cell), or a steady request (no time step): nothing to read."""
    ctx = _ctx({"busy_s": 1.0}, spans={
        "counts": counts,
        "host": {"fgmres.iter": [30, 0.1, 0.05],
                 "unsteady.residual": [0, 0.0, 0.0]}})
    assert _reader(name).read(ctx) is None


def test_ell_roofline_silent_without_the_counters(monkeypatch):
    from fenapack_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "counts", {"bsr_nnz_f64": 0,
                                           "host_syncs": 0})
    monkeypatch.setattr(spans, "_run_locals", lambda: pytest.fail(
        "looked for the run without the program's counters"))
    assert ell_reader.read(_ctx({"busy_s": 1.0})) is None


def test_ell_roofline_silent_off_a_card(monkeypatch):
    monkeypatch.setattr(spans, "_run_locals", lambda: {"cuda": False})
    assert ell_reader.read(_ctx({"busy_s": 1.0})) is None


@pytest.mark.parametrize("products", [
    [(1000, 64, 64, 1, "f64")],
    [(1000, 64, 64, 1, "f64"), (50, 16, 64, 1, "f64"),
     (7000, 200, 200, 2, "f32")],
])
def test_ell_least_time_of_the_sums(products):
    """One product: the frozen yardstick's own least time; several: the
    sums' least time, at most the sum of each product's own."""
    vb = ell_reader.VALUE_BYTES
    own = sum(roofline.least_s(*roofline.single(
        nnz, r, c, k, vb[t], vb[t]), vb[t]) for nnz, r, c, k, t in products)
    reads = {t: [0, 0] for t in vb}
    for nnz, r, c, k, t in products:
        reads[t][0] += nnz
        reads[t][1] += (r + c) * k
    got = ell_reader.least(reads)
    assert 0 < got <= own * (1 + 1e-12)
    if len(products) == 1:
        assert got == pytest.approx(own, rel=1e-12)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A copy of the harness's data with the configuration at level 0."""
    d = tmp_path_factory.mktemp("pcdbench_unsteady")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), d / sub)
    (d / "configs" / (CONFIG + ".json")).write_text(json.dumps(_cfg()))
    return str(d)


def test_traced_run_on_the_cpu(data, small_cap):
    """The cell found by name and run end to end: ``correct``, the four
    readers of spans and counters report, the device's reader stays
    silent."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = harness.run(bench, CELL, 2 ** 31 + 3, 0.5, True,
                             device="cpu", data=data)
    assert result["correct"] and result["failed"] == 0, result["check"]
    m = result["metrics"]
    assert set(SPAN_READERS) <= set(m) and "ell_spmv_roofline" not in m
    assert m["picard_iters_per_step"]["value"] == 3.0
    assert m["fgmres_iters_per_step"]["value"] > 3
    # one sync an FGMRES iteration, two a solve, two of the loop a solve
    assert m["host_syncs_per_step"]["value"] == pytest.approx(
        m["fgmres_iters_per_step"]["value"] + 3 * 4)
    assert "oseen_rel" in result["check"]
    assert buf.getvalue().count("judged request 0 step ") == 2


def test_control_readings(small_cap):
    """Sound passes the limits by the harness's verdict; the state
    unchanged and the program's float32 loop each fail one of ``res_rel``,
    ``cont_rel`` and ``oseen_rel``."""
    from pcdbench import unsteady
    cfg = _cfg()
    mod = harness.load_module(os.path.join(HERE, "configs",
                                           CONFIG + ".py"), "c_cyl_l0")
    with redirect_stdout(io.StringIO()):
        rows = unsteady.readings(cfg, mod, [5], [5], torch.device("cpu"))
    lim = cfg["limits"]
    out = {}
    for r in rows:
        rec = types.SimpleNamespace(ok=r["converged"])
        out[r["kind"]] = harness.verdict([rec], [r], lim)[0]
        over = {k for k in ("res_rel", "cont_rel", "oseen_rel")
                if not r[k] <= lim[k]}
        assert bool(over) == (r["kind"] != "sound"), (r["kind"], r)
    assert out == {"sound": 0, "unchanged": 1, "program32": 1}
