"""The harness driven end to end at level 0 on the CPU (its look for a
card skipped: ``run(..., device="cpu")``): a new configuration, traffic
mix and metric found by name with no other edit; the traced path; the
refusal without a card; and ``correct`` coming out false under each fault
that a steady cell can have, and under its control."""
import io
import json
import os
import shutil
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from conftest import ROOT
from pcdbench import run as harness

HERE = os.path.join(ROOT, "pcdbench")
CELL = "step2d-l0.test"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A copy of the harness's data with one configuration, one traffic
    mix and one metric added as new files."""
    d = tmp_path_factory.mktemp("pcdbench_data")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), d / sub)
    cfg = harness.load_json(os.path.join(HERE, "configs",
                                         "step2d-brm2-l2.json"))
    cfg["name"] = "step2d-brm2-l0"
    cfg["level"] = cfg["problem"]["level"] = 0
    (d / "configs" / "step2d-brm2-l0.json").write_text(json.dumps(cfg))
    shutil.copy(os.path.join(HERE, "configs", "step2d-brm2-l2.py"),
                d / "configs" / "step2d-brm2-l0.py")
    (d / "traffic" / "picard_twice.json").write_text(json.dumps(
        {"clients": 1, "warmup_steps": 2, "profile_requests": 2}))
    (d / "metrics" / "solves_done.py").write_text(
        "def read(ctx):\n    return len(ctx['window'].records)\n")
    return str(d)


def _bench(extra_e2e=()):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"] = [{"name": CELL, "config": "step2d-brm2-l0",
                       "traffic": "picard_twice", "chips": 1, "why": "t"}]
    for m in b["per_layer"]:
        m["workloads"] = [CELL]
    b["end_to_end"] += [dict(name=n, unit="solves", better="higher",
                             bound=0.25, source="host_clock")
                        for n in extra_e2e]
    return b


def _run(data, trace=False, seconds=0.5, seed=2 ** 31 + 11, bench=None):
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = harness.run(bench or _bench(), CELL, seed, seconds, trace,
                             device="cpu", data=data)
    return result, buf.getvalue()


def test_new_files_found_by_name(data):
    result, out = _run(data, bench=_bench(["solves_done"]))
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "solve_s", "step_p95_ms",
                                      "peak_mem_gib", "solves_done"}
    assert result["metrics"]["solves_done"]["value"] == result["attempted"]
    assert list(result)[-1] == "check"
    assert "samples:" in out


def test_traced_run_on_the_cpu(data):
    result, out = _run(data, trace=True)
    assert result["correct"]
    m = result["metrics"]
    # no device here: the device readers find nothing and stay silent
    assert {"picard_steps_per_solve", "fgmres_iters_per_solve",
            "fgmres_iter_ms", "build_s"} <= set(m)
    assert not {"spmv_roofline_pct", "device_idle_pct",
                "device_events_per_iter"} & set(m)
    prof = json.loads(next(line for line in out.splitlines()
                           if line.startswith("profile: "))[9:])
    assert prof["requests"] == 2 and prof["unknown"] == 0
    assert prof["calls"]["bsr"] > 0 and prof["least_s"] > 0


def test_same_seed_same_answer(data):
    a, _ = _run(data, seed=77)
    b, _ = _run(data, seed=77)
    c, _ = _run(data, seed=78)
    assert a["check"]["res_rel"] == b["check"]["res_rel"]
    assert a["check"]["res_rel"] != c["check"]["res_rel"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "step2d-l2.picard-cold", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == "" and "no result" in cap.err


def test_fault_state_unchanged(data, monkeypatch):
    """Every step returns its state unchanged."""
    from fenapack_tpu_torch.solvers.oseen import OseenSolver
    make = OseenSolver.make_ir_solve

    def broken(self, rtol):
        ir = make(self, rtol)

        def solve(wind, b, rec=None):
            x, it, rn, lin, rec = ir(wind, b, rec)
            return torch.zeros_like(x), it, rn, lin, rec
        return solve
    monkeypatch.setattr(OseenSolver, "make_ir_solve", broken)
    result, _ = _run(data)
    assert not result["correct"]
    assert result["failed"] == result["attempted"] > 0


@pytest.mark.parametrize("where", ["velocity", "boundary", "pressure"])
def test_fault_answer_altered(data, monkeypatch, where):
    """The answer altered where it is produced, at one value."""
    from fenapack_tpu_torch.solvers.nonlinear import NonlinearSolver
    make = NonlinearSolver.make_full_solve

    def broken(self, *a, **kw):
        full = make(self, *a, **kw)
        o = self.oseen
        free = torch.nonzero(o.bc_mask_u == 0).ravel()
        fixed = torch.nonzero(o.bc_mask_u != 0).ravel()
        i = {"velocity": int(free[len(free) // 2]),
             "boundary": int(fixed[len(fixed) // 2]),
             "pressure": self.n_u + (self.n - self.n_u) // 2}[where]

        def solve(w0=None):
            r = full(w0)
            r.w = r.w.clone()
            r.w[i] += 1e-3
            return r
        return solve
    monkeypatch.setattr(NonlinearSolver, "make_full_solve", broken)
    result, _ = _run(data)
    assert not result["correct"] and result["failed"] > 0


def _control_verdicts(rows, limits):
    """``{kind: failed}`` of each reading, by the harness's own verdict."""
    out = {}
    for r in rows:
        rec = types.SimpleNamespace(ok=r["converged"])
        failed, _ = harness.verdict([rec], [r], limits)
        out.setdefault(r["kind"], []).append(failed)
    return out


def test_control_is_not_correct():
    """The control (the program's float32 path, and the sound answer
    rounded to float32) fails the configuration's limits by the harness's
    verdict; the sound run passes them."""
    from pcdbench import control
    cfg = harness.load_json(os.path.join(HERE, "configs",
                                         "step2d-brm2-l2.json"))
    cfg["level"] = cfg["problem"]["level"] = 0
    mod = harness.load_module(os.path.join(HERE, "configs",
                                           "step2d-brm2-l2.py"), "c_l0")
    with redirect_stdout(io.StringIO()):
        rows = control.readings(cfg, mod, [5, 2 ** 32 + 1], [5],
                                torch.device("cpu"))
    lim = cfg["limits"]
    assert _control_verdicts(rows, lim) == {
        "sound": [0, 0], "round32": [1, 1], "program32": [1]}
    sound = [r["cont_rel"] for r in rows if r["kind"] == "sound"]
    lower = [r["cont_rel"] for r in rows if r["kind"] != "sound"]
    assert max(sound) * 100 < lim["cont_rel"] < min(lower) / 10


@pytest.mark.gpu
def test_control_on_the_card(card):
    """The same on the card at the 2D cell's own size."""
    from pcdbench import control
    cfg = harness.load_json(os.path.join(HERE, "configs",
                                         "step2d-brm2-l2.json"))
    mod = harness.load_module(os.path.join(HERE, "configs",
                                           "step2d-brm2-l2.py"), "c_l2")
    with redirect_stdout(io.StringIO()):
        rows = control.readings(cfg, mod, [7, 8, 9], [7], card)
    assert _control_verdicts(rows, cfg["limits"]) == {
        "sound": [0, 0, 0], "round32": [1, 1, 1], "program32": [1]}
