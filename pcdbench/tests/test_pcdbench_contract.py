"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and which cells report which metrics."""
import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[part]]
        assert len(names) == len(set(names))
        for e in bench[part]:
            extra = {"workloads"} if part in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[part] <= set(e) <= KEYS[part] | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_paths_and_command(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch") and ".." not in p
    assert len(bench["command"]) <= 32
    for w in bench["command"]:
        assert _line(w) and not w.startswith("/") and ".." not in w


def test_files_found_by_name(bench):
    here = os.path.join(ROOT, "pcdbench")
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"pcdbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(here, "configs",
                                           c["name"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           m["name"] + ".py"))


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e_of = {c: {n for n, m in e2e.items()
                  if c in m.get("workloads", cells)} for c in cells}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        for c in m.get("workloads", cells):
            assert c in cells
            assert m["moves"] in e2e_of[c], (m["name"], c)
    for c in cells:
        assert "setup_s" in e2e_of[c] and len(e2e_of[c]) >= 2
        assert any(c in m.get("workloads", cells)
                   for m in bench["per_layer"])
    # four chips for at most a quarter of the cells, rounded down, or one
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
