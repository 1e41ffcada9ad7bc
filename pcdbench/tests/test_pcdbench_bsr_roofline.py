"""The reader of ``bsr_spmv_roofline`` (``metrics/bsr_spmv_roofline.py``):
silent where there is nothing to read, and its least time no more than the
sum of the products' own least times."""
import types

import pytest

from pcdbench import roofline, spans
from pcdbench.metrics import bsr_spmv_roofline as reader


def _ctx(profile):
    return {"profile": profile, "window": types.SimpleNamespace(records=[])}


def test_silent_without_a_traced_run():
    assert reader.read(_ctx(None)) is None


def test_silent_where_the_program_has_no_such_counters(monkeypatch):
    from fenapack_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "counts",
                        {"bsr_slots": 0, "bsr_nnz": 0, "host_syncs": 0})
    monkeypatch.setattr(spans, "_run_locals", lambda: pytest.fail(
        "looked for the run without the program's counters"))
    assert reader.read(_ctx({"busy_s": 1.0})) is None


def test_silent_off_a_card(monkeypatch):
    monkeypatch.setattr(spans, "_run_locals", lambda: {"cuda": False})
    assert reader.read(_ctx({"busy_s": 1.0})) is None


@pytest.mark.parametrize("products", [
    [(1000, 64, 64, 1, "f32")],
    [(1000, 64, 64, 1, "f32"), (50, 16, 64, 1, "f32"),
     (7000, 200, 200, 1, "f64")],
])
def test_least_time_of_the_sums(products):
    """One product: its own least time; several: the sums' least time,
    which is at most the sum of each product's own."""
    own = sum(roofline.least_s(*roofline.single(
        nnz, r, c, k, reader.VALUE_BYTES[t], reader.VALUE_BYTES[t]),
        reader.VALUE_BYTES[t]) for nnz, r, c, k, t in products)
    reads = {t: [0, 0] for t in reader.VALUE_BYTES}
    for nnz, r, c, k, t in products:
        reads[t][0] += nnz
        reads[t][1] += (r + c) * k
    got = reader.least(reads)
    assert 0 < got <= own * (1 + 1e-12)
    if len(products) == 1:
        assert got == pytest.approx(own, rel=1e-12)
