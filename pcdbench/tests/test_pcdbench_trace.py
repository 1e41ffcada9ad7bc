"""The profile's reduction on synthetic events: the union of the device
intervals, the device time inside the scopes' annotations, and the idle
gaps named by the innermost host event open at their middle."""
import pytest

from pcdbench.trace import SCOPE, summarize, union_us


def test_union_merges_overlaps():
    busy, merged = union_us([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert busy == 5 and merged == [[0, 3], [5, 7]]


def test_summarize():
    # (start_us, end_us, name, on_device, thread, is_async)
    ev = [
        (0, 100, "outer", False, 1, False),
        (10, 20, "aten::mul", False, 1, False),
        (40, 60, SCOPE + "bsr", False, 1, False),
        (0, 1000, "other thread", False, 2, True),
        (100, 110, "k1", True, 0, False),
        (150, 170, SCOPE + "bsr", True, 0, False),     # annotation
        (150, 160, "bsr_kernel", True, 0, False),
        (160, 170, "bsr_kernel", True, 0, False),
        (300, 305, "k1", True, 0, False),
    ]
    host = [(105, 145, "aten::mul", False, 1, False),
            (170, 300, "cudaLaunchKernel", False, 1, False)]
    s = summarize(ev + host, wall_s=1e-3)
    assert s["device_events"] == 4
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["spmv_device_s"] == pytest.approx(20e-6)
    assert s["device_ops"][0] == ["bsr_kernel", pytest.approx(20e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(40e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(130e-6)
