"""The reduction of the span-profile pass on synthetic events: device events
go to the innermost span open at their launch (by correlation id, else by
the spans' device-side annotations), idle gaps to the innermost span open
at their middle, and the parts add up to the busy and idle time."""
import types

import pytest

from pcdbench import spans

# host spans (start_us, end_us, name): solve > fgmres.iter > pc > pc.pcd,
# pc.velocity; then a residual outside the iteration
HOST = [
    (0, 1000, "solve"),
    (10, 600, "fgmres.iter"),
    (20, 400, "pc"),
    (30, 100, "pc.pcd"),
    (150, 380, "pc.velocity"),
    (700, 800, "residual"),
]
# launch calls: correlation id -> host time
LAUNCH = {1: 40, 2: 160, 3: 390, 4: 450, 5: 710, 6: 1200}
# device events (start, end, name, correlation id), one stream
DEVICE = [
    (50, 60, "k_pcd", 1),          # launched in pc.pcd
    (170, 200, "k_vel", 2),        # pc.velocity
    (400, 410, "k_pc", 3),         # pc itself (between its parts)
    (460, 470, "k_iter", 4),       # fgmres.iter
    (720, 740, "k_res", 5),        # residual
    (1210, 1215, "k_late", 6),     # launched outside every span
    (300, 305, "k_ann", 0),        # no launch found: the annotation's
]
ANN = [(290, 310, "pc.velocity"), (280, 320, "pc"), (50, 740, "solve")]


def test_events_go_to_the_innermost_span_of_their_launch():
    out = spans.attribute(HOST, LAUNCH, DEVICE, ANN)
    t = out["table"]
    assert t["pc.pcd"]["events"] == 1
    assert t["pc.pcd"]["device_s"] == pytest.approx(10e-6)
    assert t["pc.velocity"]["events"] == 2            # k_vel and k_ann
    assert t["pc.velocity"]["device_s"] == pytest.approx(35e-6)
    assert t["pc"]["events"] == 1 and t["fgmres.iter"]["events"] == 1
    assert t["residual"]["device_s"] == pytest.approx(20e-6)
    assert out["by_annotation"] == 1
    assert out["unattributed_events"] == 1
    assert out["unattributed_s"] == pytest.approx(5e-6)
    # under a span: its own events and those of the spans inside it
    assert t["pc"]["under_events"] == 4
    assert t["pc"]["under_s"] == pytest.approx((10 + 30 + 10 + 5) * 1e-6)
    assert t["solve"]["under_events"] == 6
    assert t["solve"]["device_s"] == 0.0


def test_parts_add_up_to_busy_and_idle():
    out = spans.attribute(HOST, LAUNCH, DEVICE, ANN)
    t = out["table"]
    dev = sum(r["device_s"] for r in t.values()) + out["unattributed_s"]
    assert dev == pytest.approx(out["busy_s"], rel=1e-12)
    assert out["busy_s"] == pytest.approx(90e-6)
    idle = sum(s for _, s in out["idle_by_span"])
    assert idle == pytest.approx(out["gaps_s"], rel=1e-12)
    assert out["gaps_s"] == pytest.approx((1215 - 50 - 90) * 1e-6)


def test_idle_gaps_are_named_by_the_innermost_span_at_their_middle():
    out = spans.attribute(HOST, LAUNCH, DEVICE, ANN)
    idle = dict(out["idle_by_span"])
    # gaps: 60-170 (mid 115: pc), 200-300 (250: pc.velocity), 305-400
    # (352.5: pc.velocity), 410-460 (435: fgmres.iter), 470-720 (595:
    # fgmres.iter), 740-1210 (975: solve)
    assert idle["pc"] == pytest.approx(110e-6)
    assert idle["pc.velocity"] == pytest.approx(195e-6)
    assert idle["fgmres.iter"] == pytest.approx(300e-6)
    assert idle["solve"] == pytest.approx(470e-6)
    assert out["table"]["pc.velocity"]["idle_s"] == pytest.approx(195e-6)
    none = spans.attribute([], {}, [(0, 1, "k", 1), (5, 6, "k", 2)], [])
    assert none["idle_by_span"] == [[spans.OUTSIDE, pytest.approx(4e-6)]]


def test_readers_are_silent_without_a_traced_run():
    """No profiled pass in the context (an untraced run): no passes, no
    values, and nothing is built."""
    import importlib
    ctx = {"profile": None, "window": types.SimpleNamespace(records=[])}
    assert spans.passes(ctx) is None and ctx["spans"] is None
    for name in ("host_syncs_per_iter", "pc_device_ms_per_iter",
                 "pc_velocity_device_ms_per_iter",
                 "pc_pcd_device_ms_per_iter", "pc_events_per_iter",
                 "step_build_ms"):
        reader = importlib.import_module("pcdbench.metrics." + name)
        assert reader.read(ctx) is None
