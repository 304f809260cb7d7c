"""The readers of the host's waits (``portbench/waits.py``) on event
lists as ``trace.read_events`` takes them, and on the port's span report
under a CPU profiler."""

import types

import pytest
from torch.profiler import ProfilerActivity, profile

from opticalimageprocessor_tpu_torch.utils import logging as tlog
from portbench import harness, trace, waits

# the window [0, 1000) us: one scene [100, 900), a wait [200, 300) and a
# wait [870, 950) that reaches past the scene; kernels leave three gaps
KERNELS = ((0, 210), (350, 600), (620, 880))
GAPS = {"opens in a wait": (210, 350),
        "opens outside a wait": (600, 620),
        "middle outside the scene": (880, 1000)}


def _events(syncs=((200, 100), (870, 80)), kernels=KERNELS):
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    return [x(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
            x("oip.scene", "user_annotation", 100, 800),
            *(x("oip.sync", "user_annotation", ts, dur) for ts, dur in syncs),
            *(x("kernel", "kernel", s, e - s) for s, e in kernels)]


def _ctx(events):
    return types.SimpleNamespace(trace=trace.read_events(events, 1))


def test_the_synthetic_trace_has_the_three_gaps():
    assert trace.idle_gaps(_ctx(_events()).trace) == list(GAPS.values())
    # 140 us from the one gap that counts
    assert waits.wait_gap_ms(_ctx(_events())) == pytest.approx(0.140)


@pytest.mark.parametrize("gap", list(GAPS))
def test_only_a_gap_that_opens_in_a_wait_inside_the_scene_counts(gap):
    """Each gap alone (the kernels cover the rest of the window)."""
    s, e = GAPS[gap]
    alone = [k for k in ((0, s), (e, 1000)) if k[1] > k[0]]
    got = waits.wait_gap_ms(_ctx(_events(kernels=alone)))
    want = (e - s) / 1e3 if gap == "opens in a wait" else 0.0
    assert got == pytest.approx(want)


def test_wait_gaps_are_at_most_the_host_gaps():
    ctx = _ctx(_events())
    host_gap = harness.reader("host_gap_ms.resident")(ctx)
    assert host_gap == pytest.approx(0.160)
    for name in ("wait_gap_ms.resident", "wait_gap_ms.dual",
                 "wait_gap_ms.parity"):
        assert harness.reader(name)(ctx) <= host_gap


def test_a_wait_over_every_gap_start_still_leaves_the_scene_out():
    ctx = _ctx(_events(syncs=((0, 1000),)))
    assert waits.wait_gap_ms(ctx) == pytest.approx(0.160)
    assert waits.wait_gap_ms(ctx) == pytest.approx(
        harness.reader("host_gap_ms.resident")(ctx))


def test_no_trace_or_no_wait_reads_nothing():
    assert waits.wait_gap_ms(types.SimpleNamespace(trace=None)) is None
    assert waits.wait_gap_ms(_ctx(_events(syncs=()))) is None
    assert waits.waits_a_scene(types.SimpleNamespace(trace=None)) is None


def test_host_waits_reads_the_port_s_waits_a_scene():
    ctx = _ctx(_events())
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with tlog.span("oip.scene"):
                for _ in range(3):
                    with tlog.host_wait():
                        pass
    try:
        for name in ("host_waits.resident", "host_waits.dual",
                     "host_waits.parity"):
            assert harness.reader(name)(ctx) == 3.0
    finally:
        tlog.reset_span_report()


def test_host_waits_reads_nothing_from_a_program_without_waits():
    """A program without ``oip.sync`` spans (before they were added)
    leaves the metric out, where it counts scenes."""
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        with tlog.span("oip.scene"):
            pass
    try:
        assert waits.waits_a_scene(_ctx(_events())) is None
    finally:
        tlog.reset_span_report()
