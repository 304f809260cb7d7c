"""The host's waits for the card (utils/logging.host_wait, to_host,
to_device): one ``oip.sync`` span around each, on the host clock, with its
enclosing span as parent, on only while a torch profiler records.  Here
on the small scene, dual and parity forwards of
tests/test_torch_spans.py: where the waits sit, the ``host_syncs`` count
beside them, nothing kept while untraced, the same outputs either way,
and the ``--profile`` report's waits by site.  On an NVIDIA card (marker
``cuda``) the three forwards run under
``torch.cuda.set_sync_debug_mode("error")``, which the spans lift for
their own wait only: no wait of theirs bypasses the spans.

This file imports no JAX, so its card tests also run where the port runs
alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_waits.py
"""

import json
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.io.streaming import HostDeviceCopies
from opticalimageprocessor_tpu_torch.utils import logging as tlog
from test_torch_spans import (
    _dual_pipeline,
    _parity_pipeline,
    _pipeline,
    _same,
    _same_dual,
)

SYNC = tlog.SYNC_SPAN

# where each forward waits: the span that encloses each oip.sync, and how
# many a forward (on the CPU no upload waits: a host copy opens no span)
SITES = {
    "scene": {"oip.transform": 2, "oip.scene": 2},
    "dual": {"oip.transform": 2, "oip.scene": 2},
    "parity": {"oip.register.fit": 1, "oip.stt": 1},
}
READS = {"scene": 4, "dual": 4, "parity": 2}


def _build(kind):
    return {"scene": _pipeline, "dual": _dual_pipeline,
            "parity": _parity_pipeline}[kind]()


def _traced(pipe, args, tmp_path):
    """One forward under a CPU profiler: -> (outputs, span_report(),
    wait_report(), the trace's oip.* user annotations)."""
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pipe(*args)
    report, waits = tlog.span_report(), tlog.wait_report()
    tlog.reset_span_report()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("oip.")]
    return out, report, waits, events


@pytest.fixture(scope="module", params=list(SITES))
def forward(request, tmp_path_factory):
    """Each forward traced once and run once untraced: -> (kind, traced
    outputs, untraced outputs, span_report(), wait_report(), events)."""
    kind = request.param
    pipe, args = _build(kind)
    on, report, waits, events = _traced(
        pipe, args, tmp_path_factory.mktemp(f"waits_{kind}"))
    assert not tlog.tracing()
    off = pipe(*args)
    return kind, on, off, report, waits, events


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_waits_sit_in_their_spans(forward):
    kind, _on, _off, report, waits, events = forward
    assert {site: w["calls"] for site, w in waits.items()} == SITES[kind]
    assert report[SYNC]["calls"] == sum(SITES[kind].values())
    # in the trace each wait lies inside one span of its site, and on
    # the host clock
    syncs = [e for e in events if e["name"] == SYNC]
    assert len(syncs) == sum(SITES[kind].values())
    for site in SITES[kind]:
        spans = [e for e in events if e["name"] == site]
        inside = [s for s in syncs if any(_inside(s, p) for p in spans)]
        assert len(inside) >= SITES[kind][site], site
    assert all(w["host_ms"] >= 0.0 for w in waits.values())


def test_host_syncs_keep_counting_the_reads(forward):
    kind, _on, _off, report, _waits, _events = forward
    assert report["host_syncs"]["count"] == READS[kind]
    assert report["host_syncs"]["calls"] == READS[kind]


def test_outputs_identical_with_the_waits_traced_and_not(forward):
    kind, on, off, _report, _waits, _events = forward
    if kind == "scene":
        _same(on, off)
    elif kind == "dual":
        _same_dual(on, off)
    else:
        for got, want in zip(off[:4], on[:4]):
            assert torch.equal(got, want)
        assert off[4] == on[4] and off[5][2:] == on[5][2:]
        for got, want in zip(off[5][:2], on[5][:2]):
            assert torch.equal(got, want)


def test_untraced_waits_keep_nothing_and_call_no_record_function(
        monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tlog.reset_span_report()
    assert tlog.to_host(torch.tensor(1.5)) == 1.5
    assert torch.equal(tlog.to_device(np.arange(4), "cpu"),
                       torch.arange(4))
    with tlog.host_wait():
        pass
    with tlog.host_wait(torch.device("cuda")):
        pass
    assert tlog._RECORDS == []
    assert tlog.wait_report() == {}


@pytest.mark.parametrize("target, spans", [
    (None, 1), ("cuda", 1), (torch.device("cuda", 0), 1), ("cpu", 0),
    ("meta", 0)], ids=["any", "cuda", "cuda:0", "cpu", "meta"])
def test_host_wait_opens_a_span_for_a_card_only(target, spans):
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        with tlog.span("unit_test_site"):
            with tlog.host_wait(target):
                pass
    waits = tlog.wait_report()
    tlog.reset_span_report()
    assert waits.get("unit_test_site", {}).get("calls", 0) == spans


def test_to_device_opens_no_span_off_the_card():
    """A host copy to the host (or to a device without memory) waits for
    no card; the values arrive as ``.to`` gives them."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)[:, 1:]
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        got = tlog.to_device(a, "cpu")
        meta = tlog.to_device(torch.from_numpy(a), "meta")
    report = tlog.span_report()
    tlog.reset_span_report()
    assert torch.equal(got, torch.from_numpy(a).to("cpu"))
    assert meta.device.type == "meta" and meta.shape == (2, 2)
    assert report == {}


def test_profile_report_lists_the_waits_by_site(caplog, tmp_path):
    pipe, args = _pipeline()
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        pipe(*args)
    with caplog.at_level(logging.DEBUG, logger="oiptpu"):
        cli._print_stage_report()
    tlog.reset_span_report()
    lines = [r.getMessage() for r in caplog.records]
    at = lines.index("==== waits by site ====")
    sites = {x.split()[0]: x.split() for x in lines[at + 1:]}
    for site, n in SITES["scene"].items():
        assert sites[site][1:3] == [str(n), "waits"], sites[site]
        assert sites[site][4:] == ["host", "ms"]
        assert float(sites[site][3]) >= 0.0


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the forwards' waits on the CPU "
                    "are reads of host memory")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(SITES))
def test_every_wait_of_a_forward_is_a_span(card, kind):
    """Each forward twice (cold caches, then warm) on the card under sync
    debug mode "error", traced: every wait that torch can see raises
    unless a span lifts the mode for it.  Its reads still count as
    before; the first forward's uploads (the plans, the cached tables)
    are waits too."""
    pipe, args = _build(kind)
    pipe = pipe.to(card)
    args = [a.to(card) for a in args]
    torch.cuda.synchronize()
    tlog.reset_span_report()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(2):
                    pipe(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        report, waits = tlog.span_report(), tlog.wait_report()
    finally:
        tlog.reset_span_report()
    assert report["host_syncs"]["count"] == 2 * READS[kind]
    for site, n in SITES[kind].items():
        assert waits[site]["calls"] >= 2 * n, (site, waits)
    assert report[SYNC]["calls"] >= 2 * READS[kind]


@pytest.mark.cuda
def test_to_device_spans_a_host_to_card_copy_only(card):
    a = np.arange(12, dtype=np.int32)
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        up = tlog.to_device(a, card)
        same = tlog.to_device(up, card)
        back = tlog.to_device(up.cpu(), "cpu")
    waits = tlog.wait_report()
    tlog.reset_span_report()
    assert same is up and torch.equal(back, torch.from_numpy(a))
    assert waits == {None: {"calls": 1, "host_ms": waits[None]["host_ms"]}}


@pytest.mark.cuda
def test_host_device_copies_waits_are_spans(card):
    """The third upload waits for the first's slot, and a drain waits
    for its copy: both are waits."""
    copies = HostDeviceCopies(card)
    a = np.arange(1 << 16, dtype=np.uint16)
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        ups = [copies.upload([a]) for _ in range(3)]
        (t,) = ups[2].get()
        (host,) = copies.download([t]).wait()
    waits = tlog.wait_report()
    tlog.reset_span_report()
    assert np.array_equal(host, a)
    assert waits[None]["calls"] == 2
