"""The port's spans and counters (utils/logging.span, count, to_host,
span_report) on a small scene forward, and the kernel library's load
record (_build.load_s): on only while a torch profiler records, nested
scene > estimate > registration steps / stt, the same outputs either
way."""

import json
import logging
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalimageprocessor_tpu_torch import _build, cli
from opticalimageprocessor_tpu_torch.models import device_pipeline as dp
from opticalimageprocessor_tpu_torch.ops.resample import upsample4_f32
from opticalimageprocessor_tpu_torch.parallel.mesh import LineMesh
from opticalimageprocessor_tpu_torch.parallel.sharded_scene import (
    ShardedScene,
)
from opticalimageprocessor_tpu_torch.utils import logging as tlog

torch.set_num_threads(2)

LINES, WIDTH = 1024, 1024
FORWARDS = 2
REGISTER = ("oip.register.tiles", "oip.register.spectra",
            "oip.register.correlate", "oip.register.fit")
SPANS = ("oip.scene", "oip.estimate", *REGISTER, "oip.stt",
         "oip.transform")
PARENT = {"oip.scene": None, "oip.estimate": "oip.scene",
          **{n: "oip.estimate" for n in REGISTER},
          "oip.stt": "oip.estimate", "oip.transform": "oip.scene"}


def _pipeline():
    """A 1024 x 1024 scene as tests/test_torch_device_pipeline.py builds
    one (PAN = x4 upsample of noise, PAN2 rolled by (+2, -3), the bands
    rolled), and its pipeline."""
    rng = np.random.default_rng(7)
    scene = rng.integers(2000, 42000, (LINES // 4, WIDTH // 4)).astype(
        np.float32)
    up = upsample4_f32(torch.from_numpy(scene)).round().clamp(0, 65535)
    up = up.numpy().astype(np.uint16)
    pan2 = np.roll(np.roll(up, 2, 0), 200 - 3 - WIDTH, 1)
    mss = np.stack([np.roll(scene, (b % 2, b - 1), (0, 1))
                    for b in range(4)]).astype(np.uint16)
    params = [(0.98 + 0.04 * rng.random(WIDTH), rng.normal(0, 20, WIDTH))
              for _ in range(2)]
    mparams = (0.98 + 0.04 * rng.random((4, WIDTH // 4)),
               rng.normal(0, 20, (4, WIDTH // 4)))
    pipe = dp.ScenePipeline(*params, mparams, slices=8, fold=100,
                            stt_sections=4, overlap_cols=200)
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (up, pan2, mss)]
    return pipe, args


def _flat(out):
    """A forward's outputs as a flat list of tensors and floats."""
    aligned, stitched, n_valid, n_stt, params = out
    return [aligned, stitched, n_valid, n_stt, *params]


def _same(a, b):
    for x, y in zip(_flat(a), _flat(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """FORWARDS forwards under a CPU profiler: -> (pipe, args, outputs,
    span_report(), the exported trace's user annotations)."""
    pipe, args = _pipeline()
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [pipe(*args) for _ in range(FORWARDS)]
    report = tlog.span_report()
    tlog.reset_span_report()
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("oip.")]
    return pipe, args, outs, report, events


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_traced_forward_exports_every_span_nested_once_a_forward(traced):
    _pipe, _args, _outs, _report, events = traced
    by_name = {n: [e for e in events if e["name"] == n] for n in SPANS}
    for name in SPANS:
        assert len(by_name[name]) == FORWARDS, (name, len(by_name[name]))
    for name, parent in PARENT.items():
        if parent is None:
            continue
        for e in by_name[name]:
            assert sum(_inside(e, p) for p in by_name[parent]) == 1, name
    assert {e["name"] for e in events} == set(SPANS)


def test_span_report_counts_the_forwards(traced):
    _pipe, _args, _outs, report, _events = traced
    for name in SPANS:
        assert report[name]["calls"] == FORWARDS, name
        assert report[name]["parent"] == PARENT[name], name
        assert report[name]["device_ms"] > 0.0
        # on the CPU the device ms are the host clock's
        assert report[name]["device_ms"] == report[name]["host_ms"]
    est = report["oip.estimate"]["host_ms"]
    assert sum(report[n]["host_ms"] for n in (*REGISTER, "oip.stt")) <= est


def test_host_syncs_count_four_a_forward(traced):
    _pipe, _args, _outs, report, _events = traced
    assert report["host_syncs"] == {"calls": 4 * FORWARDS,
                                    "parent": "oip.transform",
                                    "count": 4 * FORWARDS}


def test_reg_stack_tiles_counts_every_tile_once_a_forward(traced):
    """Each registration writes its 8 PAN tiles and 8 band-quad tiles
    (8 slices, one row block) into its stacks: 16 a forward, in one
    write_tiles call each for the PAN and the bands."""
    _pipe, _args, _outs, report, _events = traced
    assert report["reg_stack_tiles"] == {"calls": 2 * FORWARDS,
                                         "parent": "oip.register.tiles",
                                         "count": 16 * FORWARDS}


def test_reg_stack_tiles_at_the_scene_geometry():
    """At the benchmark's geometry (10 slices, 5 row blocks; small rows
    here) a registration writes 100 tiles -- 50 PAN, 50 band quads -- in
    10 write_tiles calls (kernel (h)'s launches on the card); the counter
    counts nothing while no profiler records."""
    geom = dp.RegGeometry(10, 5, corr_rows=64, sec_stride=16, cols=32,
                          bcols=8, brows=16)
    rng = np.random.default_rng(3)
    pan = torch.from_numpy(rng.integers(0, 65536, (128, 320),
                                        dtype=np.uint16))
    mss = torch.from_numpy(rng.integers(0, 65536, (4, 32, 80),
                                        dtype=np.uint16))
    cpu = torch.device("cpu")

    def register():
        return dp.register_rows(geom, dp.StripRows(pan), dp.StripRows(mss),
                                [cpu], win=(8, 8))

    tlog.reset_span_report()
    off = register()
    assert "reg_stack_tiles" not in tlog.span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        on = register()
    report = tlog.span_report()
    tlog.reset_span_report()
    assert report["reg_stack_tiles"]["count"] == 100
    assert report["reg_stack_tiles"]["calls"] == 10
    for x, y in zip(off, on, strict=True):
        # noise against noise: the fits may be NaN, on and off alike
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_outputs_identical_with_tracing_on_and_off(traced):
    pipe, args, outs, _report, _events = traced
    assert not tlog.tracing()
    off = pipe(*args)
    for on in outs:
        _same(on, off)


def test_mesh_estimate_exports_the_estimate_spans(tmp_path):
    """ShardedScene.estimate on a 2-device CPU mesh runs the resident
    route's estimate: its registration steps and its stt export the same
    spans, nested in oip.estimate."""
    pipe, args = _pipeline()
    scene = ShardedScene(pipe, LineMesh(["cpu"] * 2))
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scene.estimate(*args)
    report = tlog.span_report()
    tlog.reset_span_report()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]
        if e.get("cat") == "user_annotation"}
    for name in (*REGISTER, "oip.stt"):
        assert name in names, name
        assert report[name]["parent"] == "oip.estimate", name


def test_untraced_spans_call_no_record_function(monkeypatch):
    """With no profiler recording, a span is a flag check: no
    record_function, no CUDA event, nothing in the table."""
    def refuse(*_a, **_k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    tlog.reset_span_report()
    pipe, args = _pipeline()
    pipe(*args)
    with tlog.stage("unit_test_untraced_stage"):
        tlog.count("unit_test_counter")
    assert tlog._RECORDS == []
    assert tlog.span_report() == {}


def test_traced_span_lets_the_body_error_through():
    tlog.reset_span_report()
    with pytest.raises(ValueError, match="the real error"):
        with profile(activities=[ProfilerActivity.CPU]):
            with tlog.span("oip.scene"):
                with tlog.span("unit_test_inner"):
                    raise ValueError("the real error")
    report = tlog.span_report()
    tlog.reset_span_report()
    assert report["unit_test_inner"]["parent"] == "oip.scene"
    assert report["oip.scene"]["calls"] == 1
    assert tlog._open_names() == []


def test_to_host_counts_only_tensors():
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tlog.to_host(2.5) == 2.5
        arr = np.arange(3)
        assert tlog.to_host(arr) is arr
        t = tlog.to_host(torch.tensor([1, 2]))
        v = tlog.to_host(torch.tensor(2.5))
    report = tlog.span_report()
    tlog.reset_span_report()
    assert isinstance(t, torch.Tensor) and t.tolist() == [1, 2]
    assert v == 2.5 and isinstance(v, float)
    assert report == {"host_syncs": {"calls": 2, "parent": None,
                                     "count": 2}}


def test_cli_stage_report_logs_the_span_report(caplog):
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tlog.span("unit_test_cli_span"):
                tlog.count("unit_test_cli_counter", 2)
    with caplog.at_level(logging.DEBUG, logger="oiptpu"):
        cli._print_stage_report()
    tlog.reset_span_report()
    lines = [r.getMessage() for r in caplog.records]
    assert "==== span report ====" in lines
    span_line = next(x for x in lines if x.startswith("unit_test_cli_span"))
    assert "device ms a call" in span_line and "(3 calls)" in span_line
    count_line = next(x for x in lines
                      if x.startswith("unit_test_cli_counter"))
    assert count_line.split()[1] == "6"


class _FakeLib:
    def __init__(self, path):
        self.path = path
        for name in _build._SIGNATURES:
            setattr(self, name, types.SimpleNamespace())


@pytest.mark.parametrize("cached", [False, True], ids=["built", "cached"])
def test_build_load_is_recorded(tmp_path, monkeypatch, cached):
    """library()'s first call records its seconds and whether it built,
    with nvcc and the dlopen faked."""
    so = tmp_path / "liboiptorch_test.so"
    if cached:
        so.write_bytes(b"")
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, argv, **_kw):
            calls.append(argv)

        def communicate(self):
            return ("", None)

    def run(argv, **_kw):
        calls.append(argv)
        open(argv[argv.index("-o") + 1], "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_library_path", lambda: so)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "subprocess", types.SimpleNamespace(
        Popen=Proc, run=run, PIPE=-1, STDOUT=-2))
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "load_s", None)
    monkeypatch.setattr(_build, "built", None)
    lib = _build.library()
    assert lib.path == str(so) and so.exists()
    assert _build.built is (not cached)
    assert bool(calls) is (not cached)
    first = _build.load_s
    assert isinstance(first, float) and first >= 0.0
    assert _build.library() is lib and _build.load_s == first


# ---- the whole sample task: DualScenePipeline.forward

DUAL_SPANS = ("oip.scene", "oip.align2", "oip.seam")


def _dual_pipeline():
    """:func:`_pipeline`'s scene, returning the prestitched PAN2, with
    CMOS2's MSS (the noise rolled ((b + 1) mod 2, 1 - b) under the
    prestitched PAN2) and its align step."""
    pipe, args = _pipeline()
    pipe.return_prestt = True
    rng = np.random.default_rng(8)
    scene = np.roll(args[2][1].numpy(), -1, 0)       # band 1's roll is (1, 0)
    shift = (200 - WIDTH) // 4
    mss2 = np.stack([np.roll(scene, ((b + 1) % 2, shift + 1 - b), (0, 1))
                     for b in range(4)]).astype(np.uint16)
    align = dp.MssAlign((0.98 + 0.04 * rng.random((4, WIDTH // 4)),
                         rng.normal(0, 20, (4, WIDTH // 4))), slices=8)
    return dp.DualScenePipeline(pipe, align, 200), [
        *args, torch.from_numpy(mss2)]


def _same_dual(a, b):
    flat = [*a[:7], *a[7], *a[8]], [*b[:7], *b[7], *b[8]]
    for x, y in zip(*flat, strict=True):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.fixture(scope="module")
def traced_dual(tmp_path_factory):
    """One dual forward under a CPU profiler: -> (dual, args, outputs,
    span_report(), the exported trace's user annotations)."""
    dual, args = _dual_pipeline()
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = dual(*args)
    report = tlog.span_report()
    tlog.reset_span_report()
    path = tmp_path_factory.mktemp("dual_spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("oip.")]
    return dual, args, out, report, events


def test_traced_dual_forward_is_one_scene_with_align2_and_seam(traced_dual):
    _dual, _args, _out, report, events = traced_dual
    by_name = {n: [e for e in events if e["name"] == n] for n in DUAL_SPANS}
    for name in DUAL_SPANS:
        assert len(by_name[name]) == 1, (name, len(by_name[name]))
        assert report[name]["calls"] == 1, name
    (scene_ev,) = by_name["oip.scene"]
    for name in ("oip.align2", "oip.seam"):
        assert _inside(by_name[name][0], scene_ev), name
        assert report[name]["parent"] == "oip.scene", name
    # the second registration's steps nest in oip.align2: each registration
    # step twice, the second time inside it
    (align2,) = by_name["oip.align2"]
    for name in REGISTER:
        evs = [e for e in events if e["name"] == name]
        assert len(evs) == 2 and report[name]["calls"] == 2, name
        assert [_inside(e, align2) for e in evs] == [False, True], name
    assert not _inside(by_name["oip.seam"][0], align2)
    assert {e["name"] for e in events} == set(SPANS) | set(DUAL_SPANS)


def test_host_syncs_count_four_a_dual_forward(traced_dual):
    """The forward reads back what ScenePipeline.forward does: the stt
    deltas, clamped for the transform and again for the returned
    parameters; the second registration and the seam read nothing."""
    _dual, _args, _out, report, _events = traced_dual
    assert report["host_syncs"]["count"] == 4
    assert report["host_syncs"]["calls"] == 4


def test_reg_stack_tiles_counts_both_registrations(traced_dual):
    """Two registrations a dual scene, each writing its 16 tiles: 32 (at
    the benchmark's 10 slices and 5 row blocks, 200)."""
    _dual, _args, _out, report, _events = traced_dual
    assert report["reg_stack_tiles"]["count"] == 32
    assert report["reg_stack_tiles"]["calls"] == 4


def test_dual_outputs_identical_with_tracing_on_and_off(traced_dual):
    dual, args, out, _report, _events = traced_dual
    assert not tlog.tracing()
    _same_dual(out, dual(*args))


# ---- the parity scene (ParityScenePipeline, scene --parity)

PARITY_LINES, PARITY_WIDTH = 12288, 640
PARITY_SPANS = ("oip.register.surface", "oip.upsample", "oip.remap.sections")


def _parity_pipeline():
    """A 12288 x 640 scene of the benchmark's synthesis (PAN2 two rows
    down, so the stt's dy is about +1.6 and PreStitch takes a 2-row bottom
    cut) and its parity pipeline: one registration block of 10 tiles, 10
    stt windows, 3000-row PreStitch sections, 2048-line alignment
    sections."""
    from portbench import harness, scenes

    traffic = json.loads(
        (harness.HERE / "traffic" / "scene_160k.json").read_text())
    traffic.update(scene_lines=PARITY_LINES, pool=1)
    tables, (s,) = scenes.make_pool(7, traffic, PARITY_WIDTH, 200, "cpu")
    pipe = dp.ParityScenePipeline(
        tables.pan1, tables.pan2, tables.mss, n_sections=1, stt_lines=1024,
        remap_section_rows=3000, line_per_section=2048,
        quantized_coords=True)
    return pipe, [s.pan1, s.pan2, s.mss]


@pytest.fixture(scope="module")
def traced_parity(tmp_path_factory):
    pipe, args = _parity_pipeline()
    tlog.reset_span_report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [pipe(*args) for _ in range(FORWARDS)]
    report = tlog.span_report()
    tlog.reset_span_report()
    path = tmp_path_factory.mktemp("parity_spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("oip.")]
    return pipe, args, outs, report, events


def test_parity_spans_nest_under_the_scene(traced_parity):
    """Each full-surface group (10 registration tiles and the stt's one
    group of windows), each tile's x4 resize and each section remap is a
    span inside one ``oip.scene`` a forward; the estimate's, the stt's
    and the transform's spans nest as in the fast route."""
    _pipe, _args, _outs, report, events = traced_parity
    scenes_ = [e for e in events if e["name"] == "oip.scene"]
    assert len(scenes_) == FORWARDS
    calls = {"oip.register.surface": 11, "oip.upsample": 10,
             "oip.remap.sections": 14}
    for name in PARITY_SPANS:
        mine = [e for e in events if e["name"] == name]
        assert len(mine) == calls[name] * FORWARDS, name
        assert all(sum(_inside(e, s) for s in scenes_) == 1 for e in mine)
        assert report[name]["calls"] == calls[name] * FORWARDS
        assert report[name]["device_ms"] > 0.0
    assert report["oip.register.surface"]["parent"] == "oip.estimate"
    assert report["oip.upsample"]["parent"] == "oip.estimate"
    assert report["oip.remap.sections"]["parent"] == "oip.transform"
    for name in ("oip.estimate", "oip.transform"):
        assert report[name]["parent"] == "oip.scene"
    for name in ("oip.register.tiles", "oip.register.fit", "oip.stt"):
        assert report[name]["parent"] == "oip.estimate"
    stt_surfaces = [e for e in events if e["name"] == "oip.register.surface"
                    and any(_inside(e, s) for s in events
                            if s["name"] == "oip.stt")]
    assert len(stt_surfaces) == FORWARDS


def test_parity_counters_read_their_pinned_counts(traced_parity):
    """A forward correlates 10 tiles x 4 bands and 10 stt windows over the
    whole surface (50), remaps 5 PreStitch sections, the rolling-buffer
    window and 2 alignment sections of each band (14), writes 10 PAN and
    10 band-quad tiles (kernel (h)'s counter) and reads back 2 sets of
    statistics (the fit's and the stt average's)."""
    _pipe, _args, _outs, report, _events = traced_parity
    assert report["surface_pairs"]["count"] == 50 * FORWARDS
    assert report["remap_sections"]["count"] == 14 * FORWARDS
    assert report["reg_stack_tiles"]["count"] == 20 * FORWARDS
    assert report["host_syncs"]["count"] == 2 * FORWARDS


def test_parity_untraced_records_nothing(traced_parity):
    """With tracing off the spans and counters keep nothing, and the
    outputs are the traced forwards' bit for bit."""
    pipe, args, outs, _report, _events = traced_parity
    tlog.reset_span_report()
    out = pipe(*args)
    assert tlog.span_report() == {}
    aligned, prestt, stitched, n_valid, n_stt, params = out
    for got, want in zip((aligned, prestt, stitched, n_valid),
                         outs[0][:4]):
        assert torch.equal(got, want)
    assert n_stt == outs[0][4] and params[2:] == outs[0][5][2:]
    for got, want in zip(params[:2], outs[0][5][:2]):
        assert torch.equal(got, want)
