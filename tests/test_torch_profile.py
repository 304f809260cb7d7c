"""``--profile DIR`` of the port's CLI (utils/logging.device_profile and the
stage spans): the default action, ``prestitch`` and ``scene`` (resident and
``--stream``) each write one torch.profiler trace holding their stage()
spans, and the same outputs as the run without ``--profile``."""

import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.models import (
    preprocessor,
    scene,
    scene_stream,
    stitcher,
)
from opticalimageprocessor_tpu_torch.utils import logging as tlog
from test_torch_scene import FOLD, LINES, PIX, _write_scene

torch.set_num_threads(2)

# the default action keeps 1500 MSS lines after its overlap: a narrower,
# longer scene of its own
ALIGN_PIX, ALIGN_LINES = 1024, 6400


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("profile")
    files, _, _ = _write_scene(str(d), np.random.default_rng(31), LINES, PIX,
                               dy=3)
    (d / "align").mkdir()
    files["align"], _, _ = _write_scene(str(d / "align"),
                                        np.random.default_rng(32),
                                        ALIGN_LINES, ALIGN_PIX, dy=3)
    return files


def _patch_width(mp):
    """The CLI at the test scenes' widths (it runs at the camera's)."""
    for mod, name, width in ((preprocessor, "PreProcessor", ALIGN_PIX),
                             (stitcher, "Stitcher", PIX),
                             (scene, "run_scene", PIX),
                             (scene_stream, "run_scene_streamed", PIX)):
        mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                pixels_per_line=width))


@pytest.fixture(autouse=True)
def _test_width(monkeypatch):
    _patch_width(monkeypatch)


def _argv(command, files, out):
    rrc_msb = [x for b in range(1, 5)
               for x in (f"--rrc-msb{b}", files[f"rrc_msb{b}"])]
    common = ["--out-dir", str(out), "--device", "cpu"]
    if command == "prestitch":
        return ["prestitch", "--fast", "--pan1", files["pan1"], "--pan2",
                files["pan2"], "--rrc1", files["rrc_pan1"], "--rrc2",
                files["rrc_pan2"], "-s", "2", "-l", "1024",
                "--stitch-overlap", str(FOLD), *common]
    if command == "default":
        f = files["align"]
        return ["--fast", "--pan", f["pan1"], "--mss", f["mss"],
                "--do-rrc4pan", "--rrc-pan", f["rrc_pan1"],
                *[x for b in range(1, 5)
                  for x in (f"--rrc-msb{b}", f[f"rrc_msb{b}"])],
                "--slices", "8", "--ibc-sections", "1", *common]
    argv = ["scene", "--pan1", files["pan1"], "--pan2", files["pan2"],
            "--mss", files["mss"], "--rrc-pan1", files["rrc_pan1"],
            "--rrc-pan2", files["rrc_pan2"], *rrc_msb, "--slices", "8",
            "-s", "4", "-c", str(FOLD), "-o", str(out / "OUT.RAW"), *common]
    if command == "scene_stream":
        argv += ["--stream", "--stream-section-lines", "384"]
    return argv


SPANS = {
    "prestitch": {"stt_correlate", "rrc:pan1.RAW", "rrc:pan2.RAW",
                  "prestitch_fast"},
    "default": {"ibc_correlate", "alignment_fast",
                "write_tiff:mss.ALIGNED.TIFF"},
    "scene": {"scene_load", "scene_estimate", "scene_transform",
              "scene_write_aligned", "scene_write_stitched"},
    "scene_stream": {"stream_estimate", "stream_transform"},
}


def _outputs(out):
    return {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}


@pytest.fixture(scope="module")
def baselines(files, tmp_path_factory):
    """Each command without ``--profile`` (scene: the resident route, whose
    outputs the streamed one equals byte for byte), run from an empty
    working directory with ``--profile ""``."""
    root = tmp_path_factory.mktemp("base")
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_width(mp)
        mp.chdir(root)
        for command in ("prestitch", "default", "scene"):
            out = root / command
            out.mkdir()
            assert cli.main(_argv(command, files, out)
                            + ["--profile", ""]) == 0
            outs[command] = _outputs(out)
    return root, outs


@pytest.mark.parametrize("command", ["prestitch", "default", "scene",
                                     "scene_stream"])
def test_profile_writes_one_trace_with_the_stage_spans(files, baselines,
                                                       tmp_path, command):
    out, prof = tmp_path / "out", tmp_path / "prof"
    out.mkdir()
    assert cli.main(_argv(command, files, out) + ["--profile",
                                                  str(prof)]) == 0
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(prof)
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert SPANS[command] <= spans, spans
    assert any(e.get("cat") == "cpu_op" for e in events)
    want = baselines[1]["scene" if command == "scene_stream" else command]
    assert _outputs(out) == want


def test_empty_profile_writes_nothing(baselines):
    root, _ = baselines
    assert not glob.glob(str(root / "**" / "*.json"), recursive=True)
    assert tlog.device_profile("", "cuda").__class__.__name__ == \
        "nullcontext"


def test_stage_errors_propagate_through_the_profile(tmp_path):
    """A stage's exception leaves the span and the profiler as itself, and
    the trace up to it is still written."""
    with pytest.raises(ValueError, match="the real error"):
        with tlog.device_profile(str(tmp_path), "cpu"):
            with tlog.stage("failing_stage"):
                torch.ones(4).sum()
                raise ValueError("the real error")
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "failing_stage" in names
    assert tlog.stage_report()["failing_stage"]["calls"] >= 1
