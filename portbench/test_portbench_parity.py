"""Cell ``resident_parity_160k`` (configuration ``tj3_parity``) on the CPU
at a size that has the reference's section loops: sound in both
coordinate modes, the control in the program's place not correct, and
every fault of ``faults/parity.py`` caught; its plain reference takes
nothing of the port; its roofline's section count and bound against
numbers worked by hand."""

import time

import pytest
import torch

from portbench import control, harness, judge, roofline_parity
from portbench.faults import parity as faults

CELL = "resident_parity_160k"
# 16384 lines: one registration block of 16000 lines 192 lines down the
# strip (where the fast grid starts at 0), 3 PreStitch sections of 6000
# rows and the rolling-buffer cut, 2 alignment sections of 2048 band lines
SIZED = {"config": {"pixels_per_line": 640, "sections": 1, "stt_lines": 1024,
                    "remap_section_rows": 6000, "line_per_section": 2048},
         "traffic": {"scene_lines": 16384, "pool": 1}}
SEED = 2**31 + 4111


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(overrides=SIZED):
    return harness.run(CELL, SEED, 0.1, False, time.perf_counter(),
                       device="cpu", overrides=overrides)


@pytest.mark.parametrize("mode", ["quantized", "continuous"])
def test_a_sound_run_is_correct(mode):
    over = {"config": dict(SIZED["config"], coord_mode=mode),
            "traffic": SIZED["traffic"]}
    res, lines = run(over)
    assert res["correct"], lines
    assert all(c["value"] == 0 for c in res["checks"].values()), lines


def test_the_control_is_not_correct():
    r = control.readings(CELL, SEED, "control", "cpu", SIZED)
    ok, checks = judge.verdict(r, judge.load_limits("tj3_parity"),
                               judge.find("parity").NUMBERS)
    assert not ok, checks
    # a step below every stated precision moves every number
    assert all(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", [f.__name__ for f in
                                   faults.FAULTS + faults.SECTIONED])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    planted = getattr(faults, fault)
    number = planted(monkeypatch)
    res, lines = run()
    assert not res["correct"], lines
    c = res["checks"][number]
    assert c["value"] > c["limit"], lines
    for k in faults.unmoved(planted):
        assert res["checks"][k]["value"] == 0, lines


def test_the_reference_imports_nothing_of_the_port():
    for name in ("reference_parity.py", "roofline_parity.py",
                 "judges/parity.py"):
        text = (harness.HERE / name).read_text()
        assert "opticalimageprocessor_tpu" not in text
        assert "jax" not in text.replace("JAX", "")


def test_section_calls_of_the_scene():
    """At 160000 lines and the traffic's dy of about +1.68: PreStitch's 6
    sections of 30000 rows (the last 10010) keep all but their 2-row
    bottom cut, the rolling-buffer window of 12 rows gives those 2; each
    of the 4 bands' 2 alignment sections of 20000 lines keeps 19480."""
    cfg = harness.load_cell(CELL)[1]
    calls = roofline_parity.section_calls(cfg, (160000, 12288),
                                          (4, 40000, 3072), 1.678)
    assert calls == ([(30000, 29998, 12288)] * 5 + [(10010, 10008, 12288),
                                                    (12, 2, 12288)]
                     + [(20000, 19480, 3072)] * 8)
    assert sum(c[1] for c in calls[:7]) == 160000
    # dy < 0: a 3-row upper cut, kept by the first section, no window
    up = roofline_parity.section_calls(cfg, (160000, 12288),
                                       (4, 40000, 3072), -2.1)
    assert [c[1] for c in up[:6]] == [30000] + [29997] * 4 + [10012]
    assert len(up) == 6 + 8


def test_section_bound_of_the_scene():
    # every call is bound by its bytes: 2 (rows + count) W + 28 W at
    # 3.35 TB/s (34 operations a pixel at 33.5 TFLOP/s take less)
    cfg = harness.load_cell(CELL)[1]
    calls = roofline_parity.section_calls(cfg, (160000, 12288),
                                          (4, 40000, 3072), 1.678)
    nbytes = sum(2 * r * w + 2 * c * w + 28 * w for r, c, w in calls)
    assert nbytes == 2 * 12288 * (5 * 59998 + 20018 + 14 + 7 * 14) \
        + 8 * (2 * 3072 * 39480 + 28 * 3072)
    assert roofline_parity.section_bound_ms(calls) == pytest.approx(
        nbytes / 3.35e12 * 1e3, rel=1e-12)
