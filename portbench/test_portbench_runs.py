"""Whole runs of each cell on the CPU at a small size, the port on its
plain versions: the reference agrees, and a run whose timed path is
broken underneath, or the control in the program's place, comes out not
correct.  (The look for a card is run.py's; these call the harness
behind it.)"""

import importlib
import importlib.util
import time

import pytest
import torch

from portbench import control, harness, judge

SMALL = {"config": {"pixels_per_line": 1280, "sections": 1,
                    "stt_lines": 192},
         "traffic": {"scene_lines": 2048}}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def judge_of(cell):
    """The name of the cell's judge, as its configuration's file gives
    it."""
    return harness.load_cell(cell)[1].get("judge")


def run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res, lines = run(cell)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    numbers = judge.find(judge_of(cell)).NUMBERS
    assert all(res["checks"][k]["value"] == 0 for k in numbers)
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = control.readings(cell, SEED, "control", "cpu", SMALL)
    conf = next(w["config"] for w in harness.load_benchmark()["workloads"]
                if w["name"] == cell)
    ok, checks = judge.verdict(r, judge.load_limits(conf),
                               judge.find(judge_of(cell)).NUMBERS)
    assert not ok, checks


def _faults(cell):
    """The faults module of the cell's judge, ``faults/<judge>.py``, or
    None where there is none."""
    name = f"portbench.faults.{judge_of(cell)}"
    if importlib.util.find_spec(name) is None:
        return None
    return importlib.import_module(name)


@pytest.mark.parametrize("cell", CELLS)
def test_every_judge_has_faults(cell):
    mod = _faults(cell)
    assert mod is not None and mod.FAULTS, (
        f"{cell}: no faults/{judge_of(cell)}.py with FAULTS")


@pytest.mark.parametrize("cell, fault", [
    (c, f.__name__) for c in CELLS for f in getattr(_faults(c), "FAULTS", [])])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    mod = _faults(cell)
    planted = getattr(mod, fault)
    number = planted(monkeypatch)
    res, lines = run(cell)
    assert not res["correct"], lines
    c = res["checks"][number]
    assert c["value"] > c["limit"], lines
    for k in mod.unmoved(planted):
        assert res["checks"][k]["value"] == 0, lines


def test_the_card_runs_a_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest portbench` "
                    "on the card")
    res, lines = harness.run(CELLS[0], SEED, 1.0, False, time.perf_counter())
    assert res["correct"], lines
