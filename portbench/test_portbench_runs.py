"""Whole runs of each cell on the CPU at a small size, the port on its
plain versions: the reference agrees, and a run whose timed path is
broken underneath, or the control in the program's place, comes out not
correct.  (The look for a card is run.py's; these call the harness
behind it.)"""

import time

import pytest
import torch

from opticalimageprocessor_tpu_torch.models import device_pipeline

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


def run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res, lines = run(cell)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(res["checks"][k]["value"] == 0 for k in judge.NUMBERS)
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = control.readings(cell, SEED, "control", "cpu", SMALL)
    conf = next(w["config"] for w in harness.load_benchmark()["workloads"]
                if w["name"] == cell)
    ok, checks = judge.verdict(r, judge.load_limits(conf))
    assert not ok, checks


def _altered_pixel(monkeypatch):
    real = device_pipeline.remap_const_stitch_chunked

    def altered(*a, **kw):
        out = real(*a, **kw)
        st = out[0] if isinstance(out, tuple) else out
        st[7, 11] = (st[7, 11].to(torch.int32) ^ 1).to(torch.uint16)
        return out

    monkeypatch.setattr(device_pipeline, "remap_const_stitch_chunked",
                        altered)
    return "stitched_dn_gap"


def _raster_never_written(monkeypatch):
    real = device_pipeline.remap_bands_interleaved

    def unwritten(src, *a, **kw):
        return torch.zeros_like(real(src, *a, **kw))

    monkeypatch.setattr(device_pipeline, "remap_bands_interleaved",
                        unwritten)
    return "aligned_dn_gap"


def _half_the_tiles(monkeypatch):
    real = device_pipeline.fit_tiles

    def half(geom, dx, dy, rs, threshold=0.4):
        rs = rs.clone()
        rs[rs.shape[0] // 2:] = 0.0     # left out; the fit over the rest
        return real(geom, dx, dy, rs, threshold)

    monkeypatch.setattr(device_pipeline, "fit_tiles", half)
    return "fit_gap_px"


def _fit_shifted_with_its_rasters(monkeypatch):
    # a wrong estimate that the transform then follows: the rasters agree
    # with the reference's resample at that estimate, the fit does not
    real = device_pipeline.fit_tiles

    def shifted(*a, **kw):
        coeffs, n_valid = real(*a, **kw)
        return [(cx + torch.tensor([2e-3, 0.0]), cy)
                for cx, cy in coeffs], n_valid

    monkeypatch.setattr(device_pipeline, "fit_tiles", shifted)
    return "fit_gap_px"


def _stt_shifted_with_its_raster(monkeypatch):
    real = device_pipeline.stt_average

    def shifted(*a, **kw):
        dx, dy, rs, n = real(*a, **kw)
        return dx + 0.25, dy, rs, n

    monkeypatch.setattr(device_pipeline, "stt_average", shifted)
    return "stt_gap_px"


FAULTS = {
    "resident_scene_160k": [_altered_pixel, _raster_never_written,
                            _half_the_tiles, _fit_shifted_with_its_rasters,
                            _stt_shifted_with_its_raster],
}
SELF_CONSISTENT = (_fit_shifted_with_its_rasters, _stt_shifted_with_its_raster)


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in FAULTS[c]],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    number = fault(monkeypatch)
    res, lines = run(cell)
    assert not res["correct"], lines
    c = res["checks"][number]
    assert c["value"] > c["limit"], lines
    if fault in SELF_CONSISTENT:
        # the rasters alone, judged at the program's estimate, miss it
        assert res["checks"]["aligned_dn_gap"]["value"] == 0, lines
        assert res["checks"]["stitched_dn_gap"]["value"] == 0, lines


def test_the_card_runs_a_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest portbench` "
                    "on the card")
    res, lines = harness.run(CELLS[0], SEED, 1.0, False, time.perf_counter())
    assert res["correct"], lines
