"""The pixel count and the roofline arithmetic, against numbers worked by
hand."""

import pytest
import torch

from portbench import judge, readers, roofline, scenes
from portbench.judges import scene as scene_judge
from portbench.routes import resident


def test_pixels_of_a_160000_line_scene():
    # PAN1 + PAN2 + 4 bands of (40000, 3072), each input pixel once
    s = scenes.Scene(torch.empty(160000, 12288, dtype=torch.uint16),
                     torch.empty(160000, 12288, dtype=torch.uint16),
                     torch.empty(4, 40000, 3072, dtype=torch.uint16))
    assert s.pixels == 4_423_680_000


def test_pixels_of_a_160000_line_dual_scene():
    # CMOS2's 4 bands of (40000, 3072) besides: 491,520,000 more
    pan = torch.empty(160000, 12288, dtype=torch.uint16)
    mss = torch.empty(4, 40000, 3072, dtype=torch.uint16)
    s = scenes.Scene(pan, pan, mss, mss)
    assert s.pixels == 4_915_200_000


def test_crosspower_shape_and_bound_of_the_scene():
    cfg = {"slices": 10, "sections": 5}
    shape = resident.crosspower_shape(cfg, 160000, 12288)
    # 5 row blocks x 10 slices of 16000 x 1228 PAN px (615 half-spectrum
    # columns) against 4000 x 307 band px, a 129-column window
    assert shape == (50, 4, 16000, 615, 4000, 307, 129)
    # 8 (T M keep + T NB m n + M + keep) + 2 * 4 T NB M wx = 9203332920
    # bytes at 3.35 TB/s; the GEMM's 2.054 ms and the whitening's 1.175
    # ms are below it
    assert roofline.crosspower_bound_ms(*shape) == pytest.approx(
        9203332920 / 3.35e12 * 1e3, rel=1e-12)
    assert roofline.crosspower_bound_ms(*shape) == pytest.approx(
        2.7472636, rel=1e-6)


def test_stitch_bound_of_the_scene():
    # 2 * 2 * 160000 * 12288 read, 2 * 160000 * 24376 written, 4 float64
    # rows: 15665033216 bytes
    assert roofline.stitch_bound_ms(160000, 12288, 100) == pytest.approx(
        15665033216 / 3.35e12 * 1e3, rel=1e-12)


def test_an_operation_bound_kernel():
    # a GEMM-heavy shape: the operations bound it, not the bytes
    ms = roofline.bound_ms(1e6, ops=(989e12, 989e12))
    assert ms == pytest.approx(1e3)


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert readers.percentile(v, 95) == 95
    assert readers.percentile([3.0], 95) == 3.0
    assert readers.percentile([], 95) is None


def test_estimate_gaps_in_pan_pixels():
    cx = torch.tensor([[1.0, 0.0]] * 4)
    cy = torch.tensor([[2.0, 0.0, 0.0]] * 4)
    est = (cx, cy, torch.tensor([20] * 4), torch.tensor(-3.0),
           torch.tensor(2.0), torch.tensor(10))
    moved = (cx + torch.tensor([0.0, 1e-6]), cy, torch.tensor([20] * 4),
             torch.tensor(-3.0), torch.tensor(2.25), torch.tensor(10))
    g = scene_judge.estimate_gaps(moved, est, 1280)
    # a slope gap of 1e-6 at the last band column's PAN coordinate 4 * 319
    assert g["fit_gap_px"] == pytest.approx(1e-6 * 4 * 319, rel=1e-6)
    assert g["stt_gap_px"] == 0.25
    inf = float("inf")
    nan = (cx * float("nan"), cy, *est[2:])
    assert scene_judge.estimate_gaps(nan, est, 1280)["fit_gap_px"] == inf
    # another count of valid tiles or sections: fits over other samples
    fewer = (cx, cy, torch.tensor([20, 19, 20, 20]), *est[3:])
    assert scene_judge.estimate_gaps(fewer, est, 1280)["fit_gap_px"] == inf
    lost = (*est[:5], torch.tensor(9))
    assert scene_judge.estimate_gaps(lost, est, 1280)["stt_gap_px"] == inf


def test_the_reservoir_keeps_a_uniform_sample():
    counts = [0] * 10
    for seed in range(2000):
        keep = judge.Reservoir(seed, 2)
        for i in range(10):
            keep.offer(i)
        for i in keep.kept.values():
            counts[i] += 1
    assert sum(counts) == 4000
    assert all(300 < c < 500 for c in counts)


def test_a_verdict_needs_a_limit_for_each_number_and_no_more():
    numbers = ("a_gap", "b_gap")
    readings = {"a_gap": 0.5, "b_gap": 0}
    ok, checks = judge.verdict(readings, {"a_gap": 1.0, "b_gap": 0},
                               numbers)
    assert ok and list(checks) == ["a_gap", "b_gap"]
    # a number of the judge's without a limit
    ok, checks = judge.verdict(readings, {"a_gap": 1.0}, numbers)
    assert not ok and checks["b_gap"] == {"value": 0, "limit": None}
    # a limit of a number the judge does not compare
    ok, checks = judge.verdict(readings, {"a_gap": 1.0, "b_gap": 0,
                                          "c_gap": 2.0}, numbers)
    assert not ok and checks["c_gap"] == {"value": None, "limit": 2.0}
    # a number of the judge's that no comparison read
    ok, checks = judge.verdict({"a_gap": 0.5}, {"a_gap": 1.0, "b_gap": 0},
                               numbers)
    assert not ok and checks["b_gap"]["value"] is None
    # over a limit, or not finite
    assert not judge.verdict({"a_gap": 1.5, "b_gap": 0},
                             {"a_gap": 1.0, "b_gap": 0}, numbers)[0]
    assert not judge.verdict({"a_gap": float("inf"), "b_gap": 0},
                             {"a_gap": 1.0, "b_gap": 0}, numbers)[0]
