"""The whole sample task on one device (models/device_pipeline.
DualScenePipeline) on the CPU at a small size: against the plain
reference of the benchmark (portbench/reference.py, reference_dual.py,
judge ``dual``), against the ``scene --mss2`` route (models/scene.
run_scene) on the same strips, and the seam (stitch_mss_seam) against the
concat it replaced."""

import json

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu_torch.io import tiff as tiff_io
from opticalimageprocessor_tpu_torch.models import scene
from opticalimageprocessor_tpu_torch.models.device_pipeline import (
    DualScenePipeline,
    MssAlign,
    ScenePipeline,
    mss_fold_half,
    stitch_mss_seam,
)
from portbench import harness, scenes
from portbench.judges import dual as judge

torch.set_num_threads(2)

WIDTH, LINES = 1280, 2048
# the benchmark's configuration at the small size of its CPU tests: one
# registration row block, stt windows of 192 lines
CFG = dict(harness.load_cell("resident_dual_160k")[1], sections=1,
           stt_lines=192, pixels_per_line=WIDTH)
SEEDS = (2**31 + 977, 5_000_000_021)
# the program's fits and stt deltas against the reference's, PAN px: on
# the CPU both run the same float32 FFTs and bf16-rounded products, but
# BLAS may sum a contraction in another order (its blocking follows the
# thread count), which moves a fit by ~1e-6 px; the reference a precision
# step lower (portbench's control) reads 5e-4 px and more at this size
FIT_TOL = 1e-5


def _pool(seed):
    traffic = json.loads(
        (harness.HERE / "traffic" / "scene_dual_160k.json").read_text())
    traffic.update(scene_lines=LINES, pool=1)
    tables, pool = scenes.make_pool(seed, traffic, WIDTH, CFG["fold_cols"],
                                    "cpu")
    return tables, pool[0]


def _dual(tables, stt_lines):
    pipe = ScenePipeline(
        tables.pan1, tables.pan2, tables.mss, slices=CFG["slices"],
        n_sections=CFG["sections"], fold=CFG["fold_cols"] // 2,
        stt_sections=CFG["stt_sections"], stt_lines=stt_lines,
        overlap_cols=CFG["fold_cols"], return_prestt=True)
    align = MssAlign(tables.mss2, slices=CFG["slices"],
                     n_sections=CFG["sections"])
    return DualScenePipeline(pipe, align, CFG["fold_cols"])


@pytest.mark.parametrize("seed", SEEDS)
def test_dual_forward_matches_the_plain_reference(seed):
    """Estimates within FIT_TOL of the reference's own (its own stt deltas,
    prestitched PAN2 and second fit); every raster byte for byte the
    reference's resample at the program's own estimate."""
    tables, s = _pool(seed)
    (aligned, stitched, aligned2, stitched_mss, n_valid, n_stt, n_valid2,
     params, (cx2, cy2)) = _dual(tables, CFG["stt_lines"])(
        s.pan1, s.pan2, s.mss, s.mss2)
    cx, cy, _dxs, _dys, raw_dx, raw_dy = params
    est = (cx, cy, n_valid, raw_dx, raw_dy, n_stt, cx2, cy2, n_valid2)
    ref = judge.reference_estimate(s, tables, CFG)
    gaps = judge.estimate_gaps(est, ref, WIDTH)
    for k in ("fit_gap_px", "stt_gap_px", "fit2_gap_px"):
        assert gaps[k] <= FIT_TOL, (k, gaps)
    assert int(n_valid2.min()) >= 5
    rasters = (aligned, stitched, aligned2, stitched_mss)
    assert judge.raster_gaps(s, tables, CFG, est, rasters) == {
        k: 0 for k in judge.RASTERS}
    assert tuple(stitched_mss.shape) == (
        LINES // 4, 2 * (WIDTH // 4 - mss_fold_half(CFG["fold_cols"])), 4)


def _write_csv(path, k, b):
    with open(path, "w") as f:
        f.write(f"1\n{k.numel()}\n0\n")
        for kk, bb in zip(k.tolist(), b.tolist()):
            f.write(f"{kk!r} , {bb!r}\n")


def test_dual_forward_equals_the_scene_mss2_files(tmp_path):
    """``run_scene(..., mss2_file=...)`` on the same strips and RRC tables
    writes exactly the dual forward's four rasters."""
    tables, s = _pool(SEEDS[0])
    f = {n: str(tmp_path / f"{n}.RAW") for n in ("pan1", "pan2", "mss",
                                                 "mss2")}
    s.pan1.numpy().tofile(f["pan1"])
    s.pan2.numpy().tofile(f["pan2"])
    for name in ("mss", "mss2"):
        getattr(s, name).numpy().transpose(1, 0, 2).tofile(f[name])
    rrc = {}
    for name in ("pan1", "pan2"):
        rrc[name] = str(tmp_path / f"{name}.csv")
        _write_csv(rrc[name], *getattr(tables, name))
    for name in ("mss", "mss2"):
        k, b = getattr(tables, name)
        rrc[name] = tuple(str(tmp_path / f"{name}b{i}.csv") for i in range(4))
        for i in range(4):
            _write_csv(rrc[name][i], k[i], b[i])
    out = tmp_path / "out"
    out.mkdir()
    paths = scene.run_scene(
        f["pan1"], f["pan2"], f["mss"], rrc["pan1"], rrc["pan2"], rrc["mss"],
        mss2_file=f["mss2"], rrc_mss2_files=rrc["mss2"],
        slices=CFG["slices"], sections=CFG["sections"],
        fold_cols=CFG["fold_cols"], stt_sections=CFG["stt_sections"],
        out_dir=str(out), out_stitched=str(out / "STITCHED.RAW"),
        pixels_per_line=WIDTH, device="cpu")
    # run_scene's stt windows are as long as the strip allows
    got = _dual(tables, None)(s.pan1, s.pan2, s.mss, s.mss2)
    bgr = [2, 1, 0, 3]
    for key, raster in zip(("aligned", "aligned2", "stitched_mss"),
                           (got[0], got[2], got[3])):
        written = tiff_io.read_tiff(paths[key])[..., bgr]
        np.testing.assert_array_equal(written, raster.numpy(), key)
    stitched = np.fromfile(paths["stitched"], "<u2").reshape(LINES, -1)
    np.testing.assert_array_equal(stitched, got[1].numpy())


@pytest.mark.parametrize("fold_cols", [8, 15, 200, 400])
def test_stitch_mss_seam_is_the_former_concat(fold_cols):
    g = torch.Generator().manual_seed(fold_cols)
    a, b = (torch.randint(0, 65536, (64, 320, 4), generator=g,
                          dtype=torch.int32).to(torch.uint16)
            for _ in range(2))
    foldm_half = max(1, fold_cols // 4 // 2)
    half = 320 - foldm_half
    want = torch.cat([a[:, :half], b[:, foldm_half:]], dim=1)
    assert mss_fold_half(fold_cols) == foldm_half
    got = stitch_mss_seam(a, b, fold_cols)
    assert got.dtype == torch.uint16 and torch.equal(got, want)


def test_dual_needs_the_prestitched_pan2():
    tables, _s = _pool(SEEDS[0])
    pipe = ScenePipeline(tables.pan1, tables.pan2, tables.mss)
    with pytest.raises(ValueError, match="return_prestt"):
        DualScenePipeline(pipe, MssAlign(tables.mss2), 200)


def test_scene_reexports_the_seam_width():
    # models/scene_stream and chip_smoke.py take it from models/scene
    assert scene.mss_fold_half is mss_fold_half
