"""The reference binary's own sample task on one device
(models/device_pipeline.ParityScenePipeline, ``scene --parity``) on the CPU
at a small size with the reference's section loops, in both coordinate
modes: against the benchmark's plain reference (portbench/
reference_parity.py), against the port's file commands' parity route
(``prestitch``, the default action with ``--do-rrc4pan``, ``stitch -c``) on
the same strips written to files, and against the JAX package's parity
routes with the numpy ``cv::remap`` oracle at pinned estimates."""

import functools
import json
import os

import numpy as np
import pytest
import torch
from torch_parity_oracle import use_oracle_remap

from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
from opticalimageprocessor_tpu.models import preprocessor as jpre
from opticalimageprocessor_tpu.models import stitcher as jst
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.io import tiff as tiff_io
from opticalimageprocessor_tpu_torch.models import preprocessor as pre
from opticalimageprocessor_tpu_torch.models import scene
from opticalimageprocessor_tpu_torch.models import stitcher as st
from opticalimageprocessor_tpu_torch.models.device_pipeline import (
    ParityScenePipeline,
)
from portbench import harness, scenes
from portbench.judges import parity as judge

torch.set_num_threads(2)

# 12288 lines of 640 px: one registration block of 12288 lines (10 tiles
# of 64 columns), 10 stt windows of 1024 lines, PreStitch in 3000-row
# sections (5 of them and the rolling-buffer cut at the traffic's dy of
# about +1.6), 2 alignment sections of 2048 band lines with 520 overlap
# lines
WIDTH, LINES, SECTION_ROWS, LPS, OVERLAP = 640, 12288, 3000, 2048, 520
CFG = dict(harness.load_cell("resident_parity_160k")[1],
           pixels_per_line=WIDTH, sections=1, stt_lines=1024,
           remap_section_rows=SECTION_ROWS, line_per_section=LPS)
SEEDS = (2**31 + 4111, 6_000_000_017)
MODES = pytest.mark.parametrize("quantized", [False, True],
                                ids=["continuous", "quantized"])
# the program's fits and stt deltas against the reference's, PAN px: on
# the CPU both run the same float32 transforms of the same tiles and the
# same float64 least squares, and read 0; the bound leaves room for an
# FFT library whose last bits follow its batch (the program takes a PAN
# tile's spectrum once, the reference once a band).  The control, the
# reference a precision step lower, reads 9.2e-6 px (the stt) and 1.7e-3
# px (the fit) and more at this size.
EST_TOL = 1e-6


def _cfg(quantized):
    return dict(CFG, coord_mode="quantized" if quantized else "continuous")


def _pool(seed):
    traffic = json.loads(
        (harness.HERE / "traffic" / "scene_160k.json").read_text())
    traffic.update(scene_lines=LINES, pool=1)
    tables, pool = scenes.make_pool(seed, traffic, WIDTH, CFG["fold_cols"],
                                    "cpu")
    return tables, pool[0]


def _pipeline(tables, quantized):
    return ParityScenePipeline(
        tables.pan1, tables.pan2, tables.mss, slices=CFG["slices"],
        n_sections=1, stt_lines=CFG["stt_lines"], fold=CFG["fold_cols"] // 2,
        overlap_cols=CFG["fold_cols"], remap_section_rows=SECTION_ROWS,
        line_per_section=LPS, section_overlap=OVERLAP,
        quantized_coords=quantized)


@pytest.mark.parametrize("seed", SEEDS)
@MODES
def test_forward_matches_the_plain_reference(seed, quantized):
    """Estimates within EST_TOL of the reference's own; every raster byte
    for byte the reference's at the program's estimate, the rolling-buffer
    cut included."""
    tables, s = _pool(seed)
    aligned, prestt, stitched, n_valid, n_stt, (cx, cy, dx, dy) = _pipeline(
        tables, quantized)(s.pan1, s.pan2, s.mss)
    assert dy > 0 and int(n_valid.min()) >= 5 and n_stt == 10
    est = (cx, cy, n_valid, dx, dy, n_stt)
    cfg = _cfg(quantized)
    gaps = judge.estimate_gaps(est, judge.reference_estimate(s, tables, cfg),
                               WIDTH)
    assert gaps["fit_gap_px"] <= EST_TOL and gaps["stt_gap_px"] <= EST_TOL, \
        gaps
    assert judge.raster_gaps(s, tables, cfg, est,
                             (aligned, prestt, stitched)) == {
        k: 0 for k in judge.RASTERS}
    assert tuple(aligned.shape) == (LINES // 4 - OVERLAP, WIDTH // 4, 4)
    assert tuple(prestt.shape) == (LINES, WIDTH)
    assert tuple(stitched.shape) == (LINES, 2 * (WIDTH - 100))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One seed's strips and RRC tables as the file commands take them:
    RAW PANs, the line-interleaved RAW MSS, RRC CSVs."""
    d = tmp_path_factory.mktemp("parity_scene")
    tables, s = _pool(SEEDS[0])
    f = {n: str(d / f"{n}.RAW") for n in ("pan1", "pan2", "mss")}
    s.pan1.numpy().tofile(f["pan1"])
    s.pan2.numpy().tofile(f["pan2"])
    s.mss.permute(1, 0, 2).numpy().tofile(f["mss"])
    for name, (k, b) in (("pan1", tables.pan1), ("pan2", tables.pan2),
                         *[(f"msb{i + 1}", (tables.mss[0][i],
                                            tables.mss[1][i]))
                           for i in range(4)]):
        f[f"rrc_{name}"] = str(d / f"{name}.csv")
        save_rrc_params(f[f"rrc_{name}"], np.stack([k.numpy(), b.numpy()],
                                                   1))
    return str(d), f


def _rrc_mss(f):
    return tuple(f[f"rrc_msb{b}"] for b in range(1, 5))


def _forward_from_csvs(f, quantized, section_rows=SECTION_ROWS, lps=LPS,
                       stt_lines=CFG["stt_lines"]):
    """The pipeline on the files' strips, with the tables as the CSVs give
    them back."""
    pipe = ParityScenePipeline(
        scene.load_rrc(f["rrc_pan1"], WIDTH),
        scene.load_rrc(f["rrc_pan2"], WIDTH),
        scene.load_band_rrc(_rrc_mss(f), WIDTH // 4), slices=CFG["slices"],
        n_sections=1, stt_lines=stt_lines, fold=100,
        overlap_cols=CFG["fold_cols"], remap_section_rows=section_rows,
        line_per_section=lps, section_overlap=OVERLAP,
        quantized_coords=quantized)
    pan1, pan2 = (torch.from_numpy(np.fromfile(f[n], "<u2").reshape(
        LINES, WIDTH)) for n in ("pan1", "pan2"))
    mss = torch.from_numpy(np.fromfile(f["mss"], "<u2").reshape(
        LINES // 4, 4, WIDTH // 4).transpose(1, 0, 2).copy())
    return pipe(pan1, pan2, mss)


@pytest.fixture(scope="module", params=[False, True],
                ids=["continuous", "quantized"])
def file_runs(request, files, tmp_path_factory):
    """The pipeline, and the file commands' parity route on the same
    strips: ``prestitch``, the default action with ``--do-rrc4pan``,
    ``stitch -c 200``."""
    quantized = request.param
    d, f = files
    out = str(tmp_path_factory.mktemp("files"))
    mp = pytest.MonkeyPatch()
    mp.setattr(st, "REMAP_SECTION_ROWS", SECTION_ROWS)
    try:
        s = st.Stitcher(f["pan1"], f["pan2"], f["rrc_pan1"], f["rrc_pan2"],
                        sections=10, line_per_section=CFG["stt_lines"],
                        overlap_cols=CFG["fold_cols"], out_dir=out,
                        quantized_coords=quantized, pixels_per_line=WIDTH,
                        device="cpu")
        s.calc_stt_parameters()
        s.do_rrc()
        s.pre_stitch()
    finally:
        mp.undo()
    p = pre.PreProcessor(f["pan1"], f["mss"], f["rrc_pan1"], _rrc_mss(f),
                         out_dir=out, quantized_coords=quantized,
                         pixels_per_line=WIDTH, device="cpu")
    p.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    p.calc_inter_band_correlation(slices=10, sections=1, threshold=0.4)
    aligned_path = p.do_inter_band_alignment(LPS, 0, OVERLAP)
    stitched_path = st.stitch(s.rrc_file_pan1, s.prestt_file_pan2,
                              os.path.join(out, "stitched.RAW"), 100,
                              pixels_per_line=WIDTH)
    return (quantized, _forward_from_csvs(f, quantized), s, p, aligned_path,
            stitched_path)


def test_file_commands_estimates_equal(file_runs):
    """The pipeline's estimate is the file commands', number for number:
    the same tiles, transforms, fit and average."""
    _q, (_a, _p, _s, n_valid, n_stt, (cx, cy, dx, dy)), s, p, _ap, _sp = \
        file_runs
    assert (dx, dy) == (s.delta_x, s.delta_y)
    np.testing.assert_array_equal(cx.numpy(), p.coeff_x)
    np.testing.assert_array_equal(cy.numpy(), p.coeff_y)
    assert n_stt == 10 and int(n_valid.min()) == 10


def test_file_commands_rasters_equal(file_runs):
    """``*.RRC.PRESTT.RAW``, the ALIGNED raster and the stitched RAW byte
    for byte."""
    _q, (aligned, prestt, stitched, *_), s, _p, aligned_path, stitched_path \
        = file_runs
    assert open(s.prestt_file_pan2, "rb").read() == prestt.numpy().tobytes()
    np.testing.assert_array_equal(tiff_io.read_tiff(aligned_path),
                                  aligned.numpy()[..., [2, 1, 0, 3]])
    assert open(stitched_path, "rb").read() == stitched.numpy().tobytes()


def test_jax_parity_routes_with_the_oracle(file_runs, files, monkeypatch):
    """JAX's parity prestitch and alignment, the numpy ``cv::remap`` oracle
    in place of its XLA remap and the port's estimates pinned, give the
    pipeline's PRESTT and ALIGNED rasters byte for byte."""
    quantized, (aligned, prestt, *_rest, (cx, cy, dx, dy)), s, _p, _a, _s = \
        file_runs
    _d, f = files
    use_oracle_remap(monkeypatch)
    monkeypatch.setattr(jst, "REMAP_SECTION_ROWS", SECTION_ROWS)
    out = os.path.join(os.path.dirname(s.prestt_file_pan2), "jax")
    os.makedirs(out, exist_ok=True)
    js = jst.Stitcher(f["pan1"], f["pan2"], out_dir=out, sections=10,
                      line_per_section=CFG["stt_lines"],
                      overlap_cols=CFG["fold_cols"],
                      quantized_coords=quantized, pixels_per_line=WIDTH,
                      fast=False)
    js.delta_x, js.delta_y = dx, dy
    js.rrc_file_pan2 = s.rrc_file_pan2
    js.pre_stitch()
    assert open(js.prestt_file_pan2, "rb").read() == \
        prestt.numpy().tobytes()
    jp = jpre.PreProcessor(f["pan1"], f["mss"], "", _rrc_mss(f),
                           pixels_per_line=WIDTH, quantized_coords=quantized)
    jp.load_and_rrc(do_rrc_pan=False, do_rrc_mss=True)
    jp.coeff_x, jp.coeff_y = cx.numpy(), cy.numpy()
    want = jp.do_inter_band_alignment(LPS, 0, OVERLAP, write_tiff=False)
    np.testing.assert_array_equal(np.asarray(want), aligned.numpy())


@MODES
def test_cli_scene_parity_writes_the_pipelines_rasters(files, quantized,
                                                       monkeypatch, tmp_path):
    """``scene --parity`` (at the test width, in the command's 30000-row
    PreStitch sections, 20000-line alignment sections and stt windows of
    a tenth of the strip) writes the pipeline's aligned MSS and stitched
    PAN."""
    _d, f = files
    aligned, _p, stitched, *_ = _forward_from_csvs(f, quantized, 30000,
                                                   20000, LINES // 10)
    monkeypatch.setattr(scene, "run_parity_scene", functools.partial(
        scene.run_parity_scene, pixels_per_line=WIDTH))
    argv = ["scene", "--parity", "--pan1", f["pan1"], "--pan2", f["pan2"],
            "--mss", f["mss"], "--rrc-pan1", f["rrc_pan1"], "--rrc-pan2",
            f["rrc_pan2"], "--ibc-sections", "1", "--out-dir",
            str(tmp_path), "-o", str(tmp_path / "OUT.RAW"), "--device", "cpu",
            "--coord-mode", "quantized" if quantized else "continuous"]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", f[f"rrc_msb{b}"]]
    assert cli.main(argv) == 0
    assert (tmp_path / "OUT.RAW").read_bytes() == stitched.numpy().tobytes()
    np.testing.assert_array_equal(
        tiff_io.read_tiff(str(tmp_path / "mss.ALIGNED.TIFF")),
        aligned.numpy()[..., [2, 1, 0, 3]])


@pytest.mark.parametrize("flag", ["--mesh", "--stream", "--mss2"])
def test_cli_scene_parity_refusals(files, flag, capsys):
    """``--parity`` with ``--mesh``, ``--stream`` or ``--mss2`` is a usage
    error that says why, before any work."""
    d, f = files
    extra = {"--mesh": ["--mesh", "2"], "--stream": ["--stream"],
             "--mss2": ["--mss2", f["mss"]]}[flag]
    argv = ["scene", "--parity", "--pan1", f["pan1"], "--pan2", f["pan2"],
            "--mss", f["mss"], "--out-dir", d, "--device", "cpu", *extra]
    capsys.readouterr()
    assert cli.main(argv) == 254
    said = capsys.readouterr().out
    assert f"USAGE ERROR: --parity runs on one device from resident " \
           f"strips, without {flag}" in said


def test_cli_scene_parity_too_short_for_an_alignment_section(files,
                                                              tmp_path):
    """The reference's argument errors come before any device work: MSS
    strips of fewer than 1500 lines are a runtime error (rc 2)."""
    _d, f = files
    short = {}
    for n, lines in (("pan1", 4096), ("pan2", 4096), ("mss", 1024)):
        short[n] = str(tmp_path / f"{n}.RAW")
        np.fromfile(f[n], "<u2")[:lines * WIDTH].tofile(short[n])
    argv = ["scene", "--parity", "--pan1", short["pan1"], "--pan2",
            short["pan2"], "--mss", short["mss"], "-s", "4", "--out-dir",
            str(tmp_path), "--device", "cpu"]
    pipe = functools.partial(scene.run_parity_scene, pixels_per_line=WIDTH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scene, "run_parity_scene", pipe)
        assert cli.main(argv) == 2
