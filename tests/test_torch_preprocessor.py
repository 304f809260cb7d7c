"""Port registration + alignment (models/preprocessor, the CLI's default
action) against the JAX package's PreProcessor on the same RAW files and
RRC CSVs: the fast route, and the parity route against JAX's with the
numpy ``cv::remap`` oracle in place of its XLA remap."""

import functools
import os

import numpy as np
import pytest
import torch
from torch_parity_oracle import use_oracle_remap
from torch_jax_cli import jax_cli_main

from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
from opticalimageprocessor_tpu.io import tiff as tiff_io
from opticalimageprocessor_tpu.models import preprocessor as jpre
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.models import preprocessor as pre

torch.set_num_threads(2)

PPL, LINES_MSS = 1024, 1600
BAND_PX = PPL // 4
VX, VY = [1, 0, -1, 2], [0, -1, 1, 0]     # band rolls, band pixels


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """tests/test_pipeline_e2e.py's synthetic scene: a band-resolution
    noise field S, PAN = its x4 cubic upsample, band b = S rolled by
    (VY[b], VX[b]); random near-identity RRC CSVs."""
    d = str(tmp_path_factory.mktemp("pre"))
    rng = np.random.default_rng(42)
    s = rng.integers(2000, 42000, (LINES_MSS, BAND_PX)).astype(np.uint16)
    pan = np.clip(np.rint(np.asarray(jres.upsample4_f32(
        s.astype(np.float32)))), 0, 65535).astype(np.uint16)
    bands = [np.roll(s, (VY[b], VX[b]), (0, 1)) for b in range(4)]
    files = {"pan": os.path.join(d, "scene.PAN.RAW"),
             "mss": os.path.join(d, "scene.MSS.RAW")}
    pan.tofile(files["pan"])
    np.stack(bands, axis=1).reshape(LINES_MSS, PPL).tofile(files["mss"])
    for name, n in (("rrc_pan", PPL),
                    *[(f"rrc_msb{b}", BAND_PX) for b in range(1, 5)]):
        files[name] = os.path.join(d, f"{name}.csv")
        save_rrc_params(files[name], np.stack(
            [0.98 + 0.04 * rng.random(n), rng.normal(0, 20, n)], 1))
    return d, files


def _rrc_mss(files):
    return tuple(files[f"rrc_msb{b}"] for b in range(1, 5))


def _run(module, files, out_dir, **extra):
    os.mkdir(out_dir)
    pp = module.PreProcessor(files["pan"], files["mss"], files["rrc_pan"],
                             _rrc_mss(files), out_dir=out_dir,
                             pixels_per_line=PPL, fast=True, **extra)
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    rrc_tiff = pp.write_rrc_pan_tiff(line_offset=16)
    pp.calc_inter_band_correlation(slices=8, sections=1, threshold=0.1)
    aligned = pp.do_inter_band_alignment(line_per_section=1600,
                                         section_overlap=20,
                                         write_tiff=False)
    return pp, rrc_tiff, aligned


@pytest.fixture(scope="module")
def runs(scene):
    d, files = scene
    return (_run(jpre, files, os.path.join(d, "jax")),
            _run(pre, files, os.path.join(d, "port"), device="cpu"))


def _curve(c):
    x = np.linspace(0.0, PPL, 257)
    c = np.asarray(c, np.float64)
    return sum(c[k] * x**k for k in range(c.size))


def test_fits_match_jax(runs):
    """The fitted dx and dy polynomials within 1e-3 px of JAX across the
    strip, and the band rolls recovered (4x in PAN pixels)."""
    (jp, _, _), (pp, _, _) = runs
    for b in range(4):
        for attr in ("coeff_x", "coeff_y"):
            d = np.abs(_curve(getattr(pp, attr)[b])
                       - _curve(getattr(jp, attr)[b]))
            assert d.max() <= 1e-3, (attr, b, d.max())
        assert abs(np.mean([s.dx for s in pp.band_shifts[b]])
                   - 4 * VX[b]) < 0.35
        assert abs(np.mean([s.dy for s in pp.band_shifts[b]])
                   - 4 * VY[b]) < 0.35


def test_shift_samples_match_jax(runs):
    """Every (tile, band) sample within the fast-mode 1e-3 px envelope:
    JAX's x4 upsample on XLA:CPU sits a few ulp off the port's (ROADMAP
    Queue 3), which moves single centroids by up to ~2.5e-4 px."""
    (jp, _, _), (pp, _, _) = runs
    for b in range(4):
        for sj, sp in zip(jp.band_shifts[b], pp.band_shifts[b]):
            assert sj.cx == sp.cx
            assert abs(sj.dx - sp.dx) <= 1e-3 and abs(sj.dy - sp.dy) <= 1e-3
            assert abs(sj.rs - sp.rs) <= 1e-4


def test_rrc_pan_tiff_byte_equal_to_jax(runs):
    (_, jt, _), (_, pt, _) = runs
    assert os.path.basename(jt) == os.path.basename(pt)
    assert open(jt, "rb").read() == open(pt, "rb").read()


def test_pinned_alignment_matches_jax(runs):
    """JAX's fitted coefficients pinned into the port: the aligned bands
    within 1 DN on < 1% of pixels."""
    (jp, _, want), (pp, _, _) = runs
    pp.coeff_x, pp.coeff_y = jp.coeff_x.copy(), jp.coeff_y.copy()
    got = pp.do_inter_band_alignment(line_per_section=1600,
                                     section_overlap=20, write_tiff=False)
    assert got.shape == want.shape == (LINES_MSS - 20, BAND_PX, 4)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_aligned_tiff_is_bgra(runs, scene):
    """The ALIGNED.TIFF holds the aligned bands in channel order
    [2, 1, 0, 3] (cv::imwrite's BGRA), and keeps the leading rows with
    ``keep_leading_lines``."""
    _, (pp, _, _) = runs
    arr = pp.do_inter_band_alignment(1600, 0, 20, keep_leading_lines=True,
                                     write_tiff=False)
    assert arr.shape == (LINES_MSS, BAND_PX, 4)
    path = pp.do_inter_band_alignment(1600, 0, 20, keep_leading_lines=True)
    assert os.path.basename(path) == "scene.MSS.ALIGNED.TIFF"
    np.testing.assert_array_equal(tiff_io.read_tiff(path),
                                  arr[..., [2, 1, 0, 3]])


def test_resize_route_for_inexact_tiles(runs):
    """Slices that give no exact x4 tiles (1024 / 9 = 113 px PAN vs 28 px
    band) take the general cubic resize, as in JAX: the samples agree."""
    (jp, _, _), (pp, _, _) = runs
    for p in (jp, pp):
        p.calc_inter_band_correlation(slices=9, sections=1, threshold=0.0)
    for b in range(4):
        for sj, sp in zip(jp.band_shifts[b], pp.band_shifts[b]):
            assert abs(sj.dx - sp.dx) <= 1e-3 and abs(sj.dy - sp.dy) <= 1e-3


def test_cli_default_action_matches_model_api(scene, runs, monkeypatch,
                                              tmp_path):
    """``--fast`` through the CLI (at the test width) writes the model
    API's ALIGNED.TIFF byte for byte."""
    _, files = scene
    _, (pp, _, _) = runs
    pp.calc_inter_band_correlation(slices=8, sections=1, threshold=0.4)
    want = pp.do_inter_band_alignment(1600, 0, 520)
    monkeypatch.setattr(pre, "PreProcessor",
                        functools.partial(pre.PreProcessor,
                                          pixels_per_line=PPL))
    argv = ["--fast", "--pan", files["pan"], "--mss", files["mss"],
            "--do-rrc4pan", "--rrc-pan", files["rrc_pan"], "--slices", "8",
            "--ibc-sections", "1", "--out-dir", str(tmp_path),
            "--device", "cpu"]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", files[f"rrc_msb{b}"]]
    assert cli.main(argv) == 0
    got = tmp_path / os.path.basename(want)
    assert got.read_bytes() == open(want, "rb").read()


def test_parity_route_is_refused(scene):
    """The parity route, refused until it was ported, is the default and
    runs: one 1600-line section, the leading 520 overlap rows trimmed."""
    _, files = scene
    pp = pre.PreProcessor(files["pan"], files["mss"], pixels_per_line=PPL,
                          device="cpu")
    assert not pp.fast
    pp.load_and_rrc(do_rrc_mss=False)
    pp.coeff_x, pp.coeff_y = np.zeros((4, 2)), np.zeros((4, 3))
    got = pp.do_inter_band_alignment(20000, write_tiff=False)
    want = np.fromfile(files["mss"], "<u2").reshape(LINES_MSS, 4, BAND_PX)
    # the zero shift is the identity (the weights are exactly 0, 1, 0, 0)
    np.testing.assert_array_equal(got, want[520:].transpose(0, 2, 1))


@pytest.mark.parametrize("case", ["no_fast", "mesh", "profile",
                                  "orphan_rrc_pan", "missing_mss",
                                  "bad_threshold", "missing_band_rrc"])
def test_cli_usage_errors(scene, case, tmp_path):
    """Usage errors give 254; without ``--fast`` (the parity route, which
    once gave 254), with ``--profile`` (once refused with 254) and with
    ``--mesh`` (the line mesh, refused with 254 until it was ported) the JAX
    CLI's rc for the same argv: 2, the camera width does not divide this
    scene's files."""
    _, files = scene
    base = ["--pan", files["pan"], "--mss", files["mss"], "--device", "cpu"]
    for b in range(1, 5):
        base += [f"--rrc-msb{b}", files[f"rrc_msb{b}"]]
    argv = {
        "no_fast": base,
        "mesh": base + ["--fast", "--mesh", "8"],
        "profile": base + ["--fast", "--profile", str(tmp_path / "prof")],
        "orphan_rrc_pan": base + ["--fast", "--rrc-pan", files["rrc_pan"]],
        "missing_mss": ["--fast", "--pan", files["pan"], "--mss", "/nope",
                        "--no-rrc4mss"],
        "bad_threshold": base + ["--fast", "--ibc-threshold", "1.5"],
        "missing_band_rrc": ["--fast", "--pan", files["pan"], "--mss",
                             files["mss"]],
    }[case]
    if case in ("no_fast", "mesh"):
        i = argv.index("--device")
        assert cli.main(argv) == jax_cli_main(argv[:i] + argv[i + 2:]) == 2
    elif case == "profile":
        assert cli.main(argv) == 2
    else:
        assert cli.main(argv) == 254


def test_cli_runtime_error_is_rc2(scene):
    """The camera width does not divide this scene's files: RawStrip's
    whole-line check is a runtime error (rc 2), as in the JAX CLI."""
    _, files = scene
    argv = ["--fast", "--pan", files["pan"], "--mss", files["mss"],
            "--no-rrc4mss", "--device", "cpu"]
    assert cli.main(argv) == 2


# -- the parity route: bordered sections in both coordinate modes -----------

SEC_MSS_LINES = 3100
PINNED_X = [[4.0 * VX[b] + 0.3, -2.1e-4] for b in range(4)]
PINNED_Y = [[4.0 * VY[b] - 0.4, 6.5e-4, -3.0e-7] for b in range(4)]
MODES = pytest.mark.parametrize("quantized", [False, True],
                                ids=["continuous", "quantized"])
# (keep_leading_lines, line_offset): 1600-line sections overlapping by 100
# rows at offsets 0 and 1500, or 37, 1537 (a short last section of 1563)
LAYOUTS = pytest.mark.parametrize("keep,offset", [(False, 0), (True, 37)],
                                  ids=["trimmed", "keep_leading"])


@pytest.fixture(scope="module")
def section_files(tmp_path_factory):
    """A 3100-line MSS of noise with random band RRC CSVs, beside a PAN
    file of 4x its size that nothing reads (the fit is pinned)."""
    d = tmp_path_factory.mktemp("pre_sections")
    rng = np.random.default_rng(5)
    files = {"pan": str(d / "sec.PAN.RAW"), "mss": str(d / "sec.MSS.RAW")}
    rng.integers(0, 65536, (SEC_MSS_LINES, PPL), dtype=np.uint16).tofile(
        files["mss"])
    with open(files["pan"], "wb") as f:
        f.truncate(4 * SEC_MSS_LINES * PPL * 2)
    for b in range(1, 5):
        files[f"rrc_msb{b}"] = str(d / f"msb{b}.csv")
        save_rrc_params(files[f"rrc_msb{b}"], np.stack(
            [0.98 + 0.04 * rng.random(BAND_PX), rng.normal(0, 20, BAND_PX)],
            1))
    return files


def _align_sections(module, files, quantized, keep, offset, **extra):
    pp = module.PreProcessor(files["pan"], files["mss"], "", _rrc_mss(files),
                             pixels_per_line=PPL, quantized_coords=quantized,
                             **extra)
    pp.load_and_rrc(do_rrc_pan=False, do_rrc_mss=True)
    pp.coeff_x, pp.coeff_y = np.array(PINNED_X), np.array(PINNED_Y)
    return pp.do_inter_band_alignment(1600, offset, 100,
                                      keep_leading_lines=keep,
                                      write_tiff=False)


@MODES
@LAYOUTS
def test_parity_sections_equal_jax_with_oracle(section_files, monkeypatch,
                                               quantized, keep, offset):
    """With the oracle in place of JAX's XLA remap, JAX's parity route
    gives the reference's bytes: the port's ALIGNED array equals them, two
    sections with their overlap trimmed (or the first one's kept)."""
    got = _align_sections(pre, section_files, quantized, keep, offset,
                          device="cpu")
    use_oracle_remap(monkeypatch)
    want = _align_sections(jpre, section_files, quantized, keep, offset)
    assert got.shape == want.shape == (
        SEC_MSS_LINES - offset - (0 if keep else 100), BAND_PX, 4)
    np.testing.assert_array_equal(got, want)


@MODES
def test_parity_sections_within_jax(section_files, quantized):
    """Against JAX's own XLA:CPU parity route: <= 1 DN on < 2% of pixels;
    the two coordinate modes differ."""
    got = _align_sections(pre, section_files, quantized, False, 0,
                          device="cpu")
    want = _align_sections(jpre, section_files, quantized, False, 0)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())
    other = _align_sections(pre, section_files, not quantized, False, 0,
                            device="cpu")
    assert not np.array_equal(got, other)


@MODES
def test_cli_parity_matches_model_api(scene, monkeypatch, tmp_path,
                                      quantized):
    """The default action without ``--fast`` (at the test width), in each
    ``--coord-mode``, writes the model API's ALIGNED.TIFF byte for byte."""
    _, files = scene
    api = pre.PreProcessor(files["pan"], files["mss"], files["rrc_pan"],
                           _rrc_mss(files), out_dir=str(tmp_path),
                           pixels_per_line=PPL, quantized_coords=quantized,
                           device="cpu")
    api.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    api.calc_inter_band_correlation(slices=8, sections=1, threshold=0.4)
    want = api.do_inter_band_alignment(20000, 0, 520)
    monkeypatch.setattr(pre, "PreProcessor",
                        functools.partial(pre.PreProcessor,
                                          pixels_per_line=PPL))
    os.mkdir(tmp_path / "cli")
    argv = ["--pan", files["pan"], "--mss", files["mss"], "--do-rrc4pan",
            "--rrc-pan", files["rrc_pan"], "--slices", "8", "--ibc-sections",
            "1", "--out-dir", str(tmp_path / "cli"), "--device", "cpu",
            "--coord-mode", "quantized" if quantized else "continuous"]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", files[f"rrc_msb{b}"]]
    assert cli.main(argv) == 0
    got = tmp_path / "cli" / os.path.basename(want)
    assert got.read_bytes() == open(want, "rb").read()
