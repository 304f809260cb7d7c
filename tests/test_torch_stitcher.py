"""Port prestitch/stitch (models/stitcher, cli prestitch/stitch) against
the JAX package's Stitcher and stitch writers, on the same RAW files and
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
from opticalimageprocessor_tpu.models import stitcher as jst
from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.models import stitcher as st

torch.set_num_threads(2)

PPL, LINES, OVERLAP = 1024, 1024, 64
KW = dict(sections=3, line_per_section=256, overlap_cols=OVERLAP,
          pixels_per_line=PPL, fast=True)


def _write_pair(d, rng, dy):
    """CMOS1 and CMOS2 cut from one full-spectrum noise terrain: CMOS2's
    first OVERLAP columns see CMOS1's last ones 3 px further on, and its
    rows ``dy`` rows further down; random near-identity RRC CSVs."""
    terrain = rng.integers(2000, 42000, (LINES + 16, 2 * PPL)).astype(
        np.uint16)
    files = {"pan1": os.path.join(d, "CMOS1.PAN.RAW"),
             "pan2": os.path.join(d, "CMOS2.PAN.RAW")}
    terrain[4:4 + LINES, :PPL].tofile(files["pan1"])
    terrain[4 + dy:4 + dy + LINES,
            PPL - OVERLAP + 3:2 * PPL - OVERLAP + 3].tofile(files["pan2"])
    for name in ("rrc1", "rrc2"):
        files[name] = os.path.join(d, f"{name}.csv")
        save_rrc_params(files[name], np.stack(
            [0.98 + 0.04 * rng.random(PPL), rng.normal(0, 20, PPL)], 1))
    return files


def _run(module, files, out_dir, **extra):
    os.mkdir(out_dir)
    s = module.Stitcher(files["pan1"], files["pan2"], files["rrc1"],
                        files["rrc2"], out_dir=out_dir, **{**KW, **extra})
    s.calc_stt_parameters(threshold=0.05)
    s.do_rrc()
    n = s.pre_stitch()
    return s, n


@pytest.fixture(scope="module", params=[3, 9], ids=["dy3", "dy9"])
def runs(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"stt{request.param}"))
    files = _write_pair(d, np.random.default_rng(11 + request.param),
                        request.param)
    js, jn = _run(jst, files, os.path.join(d, "jax"))
    ps, pn = _run(st, files, os.path.join(d, "port"), device="cpu")
    return files, (js, jn), (ps, pn)


def _read(path):
    return np.fromfile(path, "<u2").reshape(-1, PPL)


def test_stt_deltas_match_jax(runs):
    _, (js, _), (ps, _) = runs
    assert abs(ps.delta_x - js.delta_x) <= 1e-3
    assert abs(ps.delta_y - js.delta_y) <= 1e-3
    assert abs(ps.response - js.response) <= 1e-3
    assert abs(ps.delta_x + 3) < 0.1, ps.delta_x


def test_rrc_raw_byte_equal_to_jax(runs):
    _, (js, _), (ps, _) = runs
    for jf, pf in ((js.rrc_file_pan1, ps.rrc_file_pan1),
                   (js.rrc_file_pan2, ps.rrc_file_pan2)):
        assert os.path.basename(jf) == os.path.basename(pf)
        with open(jf, "rb") as a, open(pf, "rb") as b:
            assert a.read() == b.read()


def test_pinned_prestitch_matches_jax(runs):
    """JAX's deltas pinned into the port: the PRESTT.RAW within 1 DN on
    < 1% of pixels (|dy| 3 takes kernel (c)'s route, |dy| 9 the staged
    route), and the same SectionaryRemap line count."""
    _, (js, jn), (ps, pn) = runs
    ps.delta_x, ps.delta_y = js.delta_x, js.delta_y
    n = ps.pre_stitch()
    assert n == jn == pn
    want, got = _read(js.prestt_file_pan2), _read(ps.prestt_file_pan2)
    assert got.shape == want.shape == (LINES, PPL)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_prestitch_route_follows_dy(runs, monkeypatch):
    """|dy| ~ 3 gives row bound 4-5 (kernel (c)); |dy| ~ 9 row bound
    10-11 (the staged remap)."""
    _, _, (ps, _) = runs
    seen = []
    real = st.resample.remap_band_fast_chunked
    monkeypatch.setattr(
        st.resample, "remap_band_fast_chunked",
        lambda *a, **k: seen.append(k["row_bound"]) or real(*a, **k))
    ps.pre_stitch()
    staged = abs(ps.delta_y) > 5
    assert (seen[0] > 6) == staged, (seen, ps.delta_y)


def test_cli_prestitch_matches_model_api(runs, monkeypatch, tmp_path):
    """``prestitch --fast`` through the CLI (at the test width) writes
    the model API's files byte for byte."""
    files, _, _ = runs
    api, _ = _run(st, files, str(tmp_path / "api"), device="cpu")
    monkeypatch.setattr(st, "Stitcher",
                        functools.partial(st.Stitcher, pixels_per_line=PPL))
    os.mkdir(tmp_path / "cli")
    rc = cli.main(["prestitch", "--fast", "--pan1", files["pan1"],
                   "--pan2", files["pan2"], "--rrc1", files["rrc1"],
                   "--rrc2", files["rrc2"], "-s", "3", "-l", "256",
                   "--stitch-overlap", str(OVERLAP), "--stt-threshold",
                   "0.05", "--out-dir", str(tmp_path / "cli"),
                   "--device", "cpu"])
    assert rc == 0
    for want in (api.rrc_file_pan1, api.rrc_file_pan2, api.prestt_file_pan2):
        got = tmp_path / "cli" / os.path.basename(want)
        assert got.read_bytes() == open(want, "rb").read()


def test_parity_route_is_refused(tmp_path, rng):
    """The parity route, refused until it was ported, is the default and
    runs: a one-section strip is the oracle's remap with the reference's
    float32 map fill, its bottom cut row included (the fresh tail), and
    pre_stitch returns SectionaryRemap's count."""
    p = str(tmp_path / "a.RAW")
    src = rng.integers(0, 65536, (8, 64), dtype=np.uint16)
    src.tofile(p)
    s = st.Stitcher(p, p, pixels_per_line=64, sections=1,
                    line_per_section=8, out_dir=str(tmp_path), device="cpu")
    assert not s.fast
    s.delta_x, s.delta_y = -1.25, 0.5
    assert s.pre_stitch() == 7          # 8 rows less the bottom cut of 1
    mapx = np.tile((np.arange(64.0) - 1.25).astype(np.float32), (8, 1))
    mapy = np.tile((np.arange(8.0) + 0.5).astype(np.float32)[:, None],
                   (1, 64))
    np.testing.assert_array_equal(
        np.fromfile(s.prestt_file_pan2, "<u2").reshape(8, 64),
        cv_exact.remap_cubic_u16_exact(src, mapx, mapy))


def test_average_valid_deltas_matches_jax(rng):
    dxs, dys = rng.normal(-3, 0.1, 6), rng.normal(2, 0.1, 6)
    rss = np.array([0.9, 0.3, 0.8, 0.95, 0.2, 0.7])
    offs = list(range(0, 600, 100))
    for th, my in ((0.4, 0.0), (0.75, 2.05)):
        assert st.average_valid_deltas(dxs, dys, rss, offs, th, my) == \
            jst.average_valid_deltas(dxs, dys, rss, offs, th, my)
    with pytest.raises(RuntimeError, match="No valid delta"):
        st.average_valid_deltas(dxs, dys, rss, offs, 0.99, 0.0)


@pytest.fixture
def tiff_pair(tmp_path, rng):
    h, w = 96, 128
    paths = []
    for name in ("L", "R"):
        p = str(tmp_path / f"{name}.TIFF")
        tiff_io.write_tiff(p, rng.integers(0, 65536, (h, w, 4),
                                           dtype=np.uint16))
        paths.append(p)
    return paths


@pytest.mark.parametrize("style", ["plain", "gdal_band_map", "band_interp"])
def test_stitch_tiff_byte_equal_to_jax(tmp_path, tiff_pair, style):
    """The TIFF path through both CLIs: plain, LZW GDAL style with the
    '-m 3,2,1,4' band map, and the R/G/B/Alpha tagging."""
    flags = {"plain": [], "gdal_band_map": ["-g", "-m", "3,2,1,4"],
             "band_interp": ["--band-interp"]}[style]
    outs = []
    for main, name in ((jax_cli_main, "jax"), (cli.main, "port")):
        out = str(tmp_path / f"{name}.TIFF")
        assert main(["stitch", "--image1", tiff_pair[0], "--image2",
                         tiff_pair[1], "-o", out, "-c", "16", *flags]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("out", ["S.RAW", "S.TIFF"])
def test_stitch_raw_byte_equal_to_jax(tmp_path, rng, out):
    """The RAW path through both CLIs at the camera width, RAW and TIFF
    outputs."""
    a, b = (str(tmp_path / f"{n}.RAW") for n in "ab")
    for p in (a, b):
        rng.integers(0, 65536, (16, 12288), dtype=np.uint16).tofile(p)
    got = []
    for main, d in ((jax_cli_main, "jax"), (cli.main, "port")):
        os.mkdir(tmp_path / d)
        path = str(tmp_path / d / out)
        assert main(["stitch", "--image1", a, "--image2", b, "-o", path,
                         "-c", "200"]) == 0
        got.append(open(path, "rb").read())
    assert got[0] == got[1]
    if out.endswith(".RAW"):
        st_ = np.frombuffer(got[1], "<u2").reshape(16, 2 * (12288 - 100))
        np.testing.assert_array_equal(
            st_[:, :12188], np.fromfile(a, "<u2").reshape(16, 12288)[:, :12188])


@pytest.mark.parametrize("case,rc", [
    ("stitch_fold_too_small", 254), ("stitch_map_without_gdal", 254),
    ("stitch_mixed_types", 2), ("prestitch_without_fast", 2),
    ("prestitch_mesh", 2), ("prestitch_profile", 2),
    ("prestitch_missing_pan2", 254), ("prestitch_bad_edge_cols", 254),
    ("auxsep", 2),
])
def test_cli_exit_codes(tmp_path, case, rc):
    """The JAX CLI's exit codes for the same argv: ``--profile``, ``--mesh``
    and ``auxsep`` run (an undersized PAN for the default -s x -l, and a
    name that matches no AOS pattern, are runtime errors)."""
    p = str(tmp_path / "a.RAW")
    np.zeros((4, 12288), np.uint16).tofile(p)
    pre = ["prestitch", "--pan1", p, "--pan2", p, "--device", "cpu"]
    argv = {
        "stitch_fold_too_small": ["stitch", "--image1", p, "--image2", p,
                                  "-c", "1"],
        "stitch_map_without_gdal": ["stitch", "--image1", p, "--image2", p,
                                    "-c", "4", "-m", "1,2,3,4"],
        "stitch_mixed_types": ["stitch", "--image1", p, "--image2", "x.TIFF",
                               "-c", "4"],
        "prestitch_without_fast": pre,
        "prestitch_mesh": pre + ["--fast", "--mesh", "2"],
        "prestitch_profile": pre + ["--fast", "--profile",
                                    str(tmp_path / "prof")],
        "prestitch_missing_pan2": ["prestitch", "--fast", "--pan1", p,
                                   "--pan2", str(tmp_path / "nope.RAW")],
        "prestitch_bad_edge_cols": pre + ["--fast", "-e", "101"],
        "auxsep": ["auxsep", p],
    }[case]
    assert cli.main(argv) == rc


def test_cli_prestitch_runtime_error_is_rc2(tmp_path):
    """An undersized PAN for -s x -l is a runtime error (rc 2), as in the
    JAX CLI."""
    p = str(tmp_path / "a.RAW")
    np.zeros((4, 12288), np.uint16).tofile(p)
    argv = ["prestitch", "--fast", "--pan1", p, "--pan2", p, "-s", "1",
            "-l", "16"]
    assert jax_cli_main(argv) == 2
    assert cli.main(argv + ["--device", "cpu"]) == 2


# -- the parity route: 384-row sections, both signs of delta_y, both modes --

MODES = pytest.mark.parametrize("quantized", [False, True],
                                ids=["continuous", "quantized"])


@pytest.fixture(scope="module", params=[3, -2], ids=["ucut", "bcut"])
def parity_pair(request, tmp_path_factory):
    """A CMOS pair ``dy`` rows apart (stt delta_y = -dy: -3 gives the upper
    cut, +2 the bottom cut), JAX's stt deltas and RRC'd PANs: the
    deltas are pinned into every run below, which remaps JAX's RRC'd PAN2
    (byte-equal to the port's, test_rrc_raw_byte_equal_to_jax)."""
    d = str(tmp_path_factory.mktemp(f"stt_parity{request.param}"))
    files = _write_pair(d, np.random.default_rng(23 + request.param),
                        request.param)
    os.mkdir(os.path.join(d, "jax"))
    js = jst.Stitcher(files["pan1"], files["pan2"], files["rrc1"],
                      files["rrc2"], out_dir=os.path.join(d, "jax"),
                      **{**KW, "fast": False})
    js.calc_stt_parameters(threshold=0.05)
    js.do_rrc()
    assert abs(js.delta_y + request.param) < 0.1, js.delta_y
    return files, js


def _prestitch(module, js, out_dir, quantized, **extra):
    os.mkdir(out_dir)
    s = module.Stitcher(js.pan1, js.pan2, out_dir=out_dir,
                        quantized_coords=quantized,
                        **{**KW, "fast": False, **extra})
    s.delta_x, s.delta_y = js.delta_x, js.delta_y
    s.rrc_file_pan2 = js.rrc_file_pan2
    n = s.pre_stitch()
    return n, _read(s.prestt_file_pan2)


@pytest.fixture
def short_sections(monkeypatch):
    """384-row sections in both packages: 1024 lines give 3 sections (the
    last one short) and, for delta_y >= 0, the rolling-buffer bottom
    cut."""
    monkeypatch.setattr(jst, "REMAP_SECTION_ROWS", 384)
    monkeypatch.setattr(st, "REMAP_SECTION_ROWS", 384)


@MODES
def test_parity_prestitch_equals_jax_with_oracle(parity_pair, short_sections,
                                                 monkeypatch, tmp_path,
                                                 quantized):
    """With the oracle in place of JAX's XLA remap, JAX's parity route
    gives the compiled reference's bytes: the port's PRESTT.RAW equals
    them, upper or bottom cut included, and so does the line count."""
    _, js = parity_pair
    n, got = _prestitch(st, js, str(tmp_path / "port"), quantized,
                        device="cpu")
    use_oracle_remap(monkeypatch)
    jn, want = _prestitch(jst, js, str(tmp_path / "jax"), quantized)
    cut = abs(int(js.delta_y)) + 1
    assert n == jn == LINES - cut
    assert got.shape == want.shape == (LINES, PPL)
    np.testing.assert_array_equal(got, want)


@MODES
@pytest.mark.parametrize("sections", ["384", "30000"])
def test_parity_prestitch_within_jax(parity_pair, monkeypatch, tmp_path,
                                     quantized, sections):
    """Against JAX's own XLA:CPU parity route, in 384-row sections and in
    one 30000-row section (the fresh tail): <= 1 DN on < 2% of pixels;
    the two coordinate modes differ."""
    _, js = parity_pair
    monkeypatch.setattr(jst, "REMAP_SECTION_ROWS", int(sections))
    monkeypatch.setattr(st, "REMAP_SECTION_ROWS", int(sections))
    n, got = _prestitch(st, js, str(tmp_path / "port"), quantized,
                        device="cpu")
    jn, want = _prestitch(jst, js, str(tmp_path / "jax"), quantized)
    assert n == jn
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())
    _, other = _prestitch(st, js, str(tmp_path / "other"), not quantized,
                          device="cpu")
    assert not np.array_equal(got, other)


@MODES
def test_cli_parity_prestitch_matches_model_api(parity_pair, monkeypatch,
                                                tmp_path, quantized):
    """``prestitch`` without ``--fast`` (at the test width), in each
    ``--coord-mode``, writes the model API's files byte for byte."""
    files, _ = parity_pair
    api, _ = _run(st, files, str(tmp_path / "api"), device="cpu", fast=False,
                  quantized_coords=quantized)
    monkeypatch.setattr(st, "Stitcher",
                        functools.partial(st.Stitcher, pixels_per_line=PPL))
    os.mkdir(tmp_path / "cli")
    rc = cli.main(["prestitch", "--pan1", files["pan1"], "--pan2",
                   files["pan2"], "--rrc1", files["rrc1"], "--rrc2",
                   files["rrc2"], "-s", "3", "-l", "256", "--stitch-overlap",
                   str(OVERLAP), "--stt-threshold", "0.05", "--out-dir",
                   str(tmp_path / "cli"), "--device", "cpu", "--coord-mode",
                   "quantized" if quantized else "continuous"])
    assert rc == 0
    for want in (api.rrc_file_pan1, api.rrc_file_pan2, api.prestt_file_pan2):
        got = tmp_path / "cli" / os.path.basename(want)
        assert got.read_bytes() == open(want, "rb").read()


def test_jax_cli_main_keeps_the_compile_cache_config(tmp_path):
    """A JAX CLI call through tests/torch_jax_cli.py leaves the worker's
    JAX compile-cache settings as they were (JAX ``cli.main`` itself turns
    the persistent cache on for the rest of the process)."""
    import jax
    from jax._src import compilation_cache

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    p = str(tmp_path / "a.RAW")
    np.zeros((4, 12288), np.uint16).tofile(p)
    assert jax_cli_main(["stitch", "--image1", p, "--image2", p, "-o",
                         str(tmp_path / "o.RAW"), "-c", "4"]) == 0
    assert (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs) == before
    assert compilation_cache._cache is None   # reset: re-read at next use
