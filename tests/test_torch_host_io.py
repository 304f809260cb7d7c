"""The port's own copies of the JAX package's host modules (constants,
output naming, the RRC CSV reader, RAW and TIFF IO, stage logging) against
the originals: equal values, equal paths, byte-equal files."""

import logging

import numpy as np
import pytest

from opticalimageprocessor_tpu import constants as jconst
from opticalimageprocessor_tpu.formats import naming as jnaming
from opticalimageprocessor_tpu.formats import rrc_csv as jrrc
from opticalimageprocessor_tpu.io import raw as jraw
from opticalimageprocessor_tpu.io import tiff as jtiff
from opticalimageprocessor_tpu.utils import logging as jlog
from opticalimageprocessor_tpu_torch import constants as tconst
from opticalimageprocessor_tpu_torch.formats import naming as tnaming
from opticalimageprocessor_tpu_torch.formats import rrc_csv as trrc
from opticalimageprocessor_tpu_torch.io import raw as traw
from opticalimageprocessor_tpu_torch.io import tiff as ttiff
from opticalimageprocessor_tpu_torch.utils import logging as tlog


def test_constants_equal_the_originals():
    names = [n for n in dir(tconst) if n.isupper()]
    assert len(names) >= 25
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


@pytest.mark.parametrize("args", [
    ("/a/b/CMOS1.PAN.RAW", ".RRC", None, None),
    ("x/CMOS2.PAN.RAW", ".PRESTT", None, "/tmp/out"),
    ("MSS.RAW", ".ALIGNED", ".TIFF", None),
    ("d/noext", ".RRC", ".RAW", "o"),
])
def test_build_output_file_path_equals_the_original(args):
    assert (tnaming.build_output_file_path(*args)
            == jnaming.build_output_file_path(*args))


def _write_csv(path, k, b, declared=None, extra=""):
    with open(path, "w") as f:
        f.write(f"1\n{declared if declared is not None else len(k)}\n0\n")
        for kk, bb in zip(k, b):
            f.write(f"{float(kk)!r} , {float(bb)!r}\n")
        f.write(extra)


def test_load_rrc_params_equals_the_original(rng, tmp_path):
    k = 0.98 + 0.04 * rng.random(64)
    b = rng.normal(0, 20, 64)
    path = tmp_path / "p.csv"
    _write_csv(path, k, b, extra="\n\n")
    got = trrc.load_rrc_params(str(path), 64)
    np.testing.assert_array_equal(got, jrrc.load_rrc_params(str(path), 64))
    np.testing.assert_array_equal(got, np.stack([k, b], axis=1))


@pytest.mark.parametrize("case", ["count", "rows", "row"])
def test_load_rrc_params_refuses_what_the_original_refuses(rng, tmp_path,
                                                            case):
    k, b = rng.random(8), rng.random(8)
    path = tmp_path / "bad.csv"
    if case == "count":
        _write_csv(path, k, b, declared=9)
    elif case == "rows":
        _write_csv(path, k[:7], b[:7], declared=8)
    else:
        _write_csv(path, k, b, extra="1.0 ; 2.0\n")
    with pytest.raises(jrrc.RRCParamError) as want:
        jrrc.load_rrc_params(str(path), 8)
    with pytest.raises(trrc.RRCParamError) as got:
        trrc.load_rrc_params(str(path), 8)
    assert str(got.value) == str(want.value)


def test_raw_strips_and_writers_equal_the_originals(rng, tmp_path):
    img = rng.integers(0, 65536, (37, 48), dtype=np.uint16)
    for mod, name in ((jraw, "j.RAW"), (traw, "t.RAW")):
        w = mod.RawStripWriter(str(tmp_path / name), 48)
        w.write_lines(img[:20])
        w.write_lines(img[20:])
        w.close()
    assert (tmp_path / "j.RAW").read_bytes() == (tmp_path / "t.RAW").read_bytes()
    strip = traw.RawStrip(str(tmp_path / "t.RAW"), 48)
    assert (strip.lines, strip.nbytes) == (37, img.nbytes)
    np.testing.assert_array_equal(strip.section(30, 20), img[30:])
    with pytest.raises(ValueError, match="negative section"):
        strip.section(-1, 2)
    with pytest.raises(ValueError, match="whole number"):
        traw.RawStrip(str(tmp_path / "t.RAW"), 50)
    mss = traw.RawStrip(str(tmp_path / "t.RAW"), 12)
    with pytest.raises(ValueError, match="4x as large"):
        traw.check_pan_mss_sizes(strip, mss)
    img[:, :12].copy().tofile(tmp_path / "m.RAW")   # a quarter of the PAN
    traw.check_pan_mss_sizes(strip,
                             traw.RawStrip(str(tmp_path / "m.RAW"), 12))
    assert traw.file_size(str(tmp_path / "t.RAW")) == img.nbytes


@pytest.mark.parametrize("samples,compression,predictor", [
    (1, "none", False),
    (4, "none", False),
    (1, "lzw", True),
    (4, "lzw", True),
])
def test_tiff_writers_equal_the_originals(rng, tmp_path, samples, compression,
                                          predictor):
    """Streaming writer and ``write_tiff``: byte-equal files; the port's
    readers return the raster and the original's header fields."""
    shape = (70, 33) if samples == 1 else (70, 33, samples)
    img = rng.integers(0, 4096, shape, dtype=np.uint16)
    for mod, name in ((jtiff, "j.TIFF"), (ttiff, "t.TIFF")):
        w = mod.TiffStripWriter(str(tmp_path / name), 33, 70, samples,
                                rows_per_strip=16, compression=compression,
                                predictor=predictor)
        w.write_rows(img[:25])
        w.write_rows(img[25:])
        w.close()
        mod.write_tiff(str(tmp_path / f"w{name}"), img,
                       compression=compression, predictor=predictor)
    for pre in ("", "w"):
        want = (tmp_path / f"{pre}j.TIFF").read_bytes()
        assert (tmp_path / f"{pre}t.TIFF").read_bytes() == want
    path = str(tmp_path / "t.TIFF")
    got, ref = ttiff.read_tiff_info(path), jtiff.read_tiff_info(path)
    for field in ("width", "height", "samples", "bits", "compression",
                  "predictor", "rows_per_strip", "bigtiff", "extrasamples"):
        assert getattr(got, field) == getattr(ref, field), field
    np.testing.assert_array_equal(got.strip_offsets, ref.strip_offsets)
    np.testing.assert_array_equal(ttiff.read_tiff(path), img)
    rows = list(ttiff.iter_tiff_rows(path, 30))
    assert [r.shape[0] for r in rows] == [30, 30, 10]
    np.testing.assert_array_equal(np.concatenate(rows).reshape(img.shape),
                                  img)


@pytest.mark.parametrize("samples", [1, 4])
def test_offset_drain_tiff_helpers_equal_the_originals(rng, tmp_path,
                                                       samples):
    """The drains' TIFF helpers: ``tiff_data_start`` (classic and BigTIFF
    sizes), ``encode_lzw_strip`` (with and without the predictor) and
    ``assemble_tiff_from_strips`` (the file from encoded strips) give the
    originals' values and bytes."""
    for w, h in ((33, 70), (12288, 65536), (3072, 131072)):
        assert ttiff.tiff_data_start(w, h, samples) == \
            jtiff.tiff_data_start(w, h, samples)
    img = rng.integers(0, 4096, (70, 33, samples), dtype=np.uint16)
    strips = [img[a:a + 16] for a in range(0, 70, 16)]
    for predictor in (True, False):
        blobs = [ttiff.encode_lzw_strip(s, predictor) for s in strips]
        assert blobs == [jtiff.encode_lzw_strip(s, predictor)
                         for s in strips]
        for mod, name in ((jtiff, "j.TIFF"), (ttiff, "t.TIFF")):
            mod.assemble_tiff_from_strips(
                str(tmp_path / name), 33, 70, samples, iter(blobs),
                rows_per_strip=16, predictor=predictor)
        assert (tmp_path / "t.TIFF").read_bytes() == \
            (tmp_path / "j.TIFF").read_bytes()
        np.testing.assert_array_equal(
            ttiff.read_tiff(str(tmp_path / "t.TIFF")).reshape(img.shape),
            img)


def test_stage_logs_the_original_lines():
    """``stage`` logs the reference's ``[name] <bytes> bytes in <s> seconds
    (<MBps> MBps).`` line and accumulates the same report fields."""
    records = []
    h = logging.Handler()
    h.emit = lambda r: records.append(r.getMessage())
    tlog.LOG.addHandler(h)
    try:
        tlog.reset_stage_report()
        with tlog.stage("port_stage", 1 << 20):
            pass
        with tlog.stage("port_stage_nobytes"):
            pass
    finally:
        tlog.LOG.removeHandler(h)
    assert tlog.LOG is jlog.LOG
    assert records[0].startswith("[port_stage] 1,048,576 bytes in ")
    assert records[0].endswith(" MBps).")
    assert records[1].startswith("[port_stage_nobytes] done in ")
    rep = tlog.stage_report()
    assert rep["port_stage"]["calls"] == 1
    assert rep["port_stage"]["bytes"] == 1 << 20
    assert set(rep["port_stage"]) == {"seconds", "bytes", "calls", "MBps"}
    assert tlog.comma_sep(1234567) == jlog.comma_sep(1234567)
    assert tlog.comma_sep(1234.5) == jlog.comma_sep(1234.5)
