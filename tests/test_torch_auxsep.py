"""Port downlink separation (formats/crc16, formats/aos, formats/naming,
utils/native, models/auxsep, cli auxsep) against the JAX package's copies
on the same inputs: the golden downlinks, synthetic downlinks with chunk
seams, junk, empty, invalid and corrupt frames, zero-filled frames, an
``-O`` restart and JPEG2000 frames, byte for byte."""

import gzip
import hashlib
import json
import os
import re
import sys

import numpy as np
import pytest

from opticalimageprocessor_tpu import cli as jcli
from opticalimageprocessor_tpu.formats import aos as jaos
from opticalimageprocessor_tpu.formats import crc16 as jcrc
from opticalimageprocessor_tpu.formats import naming as jnaming
from opticalimageprocessor_tpu.models import auxsep as jauxsep
from opticalimageprocessor_tpu.utils import native as jnative
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.formats import aos
from opticalimageprocessor_tpu_torch.formats import crc16
from opticalimageprocessor_tpu_torch.formats import naming
from opticalimageprocessor_tpu_torch.models import auxsep
from opticalimageprocessor_tpu_torch.utils import native

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NAME = "KASHI_TJ3-01_20220817_031259_1.dat"
W = 12288
OUTS = ("imdt", "pan", "mss", "aux")


def _rows(data: np.ndarray, width: int) -> np.ndarray:
    """``data`` zero-padded to whole rows of ``width`` bytes."""
    n = -(-data.size // width)
    out = np.zeros(n * width, np.uint8)
    out[:data.size] = data
    return out.reshape(n, width)


def _frame(imdt: bytes, rng=None, chid=aos.IMTR_CHID_CMOS1) -> bytes:
    """An IMDT byte stream framed into IMTR and AOS frames by the port's
    vectorised builders.  With ``rng``: leading junk, and between valid
    frames an empty frame, a valid frame flagged invalid after its CRC was
    computed (injection 0xAAAAAAAA), one with an unknown injection flag, and
    a CRC-corrupted duplicate -- none of which may add or lose data."""
    imtr = aos.build_imtr_stream(
        _rows(np.frombuffer(imdt, np.uint8), aos.IMTR_IMGDATA_BYTES),
        chid=chid)
    frames = aos.build_aos_stream(_rows(imtr.reshape(-1), aos.AOS_DATA_BYTES))
    if rng is None:
        return frames.tobytes()
    inj = slice(aos.AOS_VCDUINJ_OFF, aos.AOS_VCDUINJ_OFF + 4)
    flagged, unknown, corrupt = frames[1].copy(), frames[2].copy(), \
        frames[3].copy()
    flagged[inj] = 0xAA
    unknown[inj] = (0x12, 0x34, 0x56, 0x78)
    corrupt[aos.AOS_CRC_OFF] ^= 0xFF
    empty = np.frombuffer(aos.build_empty_aos_frame(), np.uint8)
    parts, prev = [b"JUNKHEADER", rng.integers(0, 256, 57, np.uint8)], 0
    for at, extra in ((5, empty), (49, flagged), (50, unknown),
                      (frames.shape[0] // 2, corrupt)):
        parts += [frames[prev:at], extra]
        prev = at
    parts += [frames[prev:], empty]
    return b"".join(np.asarray(p).tobytes() if not isinstance(p, bytes)
                    else p for p in parts)


def _image_frames(rng, n, seqs=None, compress=None):
    """``n`` random image frames (PAN, MSS, AUX) and their IMDT bytes."""
    pan = rng.integers(0, 65536, (1024 * n, W), dtype=np.uint16)
    mss = rng.integers(0, 65536, (256 * n, W), dtype=np.uint16)
    aux = rng.integers(0, 256, (n, aos.IMGSIG_AUX_ALLBYTES), dtype=np.uint8)
    imdt = b"".join(
        aos.build_image_frame(pan[i * 1024:(i + 1) * 1024],
                              mss[i * 256:(i + 1) * 256],
                              seq=(seqs or range(1, n + 1))[i],
                              aux=aux[i].tobytes(), compress=compress)
        for i in range(n))
    return pan, mss, aux, imdt


@pytest.fixture(scope="module")
def downlink(tmp_path_factory):
    """Two image frames framed into a downlink with every kind of extra
    frame (:func:`_frame`)."""
    rng = np.random.default_rng(91)
    pan, mss, aux, imdt = _image_frames(rng, 2)
    path = tmp_path_factory.mktemp("dl") / NAME
    path.write_bytes(_frame(imdt, rng))
    return dict(path=str(path), pan=pan, mss=mss, aux=aux, imdt=imdt)


def _separate(module, path, out_dir, **kw):
    """``module.AuxSeparator(path).separate()`` into ``out_dir``: -> the
    four outputs' bytes by name."""
    os.makedirs(out_dir, exist_ok=True)
    sep = module.AuxSeparator(str(path), out_dir=str(out_dir), **kw)
    outs = dict(sep.separate(), imdt=sep.imdt_file)
    return {k: open(outs[k], "rb").read() for k in OUTS}, sep


def _both(path, tmp_path, **kw):
    """The port's and JAX's separations of ``path``; asserts they are
    byte-identical, file names included."""
    got, psep = _separate(auxsep, path, tmp_path / "port", **kw)
    want, jsep = _separate(jauxsep, path, tmp_path / "jax", **kw)
    assert os.path.basename(psep.imdt_file) == os.path.basename(jsep.imdt_file)
    for k in OUTS:
        assert got[k] == want[k], k
    return got, psep


# -- the copies of the format modules ---------------------------------------

def test_crc16_check_value_and_batch(rng):
    assert crc16.crc16_ccitt_false(b"123456789") == 0x29B1
    assert jcrc.crc16_ccitt_false(b"123456789") == 0x29B1
    frames = rng.integers(0, 256, (64, 890), dtype=np.uint8)
    got = crc16.crc16_ccitt_false_many(frames)
    np.testing.assert_array_equal(got, jcrc.crc16_ccitt_false_many(frames))
    assert [crc16.crc16_ccitt_false(f) for f in frames[:4]] == \
        got[:4].tolist()


def _small_aos_stream(rng, n=40):
    """tests/test_io_native.py's stream: junk, valid / CRC-corrupt / empty
    frames, junk between some, a sync marker truncated at the end."""
    parts = [rng.integers(0, 256, 57, dtype=np.uint8).tobytes()]
    for i in range(n):
        data = rng.integers(0, 256, aos.AOS_DATA_BYTES, dtype=np.uint8)
        frame = bytearray(aos.build_aos_frame(bytes(data), vcdu_seq=i))
        if i % 5 == 3:
            frame[aos.AOS_CRC_OFF] ^= 0xFF
        elif i % 5 == 4:
            frame[aos.AOS_VCID_OFF] |= aos.AOS_VCID_EMPTY
            frame[aos.AOS_VCDUINJ_OFF:aos.AOS_VCDUINJ_OFF + 4] = \
                aos.AOS_VCDUINJ_INVAL.to_bytes(4, "big")
        parts.append(bytes(frame))
        if i % 7 == 0:
            parts.append(rng.integers(0, 256, 11, dtype=np.uint8).tobytes())
    parts.append(aos.SYNC_BYTES + b"\x00" * 100)
    return np.frombuffer(b"".join(parts), np.uint8)


def test_aos_scan_matches_jax(rng):
    buf = _small_aos_stream(rng)
    got, want = aos.scan_aos_frames(buf), jaos.scan_aos_frames(buf)
    for field in ("valid", "empty", "invalid"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.cursor == want.cursor
    assert (got.valid.size, got.empty.size, got.invalid.size) == (24, 8, 8)
    np.testing.assert_array_equal(aos.extract_aos_payloads(buf, got.valid),
                                  jaos.extract_aos_payloads(buf, want.valid))


def test_imtr_parse_matches_jax(rng):
    """The IMTR cut of a stream with a CRC-corrupt frame (a sequence gap)
    and a channel-2 id, seeded with ``last_seq``: every field."""
    payloads = rng.integers(0, 256, (12, aos.IMTR_IMGDATA_BYTES),
                            dtype=np.uint8)
    frames = aos.build_imtr_stream(payloads, start_seq=8,
                                   chid=aos.IMTR_CHID_CMOS2)
    np.testing.assert_array_equal(frames, jaos.build_imtr_stream(
        payloads, start_seq=8, chid=jaos.IMTR_CHID_CMOS2))
    frames[4, aos.IMTR_CRC_OFF] ^= 0x5A
    stream = np.concatenate([frames.reshape(-1), np.zeros(100, np.uint8)])
    got, want = aos.parse_imtr_stream(stream, 5), \
        jaos.parse_imtr_stream(stream, 5)
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(got.seq, want.seq)
    for field in ("chid", "n_frames", "n_invalid", "missing_ranges"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.missing_ranges == [(6, 7), (12, 12)]
    assert got.chid == aos.IMTR_CHID_CMOS2 and got.n_invalid == 1


def test_image_frame_meta_and_z_header_match_jax(rng):
    pan = rng.integers(0, 65536, (1024, W), dtype=np.uint16)
    mss = rng.integers(0, 65536, (256, W), dtype=np.uint16)
    buf = np.frombuffer(b"\x00" * 33 + aos.build_image_frame(
        pan, mss, seq=517, file_id=7), np.uint8)
    sig = int(aos.find_signatures(buf, aos.IMGSIG_SIG)[-1])
    got, want = aos.parse_image_frame_meta(buf, sig), \
        jaos.parse_image_frame_meta(buf, sig)
    for field in ("camera", "master_or_backup", "z_ratio", "file_id", "seq",
                  "image_dwords", "start", "sig_off", "frame_end"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.sub_image_dwords, want.sub_image_dwords)
    assert (got.seq, got.file_id, got.start) == (517, 7, 33)
    hdr = np.zeros(aos.Z_ZDATA_OFF, np.uint8)
    hdr[:4] = np.frombuffer(aos.Z_ODD_FRAME.to_bytes(4, "little"), np.uint8)
    hdr[aos.Z_IMGIDX_OFF + 3] = 5
    hdr[aos.Z_ZFORMAT_OFF] = aos.Z_ZFORMAT_JP2
    hdr[aos.Z_HDRVER_OFF] = aos.Z_HDRVER_VALUE
    hdr[aos.Z_DATADWORDS_OFF + 2] = 1
    assert vars(aos.parse_z_image_header(hdr)) == \
        vars(jaos.parse_z_image_header(hdr))
    hdr[aos.Z_HDRVER_OFF] = 3
    with pytest.raises(ValueError) as e_port:
        aos.parse_z_image_header(hdr)
    with pytest.raises(ValueError) as e_jax:
        jaos.parse_z_image_header(hdr)
    assert str(e_port.value) == str(e_jax.value)


@pytest.mark.parametrize("name,matches", [
    (NAME, True), ("MYST_SAT-9_19991231_235959_22.dat", True),
    ("A__B_20200101_000000_2", True),
    ("KASHI_TJ3-01_2022081_031259_1.dat", False), ("noname.dat", False),
])
def test_naming_matches_jax(name, matches):
    got, want = naming.parse_aos_file_info(name), \
        jnaming.parse_aos_file_info(name)
    assert (got is not None) == (want is not None) == matches
    if got is not None:
        assert vars(got) == vars(want)
        for cmos1 in (True, False):
            assert naming.imdt_file_name(got, cmos1) == \
                jnaming.imdt_file_name(want, cmos1)


@pytest.mark.parametrize("entry", ["crc16_many", "find_signatures",
                                   "gather_blocks", "byteswap16",
                                   "scan_aos"])
def test_native_entry_points_match_jax_and_numpy(entry, rng, monkeypatch):
    """Each native entry point of the port equals JAX's and the port's own
    numpy route (the library forced off)."""
    buf = _small_aos_stream(rng)
    offs = np.array([0, 100, 2000, 5001], np.int64)
    words = rng.integers(0, 65536, 1001, dtype=np.uint16)

    def call(mod):
        if entry == "crc16_many":
            return mod.crc16_many(buf, offs, 890)
        if entry == "find_signatures":
            return mod.find_signatures(buf, aos.SYNC_BYTES)
        if entry == "gather_blocks":
            return mod.gather_blocks(buf, offs, 880)
        if entry == "byteswap16":
            return mod.byteswap16(words.copy())
        res = mod.scan_aos(buf)
        if res is None:         # numpy route: what auxsep takes instead
            scan = aos.scan_aos_frames(buf)
            return (aos.extract_aos_payloads(buf, scan.valid),
                    scan.valid.size, scan.empty.size, scan.invalid.size,
                    scan.cursor)
        return (res[0].copy(), *res[1:])

    def same(a, b):
        if isinstance(a, tuple):
            assert len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)
        return True

    got, want = call(native), call(jnative)
    same(got, want)
    monkeypatch.setattr(native, "_load", lambda: None)
    same(got, call(native))
    if entry == "byteswap16":
        np.testing.assert_array_equal(got, words.byteswap())


# -- AuxSeparator -----------------------------------------------------------

def test_golden_downlink_matches_expected_and_jax(tmp_path):
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        expected = json.load(f)
    dat = tmp_path / NAME
    with gzip.open(os.path.join(GOLDEN, "golden.dat.gz")) as f:
        dat.write_bytes(f.read())
    got, sep = _both(dat, tmp_path)
    for k in OUTS:
        assert hashlib.sha256(got[k]).hexdigest() == expected[f"{k}_sha"], k


@pytest.mark.parametrize("backend", ["cv2", "pil"])
def test_golden_jp2_downlink_matches_expected_and_jax(tmp_path, backend,
                                                      monkeypatch):
    pytest.importorskip("cv2" if backend == "cv2" else "PIL")
    if backend == "pil":
        from PIL import features

        if not features.check("jpg_2000"):
            pytest.skip("Pillow built without OpenJPEG")
    monkeypatch.setenv("OIP_JP2_BACKEND", backend)
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        expected = json.load(f)
    dat = tmp_path / NAME
    with gzip.open(os.path.join(GOLDEN, "golden_jp2.dat.gz")) as f:
        dat.write_bytes(f.read())
    got, _ = _both(dat, tmp_path)
    for k in ("pan", "mss", "aux"):
        assert hashlib.sha256(got[k]).hexdigest() == expected[f"{k}_sha"], k


@pytest.mark.parametrize("chunk", [0, 50_000])
def test_roundtrip_matches_jax_and_the_framed_data(downlink, tmp_path,
                                                   chunk):
    """chunk 50000 splits a frame and the IMTR remainder at every seam."""
    got, sep = _both(downlink["path"], tmp_path, chunk_bytes=chunk)
    assert os.path.basename(sep.imdt_file) == \
        "KASHI_TJ3-01_CMOS-1_20220817_031259.IMDT"
    imdt = downlink["imdt"]
    pad = -len(imdt) % aos.IMTR_IMGDATA_BYTES
    assert got["imdt"] == imdt + bytes(pad)
    assert got["pan"] == downlink["pan"].astype("<u2").tobytes()
    assert got["mss"] == downlink["mss"].astype("<u2").tobytes()
    assert got["aux"] == downlink["aux"].tobytes()


def test_native_library_off_gives_the_same_outputs(downlink, tmp_path,
                                                   monkeypatch):
    """The port's numpy routes (no native library) separate the downlink
    into the same bytes as JAX's native routes, across chunk seams (1 MB
    chunks: the numpy CRC loops over a frame's bytes once a chunk)."""
    want, _ = _separate(jauxsep, downlink["path"], tmp_path / "jax",
                        chunk_bytes=1_000_003)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.scan_aos(np.zeros(2048, np.uint8)) is None
    got, _ = _separate(auxsep, downlink["path"], tmp_path / "port",
                       chunk_bytes=1_000_003)
    assert got == want


def test_zero_fill_of_a_missing_frame(tmp_path):
    """An IMDT input with frames 1 and 3: frame 2 is zero-filled."""
    pan, mss, aux, imdt = _image_frames(np.random.default_rng(5), 2,
                                        seqs=[1, 3])
    p = tmp_path / "x.IMDT"
    p.write_bytes(imdt)
    got, sep = _both(p, tmp_path)
    assert sep.imdt_file == str(p) and got["imdt"] == imdt
    rows = np.frombuffer(got["pan"], "<u2").reshape(-1, W)
    assert rows.shape[0] == 3 * 1024 and not rows[1024:2048].any()
    np.testing.assert_array_equal(rows[2048:], pan[1024:])
    assert got["aux"] == aux[0].tobytes() + bytes(aux.shape[1]) + \
        aux[1].tobytes()


def test_imdt_input_equals_the_downlink(downlink, tmp_path):
    """The IMDT a downlink separated into, fed back as the input (the
    reference's restart from the intermediate file), gives the same
    rasters."""
    p = tmp_path / "KASHI_TJ3-01_CMOS-1_20220817_031259.IMDT"
    p.write_bytes(downlink["imdt"])
    got, _ = _both(p, tmp_path)
    assert got["pan"] == downlink["pan"].astype("<u2").tobytes()
    assert got["mss"] == downlink["mss"].astype("<u2").tobytes()


def test_offset_restart_matches_jax(tmp_path):
    """``-O`` (tests/test_pipeline_e2e.py:665-705): a restart at an
    unaligned offset rounds down to the page, where the 880-byte AOS
    payloads realign with the 882-byte IMTR frames (every 441 AOS frames);
    frame 1 is then incomplete and zero-filled, frame 2 intact."""
    pan, _, _, imdt = _image_frames(np.random.default_rng(8), 2)
    p = tmp_path / NAME
    p.write_bytes(_frame(imdt))
    off = 1764 * aos.AOS_FRAME_BYTES + 123
    got, sep = _both(p, tmp_path, offset=off)
    assert sep.offset == 1764 * aos.AOS_FRAME_BYTES and sep.offset % 4096 == 0
    rows = np.frombuffer(got["pan"], "<u2").reshape(-1, W)
    assert rows.shape[0] == 2048 and not rows[:1024].any()
    np.testing.assert_array_equal(rows[1024:], pan[1024:])


def test_jpeg2000_frame_matches_jax(tmp_path):
    """A JPEG2000-compressed frame (lossless tiles in Z headers) decodes to
    the framed rasters in both packages."""
    pytest.importorskip("cv2")
    pan, mss, _, imdt = _image_frames(np.random.default_rng(9), 1,
                                      compress="jp2")
    p = tmp_path / "z.IMDT"
    p.write_bytes(imdt)
    got, _ = _both(p, tmp_path)
    assert got["pan"] == pan.astype("<u2").tobytes()
    assert got["mss"] == mss.astype("<u2").tobytes()


@pytest.mark.parametrize("case", ["unknown", "cv2_missing", "pil_undecodable",
                                  "neither", "cv2_undecodable"])
def test_jp2_backend_errors_match_jax(case, monkeypatch):
    backend = {"unknown": "jp3", "cv2_missing": "cv2",
               "pil_undecodable": "pil"}.get(case, "")
    monkeypatch.setenv("OIP_JP2_BACKEND", backend)
    if case in ("cv2_missing", "neither"):
        monkeypatch.setitem(sys.modules, "cv2", None)
    if case == "neither":
        monkeypatch.setitem(sys.modules, "PIL", None)
    if case == "cv2_undecodable":
        pytest.importorskip("cv2")
    if case == "pil_undecodable":
        pytest.importorskip("PIL")
    msgs = []
    for mod in (auxsep, jauxsep):
        with pytest.raises((RuntimeError, ValueError)) as e:
            mod._decode_jp2(b"\x00\x00\x00\x0cjP  garbage")
        # an object's address differs between the two calls
        msgs.append((type(e.value), re.sub(r"0x[0-9a-f]+", "0x",
                                           str(e.value))))
    assert msgs[0] == msgs[1]
    if case == "neither":
        assert msgs[0][1].startswith(
            "JPEG2000 sub-image decoding needs OpenCV (cv2) or Pillow with "
            "OpenJPEG")


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("extra,rc", [([], 0), (["-O", "8192"], 2)],
                         ids=["whole", "offset"])
def test_cli_auxsep_matches_jax(downlink, tmp_path, extra, rc):
    """The same files and exit code as the JAX CLI: the whole downlink, and
    a restart at AOS frame 8, where the 880-byte payloads never realign
    with the 882-byte IMTR frames (no valid IMTR frame: rc 2)."""
    outs = {}
    for mod, d in ((cli, "port"), (jcli, "jax")):
        (tmp_path / d).mkdir()
        assert mod.main(["auxsep", *extra, downlink["path"], "--out-dir",
                         str(tmp_path / d)]) == rc
        outs[d] = {f: (tmp_path / d / f).read_bytes()
                   for f in sorted(os.listdir(tmp_path / d))}
    assert list(outs["port"]) == ([
        "KASHI_TJ3-01_CMOS-1_20220817_031259" + s
        for s in (".AUX", ".IMDT", ".MSS.RAW", ".PAN.RAW")] if rc == 0
        else [])
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("case,rc", [("missing_file", 254),
                                     ("unrecognized_name", 2)])
def test_cli_auxsep_exit_codes_match_jax(tmp_path, case, rc):
    p = tmp_path / "a.RAW"
    if case == "unrecognized_name":
        p.write_bytes(bytes(4096))
    argv = ["auxsep", str(p), "--out-dir", str(tmp_path)]
    assert cli.main(argv) == jcli.main(argv) == rc
