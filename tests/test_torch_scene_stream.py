"""Port streamed scene (models/scene_stream) against the port's resident
scene, byte for byte, and against the JAX package's run_scene_streamed on
the same RAW files and RRC CSVs; the section streaming of io/streaming on
the CPU."""

import os

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.io import tiff as jtiff
from opticalimageprocessor_tpu.models import scene as jscene
from opticalimageprocessor_tpu.models import scene_stream as jstream
from opticalimageprocessor_tpu.ops import phasecorr as jphasecorr
from opticalimageprocessor_tpu.ops import phasecorr_pallas as jpallas
from opticalimageprocessor_tpu.parallel import sharded_scene as jsharded_scene
from opticalimageprocessor_tpu_torch.constants import (
    IBCV_DEF_THRESHOLD,
    STT_DEF_PHCTHRHLD,
)
from opticalimageprocessor_tpu_torch.io.raw import RawStrip
from opticalimageprocessor_tpu_torch.io.streaming import (
    HostDeviceCopies,
    SectionStreamer,
    stream_process,
    window,
)
from opticalimageprocessor_tpu_torch.models import scene, scene_stream
from opticalimageprocessor_tpu_torch.models.device_pipeline import MssAlign
from test_torch_scene import FOLD, KW, LINES, PIX, _curve, _write_scene

torch.set_num_threads(2)

SECTION = 384        # 2048 lines: 5 whole sections and one of 128 lines
KEYS = ("aligned", "stitched", "aligned2", "stitched_mss")


def _args(files, mss2):
    rrc = lambda p: tuple(files[f"rrc_{p}{b}"] for b in range(1, 5))  # noqa
    kw = dict(rrc_mss_files=rrc("msb"), **KW)
    if mss2:
        kw.update(mss2_file=files["mss2"], rrc_mss2_files=rrc("m2b"))
    return (files["pan1"], files["pan2"], files["mss"], files["rrc_pan1"],
            files["rrc_pan2"]), kw


def _pipeline(args, kw):
    """The ScenePipeline that run_scene builds for these arguments."""
    return scene.scene_pipeline(
        *args[3:], kw["rrc_mss_files"], PIX, KW["slices"], None, FOLD,
        KW["stt_sections"], IBCV_DEF_THRESHOLD, STT_DEF_PHCTHRHLD, 0.0,
        return_prestt=True)


def _run(fn, files, out_dir, mss2, captured, module, **extra):
    os.mkdir(out_dir)

    def capture(params, n_valid, n_stt):
        captured.update(params=params, n_stt=int(n_stt))

    def capture2(cx, cy, n_valid):
        captured.update(params2=(np.asarray(cx), np.asarray(cy)))

    args, kw = _args(files, mss2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "log_scene_params", capture)
        mp.setattr(module, "log_band_coeffs", capture2)
        return fn(*args, out_dir=out_dir,
                  out_stitched=os.path.join(out_dir, "STITCHED.RAW"),
                  **kw, **extra)


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("stream"))
    files, params, arrays = _write_scene(d, np.random.default_rng(77), LINES,
                                         PIX, dy=2)
    # the band RRC moves 0 (RRC(0) = trunc(b) != 0): beyond-strip rows must
    # read 0 after the RRC, which clipped halos give and zero-filled ones
    # would not
    assert any(np.trunc(params[f"msb{b}"][1]).any() for b in range(1, 5))
    return d, files, params


@pytest.fixture(scope="module")
def runs(scene_files):
    d, files, _ = scene_files
    out = {}
    for mss2 in (False, True):
        for name, module, fn, extra in (
            ("resident", scene, scene.run_scene, {}),
            ("stream", scene_stream, scene_stream.run_scene_streamed,
             dict(section_rows=SECTION)),
        ):
            cap = {}
            cap["paths"] = _run(fn, files, os.path.join(d, f"{name}{mss2}"),
                                mss2, cap, module, device="cpu", **extra)
            out[name, mss2] = cap
    return out


@pytest.mark.parametrize("mss2", [False, True])
def test_stream_equals_resident_byte_for_byte(runs, mss2):
    """Every output of the streamed route is the resident route's file, byte
    for byte, across a partial last section and at both strip ends."""
    res, st = runs["resident", mss2], runs["stream", mss2]
    keys = KEYS if mss2 else KEYS[:2]
    assert set(st["paths"]) == set(keys) | ({"prestt"} if mss2 else set())
    for key in keys:
        with open(res["paths"][key], "rb") as a, \
                open(st["paths"][key], "rb") as b:
            assert a.read() == b.read(), key


def test_stream_prestt_equals_resident_prestt(scene_files, runs):
    """The streamed PRESTT.RAW is ScenePipeline(return_prestt=True)'s
    prestitched PAN2 at the same estimates."""
    _, files, _ = scene_files
    args, kw = _args(files, True)
    pipe = _pipeline(args, kw)
    strips = [RawStrip(files[n], PIX) for n in ("pan1", "pan2", "mss")]
    pan1, pan2 = (torch.from_numpy(np.array(s._mm)) for s in strips[:2])
    mss = scene.load_bands(strips[2], "cpu")
    cx, cy, _, raw_dx, raw_dy, _ = pipe.estimate(pan1, pan2, mss)
    _, _, prestt = pipe.transform(pan1, pan2, mss, cx, cy, raw_dx, raw_dy)
    got = np.fromfile(runs["stream", True]["paths"]["prestt"], "<u2")
    np.testing.assert_array_equal(got.reshape(LINES, PIX), prestt.numpy())


def test_estimate_streamed_is_bit_identical(scene_files):
    """Phase 1 from the strip files equals ScenePipeline.estimate on the
    resident strips bit for bit, and MSS2's streamed registration equals
    MssAlign's."""
    _, files, _ = scene_files
    args, kw = _args(files, True)
    pipe = _pipeline(args, kw)
    strips = [RawStrip(files[n], PIX) for n in ("pan1", "pan2", "mss")]
    got = scene_stream.estimate_streamed(pipe, *strips, "cpu")
    pan1, pan2 = (torch.from_numpy(np.array(s._mm)) for s in strips[:2])
    mss = scene.load_bands(strips[2], "cpu")
    want = pipe.estimate(pan1, pan2, mss)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)

    # MSS2 against the prestitched PAN2 written to a file; the streamed
    # band tiles are RRC'd as they are cut, MssAlign RRCs the whole bands
    _, _, prestt = pipe.transform(pan1, pan2, mss, *want[:2], *want[3:5])
    pan_c = os.path.join(os.path.dirname(files["pan1"]), "PANC.RAW")
    prestt.numpy().tofile(pan_c)
    align = MssAlign(scene.load_band_rrc(kw["rrc_mss2_files"], PIX // 4),
                     slices=KW["slices"])
    ms2 = RawStrip(files["mss2"], PIX)
    cx, cy, n_valid = scene_stream.estimate_mss2_streamed(
        align, RawStrip(pan_c, PIX), ms2, "cpu")
    _, n_want, (cx_w, cy_w) = align(prestt, scene.load_bands(ms2, "cpu"))
    assert (n_valid == 8).all() and torch.equal(n_valid, n_want)
    assert torch.equal(cx, cx_w) and torch.equal(cy, cy_w)


_FUSED_TRACES = []


def _fused_peak_tile(p, bs, pad, brows, use_fused, win):
    """JAX's streamed registration tile as it runs on the TPU: the fused
    Pallas cross-power (bf16 GEMM operands, float32 sums), in interpret
    mode -- the contract of the port's kernel (b); on the CPU JAX would
    take its float32 path (``use_fused`` False)."""
    import jax.numpy as jnp

    _FUSED_TRACES.append(pad)
    far, fai = jphasecorr.rfft2_padded(p.astype(jnp.float32), pad, True)
    fbr4, fbi4 = jphasecorr.band_full_spectrum_small(bs)
    return jpallas.windowed_crosspower_fused_bands(
        far, fai, fbr4, fbi4, pad, brows, win[0], win[1], interpret=True)


@pytest.fixture(scope="module")
def jax_stream(scene_files, runs):
    d, files, _ = scene_files
    cap = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharded_scene, "_windowed_peak_tile", _fused_peak_tile)
        cap["paths"] = _run(jstream.run_scene_streamed, files,
                            os.path.join(d, "jax"), True, cap, jscene,
                            section_rows=SECTION)
    assert _FUSED_TRACES
    return cap


def test_stream_matches_jax_stream(runs, jax_stream):
    """The port's stream against JAX's run_scene_streamed on the same
    files, its registration on the fused route: estimates within 1e-3 px,
    the estimate-dependent rasters within a mean of 0.05 DN, the stitched
    left half (no estimate) exact."""
    j, p = jax_stream, runs["stream", True]
    assert p["n_stt"] == j["n_stt"]
    for key in ("params", "params2"):
        for k in (0, 1):
            for b in range(4):
                d = np.abs(_curve(p[key][k][b]) - _curve(j[key][k][b]))
                assert d.max() <= 1e-3, (key, k, b, d.max())
    for k in (4, 5):                      # raw stt dx, dy
        assert abs(float(p["params"][k]) - float(j["params"][k])) <= 1e-3
    left = PIX - FOLD // 2
    st = {n: np.fromfile(r["paths"]["stitched"], "<u2").reshape(LINES, -1)
          for n, r in (("jax", j), ("port", p))}
    np.testing.assert_array_equal(st["port"][:, :left], st["jax"][:, :left])
    d = np.abs(st["port"][:, left:].astype(np.int32)
               - st["jax"][:, left:].astype(np.int32))
    assert d.mean() < 0.05, d.mean()
    for key in ("aligned", "aligned2", "stitched_mss"):
        a = jtiff.read_tiff(p["paths"][key]).astype(np.int32)
        b = jtiff.read_tiff(j["paths"][key]).astype(np.int32)
        assert a.shape == b.shape, key
        assert np.abs(a - b).mean() < 0.05, (key, np.abs(a - b).mean())
    pj = np.fromfile(j["paths"]["prestt"], "<u2").astype(np.int32)
    pp = np.fromfile(p["paths"]["prestt"], "<u2").astype(np.int32)
    assert np.abs(pp - pj).mean() < 0.05


def test_section_rows_must_be_a_multiple_of_4(scene_files):
    _, files, _ = scene_files
    args, kw = _args(files, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        scene_stream.run_scene_streamed(*args, section_rows=130,
                                        device="cpu", **kw)


@pytest.mark.parametrize("lines, count, halo, want", [
    (100, 40, 3, [(0, 43, 0, 3), (37, 83, 3, 3), (77, 100, 3, 0)]),
    (100, 50, 0, [(0, 50, 0, 0), (50, 100, 0, 0)]),
    (10, 16, 8, [(0, 10, 0, 0)]),
])
def test_window_clips_the_halo_at_the_strip_ends(lines, count, halo, want):
    got = []
    for off in range(0, lines, count):
        got.append(window(lines, off, min(count, lines - off), halo))
    assert got == want


@pytest.mark.parametrize("section_lines, halo", [(40, 3), (7, 0), (200, 5)])
def test_section_streamer_yields_the_strip_in_order(rng, tmp_path,
                                                    section_lines, halo):
    """On the CPU (no copy streams) the restructured streamer still yields
    every section in line order with its clipped halo rows, as writable
    copies, and stream_process writes the payloads in order."""
    img = rng.integers(0, 65536, (103, 16), dtype=np.uint16)
    img.tofile(tmp_path / "s.RAW")
    strip = RawStrip(str(tmp_path / "s.RAW"), 16)
    secs = list(SectionStreamer(strip, section_lines, "cpu", halo))
    assert [s.index for s in secs] == list(range(len(secs)))
    assert len(secs) == -(-103 // section_lines)
    for s in secs:
        np.testing.assert_array_equal(
            s.data.numpy(),
            img[s.line_offset - s.halo_top:
                s.line_offset + s.lines + s.halo_bottom])
        s.data[0, 0] = 1          # a copy, not the read-only memory map
    out = []

    def fn(s):
        payload = s.data[s.halo_top:s.halo_top + s.lines].to(torch.int32)
        return (payload ^ 0x5A5A).to(torch.uint16)

    n = stream_process(strip, fn, out.append, section_lines, "cpu", halo)
    assert n == 103
    np.testing.assert_array_equal(np.concatenate(out), img ^ 0x5A5A)


def test_host_device_copies_on_the_cpu(rng):
    """Uploads are copies (strided views included); downloads hand back
    the tensors' data."""
    copies = HostDeviceCopies("cpu")
    a = rng.integers(0, 65536, (6, 4, 8), dtype=np.uint16)
    got = copies.upload([a[:, 1], a.transpose(1, 0, 2)]).get()
    np.testing.assert_array_equal(got[0].numpy(), a[:, 1])
    np.testing.assert_array_equal(got[1].numpy(), a.transpose(1, 0, 2))
    before = int(a[0, 1, 0])
    got[0][0, 0] = before ^ 1
    assert a[0, 1, 0] == before
    back = copies.download([got[1][1:3]]).wait()
    np.testing.assert_array_equal(back[0], a.transpose(1, 0, 2)[1:3])
