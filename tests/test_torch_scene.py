"""Port scene (models/scene.run_scene, cli scene) end to end against the
JAX package's run_scene on the same RAW files and RRC CSVs, with CMOS2's
MSS (``mss2_file``: the whole sample-task workflow)."""

import functools
import glob
import os

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
from opticalimageprocessor_tpu.io import tiff as tiff_io
from opticalimageprocessor_tpu.models import device_pipeline as jdp
from opticalimageprocessor_tpu.models import scene as jscene
from opticalimageprocessor_tpu.ops import phasecorr_pallas as jpallas
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu_torch import cli
from opticalimageprocessor_tpu_torch.models import scene
from opticalimageprocessor_tpu_torch.models.device_pipeline import (
    MssAlign,
    ScenePipeline,
)

torch.set_num_threads(2)

PIX, LINES, FOLD = 3072, 2048, 200
KW = dict(slices=8, stt_sections=4, fold_cols=FOLD, pixels_per_line=PIX)


def mss2_rolls(width):
    """Band b of the synthetic MSS2 is the noise rolled by these (rows,
    columns): its own roll ((b + 1) mod 2, 1 - b) plus the columns that
    put it under the prestitched PAN2 ((FOLD - W) / 4 band px)."""
    return [((b + 1) % 2, (FOLD - width) // 4 + 1 - b) for b in range(4)]


def _write_scene(d, rng, lines, width, dy):
    """bench.py:217-259's synthesis, small: PAN1 = x4 upsample of noise,
    PAN2 = PAN1 rolled by (dy, 200 - 3 - W), band b = the noise rolled by
    (b mod 2, b - 1); random RRC CSVs.  CMOS2's MSS: the noise rolled by
    :func:`mss2_rolls`, with its own random RRC CSVs (drawn last)."""
    scene_lr = rng.integers(2000, 42000, (lines // 4, width // 4)).astype(
        np.float32)
    up = np.clip(np.rint(np.asarray(jres.upsample4_f32(scene_lr))), 0, 65535)
    pan1 = up.astype(np.uint16)
    pan2 = np.roll(np.roll(up, dy, 0), FOLD - 3 - width, 1).astype(np.uint16)
    mss = np.stack([np.roll(scene_lr, (b % 2, b - 1), (0, 1))
                    for b in range(4)]).astype(np.uint16)
    files = {n: os.path.join(d, f"{n}.RAW") for n in ("pan1", "pan2", "mss")}
    pan1.tofile(files["pan1"])
    pan2.tofile(files["pan2"])
    mss.transpose(1, 0, 2).tofile(files["mss"])
    params = {}
    for name, n in (("pan1", width), ("pan2", width),
                    *[(f"msb{b}", width // 4) for b in range(1, 5)]):
        kb = np.stack([0.98 + 0.04 * rng.random(n), rng.normal(0, 20, n)], 1)
        files[f"rrc_{name}"] = os.path.join(d, f"{name}.csv")
        save_rrc_params(files[f"rrc_{name}"], kb)
        params[name] = (kb[:, 0], kb[:, 1])
    mss2 = np.stack([np.roll(scene_lr, r, (0, 1)) for r in mss2_rolls(width)]
                    ).astype(np.uint16)
    files["mss2"] = os.path.join(d, "mss2.RAW")
    mss2.transpose(1, 0, 2).tofile(files["mss2"])
    for b in range(1, 5):
        kb = np.stack([0.98 + 0.04 * rng.random(width // 4),
                       rng.normal(0, 20, width // 4)], 1)
        files[f"rrc_m2b{b}"] = os.path.join(d, f"m2b{b}.csv")
        save_rrc_params(files[f"rrc_m2b{b}"], kb)
        params[f"m2b{b}"] = (kb[:, 0], kb[:, 1])
    return files, params, (pan1, pan2, mss, mss2)


def _run(module, files, out_dir, captured):
    rrc_mss = tuple(files[f"rrc_msb{b}"] for b in range(1, 5))
    rrc_mss2 = tuple(files[f"rrc_m2b{b}"] for b in range(1, 5))

    def capture(params, n_valid, n_stt):
        captured.update(params=params, n_valid=np.asarray(n_valid),
                        n_stt=int(n_stt))

    def capture2(cx, cy, n_valid):
        # log_scene_params is patched: this is the MSS2 fit's call
        captured.update(params2=(np.asarray(cx), np.asarray(cy)),
                        n_valid2=np.asarray(n_valid))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "log_scene_params", capture)
        mp.setattr(module, "log_band_coeffs", capture2)
        extra = {"device": "cpu"} if module is scene else {}
        return module.run_scene(
            files["pan1"], files["pan2"], files["mss"], files["rrc_pan1"],
            files["rrc_pan2"], rrc_mss, mss2_file=files["mss2"],
            rrc_mss2_files=rrc_mss2, out_dir=out_dir,
            out_stitched=os.path.join(out_dir, "STITCHED.RAW"),
            out_stitched_mss=os.path.join(out_dir, "SMSS.TIFF"), **KW, **extra,
        )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    rng = np.random.default_rng(77)
    files, params, arrays = _write_scene(d, rng, LINES, PIX, dy=2)
    out = {}
    for name, module in (("jax", jscene), ("port", scene)):
        od = os.path.join(d, name)
        os.mkdir(od)
        cap = {}
        with pytest.MonkeyPatch.context() as mp:
            # JAX's registration as it runs on the TPU: the fused Pallas
            # cross-power (bf16 GEMM operands, float32 sums), in interpret
            # mode -- the contract of the port's kernel (b) and of its
            # plain version; on the CPU JAX would take its float32 path
            mp.setattr(jdp, "register_fast", functools.partial(
                jdp.register_fast, use_fused=True, interpret=True))
            fused = []
            real = jpallas.windowed_crosspower_fused_bands
            mp.setattr(jpallas, "windowed_crosspower_fused_bands",
                       lambda *a: fused.append(1) or real(*a))
            paths = _run(module, files, od, cap)
        assert bool(fused) == (name == "jax")
        for key in ("aligned", "aligned2", "stitched_mss"):
            cap[key] = tiff_io.read_tiff(paths[key])[..., [2, 1, 0, 3]]
        cap["stitched"] = np.fromfile(paths["stitched"], "<u2").reshape(
            LINES, -1)
        out[name] = cap
    return out, params, arrays


def _curve(c):
    x = np.linspace(0.0, PIX, 257)
    c = np.asarray(c, np.float64)
    return sum(c[k] * x**k for k in range(c.size))


def test_scene_estimates_match_jax(runs):
    out, _, _ = runs
    j, p = out["jax"], out["port"]
    np.testing.assert_array_equal(p["n_valid"], j["n_valid"])
    assert p["n_stt"] == j["n_stt"] == 4
    for k in (0, 1):                       # cx (4, 2), cy (4, 3)
        for b in range(4):
            d = np.abs(_curve(p["params"][k][b]) - _curve(j["params"][k][b]))
            assert d.max() <= 1e-3, (k, b, d.max())
    for k in (2, 3, 4, 5):                 # clamped and raw stt dx, dy
        assert abs(float(p["params"][k]) - float(j["params"][k])) <= 1e-3


def _check_envelope(got, want, what):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (what, d.max(),
                                                     (d > 0).mean())


def test_scene_pinned_transform_matches_jax(runs):
    """JAX's estimates pinned into the port's transform: aligned within
    1 DN on <= 1% of pixels; stitched left half byte-exact, right half
    within 1 DN on <= 1%."""
    out, params, (pan1, pan2, mss, _) = runs
    j = out["jax"]
    cx, cy, _, _, raw_dx, raw_dy = j["params"]
    pipe = ScenePipeline(
        params["pan1"], params["pan2"],
        tuple(np.stack([params[f"msb{b}"][i] for b in range(1, 5)])
              for i in (0, 1)),
        slices=8, fold=FOLD // 2, stt_sections=4, overlap_cols=FOLD,
    )
    aligned, stitched = pipe.transform(
        *(torch.from_numpy(x) for x in (pan1, pan2, mss)),
        torch.from_numpy(np.array(cx, np.float32)),
        torch.from_numpy(np.array(cy, np.float32)),
        np.float32(raw_dx), np.float32(raw_dy),
    )
    _check_envelope(aligned.numpy(), j["aligned"], "aligned")
    left = PIX - FOLD // 2
    st = stitched.numpy()
    np.testing.assert_array_equal(st[:, :left], j["stitched"][:, :left])
    _check_envelope(st[:, left:], j["stitched"][:, left:], "stitched")


def test_scene_outputs_match_jax(runs):
    """Unpinned: the port's own estimates through its own transform.  On
    noise a ~1e-4 px estimate difference moves isolated pixels by several
    DN (docs/NUMERICS.md:35-42), so the gates on the estimate-dependent
    rasters are means; the stitched left half (no estimate) stays exact."""
    out, _, _ = runs
    j, p = out["jax"], out["port"]
    assert p["aligned"].shape == j["aligned"].shape == (LINES // 4, PIX // 4,
                                                        4)
    d = np.abs(p["aligned"].astype(np.int32) - j["aligned"].astype(np.int32))
    assert d.mean() < 0.05, d.mean()
    left = PIX - FOLD // 2
    assert p["stitched"].shape == j["stitched"].shape == (LINES, 2 * left)
    np.testing.assert_array_equal(p["stitched"][:, :left],
                                  j["stitched"][:, :left])
    d = np.abs(p["stitched"][:, left:].astype(np.int32)
               - j["stitched"][:, left:].astype(np.int32))
    assert d.mean() < 0.05, d.mean()


def test_scene_mss2_estimates_match_jax(runs):
    """MSS2's fits against the prestitched PAN2: the same valid counts as
    JAX's, and every fitted curve within 1e-3 px."""
    out, _, _ = runs
    j, p = out["jax"], out["port"]
    np.testing.assert_array_equal(p["n_valid2"], j["n_valid2"])
    for k in (0, 1):
        for b in range(4):
            d = np.abs(_curve(p["params2"][k][b]) - _curve(j["params2"][k][b]))
            assert d.max() <= 1e-3, (k, b, d.max())


def test_scene_mss2_recovers_the_band_rolls(runs):
    """The MSS2 fits find each band's roll against the prestitched PAN2
    (4 PAN px a band px); the rows carry the prestitch's residue of dy = 2
    read as ~1.6 (half a band row at most)."""
    out, _, _ = runs
    cx, cy = out["port"]["params2"]
    for b, (dr, dc) in enumerate(mss2_rolls(PIX)):
        own = dc - (FOLD - PIX) // 4
        assert abs(cx[b][0] - 4 * own) < 0.1, (b, cx[b])
        assert abs(cy[b][0] - 4 * dr) < 0.5, (b, cy[b])


def test_scene_mss2_pinned_transform_matches_jax(runs):
    """JAX's MSS2 fits pinned into MssAlign's remap: aligned2 within 1 DN
    on <= 1% of pixels."""
    out, params, (_, _, _, mss2) = runs
    cx, cy = out["jax"]["params2"]
    align = MssAlign(tuple(np.stack([params[f"m2b{b}"][i] for b in
                                     range(1, 5)]) for i in (0, 1)),
                     slices=8)
    got = align.transform(torch.from_numpy(mss2),
                          torch.from_numpy(np.array(cx, np.float32)),
                          torch.from_numpy(np.array(cy, np.float32)))
    _check_envelope(got.numpy(), out["jax"]["aligned2"], "aligned2")


def test_scene_mss2_outputs_match_jax(runs):
    """Unpinned: aligned2 and the stitched MSS against JAX's, mean < 0.05
    DN (the estimate-dependent gate of test_scene_outputs_match_jax)."""
    out, _, _ = runs
    j, p = out["jax"], out["port"]
    half = PIX // 4 - FOLD // 8
    for key, shape in (("aligned2", (LINES // 4, PIX // 4, 4)),
                       ("stitched_mss", (LINES // 4, 2 * half, 4))):
        assert p[key].shape == j[key].shape == shape, key
        d = np.abs(p[key].astype(np.int32) - j[key].astype(np.int32))
        assert d.mean() < 0.05, (key, d.mean())


def test_scene_stitched_mss_is_the_aligned_concat(runs):
    """The port's stitched MSS is its own two aligned rasters cut at the
    MSS fold (fold_cols / 8 band px a side), byte for byte."""
    p = runs[0]["port"]
    f = FOLD // 8
    np.testing.assert_array_equal(
        p["stitched_mss"],
        np.concatenate([p["aligned"][:, :PIX // 4 - f],
                        p["aligned2"][:, f:]], axis=1))


@pytest.fixture(scope="module")
def wide_scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli"))
    files, _, _ = _write_scene(d, np.random.default_rng(5), 1024, 12288, dy=3)
    return d, files


def _argv(files, d, *extra):
    argv = ["scene", "--pan1", files["pan1"], "--pan2", files["pan2"],
            "--mss", files["mss"], "--rrc-pan1", files["rrc_pan1"],
            "--rrc-pan2", files["rrc_pan2"], "--slices", "8", "-s", "4",
            "--out-dir", d, "-o", os.path.join(d, "OUT.RAW"),
            "--device", "cpu"]
    for b in range(1, 5):
        argv += [f"--rrc-msb{b}", files[f"rrc_msb{b}"]]
    return argv + list(extra)


def test_cli_scene_runs_at_camera_width(wide_scene):
    d, files = wide_scene
    assert cli.main(_argv(files, d)) == 0
    st = np.fromfile(os.path.join(d, "OUT.RAW"), "<u2")
    assert st.size == 1024 * 2 * (12288 - FOLD // 2)
    aligned = tiff_io.read_tiff(os.path.join(d, "mss.ALIGNED.TIFF"))
    assert aligned.shape == (256, 3072, 4)


def test_cli_scene_stream_mss2_runs_at_camera_width(wide_scene):
    """``scene --stream --mss2`` at the camera width: every output, with
    its shape, and the prestitched PAN2 RAW."""
    d, files = wide_scene
    out = os.path.join(d, "stream")
    os.mkdir(out)
    argv = _argv(files, out, "--stream", "--stream-section-lines", "384",
                 "--mss2", files["mss2"], "--out-mss",
                 os.path.join(out, "SMSS.TIFF"))
    for b in range(1, 5):
        argv += [f"--rrc-m2b{b}", files[f"rrc_m2b{b}"]]
    assert cli.main(argv) == 0
    st = np.fromfile(os.path.join(out, "OUT.RAW"), "<u2")
    assert st.size == 1024 * 2 * (12288 - FOLD // 2)
    for name in ("mss.ALIGNED.TIFF", "mss2.ALIGNED.TIFF"):
        assert tiff_io.read_tiff(os.path.join(out, name)).shape == (
            256, 3072, 4)
    assert tiff_io.read_tiff(os.path.join(out, "SMSS.TIFF")).shape == (
        256, 2 * (3072 - FOLD // 8), 4)
    assert os.path.getsize(os.path.join(out, "pan2.PRESTT.RAW")) == (
        1024 * 12288 * 2)


@pytest.mark.parametrize("case", [
    "fold_too_small", "missing_pan1", "mss2", "mesh", "stream", "profile",
    "rrc_m2b_needs_mss2", "out_mss_needs_mss2", "missing_mss2",
    "mesh_stream",
])
def test_cli_scene_usage_errors(wide_scene, case, capsys, caplog):
    """Usage errors exit 254 before any work, with the JAX CLI's checks and
    messages.  The runtime checks of ``--mss2``, ``--stream`` and ``--mesh``
    (a non-TIFF stitched MSS, section lines that are no multiple of 4, a
    negative mesh, resident or streamed) exit 2 before any device work.  ``--profile``, once refused, gives the JAX
    CLI's rc for the same argv (0) and writes one trace."""
    d, files = wide_scene
    nope = os.path.join(d, "nope.RAW")
    prof = os.path.join(d, "prof")
    extra, rc, said = {
        "fold_too_small": (["-c", "1"], 254, "fold column value too small"),
        "missing_pan1": ([], 254, f"--pan1: File does not exist: {nope}"),
        "mss2": (["--mss2", files["mss2"], "--out-mss",
                  os.path.join(d, "X.RAW")], 2,
                 "Output file should be a tiff image"),
        "mesh": (["--mesh", "-1"], 2, "mesh must be >= 0, got -1"),
        "stream": (["--stream", "--stream-section-lines", "130"], 2,
                   "section_rows must be a multiple of 4"),
        "profile": (["--profile", prof], 0, ""),
        "rrc_m2b_needs_mss2": (["--rrc-m2b1", files["rrc_msb1"]], 254,
                               "--rrc-m2b* needs --mss2"),
        "out_mss_needs_mss2": (["--out-mss", os.path.join(d, "M.TIFF")], 254,
                               "--out-mss needs --mss2"),
        "missing_mss2": (["--mss2", nope], 254,
                         f"--mss2: File does not exist: {nope}"),
        "mesh_stream": (["--mesh", "-1", "--stream"], 2,
                        "mesh must be >= 0, got -1"),
    }[case]
    f = dict(files, pan1=nope) if case == "missing_pan1" else files
    capsys.readouterr()
    caplog.clear()
    assert cli.main(_argv(f, d, *extra)) == rc
    if rc == 254:
        assert f"USAGE ERROR: {said}" in capsys.readouterr().out
    elif rc == 0:
        assert len(glob.glob(os.path.join(prof, "*.pt.trace.json"))) == 1
    else:
        assert f"{said}." in caplog.text
        # failed before the strips were opened
        assert "cene: PAN" not in caplog.text


def test_cli_scene_runtime_error_is_rc2(wide_scene):
    """A validity failure (here: too many stt sections for the strip) is
    a runtime error, exit code 2."""
    d, files = wide_scene
    assert cli.main(_argv(files, d, "-s", "20")) == 2
