"""The port's parity remap (ops/resample.remap_section_u16 and its plan)
against the numpy ``cv::remap`` oracle (ops/cv_exact.remap_cubic_u16_exact)
at 0 DN, and against the JAX package's XLA parity remap, which sits within
1 DN of that oracle on XLA:CPU (its multiply-adds contract into FMAs)."""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu.ops import cv_exact
from opticalimageprocessor_tpu.ops import resample as jres
from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.ops import resample

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# tests/test_resample.py's polynomial and constant-shift cases
POLY = [((1.5, 0.0002), (-0.75, 0.0001, 1e-8)),
        ((-3.25, -0.0004), (2.5, -0.0002, -2e-8)),
        ((0.0, 0.0), (0.0, 0.0, 0.0))]
SHIFTS = [(3.25, -2.5), (-0.875, 0.0), (10.031, 4.97)]
CASES = ([("poly", c) for c in POLY] + [("shift", s) for s in SHIFTS])
MODES = pytest.mark.parametrize("quantized", [False, True],
                                ids=["continuous", "quantized"])
CASE_IDS = [f"poly{i}" for i in range(3)] + [f"shift{i}" for i in range(3)]


def poly_maps(cx, cy, rows, width):
    """The reference's per-section map fill (preproc.h:443-450), as
    tests/test_resample.py builds it: double math, then a float cast."""
    xx = np.arange(width, dtype=np.float64) * 4.0
    yy = np.arange(rows, dtype=np.float64) * 4.0
    mapx_col = (cx[1] * xx + cx[0] + xx) / 4.0
    mapx = np.tile(mapx_col.astype(np.float32)[None, :], (rows, 1))
    mapy = ((yy[:, None] + (cy[2] * xx * xx + cy[1] * xx + cy[0])[None, :])
            / 4.0).astype(np.float32)
    return mapx, mapy


def shift_maps(dx, dy, rows, width):
    """The prestitch map fill (stitcher.h:93-99): double sums, float cast."""
    x32 = (np.arange(width, dtype=np.float64) + float(dx)).astype(np.float32)
    mapx = np.tile(x32[None, :], (rows, 1))
    mapy = np.tile((np.arange(rows, dtype=np.float64) + float(dy)).astype(
        np.float32)[:, None], (1, width))
    return mapx, mapy


def _run_case(kind, params, quantized, rng):
    """-> (oracle, port, JAX) outputs of one case on a random section."""
    if kind == "poly":
        rows, width = 96, 256
        src = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
        mapx, mapy = poly_maps(*params, rows, width)
        port = resample.remap_polynomial_u16(torch.from_numpy(src), *params,
                                             quantized_coords=quantized)
        jax_out = jres.remap_polynomial_u16(jnp.asarray(src), *params,
                                            quantized_coords=quantized)
    else:
        rows, width = 64, 200
        src = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
        mapx, mapy = shift_maps(*params, rows, width)
        port = resample.remap_constant_shift_u16(
            torch.from_numpy(src), *params, quantized_coords=quantized)
        jax_out = jres.remap_constant_shift_u16(
            jnp.asarray(src), *params, quantized_coords=quantized)
    want = cv_exact.remap_cubic_u16_exact(src, mapx, mapy,
                                          quantized_coords=quantized)
    return want, port.numpy(), np.asarray(jax_out)


@MODES
@pytest.mark.parametrize("kind,params", CASES, ids=CASE_IDS)
def test_remap_equals_oracle(kind, params, quantized, rng):
    """0 DN against the oracle: every product and sum one rounded float32
    operation in the oracle's order, the map's y + g summed in float64."""
    want, got, _ = _run_case(kind, params, quantized, rng)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@MODES
@pytest.mark.parametrize("kind,params", CASES, ids=CASE_IDS)
def test_remap_within_jax_envelope(kind, params, quantized, rng):
    """Within JAX's own XLA:CPU envelope of the oracle: <= 1 DN on < 2% of
    pixels (tests/test_resample.py)."""
    _, got, jax_out = _run_case(kind, params, quantized, rng)
    d = np.abs(got.astype(np.int32) - jax_out.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 0.02, (d.max(), (d > 0).mean())


@MODES
@pytest.mark.parametrize("kind,params", CASES + [
    ("poly", ((40.0, 5.0e-3), (22.0, -1.0e-3, 2.0e-6))),
    ("shift", (-14.97, -9.03125)),
], ids=CASE_IDS + ["poly_far", "shift_far"])
def test_plan_equals_jax(kind, params, quantized):
    """The plan field for field where both packages have the field; the
    port keeps g in float64 where JAX splits it into g_hi + g_lo."""
    args = (*params, 512, quantized)
    if kind == "poly":
        got = resample.plan_for_band_alignment(*args)
        want = jres.plan_for_band_alignment(*args)
    else:
        got = resample.plan_for_constant_shift(*args)
        want = jres.plan_for_constant_shift(*args)
    assert got.width == want.width and got.quantized == want.quantized
    np.testing.assert_array_equal(got.col_tap0, want.col_tap0)
    assert got.col_tap0.dtype == want.col_tap0.dtype
    np.testing.assert_array_equal(got.wx, want.wx)
    assert got.wx.dtype == want.wx.dtype == np.float32
    assert got.col_shifts == want.col_shifts
    assert got.row_offsets == want.row_offsets
    assert (got.halo_top, got.halo_bottom) == (want.halo_top, want.halo_bottom)
    np.testing.assert_array_equal(got.g.astype(np.float32), want.g_hi)


@MODES
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_equals_whole(chunk, quantized, rng, monkeypatch):
    """Row chunks carry their halo rows and absolute y: any chunking gives
    the whole-section result at 0 DN (a G that crosses whole rows and a
    section shorter than the last chunk's halo)."""
    src = torch.from_numpy(rng.integers(0, 65536, (150, 320), dtype=np.uint16))
    plan = resample.plan_for_band_alignment(
        (-2.6, 3.0e-4), (5.3, -4.0e-3, 3.0e-6), 320, quantized)
    whole = resample.remap_section_u16(src, plan)
    monkeypatch.setattr(resample, "PARITY_CHUNK_ROWS", chunk)
    got = resample.remap_section_u16(src, plan)
    assert torch.equal(got, whole)


@pytest.fixture(scope="module")
def golden_band(tmp_path_factory):
    """Band 1 of the golden downlink's MSS (256 x 3072), separated by the
    port's AuxSeparator (tests/test_torch_auxsep.py holds it byte-equal to
    the JAX package's)."""
    from opticalimageprocessor_tpu_torch.models.auxsep import AuxSeparator

    with open(os.path.join(GOLDEN, "expected.json")) as f:
        expected = json.load(f)
    tmp = tmp_path_factory.mktemp("golden_parity")
    dat = str(tmp / "KASHI_TJ3-01_20220817_031259_1.dat")
    with gzip.open(os.path.join(GOLDEN, "golden.dat.gz")) as f, \
            open(dat, "wb") as g:
        g.write(f.read())
    mss = np.fromfile(AuxSeparator(dat, out_dir=str(tmp)).separate()["mss"],
                      dtype="<u2").reshape(-1, 12288)
    return np.ascontiguousarray(mss[:, :3072]), expected


def test_golden_band_equals_oracle(golden_band):
    """On the golden band the port equals the oracle; JAX's XLA:CPU output
    (the fixture's ``remap_band0_sha``) is 1 DN off it on 166 pixels, so
    the port is within 1 DN of JAX on at most that many."""
    band, expected = golden_band
    cx, cy = expected["remap_coeff_x"], expected["remap_coeff_y"]
    got = resample.remap_polynomial_u16(torch.from_numpy(band), cx, cy)
    want = cv_exact.remap_cubic_u16_exact(band, *poly_maps(cx, cy,
                                                           *band.shape))
    np.testing.assert_array_equal(got.numpy(), want)
    jax_out = np.asarray(jres.remap_polynomial_u16(jnp.asarray(band), cx, cy))
    d = np.abs(got.numpy().astype(np.int32) - jax_out.astype(np.int32))
    assert d.max() <= 1 and (d > 0).sum() <= 166, (d.max(), (d > 0).sum())


# Quantized coordinates saturate at int16: on map rows past 32767, s >> 5
# stays 32767.  The JAX package zeroes a pixel whose row offset iy - y lies
# outside the plan's row_offsets (_remap_section_math); cv::remap repeats
# the saturated row.  The port takes JAX's rule, per pixel, and equals the
# oracle everywhere else.
SAT_ROWS, SAT_WIDTH, SAT_SHIFT = 32800, 8, (0.4, 1.3)


@pytest.fixture(scope="module")
def saturated():
    """A quantized 32800 x 8 section at (dx, dy) = (0.4, +1.3): -> (src,
    plan, the expected result: JAX's zeros on its rows of zeros, the
    oracle elsewhere)."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 65536, (SAT_ROWS, SAT_WIDTH), dtype=np.uint16)
    want = cv_exact.remap_cubic_u16_exact(
        src, *shift_maps(*SAT_SHIFT, SAT_ROWS, SAT_WIDTH),
        quantized_coords=True)
    jax_out = np.asarray(jres.remap_constant_shift_u16(
        jnp.asarray(src), *SAT_SHIFT, quantized_coords=True))
    zero = ~jax_out.any(axis=1)
    # JAX gives 0 on exactly the saturated rows, and the oracle does not
    assert np.array_equal(zero, np.arange(SAT_ROWS) >= 32768)
    assert want[zero].all()
    want[zero] = 0
    plan = resample.plan_for_constant_shift(*SAT_SHIFT, SAT_WIDTH, True)
    return src, plan, want


@pytest.mark.parametrize("chunk", [1000, 2048, 3000])
def test_saturated_rows_zero_as_jax(saturated, chunk, monkeypatch):
    """The whole section in plain-version chunks of 1000, 2048 and 3000
    rows: 0 where JAX gives 0, the oracle elsewhere, byte for byte."""
    src, plan, want = saturated
    monkeypatch.setattr(resample, "PARITY_CHUNK_ROWS", chunk)
    got = resample.remap_section_u16(torch.from_numpy(src), plan)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("a,first,count", [(32500, 100, 200),
                                           (31000, 700, 1090)])
def test_saturated_rows_zero_through_origin(saturated, a, first, count):
    """A window of the section from row ``a`` to its end, remapped as the
    line mesh remaps a shard (``origin`` = ``a``): its output rows, which
    run past map row 32767, are the whole section's."""
    src, plan, want = saturated
    got = resample.remap_section_u16(torch.from_numpy(src[a:]), plan,
                                     first=first, count=count, origin=a)
    np.testing.assert_array_equal(got.numpy(),
                                  want[a + first:a + first + count])


def _no_build(monkeypatch):
    """Make any build or launch of a kernel fail the test."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel was built or launched")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "launch", refuse)


@pytest.mark.parametrize("bad", ["dtype", "width", "rows"])
def test_kernel_f_refuses_bad_arguments(bad, monkeypatch):
    """The kernel's wrapper refuses, before any build, a section that is
    not uint16, a plan of another width, and output rows past the
    section's end."""
    _no_build(monkeypatch)
    before = dict(_build.LAUNCHES)
    plan = resample.plan_for_constant_shift(
        0.4, 1.3, 48 if bad == "width" else 64, True)
    src = torch.empty((32, 64), device="meta",
                      dtype=torch.int16 if bad == "dtype" else torch.uint16)
    first, count = (30, 3) if bad == "rows" else (0, 32)
    with pytest.raises(ValueError, match="remap_section_u16"):
        resample._remap_section_cuda(src, plan, first, count, 0)
    assert _build.LAUNCHES == before


def test_remap_section_off_cpu_refuses_before_build(monkeypatch):
    """A tensor off the CPU never takes the plain version: without a card
    it raises before any build."""
    _no_build(monkeypatch)
    plan = resample.plan_for_constant_shift(0.4, 1.3, 64, True)
    src = torch.empty((32, 64), device="meta", dtype=torch.uint16)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        resample.remap_section_u16(src, plan)


@MODES
def test_remap_section_on_cpu_never_builds(quantized, rng, monkeypatch):
    """On CPU tensors remap_section_u16 runs the plain version and never
    reaches _build."""
    _no_build(monkeypatch)
    before = dict(_build.LAUNCHES)
    src = torch.from_numpy(rng.integers(0, 65536, (40, 64), dtype=np.uint16))
    plan = resample.plan_for_band_alignment(*POLY[0], 64, quantized)
    out = resample.remap_section_u16(src, plan, first=3, count=30)
    assert out.shape == (30, 64) and out.dtype == torch.uint16
    assert _build.LAUNCHES == before
