"""Kernel (d), the stitch tail (csrc/stitch_tail.cu, called by
opticalimageprocessor_tpu_torch.ops.resample.remap_const_stitch_chunked):
the exact identities its arithmetic rests on and the window that its
right-half warps stage, here; on an NVIDIA card (marker ``cuda``) the
kernel against ``_stitch_tail_plain``, byte for byte on both outputs.

This file imports no JAX, so it also runs where the port runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_stitch_tail.py
"""

import math

import numpy as np
import pytest
import torch

from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.ops import resample

DXS = [-119.5, -14.0, -2.7, 0.0, 3.0, 14.0, 119.5]
DYS = [-6.0, -0.5, 0.0, 1.6, 6.0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel (d) has no CPU form")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------- CPU --

def test_u16_enters_float32_exactly():
    """(2^23 + s) - 2^23 in float32, from the bits 0x4B000000 | s, is s for
    every uint16 s (the kernel's st_u16f)."""
    s = np.arange(65536, dtype=np.uint32)
    got = (s | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388608.0)
    np.testing.assert_array_equal(got, s.astype(np.float32))


def test_u16_enters_float64_exactly():
    """(2^52 + s) - 2^52 in float64, from the words (0x43300000, s), is s
    for every uint16 s (the kernel's st_rrc)."""
    s = np.arange(65536, dtype=np.uint64)
    got = (s | np.uint64(0x43300000 << 32)).view(np.float64) - 2.0 ** 52
    np.testing.assert_array_equal(got, s.astype(np.float64))


def _round_grid() -> np.ndarray:
    """Every half-integer in [-2, 65537], each with its float32 neighbours,
    the integers' neighbours, signed zeros, extremes, +-inf and NaN."""
    halves = np.arange(-4, 2 * 65537 + 1, dtype=np.float64) / 2
    v = halves.astype(np.float32)
    up = np.nextafter(v, np.float32(np.inf))
    down = np.nextafter(v, np.float32(-np.inf))
    extra = np.array([0.0, -0.0, 1e-45, -1e-45, 65535.49, 65535.5,
                      65536.0, 1e30, -1e30, np.inf, -np.inf, np.nan],
                     dtype=np.float32)
    return np.concatenate([v, up, down, extra])


def test_round_bits_equal_rint_then_clamp():
    """The rounding of an output of kernels (c) and (d), remap_common.cuh's
    oip_round_u16_bits: clamp to [0, 65535] (NaN -> 0), add 1.5 * 2^23 in
    float32, keep the low 16 bits -- against the reference's (uint16)
    fminf(fmaxf(rintf(v), 0), 65535) (``resample._round_u16``), over every
    half-integer in [-2, 65537] and its neighbours, +-inf and NaN."""
    v = _round_grid()
    with np.errstate(invalid="ignore"):
        clamped = np.fmin(np.fmax(v, np.float32(0)), np.float32(65535))
        got = ((clamped + np.float32(12582912.0)).view(np.uint32)
               & np.uint32(0xFFFF))
        want = np.fmin(np.fmax(np.rint(v), np.float32(0)),
                       np.float32(65535)).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kpx", [4, 8])
@pytest.mark.parametrize("dx", DXS + [-3.0001, -2.9999, 0.0001, -0.0001,
                                      7.99999, -119.99])
def test_right_warp_windows_hold_every_tap(dx, kpx):
    """The premise of the right half's staging, for kPx columns a lane (4
    without prestt, 8 with it): column x's first tap is x + floor(dx) - 1 or
    x + floor(dx) (float32 mapx of kernel (c)'s taps), so a warp of L =
    (32 kPx - 4 - o) / kPx output lanes, o = (floor(dx) - 1) mod kPx,
    staging the 32 kPx columns from ws = xo + floor(dx) - 1 rounded down to
    a multiple of kPx holds every tap of its kPx L columns; its 16-byte
    chunks, 4 kPx of them (one more for kPx 4) from ws rounded down to a
    multiple of 8, hold that window (Right<kPx> and launch<kPx> of
    stitch_tail.cu)."""
    width = 12288
    dx = float(np.float32(dx))
    cx = torch.tensor([4.0 * dx, 0.0], dtype=torch.float32)
    tap0, _ = resample._col_taps(cx, width, 128, 16)
    x = torch.arange(width)
    fdx = math.floor(dx)
    off = set((tap0 - x).tolist())
    assert off <= {fdx - 1, fdx}, off
    win = 32 * kpx
    chunks = win // 8 + (1 if kpx < 8 else 0)
    o = (fdx - 1) % kpx
    lanes = (win - 4 - o) // kpx
    assert lanes in (30, 31)
    span = kpx * lanes
    xo = (x // span) * span
    ws = ((xo + fdx - 1) // kpx) * kpx
    pos = tap0 - ws
    assert int(pos.min()) >= 0 and int((pos + 3).max()) <= win - 1
    ws8 = (ws // 8) * 8
    assert bool((ws8 + 8 * chunks >= ws + win).all())


# ---------------------------------------------------------------- card --

def _hard_params(rng, width):
    """RRC parameters whose k * s + b lands in every case of the reference's
    truncation: in range, negative (two's complement wrap), past 65535
    (wrap), past 2^31 (-> 0) on either side, and NaN / inf (-> 0)."""
    k = 0.98 + 0.04 * rng.random(width)
    b = rng.normal(0, 20, width)
    kind = rng.integers(0, 8, width)
    k = np.where(kind == 1, -rng.random(width), k)              # negative
    b = np.where(kind == 2, -70000.0 * rng.random(width), b)    # negative
    k = np.where(kind == 3, 1.5 + 2.0 * rng.random(width), k)   # > 65535
    k = np.where(kind == 4, 1e5 * (1 + rng.random(width)), k)   # > 2^31
    b = np.where(kind == 5, -3e9 * (1 + rng.random(width)), b)  # < -2^31
    k = np.where(kind == 6, np.nan, k)
    b = np.where(kind == 7, np.inf, b)
    return k, b


def _run(dev, rows, width, fold, dx, dy, want_prestt, seed):
    rng = np.random.default_rng(seed)
    pan1, pan2 = (torch.from_numpy(
        rng.integers(0, 65536, (rows, width), dtype=np.uint16)).to(dev)
        for _ in range(2))
    k1, b1 = _hard_params(rng, width)
    k2, b2 = _hard_params(rng, width)
    args = (pan1, pan2,
            *(torch.from_numpy(t).to(dev) for t in (k1, b1, k2, b2)),
            float(np.float32(dx)), float(np.float32(dy)), fold, 128, 16,
            want_prestt)
    before = _build.LAUNCHES["stitch_tail"]
    got = resample._stitch_tail_cuda(*args)
    assert _build.LAUNCHES["stitch_tail"] == before + 1
    want = resample._stitch_tail_plain(*args)
    torch.cuda.synchronize()
    if not want_prestt:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        d = (g.to(torch.int32) - w.to(torch.int32)).abs()
        assert int(d.max()) == 0, (int(d.max()), d.nonzero()[:5].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("want_prestt", [False, True])
@pytest.mark.parametrize("dy", DYS)
@pytest.mark.parametrize("dx", DXS)
def test_kernel_equals_plain_at_every_shift(card, dx, dy, want_prestt):
    """Both outputs byte for byte at the clamp edges of dx (|dx| < 120) and
    dy (the prestitch's |dy| <= 6), integral and fractional shifts, with 4
    columns a right-half lane (no prestt) and 8 (prestt)."""
    _run(card, 129, 768, 100, dx, dy, want_prestt,
         seed=len(DYS) * DXS.index(dx) + DYS.index(dy))


@pytest.mark.cuda
@pytest.mark.parametrize("want_prestt", [False, True])
@pytest.mark.parametrize("fold", [100, 200, 101])
@pytest.mark.parametrize("width", [256, 768, 12288])
@pytest.mark.parametrize("rows", [1, 2, 3, 127, 129, 4116, 4096])
def test_kernel_equals_plain_at_every_shape(card, rows, width, fold,
                                            want_prestt):
    """Both outputs byte for byte over row counts that leave partial tiles
    and tiles shorter than the vertical window, widths from one right-half
    warp to the camera's, folds with W - fold a multiple of 8, not one, and
    odd (unaligned stitched rows), at the scene's shift and at the far
    corner of the shifts."""
    for dx, dy in ((-2.7, 1.6), (119.5, -6.0), (-3.0001, 0.5)):
        _run(card, rows, width, fold, dx, dy, want_prestt,
             seed=rows * 7 + width + fold)


@pytest.mark.cuda
@pytest.mark.parametrize("want_prestt", [False, True])
def test_kernel_equals_plain_at_the_cells_geometry(card, want_prestt):
    """Both outputs byte for byte at 32768 x 12288, fold 100: enough rows
    that the launch keeps its longest tiles (128 rows), as at the cells'
    160000 rows, with 4 columns a right-half lane (the scene cell) and 8
    (prestt, the dual cell); at the scene's shift and one whose taps' offset
    steps inside a warp."""
    for dx, dy in ((-2.7, 1.6), (-3.0001, -0.5)):
        _run(card, 32768, 12288, 100, dx, dy, want_prestt, seed=32768)


@pytest.mark.cuda
def test_kernel_refuses_unaligned_pans(card):
    pan = torch.zeros(64 * 256 + 1, dtype=torch.uint16, device=card)
    pan = pan[1:].view(64, 256)
    kb = torch.zeros(256, dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        resample._stitch_tail_cuda(pan, pan, kb, kb, kb, kb, 0.0, 0.0, 16,
                                   128, 16, False)
