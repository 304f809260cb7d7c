"""The full surface's cross-power and peak (opticalimageprocessor_tpu_torch
.ops.phasecorr): kernel (j), ``surface_crosspower``, and kernel (k),
``surface_peak``, with the 5x5 centroid gathered from the unshifted
surface.  Here the plain versions against the chain they replace
(``whitened_crosspower``, ``irfft2``, ``fftshift``, ``torch.argmax`` and
the centroid on the shifted copy), bit for bit, and the wrappers'
refusals; on an NVIDIA card (marker ``cuda``) the kernels against that
chain at the parity route's shapes, bit for bit, and their launches.

This file imports no JAX, so it also runs where the port runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_surface.py
"""

import pytest
import torch

from opticalimageprocessor_tpu_torch import _build
from opticalimageprocessor_tpu_torch.ops import phasecorr

M, N = 16000, 1250          # a parity registration pair's padded surface
SM, SN = 16000, 200         # an stt window's


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernels (j) and (k) have no CPU "
                    "form")
    return torch.device("cuda", 0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """float32 values as their bits (NaNs compare equal to themselves)."""
    return t.contiguous().view(torch.int32)


def _same_bits(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w))
               for g, w in zip(got, want))


def _shifted_argmax(surf: torch.Tensor) -> torch.Tensor:
    """The replaced chain's peak: ``torch.argmax`` on the fftshifted copy."""
    m, n = surf.shape[-2:]
    shifted = torch.fft.fftshift(surf, dim=(-2, -1))
    return torch.argmax(shifted.reshape(-1, m * n), dim=1)


def _shifted_centroid(surf: torch.Tensor):
    """The replaced chain's (dx, dy, response) from the unshifted surfaces:
    the fftshifted copy, its arg-max and 5x5 centroid."""
    m, n = surf.shape[-2:]
    cxc, cyc, s = phasecorr._argmax_centroid(
        torch.fft.fftshift(surf, dim=(-2, -1)))
    return n / 2.0 - cxc, m / 2.0 - cyc, s


def _replaced_chain(fa, fb, pad_to):
    """``peak_from_spectra`` as it was: whitened cross-power, inverse
    rfft2, fftshift, arg-max and centroid."""
    corr = torch.fft.irfft2(phasecorr.whitened_crosspower(fa, fb), s=pad_to)
    return _shifted_centroid(corr)


def _at_shifted(m: int, n: int, sr: int, sc: int) -> tuple[int, int]:
    """The unshifted (row, column) that fftshift moves to (sr, sc)."""
    return (sr - m // 2) % m, (sc - n // 2) % n


def _surfaces(case: str, batch, m: int, n: int, seed: int,
              device="cpu") -> torch.Tensor:
    """Unshifted float32 surfaces (*batch, m, n) with a planted peak."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randn((*batch, m, n), generator=g, dtype=torch.float32)
    flat = s.reshape(-1, m, n)
    for k in range(flat.shape[0]):
        if case == "ties":
            # one value at a sample of every quadrant of the unshifted
            # surface: the unshifted order's first is not the shifted one's
            r = (k * 7) % 3
            for y, x in ((r, 1), (m - 1 - r, n - 2), (m // 2 + r, 0),
                         (1, n // 2 + r)):
                flat[k, y, x] = 9.0
        elif case == "nan":
            flat[k, (3 * k) % m, 2] = 50.0
            flat[k, m - 2, (5 * k) % n] = float("nan")
            flat[k, 1, n - 1 - k % 3] = float("nan")
        elif case == "edges":
            # shifted corners and edges, where the window clips
            sr, sc = ((0, 0), (m - 1, n - 1), (1, n - 2), (m - 2, 0),
                      (0, n // 2), (m // 2, n - 1))[k % 6]
            y, x = _at_shifted(m, n, sr, sc)
            flat[k, y, x] = 8.0
            y, x = _at_shifted(m, n, (sr + 1) % m, sc)
            flat[k, y, x] = 4.0
            y, x = _at_shifted(m, n, sr, (sc - 1) % n)
            flat[k, y, x] = 2.0
        elif case == "flat":
            # zeros of both signs and nothing above them: every sample ties
            flat[k] = torch.where(flat[k] > 0, 0.0, -0.0)
    return s.to(device)


CASES = ["noise", "ties", "nan", "edges", "flat"]
SHAPES = [(16, 20), (15, 20), (16, 21), (15, 21), (9, 7)]


# ---------------------------------------------------------------- CPU --

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_plain_peak_and_gather_equal_the_shifted_chain(case, shape):
    """The plain unshifted arg-max equals ``torch.argmax`` on the
    fftshifted copy, and the centroid gathered from the unshifted surface
    gives the shifted chain's (dx, dy, response) bit for bit: even and odd
    sizes, ties across quadrants, NaNs, peaks at the shifted edges, flat
    surfaces of signed zeros."""
    m, n = shape
    surf = _surfaces(case, (6,), m, n, seed=m * n)
    assert torch.equal(phasecorr._surface_peak_plain(surf),
                       _shifted_argmax(surf))
    assert _same_bits(phasecorr._peak_and_centroid(surf),
                      _shifted_centroid(surf))


def test_plain_peak_keeps_the_batch_dims():
    """(2, 3, M, N) surfaces: one peak a surface, in row-major batch
    order, and (dx, dy, response) shaped (2, 3)."""
    surf = _surfaces("ties", (2, 3), 12, 10, seed=4)
    assert torch.equal(phasecorr.surface_peak(surf), _shifted_argmax(surf))
    got = phasecorr._peak_and_centroid(surf)
    assert all(g.shape == (2, 3) for g in got)
    assert _same_bits(got, _shifted_centroid(surf))


@pytest.mark.parametrize("bands", [None, 1, 4], ids=["pairs", "one", "four"])
def test_peak_from_spectra_equals_the_replaced_chain(bands):
    """On CPU tensors ``peak_from_spectra`` gives the replaced chain's
    numbers bit for bit: pairs, and one spectrum against 1 or 4 bands."""
    g = torch.Generator().manual_seed(bands or 0)
    h, w = 30, 24
    if bands is None:
        a = torch.rand((3, h, w), generator=g) * 1000
        b = torch.roll(a, (2, -3), (1, 2)) + torch.rand(a.shape, generator=g)
        fa = phasecorr.rfft2_padded(a, (h, w))
    else:
        a = torch.rand((2, h, w), generator=g) * 1000
        b = torch.stack([torch.roll(a, (k, 1 - k), (1, 2)) for k in
                         range(bands)], 1)
        b = b + torch.rand(b.shape, generator=g)
        fa = phasecorr.rfft2_padded(a, (h, w))[:, None]
    fb = phasecorr.rfft2_padded(b, (h, w))
    assert _same_bits(phasecorr.peak_from_spectra(fa, fb, (h, w)),
                      _replaced_chain(fa, fb, (h, w)))


@pytest.mark.parametrize("surfaces,rows", [(4, M), (10, SM), (1, 9),
                                           (2000, 64), (3, 5), (7, 4001)])
def test_peak_slices_cover_every_row(surfaces, rows):
    """Kernel (k)'s first stage: rows a block a multiple of 4, the blocks
    cover every row and none lies wholly past the last, about
    ``_PEAK_BLOCKS`` blocks in all where the rows allow."""
    rpb, chunks = phasecorr._peak_slices(surfaces, rows)
    assert rpb % 4 == 0 and rpb > 0
    assert (chunks - 1) * rpb < rows <= chunks * rpb
    if rows >= 4 * phasecorr._PEAK_BLOCKS:
        assert phasecorr._PEAK_BLOCKS / 2 <= surfaces * chunks \
            <= 2 * phasecorr._PEAK_BLOCKS


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check before any launch: CPU tensors, other
    dtypes, spectra that do not pair, a strided stack, surfaces past the
    kernel's 2^30 samples."""
    fa = torch.zeros((2, 1, 6, 4), dtype=torch.complex64)
    fb = torch.zeros((2, 3, 6, 4), dtype=torch.complex64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel for cpu"):
        phasecorr._surface_crosspower_cuda(fa, fb)
    with pytest.raises(ValueError, match="complex64"):
        phasecorr._surface_crosspower_cuda(fa, fb.to(torch.complex128))
    for bad in (fa[:, :, :5], torch.zeros((2, 2, 6, 4), dtype=fa.dtype),
                torch.zeros((1, 1, 6, 4), dtype=fa.dtype)):
        with pytest.raises(ValueError, match="pair|must have"):
            phasecorr._surface_crosspower_cuda(bad.contiguous(), fb)
    with pytest.raises(ValueError, match="contiguous"):
        phasecorr._surface_crosspower_cuda(fa, fb.transpose(-1, -2))
    surf = torch.zeros((3, 8, 8))
    with pytest.raises(RuntimeError, match="no kernel for cpu"):
        phasecorr._surface_peak_cuda(surf)
    with pytest.raises(ValueError, match="float32"):
        phasecorr._surface_peak_cuda(surf.double())
    with pytest.raises(ValueError, match="contiguous"):
        phasecorr._surface_peak_cuda(surf.transpose(-1, -2))
    with pytest.raises(ValueError, match="2\\^30"):
        phasecorr._surface_peak_cuda(
            torch.empty((1, 1 << 16, 1 << 15), device="meta"))
    assert _build.LAUNCHES == before


# --------------------------------------------------------------- card --

def _noise_spectra(shape, pad_to, seed, device):
    """Half spectra of uint16-range noise tiles, zero-padded to
    ``pad_to``, as the parity registration and the stt take them."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 65536, shape, generator=g, device=device,
                      dtype=torch.int32).to(torch.float32)
    return phasecorr.rfft2_padded(x, pad_to)


def _plant_zeros(fb: torch.Tensor, every: int) -> None:
    """Exact zeros in every ``every``-th bin, so that |C| == 0 there."""
    fb.view(-1)[::every] = 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["parity_tile", "stt", "odd", "unaligned"])
def test_crosspower_kernel_equals_plain(card, case):
    """Kernel (j) against ``whitened_crosspower`` bit for bit: the parity
    tile (one PAN spectrum broadcast over 4 bands, (1, 4, 16000, 626)),
    the stt's 10 windows pair for pair ((10, 16000, 101)), an odd plane
    (8-byte items) and spectra off a 16-byte boundary; exact zeros
    planted so that |C| == 0.  One launch a call."""
    if case == "parity_tile":
        fa = _noise_spectra((1, M, 1228), (M, N), 1, card)[:, None]
        fb = _noise_spectra((1, 4, M, 1228), (M, N), 2, card)
    elif case == "stt":
        fa = _noise_spectra((10, SM, SN), (SM, SN), 3, card)
        fb = _noise_spectra((10, SM, SN), (SM, SN), 4, card)
    else:
        g = torch.Generator(device=card).manual_seed(5)
        shape = (3, 2, 7, 5) if case == "odd" else (2, 3, 8, 6)
        fa = torch.randn((shape[0], 1, *shape[2:]), generator=g,
                         device=card, dtype=torch.complex64)
        fb = torch.randn(shape, generator=g, device=card,
                         dtype=torch.complex64)
        if case == "unaligned":
            flat = torch.empty(fb.numel() + 1, dtype=fb.dtype, device=card)
            flat[1:] = fb.reshape(-1)
            fb = flat[1:].view(shape)
            assert fb.data_ptr() % 16
    _plant_zeros(fb, 97)
    fa.view(-1)[5::89] = 0
    want = phasecorr.whitened_crosspower(fa, fb)
    before = _build.LAUNCHES["surface_crosspower"]
    got = phasecorr.surface_crosspower(fa, fb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["surface_crosspower"] == before + 1
    assert got.is_contiguous() and got.shape == want.shape
    assert bool((want == 0).any())
    assert torch.equal(torch.view_as_real(got).view(torch.int32),
                       torch.view_as_real(want).contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(4, M, N), (10, SM, SN), (5, 15, 21),
                                   (3, 9, 7), (2, 64, 34)],
                         ids=["parity", "stt", "odd", "small", "even"])
def test_peak_kernel_and_gather_equal_the_shifted_chain(card, shape, case):
    """Kernel (k) + the gather against ``fftshift`` + ``torch.argmax`` +
    the centroid on the card, bit for bit, at the parity route's surfaces
    and at odd and small ones (4-byte loads), with every planted case.
    One launch a call."""
    g, m, n = shape
    surf = _surfaces(case, (g,), m, n, seed=g + m + n, device=card)
    before = _build.LAUNCHES["surface_peak"]
    got = phasecorr.surface_peak(surf)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["surface_peak"] == before + 1
    assert torch.equal(got, _shifted_argmax(surf))
    assert _same_bits(phasecorr._peak_and_centroid(surf),
                      _shifted_centroid(surf))


@pytest.mark.cuda
def test_peak_kernel_on_the_inverse_transform(card):
    """Kernel (k) on a parity tile's real surfaces (noise spectra
    whitened and inverted) and on an unaligned copy of them."""
    fa = _noise_spectra((1, M, 1228), (M, N), 6, card)[:, None]
    fb = _noise_spectra((1, 4, M, 1228), (M, N), 7, card)
    surf = torch.fft.irfft2(phasecorr.whitened_crosspower(fa, fb), s=(M, N))
    want = _shifted_argmax(surf)
    assert torch.equal(phasecorr.surface_peak(surf), want)
    flat = torch.empty(surf.numel() + 1, device=card)
    flat[1:] = surf.reshape(-1)
    assert torch.equal(phasecorr.surface_peak(flat[1:].view(surf.shape)),
                       want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tiles", "batch"])
def test_phase_correlate_equals_the_replaced_chain(card, route):
    """``phase_correlate_tiles`` (a parity tile: one 16000 x 1228 PAN tile
    against 4 rolled band tiles) and ``phase_correlate_batch`` (10 stt
    windows of 16000 x 200) on the card: (dx, dy, response) bit for bit
    the replaced chain's, with one launch of (j) and one of (k)."""
    g = torch.Generator(device=card).manual_seed(8)
    if route == "tiles":
        a = torch.randint(0, 65536, (1, M, 1228), generator=g, device=card,
                          dtype=torch.int32).to(torch.float32)
        b = torch.stack([torch.roll(a, (k % 2, k - 1), (1, 2))
                         for k in range(4)], 1)
        fa = phasecorr.rfft2_padded(a, (M, N))[:, None]
        fb = phasecorr.rfft2_padded(b, (M, N))
        pad = (M, N)
    else:
        a = torch.randint(0, 65536, (10, SM, SN), generator=g, device=card,
                          dtype=torch.int32).to(torch.float32)
        b = torch.roll(a, (2, -3), (1, 2))
        fa, fb = (phasecorr.rfft2_padded(x, (SM, SN)) for x in (a, b))
        pad = (SM, SN)
    want = _replaced_chain(fa, fb, pad)
    del fa, fb
    before = dict(_build.LAUNCHES)
    fn = phasecorr.phase_correlate_tiles if route == "tiles" \
        else phasecorr.phase_correlate_batch
    got = fn(a, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["surface_crosspower"] == \
        before["surface_crosspower"] + 1
    assert _build.LAUNCHES["surface_peak"] == before["surface_peak"] + 1
    assert _same_bits(got, want)
