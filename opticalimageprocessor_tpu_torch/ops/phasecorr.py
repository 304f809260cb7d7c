"""Phase correlation in PyTorch.

Counterpart of ``opticalimageprocessor_tpu/ops/phasecorr.py``: spectra
through ``torch.fft`` (cuFFT on the card) instead of the TPU's
DFT-as-matmul (``ops/fft_mxu``); the fast registration's pieces (the
spectral x4 band upsample, the windowed correlation peak with its 5x5
centroid) and the full-surface ``cv::phaseCorrelate``
(:func:`phase_correlate`, :func:`phase_correlate_batch`,
:func:`phase_correlate_tiles`) of the parity routes, each group of pairs
an ``oip.register.surface`` span and counted as ``surface_pairs``.
Spectra are complex tensors; the JAX functions' (re, im) pairs map to
``.real``/``.imag``.

A full surface goes from the half spectra to its peak with no plain-torch
pass over a full-size array on the card: kernel (j)
(``csrc/surface_crosspower.cu``, :func:`surface_crosspower`) whitens the
cross-power in one pass, cuFFT's ``irfft2`` inverts it, and kernel (k)
(``csrc/surface_peak.cu``, :func:`surface_peak`) finds the arg-max of the
fftshifted surface on the unshifted one, whose 5x5 centroid window is
then gathered at the rolled positions: no shifted copy is made.  CPU
tensors take the plain versions, :func:`whitened_crosspower` and
:func:`_surface_peak_plain`; the bits are the same either way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..utils.logging import count, span, to_device
from .resample import _X4_BASE, _X4_W

_EPS64_F32 = float(np.float32(np.finfo(np.float64).eps))
# float32 bytes of padded tiles per phase_correlate_batch group
_BATCH_BYTES = 1 << 30
# kernel (k)'s first stage: about this many blocks over all the surfaces
# of a call (~8 of 256 threads an SM of the H100's 132, one wave)
_PEAK_BLOCKS = 1024


def get_optimal_dft_size(n: int) -> int:
    """Smallest integer >= n whose only prime factors are 2, 3, 5
    (``cv::getOptimalDFTSize``).  Copied from
    ``opticalimageprocessor_tpu/ops/cv_exact.py::get_optimal_dft_size``
    (importing it would load jax)."""
    if n <= 1:
        return max(n, 1)
    best = None
    p5 = 1
    while p5 < n * 2:
        p53 = p5
        while p53 < n * 2:
            # smallest power of two >= n / p53
            q = max(0, -(-n // p53))
            p2 = 1
            while p2 < q:
                p2 <<= 1
            cand = p53 * p2
            if cand >= n and (best is None or cand < best):
                best = cand
            p53 *= 3
        p5 *= 5
    return int(best)


def rfft2_padded(x: torch.Tensor, pad_to: tuple[int, int]) -> torch.Tensor:
    """Zero-pad the last two dims to ``pad_to`` and rfft2 (complex64)."""
    h, w = x.shape[-2], x.shape[-1]
    M, N = pad_to
    p = F.pad(x.to(torch.float32), (0, N - w, 0, M - h))
    return torch.fft.rfft2(p)


def band_full_spectrum_small(band: torch.Tensor) -> torch.Tensor:
    """Full (not half) 2-D spectrum of small band tiles (complex64)."""
    return torch.fft.fft2(band.to(torch.float32))


@functools.lru_cache(maxsize=16)
def _upsample_filter_response(m: int, factor: int = 4):
    """DFT of the x4 cubic upsample kernel on the length ``factor*m`` grid,
    as (re, im) float32 numpy arrays.  Copied from
    ``opticalimageprocessor_tpu/ops/phasecorr.py::_upsample_filter_response``
    (importing it would load jax)."""
    big_n = factor * m
    taps = {}
    for r in range(factor):
        for c in range(4):
            taps[r - factor * (_X4_BASE[r] + c)] = float(_X4_W[r, c])
    k = np.arange(big_n, dtype=np.float64)
    re = np.zeros(big_n)
    im = np.zeros(big_n)
    for s, w in taps.items():
        ang = -2.0 * np.pi * k * s / big_n
        re += w * np.cos(ang)
        im += w * np.sin(ang)
    return re.astype(np.float32), im.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _eval_consts(n: int, keep: int, win: int, rows_axis: bool):
    """DFT-evaluation matrices (keep, 2*win+1) for the correlation surface
    at shifts [-win, win] (float64 trig, float32 storage).  Copied from
    ``opticalimageprocessor_tpu/ops/phasecorr.py::_eval_consts``."""
    k = np.arange(keep, dtype=np.float64)
    s = np.arange(-win, win + 1, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(k, s) / n
    cos = np.cos(ang)
    sin = np.sin(ang)
    if not rows_axis:
        # half-spectrum doubling along the W axis (kx=0 once; Nyquist once)
        wgt = np.full(keep, 2.0)
        wgt[0] = 1.0
        if n % 2 == 0 and keep == n // 2 + 1:
            wgt[-1] = 1.0
        cos = cos * wgt[:, None]
        sin = sin * wgt[:, None]
    return cos.astype(np.float32), sin.astype(np.float32)


@functools.lru_cache(maxsize=16)
def filter_response(m: int, factor: int, device) -> torch.Tensor:
    """:func:`_upsample_filter_response` as a complex64 tensor on
    ``device``, uploaded once per (shape, device); callers must not
    modify it."""
    re, im = _upsample_filter_response(m, factor)
    return to_device(torch.complex(torch.from_numpy(re),
                                   torch.from_numpy(im)), device)


@functools.lru_cache(maxsize=32)
def eval_consts(n: int, keep: int, win: int, rows_axis: bool, device):
    """:func:`_eval_consts` as float32 tensors on ``device``, uploaded once
    per (shape, device); callers must not modify them."""
    c, s = _eval_consts(n, keep, win, rows_axis)
    return to_device(c, device), to_device(s, device)


def upsampled_band_spectrum(band: torch.Tensor, factor: int = 4):
    """Half spectrum (factor*m, (factor*n)//2 + 1) of the x``factor``
    circular-cubic-upsampled band tile(s), computed spectrally:
    ``F_up[Ky,Kx] = Hr(Ky) Hc(Kx) F_band[Ky mod m, Kx mod n]``."""
    m, n = band.shape[-2], band.shape[-1]
    M, N = factor * m, factor * n
    keep = N // 2 + 1
    fb = band_full_spectrum_small(band)
    ky = torch.arange(M, device=band.device) % m
    kx = torch.arange(keep, device=band.device) % n
    ft = fb[..., ky, :][..., kx]
    hr = filter_response(m, factor, band.device)
    hc = filter_response(n, factor, band.device)[:keep]
    # complex multiply by Hr (per row) then Hc (per column)
    return ft * hr[:, None] * hc[None, :]


def clamp_win(win: tuple[int, int], pad_to: tuple[int, int]):
    """Clamp a (win_y, win_x) peak window to under half the tile (the
    windowed evaluation is circular: a window reaching dim/2 would alias)."""
    return (
        min(win[0], (pad_to[0] - 1) // 2),
        min(win[1], (pad_to[1] - 1) // 2),
    )


def whitened_crosspower(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """``C / |C|`` with ``C = fa * conj(fb)`` (|C| == 0 -> divide by 1)."""
    far, fai, fbr, fbi = fa.real, fa.imag, fb.real, fb.imag
    pr = far * fbr + fai * fbi
    pi = fai * fbr - far * fbi
    mag = torch.sqrt(pr * pr + pi * pi)
    den = torch.where(mag == 0, torch.ones_like(mag), mag)
    return torch.complex(pr / den, pi / den)


def _surface_crosspower_cuda(fa: torch.Tensor,
                             fb: torch.Tensor) -> torch.Tensor:
    if fa.dtype != torch.complex64 or fb.dtype != torch.complex64:
        raise ValueError(f"surface_crosspower: complex64 spectra only, got "
                         f"{fa.dtype} and {fb.dtype}")
    if not fa.is_contiguous() or not fb.is_contiguous():
        raise ValueError("surface_crosspower: the spectra must be "
                         "contiguous")
    if fb.dim() < 2 or fa.dim() != fb.dim() or fa.shape[-2:] != fb.shape[-2:]:
        raise ValueError(f"surface_crosspower: spectra {tuple(fa.shape)} "
                         f"and {tuple(fb.shape)} do not pair")
    plane = fb.shape[-2] * fb.shape[-1]
    if fa.shape == fb.shape:
        outer, bands = fb.numel() // max(plane, 1), 1
    elif fb.dim() >= 3 and fa.shape[-3] == 1 \
            and fa.shape[:-3] == fb.shape[:-3]:
        bands = fb.shape[-3]
        outer = fa.numel() // max(plane, 1)
    else:
        raise ValueError(
            f"surface_crosspower: fa {tuple(fa.shape)} must have fb's shape "
            f"{tuple(fb.shape)}, or fb's with one band in dim -3")
    _build.require_cuda("surface_crosspower", fa, fb)
    out = torch.empty(fb.shape, dtype=torch.complex64, device=fb.device)
    if out.numel():
        _build.launch(
            "surface_crosspower", "oip_surface_crosspower", fa.data_ptr(),
            fb.data_ptr(), out.data_ptr(), outer, bands, plane,
            _build.stream_of(fb), device=fb.device)
    return out


def surface_crosspower(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """:func:`whitened_crosspower` of the full surfaces' half spectra, in
    ``fb``'s shape, contiguous: ``fa`` has ``fb``'s shape, or one band
    (dim -3 of 1) broadcast over ``fb``'s.  Kernel (j) on CUDA tensors (one
    launch, ``fa`` read once whatever the band count), the plain version
    on CPU tensors; the bits are the same."""
    if fa.device.type == "cpu":
        return whitened_crosspower(fa, fb)
    return _surface_crosspower_cuda(fa, fb)


def contract_rows(dr, di, M: int, N: int, win_y: int):
    """ky -> window rows: ``Re((dr + i di)(cos + i sin))`` summed over ky
    against the (M, 2*win_y+1) evaluation matrices, / (M*N).  ``dr``/``di``:
    (..., M, wx) -> (..., 2*win_y+1, wx)."""
    cy_c, cy_s = eval_consts(M, M, win_y, True, dr.device)
    return (
        torch.matmul(cy_c.T, dr) - torch.matmul(cy_s.T, di)
    ) / float(M * N)


def peak_from_spectra_windowed(
    fa: torch.Tensor, fb: torch.Tensor, pad_to: tuple[int, int],
    win_y: int = 64, win_x: int = 64,
):
    """Fast-mode peak: the normalised correlation surface evaluated only at
    shifts |dy| <= win_y, |dx| <= win_x (two small matmuls against DFT
    evaluation matrices), then arg-max + 5x5 centroid.  ``fa``/``fb``:
    (..., M, keep) complex half spectra.  Returns (dx, dy, response)
    shaped like the batch dims."""
    M, N = pad_to
    keep = fa.shape[-1]
    c = whitened_crosspower(fa, fb)
    cx_c, cx_s = eval_consts(N, keep, win_x, False, fa.device)
    cr, ci = c.real, c.imag
    dr = torch.matmul(cr, cx_c) - torch.matmul(ci, cx_s)
    di = torch.matmul(ci, cx_c) + torch.matmul(cr, cx_s)
    return _centroid_on_window(contract_rows(dr, di, M, N, win_y),
                               win_y, win_x)


def _centroid_on_window(corr: torch.Tensor, win_y: int, win_x: int):
    """Arg-max + 5x5 weighted centroid on (..., 2*win_y+1, 2*win_x+1)
    windowed surfaces; returns (dx, dy, response), each shaped like the
    batch dims."""
    cxc, cyc, s = _argmax_centroid(corr)
    # window coordinate w maps to shift s = w - win (cv::phaseCorrelate sign)
    return cxc - win_x, cyc - win_y, s


def _peak_and_centroid(surf: torch.Tensor):
    """Arg-max + 5x5 centroid of full surfaces in their fftshifted order
    (``cv::phaseCorrelate``), read from the unshifted (..., M, N) ``surf``
    that the inverse transform gives: the peak by :func:`surface_peak`,
    the window's values gathered where the shift put them.  -> (dx, dy,
    response) shaped like the batch dims."""
    M, N = surf.shape[-2], surf.shape[-1]
    cxc, cyc, s = _centroid_5x5(surf, surface_peak(surf), (M // 2, N // 2))
    return N / 2.0 - cxc, M / 2.0 - cyc, s


def _surface_peak_plain(surf: torch.Tensor) -> torch.Tensor:
    """:func:`surface_peak` in plain torch: each surface's largest value
    (NaN above all, as ``torch.argmax`` takes it) and, of the samples that
    hold it, the smallest shifted index (``torch.fft.fftshift`` rolls by
    (M // 2, N // 2)): the first shifted row that holds one, then the
    first shifted column of that row.  One boolean plane besides the
    input, no shifted copy."""
    M, N = surf.shape[-2], surf.shape[-1]
    s = surf.reshape(-1, M, N)
    top = s.amax(dim=(1, 2), keepdim=True)
    hit = torch.where(top.isnan(), s.isnan(), s == top)
    rows = (torch.arange(M, device=surf.device) + M // 2) % M
    cols = (torch.arange(N, device=surf.device) + N // 2) % N
    row = torch.where(hit.any(dim=2), rows, M).amin(dim=1)
    line = hit[torch.arange(s.shape[0], device=surf.device),
               (row - M // 2) % M]
    return row * N + torch.where(line, cols, N).amin(dim=1)


def _peak_slices(surfaces: int, rows: int) -> tuple[int, int]:
    """Kernel (k)'s first stage: rows a block (a multiple of 4) and blocks
    a surface, about :data:`_PEAK_BLOCKS` blocks in all."""
    per = max(1, -(-_PEAK_BLOCKS // max(surfaces, 1)))
    rows_per_block = -(-rows // per)
    rows_per_block += -rows_per_block % 4
    return rows_per_block, -(-rows // rows_per_block)


def _surface_peak_cuda(surf: torch.Tensor) -> torch.Tensor:
    if surf.dtype != torch.float32:
        raise ValueError(f"surface_peak: float32 surfaces only, got "
                         f"{surf.dtype}")
    if surf.dim() < 2 or not surf.is_contiguous():
        raise ValueError(f"surface_peak: a contiguous (..., M, N) stack, "
                         f"got {tuple(surf.shape)}")
    M, N = surf.shape[-2], surf.shape[-1]
    if M * N > 1 << 30:
        raise ValueError(f"surface_peak: {M} x {N} surfaces exceed the "
                         "kernel's 2^30 samples")
    _build.require_cuda("surface_peak", surf)
    surfaces = surf.numel() // max(M * N, 1)
    out = torch.empty(surfaces, dtype=torch.int64, device=surf.device)
    if surfaces and M * N:
        rows_per_block, chunks = _peak_slices(surfaces, M)
        scratch = torch.empty(2 * surfaces * chunks, dtype=torch.int32,
                              device=surf.device)
        _build.launch(
            "surface_peak", "oip_surface_peak", surf.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), surfaces, M, N,
            rows_per_block, chunks, _build.stream_of(surf),
            device=surf.device)
    return out


def surface_peak(surf: torch.Tensor) -> torch.Tensor:
    """The first maximum of each (M, N) surface of ``surf`` (..., M, N) in
    fftshifted row-major order, as ``torch.argmax`` finds it on the
    shifted copy, read from the unshifted surfaces: its linear index in
    the shifted surface, int64 (prod(batch),).  Kernel (k) on CUDA
    tensors (one launch a call), :func:`_surface_peak_plain` on CPU
    tensors."""
    if surf.device.type == "cpu":
        return _surface_peak_plain(surf)
    return _surface_peak_cuda(surf)


def _argmax_centroid(corr: torch.Tensor):
    """Arg-max (row-major first maximum, like ``cv::minMaxLoc`` and
    ``jnp.argmax``) + the 5x5 weighted centroid around it
    (:func:`_centroid_5x5`) of (..., H, W) surfaces."""
    wy, wx = corr.shape[-2], corr.shape[-1]
    return _centroid_5x5(corr, torch.argmax(corr.reshape(-1, wy * wx), dim=1))


def _centroid_5x5(surf: torch.Tensor, peak: torch.Tensor,
                  roll: tuple[int, int] = (0, 0)):
    """The 5x5 weighted centroid around ``peak`` (each surface's linear
    index, (prod(batch),)), clipped at the surface's edges, of the (...,
    H, W) surfaces ``surf`` rolled by ``roll``: the value at (r, c) is
    read from ``surf`` at ((r - roll[0]) mod H, (c - roll[1]) mod W).
    Returns the centroid's (column, row) and the window sum, each shaped
    like the batch dims.  The sum gets float64 eps (as float32) before
    dividing, like OpenCV's weightedCentroid."""
    wy, wx = surf.shape[-2], surf.shape[-1]
    batch = surf.shape[:-2]
    py = peak // wx
    px = peak % wx
    start_r = torch.clamp(py - 2, 0, wy - 5)
    start_c = torch.clamp(px - 2, 0, wx - 5)
    ar = torch.arange(5, device=surf.device)
    rr = start_r[:, None, None] + ar[None, :, None]        # (B, 5, 1)
    cc = start_c[:, None, None] + ar[None, None, :]        # (B, 1, 5)
    win = surf.reshape(-1, wy, wx)
    bidx = torch.arange(win.shape[0], device=surf.device)[:, None, None]
    vals = win[bidx, (rr - roll[0]) % wy, (cc - roll[1]) % wx]  # (B, 5, 5)
    valid = (
        (rr >= py[:, None, None] - 2) & (rr <= py[:, None, None] + 2)
        & (cc >= px[:, None, None] - 2) & (cc <= px[:, None, None] + 2)
    )
    winm = torch.where(valid, vals, torch.zeros_like(vals))
    s = winm.sum(dim=(1, 2))
    s_eps = s + _EPS64_F32
    cxc = (winm * cc.to(winm.dtype)).sum(dim=(1, 2)) / s_eps
    cyc = (winm * rr.to(winm.dtype)).sum(dim=(1, 2)) / s_eps
    return cxc.reshape(batch), cyc.reshape(batch), s.reshape(batch)


def peak_from_spectra(fa: torch.Tensor, fb: torch.Tensor,
                      pad_to: tuple[int, int]):
    """Cross-power spectrum -> correlation peak (dx, dy, response), given
    the (..., M, N//2 + 1) half spectra of the two tiles (``fa`` may have
    one band where ``fb`` has several, :func:`surface_crosspower`):
    whitened cross-power, inverse rfft2, then the arg-max and 5x5 centroid
    of the fftshifted surface, read from the unshifted one."""
    M, N = pad_to
    return _peak_and_centroid(
        torch.fft.irfft2(surface_crosspower(fa, fb), s=(M, N)))


def phase_correlate(a, b):
    """``cv::phaseCorrelate`` of one (H, W) pair, zero-padded to the
    optimal DFT size; returns python floats (dx, dy, response)."""
    dx, dy, r = phase_correlate_batch(torch.as_tensor(a)[None],
                                      torch.as_tensor(b)[None])
    return float(dx[0]), float(dy[0]), float(r[0])


def phase_correlate_batch(a: torch.Tensor, b: torch.Tensor):
    """``cv::phaseCorrelate`` over a leading axis: (T, H, W) x (T, H, W)
    -> (dx[T], dy[T], response[T]) float32 tensors on the inputs' device.
    Tiles go through the transforms in groups of about
    :data:`_BATCH_BYTES` of padded float32, bounding device memory."""
    T, h, w = a.shape
    M, N = get_optimal_dft_size(h), get_optimal_dft_size(w)
    group = max(1, _BATCH_BYTES // (4 * M * N))
    outs = []
    for i in range(0, T, group):
        with span("oip.register.surface", a.device):
            fa = rfft2_padded(a[i:i + group], (M, N))
            fb = rfft2_padded(b[i:i + group], (M, N))
            outs.append(peak_from_spectra(fa, fb, (M, N)))
            del fa, fb
        count("surface_pairs", min(group, T - i))
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def phase_correlate_tiles(a: torch.Tensor, b: torch.Tensor):
    """``cv::phaseCorrelate(a[t], b[t, j])`` of every (tile, band) pair:
    ``a`` (T, H, W) against ``b`` (T, B, H, W) -> (dx, dy, response), each
    (T, B) float32.  The values of :func:`phase_correlate_batch` on ``a``
    repeated B times a tile, with each tile's spectrum taken once; all T
    tiles in one group (the caller bounds T)."""
    T, B, h, w = b.shape
    M, N = get_optimal_dft_size(h), get_optimal_dft_size(w)
    with span("oip.register.surface", a.device):
        fa = rfft2_padded(a, (M, N))[:, None]
        fb = rfft2_padded(b, (M, N))
        out = peak_from_spectra(fa, fb, (M, N))
    count("surface_pairs", T * B)
    return out
