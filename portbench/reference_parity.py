"""The plain reference of the reference binary's own sample task: what
decides ``correct`` for configuration ``tj3_parity``.

``DOC/sample-task.sh`` steps 2-4 in the binary's default semantics, those
of the port's file commands without ``--fast``: ``prestitch``
(CalcSttParameters by full-surface ``cv::phaseCorrelate`` of the
uncorrected overlap strips, DoRRC, PreStitch's SectionaryRemap of 30000-row
sections with its rolling-buffer bottom cut), the default action with
``--do-rrc4pan`` (the 5 x 10 tile grid spaced by equal gaps, each band
tile brought up x4 by ``cv::resize`` INTER_CUBIC, full-surface
``cv::phaseCorrelate`` of each (tile, band) pair, the 0.4 filter, the
float64 fit, the alignment remap in overlapping sections) and ``stitch
-c``.  Written in plain PyTorch from the reference's description, beside
``reference.py`` (whose RRC and stt offsets it takes); it imports nothing
of the port and nothing of the JAX package, and computes in row blocks so
that a 160000-line scene fits on the card after the window.

Precision, as the configuration states it: float32 FFTs, cross-power and
centroid (the centroid's sum gets float64 eps rounded to float32, as
OpenCV's ``weightedCentroid``), a float64 least-squares fit, ``cv::resize``
and ``cv::remap``'s float32 cubic weights and sums (``cv::remap`` on
OpenCV 4.x's 1/32-px grid in quantized coordinates, or continuous ones),
uint16 rasters.  ``reference.Precision(low=True)`` computes each a step
lower: the whitened cross-power rounded to bfloat16, a float32 fit, the
resize and the remap in bfloat16 -- the control a sound comparison has to
refuse.

The rolling-buffer bottom cut is rebuilt as the port's parity route and
the JAX package rebuild it: the buffer's last ``2 * bcut + 8`` rows, the
final section's fresh rows and the previous section's below them,
remapped as a section of their own with map rows from 0; on the 1/32-px
grid that gives the compiled reference's bytes (``float32(y + dy)``
rounds alike), in continuous coordinates up to 2^-11 px off it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import reference as ref
from .scenes import upsample4

MSS_BANDS = 4
CORRELATION_LINES = 16000
MIN_PROCESS_LINES = 1500       # IBPA_MIN_PROCESSLINES (oipshared.h)
_EPS64_F32 = float(np.float32(np.finfo(np.float64).eps))
REMAP_ROWS = 2048              # output rows a step of the remap


# ---------------------------------------------------------------------------
# cv::phaseCorrelate over the whole surface
# ---------------------------------------------------------------------------

def optimal_dft_size(n: int) -> int:
    """``cv::getOptimalDFTSize``: the least 2^a 3^b 5^c >= n."""
    best = None
    p5 = 1
    while p5 < 2 * n:
        p3 = p5
        while p3 < 2 * n:
            p2 = p3
            while p2 < n:
                p2 *= 2
            best = p2 if best is None else min(best, p2)
            p3 *= 3
        p5 *= 5
    return max(1, best or 1)


def rrc_rows(x, kb, prec=ref.Precision(), rows: int = 4096):
    """``reference.rrc`` of the (..., L, W) uint16 ``x`` with ``kb``'s (k,
    b), ``rows`` lines at a time so that its float64 steps stay small."""
    out = torch.empty_like(x)
    for r0 in range(0, x.shape[-2], rows):
        out[..., r0:r0 + rows, :] = ref.rrc(x[..., r0:r0 + rows, :], *kb,
                                             prec)
    return out


def _round(x, prec):
    return x.to(torch.bfloat16).to(torch.float32) if prec.low else x


def phase_correlate(a, b, prec=ref.Precision()):
    """``cv::phaseCorrelate(a[i], b[i])`` of (n, H, W) float32 pairs, each
    zero-padded to the optimal DFT size: the cross-power ``Fa conj(Fb)``
    divided by its magnitude (1 where that is 0), the inverse transform,
    the quadrant swap, the first arg-max and the 5x5 weighted centroid
    around it, clipped at the surface's edges.  -> (dx, dy, response),
    each (n,) float32."""
    h, w = a.shape[-2:]
    M, N = optimal_dft_size(h), optimal_dft_size(w)
    fa = torch.fft.rfft2(F.pad(a, (0, N - w, 0, M - h)))
    fb = torch.fft.rfft2(F.pad(b, (0, N - w, 0, M - h)))
    pr = fa.real * fb.real + fa.imag * fb.imag
    pi = fa.imag * fb.real - fa.real * fb.imag
    del fa, fb
    mag = torch.sqrt(pr * pr + pi * pi)
    den = torch.where(mag == 0, torch.ones_like(mag), mag)
    c = torch.complex(_round(pr / den, prec), _round(pi / den, prec))
    del pr, pi, mag, den
    surf = torch.fft.fftshift(torch.fft.irfft2(c, s=(M, N)), dim=(-2, -1))
    del c
    n = surf.shape[0]
    peak = torch.argmax(surf.reshape(n, M * N), dim=1)
    py, px = (peak // N)[:, None, None], (peak % N)[:, None, None]
    # the 5 x 5 box around the peak, moved inside the surface, its cells
    # farther than 2 from the peak left out
    k = torch.arange(5, device=a.device)
    rr = torch.clamp(py - 2, 0, M - 5) + k[None, :, None]
    cc = torch.clamp(px - 2, 0, N - 5) + k[None, None, :]
    vals = surf[torch.arange(n, device=a.device)[:, None, None], rr, cc]
    near = ((rr - py).abs() <= 2) & ((cc - px).abs() <= 2)
    win = torch.where(near, vals, torch.zeros_like(vals))
    rs = win.sum(dim=(1, 2))
    cx = (win * cc.to(torch.float32)).sum(dim=(1, 2)) / (rs + _EPS64_F32)
    cy = (win * rr.to(torch.float32)).sum(dim=(1, 2)) / (rs + _EPS64_F32)
    dx, dy = N / 2.0 - cx, M / 2.0 - cy
    return dx, dy, rs


# ---------------------------------------------------------------------------
# registration: the reference's tile grid, cv::resize x4, the fit
# ---------------------------------------------------------------------------

def tile_grid(lines: int, width: int, slices: int, sections: int):
    """CalcInterBandCorrelation's grid (preproc.h:224-259): ``sections``
    blocks of ``min(lines, 16000)`` PAN lines spaced by equal gaps, the
    band blocks at the gaps divided by 4.  -> (PAN first lines, band first
    lines, PAN rows, band rows, columns, band columns)."""
    rows = min(lines, CORRELATION_LINES)
    gap = (lines - rows * sections) // (sections + 1)
    brows, bgap = rows // MSS_BANDS, gap // MSS_BANDS
    cols = width // slices
    return ([gap + s * (rows + gap) for s in range(sections)],
            [bgap + s * (brows + bgap) for s in range(sections)],
            rows, brows, cols, cols // MSS_BANDS)


def resize_x4(x, prec=ref.Precision()):
    """``cv::resize(x, 4x, INTER_CUBIC)``, float32 (bfloat16 in the
    control), edges replicated."""
    if prec.low:
        return upsample4(x.to(torch.bfloat16).to(torch.float32)).to(
            torch.bfloat16).to(torch.float32)
    return upsample4(x)


def fit(cx, y, deg: int, prec=ref.Precision()):
    """The least-squares polynomial of degree ``deg`` through (cx, y),
    ascending coefficients, float64 (float32 in the control)."""
    t = np.float32 if prec.low else np.float64
    v = np.vander(np.asarray(cx, t), deg + 1, increasing=True)
    c, *_ = np.linalg.lstsq(v, np.asarray(y, t), rcond=None)
    return c.astype(np.float64)


def register(pan, mss, pan_kb, mss_kb, slices: int, sections: int,
             threshold: float, prec=ref.Precision(), responses=None):
    """RAW ``pan`` (L, W) against RAW ``mss`` (4, L/4, W/4), both RRC'd:
    -> cx (4, 2), cy (4, 3) float64 and n_valid (4,) int32, on the host.
    Every (tile, band) response is appended to ``responses`` (a list)
    when it is given."""
    lines, width = pan.shape
    r0s, br0s, rows, brows, cols, bcols = tile_grid(lines, width, slices,
                                                    sections)
    if rows != MSS_BANDS * brows or cols != MSS_BANDS * bcols:
        raise ValueError("the reference resizes band tiles by 4 only")
    stats = []
    for r0, br0 in zip(r0s, br0s):
        p = rrc_rows(pan[r0:r0 + rows], pan_kb, prec)
        m = rrc_rows(mss[:, br0:br0 + brows], mss_kb, prec)
        for i in range(slices):
            pt = p[:, i * cols:(i + 1) * cols].to(torch.float32)
            up = resize_x4(m[:, :, i * bcols:(i + 1) * bcols].to(
                torch.float32), prec)
            stats.append(torch.stack(phase_correlate(
                pt.expand(MSS_BANDS, rows, cols), up, prec)))
    st = torch.stack(stats).cpu().numpy().astype(np.float64)  # (T, 3, 4)
    dx, dy, rs = st[:, 0], st[:, 1], st[:, 2]
    if responses is not None:
        responses.append(torch.from_numpy(rs))
    centers = np.array([i * cols + cols // 2 for i in range(slices)]
                       * sections, np.float64)
    ok = rs >= threshold
    cx = np.full((MSS_BANDS, 2), np.nan)
    cy = np.full((MSS_BANDS, 3), np.nan)
    for b in range(MSS_BANDS):
        if ok[:, b].sum() >= 3:
            cx[b] = fit(centers[ok[:, b]], dx[ok[:, b], b], 1, prec)
            cy[b] = fit(centers[ok[:, b]], dy[ok[:, b], b], 2, prec)
    return (torch.from_numpy(cx), torch.from_numpy(cy),
            torch.from_numpy(ok.sum(axis=0)).to(torch.int32))


def stt_estimate(pan1, pan2, sections: int, lps: int, overlap: int,
                 edge: int, threshold: float, max_delta_y: float,
                 prec=ref.Precision(), responses=None):
    """CalcSttParameters (stitcher.h:148-201) on the uncorrected strips:
    ``sections`` windows of ``lps`` lines, PAN1's right ``overlap``
    columns (less ``edge``) against PAN2's left ones, full-surface; the
    deltas of the windows whose response passes ``threshold`` (and |dy|
    <= ``max_delta_y`` where that is positive) averaged in float64.  ->
    (dx, dy, n_valid), host numbers."""
    lines, width = pan1.shape
    offs = ref.stt_offsets(lines, sections, lps)
    t1 = torch.stack([pan1[o:o + lps, width - overlap:width - edge]
                      for o in offs]).to(torch.float32)
    t2 = torch.stack([pan2[o:o + lps, edge:overlap]
                      for o in offs]).to(torch.float32)
    dxs, dys, rss = (v.cpu().numpy().astype(np.float64)
                     for v in phase_correlate(t1, t2, prec))
    if responses is not None:
        responses.append(torch.from_numpy(rss))
    sx = sy = 0.0
    n = 0
    for dx, dy, r in zip(dxs, dys, rss):
        if r >= threshold and (max_delta_y <= 0.0
                               or abs(dy) <= max_delta_y):
            sx += dx
            sy += dy
            n += 1
    return (sx / n, sy / n, n) if n else (0.0, 0.0, 0)


# ---------------------------------------------------------------------------
# cv::remap INTER_CUBIC, BORDER_CONSTANT 0, uint16, float32 maps
# ---------------------------------------------------------------------------

def remap(src, mapx_cols, g, quantized: bool, prec=ref.Precision(),
          first: int = 0, count: int | None = None):
    """Output rows ``[first, first + count)`` of ``cv::remap`` of the
    (rows, W) uint16 section ``src`` by the float32 maps ``mapx[y, x] =
    float32(mapx_cols[x])``, ``mapy[y, x] = float32(y + g[x])`` (float64
    sums): quantized, OpenCV 4.x's ``s = cvRound(32 m)``, tap ``(s >> 5) -
    1``, fraction ``(s & 31) / 32``; else ``floor(m) - 1`` and ``m -
    floor(m)``.  Each tap weight ``float32(wy[a] * wx[b])``, each tap row
    summed left to right and the rows in order, taps outside the section
    reading 0, rounded half to even and clamped."""
    rows, width = src.shape
    count = rows - first if count is None else count
    if rows + 8 > 32767:
        raise ValueError("quantized row coordinates would saturate")
    dev = src.device
    t = prec.resample
    mx = torch.as_tensor(np.asarray(mapx_cols, np.float64)).to(
        torch.float32).to(dev)
    g64 = torch.as_tensor(np.asarray(g, np.float64)).to(dev)
    ix, fx = _coords(mx, quantized)
    wx = torch.stack(ref._cubic_weights(fx))                 # (4, W)
    out = torch.empty((count, width), dtype=torch.uint16, device=dev)
    for y0 in range(first, first + count, REMAP_ROWS):
        y1 = min(y0 + REMAP_ROWS, first + count)
        y = torch.arange(y0, y1, device=dev, dtype=torch.float64)
        my = (y[:, None] + g64[None, :]).to(torch.float32)
        iy, fy = _coords(my, quantized)
        wy = ref._cubic_weights(fy)
        lo = int(iy.min()) - 1
        hi = int(iy.max()) + 3
        a, b = max(lo, 0), min(hi, rows)
        blk = torch.zeros((hi - lo, width + 8), dtype=torch.float32,
                          device=dev)
        if b > a:
            blk[a - lo:b - lo, 4:4 + width] = src[a:b].to(torch.float32)
        blk = blk.to(t)
        cols = torch.clamp(ix - 1 + 4, 0, width + 4)         # (W,)
        acc = None
        for ka in range(4):
            r = torch.clamp(iy - 1 + ka - lo, 0, hi - lo - 1)
            tap = None
            for kb in range(4):
                w = (wy[ka] * wx[kb][None, :]).to(t)
                v = blk[r, (cols + kb)[None, :].expand_as(r)] * w
                tap = v if tap is None else tap + v
            acc = tap if acc is None else acc + tap
        # a pixel whose 4x4 support lies wholly outside the section reads
        # the border value
        out_x = (ix - 1 >= width) | (ix + 3 <= 0)
        out_y = (iy - 1 >= rows) | (iy + 3 <= 0)
        acc = torch.where(out_x[None, :] | out_y, torch.zeros_like(acc), acc)
        out[y0 - first:y1 - first] = torch.clamp(
            torch.round(acc.to(torch.float32)), 0.0, 65535.0).to(
                torch.int32).to(torch.uint16)
    return out


def _coords(m, quantized: bool):
    """Integer part and float32 fraction of float32 map values."""
    if quantized:
        s = torch.round(m * 32.0).to(torch.int64)
        return s >> 5, (s & 31).to(torch.float32) * (1.0 / 32.0)
    fl = torch.floor(m)
    return fl.to(torch.int64), m - fl


# ---------------------------------------------------------------------------
# the two section loops and the stitch
# ---------------------------------------------------------------------------

def prestitch(pan2, kb2, dx: float, dy: float, section_rows: int,
              quantized: bool, prec=ref.Precision()):
    """PreStitch (stitcher.h:83-139) of RAW ``pan2``, RRC'd: SectionaryRemap
    by (dx, dy) in ``section_rows``-row sections, each section advancing
    by the rows it keeps between its upper cut (dy < 0: ``int(-dy) + 1``
    rows, kept by the first section) and its bottom cut (dy >= 0:
    ``int(dy) + 1`` rows); the bottom cut of a strip of 2 or more sections
    from the rolling buffer (module docstring), of a single section its
    own last rows.  -> (rows written, W) uint16."""
    lines, width = pan2.shape
    mapx = np.arange(width, dtype=np.float64) + float(dx)
    g = np.full(width, float(dy), np.float64)
    ucut = 0 if dy >= 0.0 else int(-dy) + 1
    bcut = int(dy) + 1 if dy >= 0.0 else 0
    parts = []
    offset = prev = final = 0
    n = 0
    while True:
        rows = min(section_rows, lines - offset)
        if rows <= ucut + bcut:
            break
        sec = rrc_rows(pan2[offset:offset + rows], kb2, prec)
        first = ucut if n else 0
        parts.append(remap(sec, mapx, g, quantized, prec, first,
                           rows - bcut - first))
        last = sec
        prev, final = final, offset
        offset += rows - ucut - bcut
        n += 1
    if bcut and n == 1:
        parts.append(remap(last, mapx, g, quantized, prec,
                           last.shape[0] - bcut, bcut))
    elif bcut and n:
        # the buffer's rows [w0, R): the final section's fresh rows, then
        # the previous section's rows that it did not overwrite
        w0 = max(0, section_rows - 2 * bcut - 8)
        fresh = min(lines - final, section_rows)
        buf = [pan2[final + j:final + j + 1] if j < fresh
               else pan2[prev + j:prev + j + 1]
               for j in range(w0, section_rows)]
        window = rrc_rows(torch.cat(buf), kb2, prec)
        parts.append(remap(window, mapx, g, quantized, prec,
                           window.shape[0] - bcut, bcut))
    return torch.cat(parts)


def align(mss, kb, cx, cy, line_per_section: int, overlap: int,
          quantized: bool, prec=ref.Precision()):
    """DoInterBandAlignment (preproc.h:351-425) of RAW ``mss`` (4, rows,
    W/4), RRC'd, at the fit (cx, cy): sections of ``line_per_section``
    lines advancing by ``line_per_section - overlap`` while at least 1500
    lines are left, each remapped with section-local maps ``mapx = (cx1 xx
    + cx0 + xx) / 4``, ``G = (cy2 xx^2 + cy1 xx + cy0) / 4`` (xx = 4x, in
    float64) and written without its first ``overlap`` rows; the rows past
    the last section 0.  -> (rows - overlap, W/4, 4) uint16."""
    bands, lines, bw = mss.shape
    xx = np.arange(bw, dtype=np.float64) * 4.0
    maps = []
    for b in range(bands):
        c_x = [float(v) for v in cx[b]]
        c_y = [float(v) for v in cy[b]]
        maps.append(((c_x[1] * xx + c_x[0] + xx) / 4.0,
                     (c_y[2] * xx * xx + c_y[1] * xx + c_y[0]) / 4.0))
    # zeros through int16: torch has few uint16 kernels on CUDA
    out = torch.zeros((max(0, lines - overlap), bw, bands),
                      dtype=torch.int16, device=mss.device).view(torch.uint16)
    offset = dst = 0
    while True:
        rows = min(lines - offset, line_per_section)
        if rows < MIN_PROCESS_LINES:
            break
        for b in range(bands):
            sec = rrc_rows(mss[b, offset:offset + rows], (kb[0][b], kb[1][b]),
                           prec)
            out[dst:dst + rows - overlap, :, b] = remap(
                sec, *maps[b], quantized, prec, overlap, rows - overlap)
        dst += rows - overlap
        offset += line_per_section - overlap
    return out


def stitch(pan1, kb1, prestt, fold: int, prec=ref.Precision(),
           rows_per_block: int = 8192):
    """StitchBigRaw (imageop.h:277-363): RRC(PAN1)'s left ``W - fold``
    columns beside the prestitched PAN2's columns from ``fold`` on."""
    lines, width = pan1.shape
    out = torch.empty((lines, 2 * (width - fold)), dtype=torch.uint16,
                      device=pan1.device)
    for r0 in range(0, lines, rows_per_block):
        r1 = min(lines, r0 + rows_per_block)
        out[r0:r1, :width - fold] = ref.rrc(pan1[r0:r1], *kb1, prec)[
            :, :width - fold]
        out[r0:r1, width - fold:] = prestt[r0:r1, fold:]
    return out
