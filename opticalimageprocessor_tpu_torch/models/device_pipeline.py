"""The single-device scene pipeline (the port's main path).

Counterpart of ``opticalimageprocessor_tpu/models/device_pipeline.py``.
Per scene:

  estimate:  registration -- (section, slice) tiles of PAN1 and the 4 MSS
             bands, RRC'd inline and written as float32 into one tile
             stack each (kernel (h)), one batched rfft2 of the PAN tiles
             and one fft2 of the band tiles (kernel (i)'s row DFTs and
             cuFFT's column transforms), the fused
             windowed cross-power of every (tile, band) (kernel (b)), the
             5x5 centroid, the 0.4 response filter and a float64 weighted
             polynomial fit; then the stt estimate on the uncorrected CMOS
             overlap strips
  transform: RRC of the 4 bands (kernel (a)), the 4 alignment resamples
             into the interleaved raster (one kernel-(c) launch), and the
             stitch tail: RRC of both PANs, the prestitch translation of
             PAN2 and the seam concat (kernel (d))

:class:`MssAlign` aligns CMOS2's MSS against the prestitched PAN2 the same
way (RRC, registration, one kernel-(c) launch at row bound 6), and
:class:`DualScenePipeline` runs the reference's whole sample task on one
device: the scene, CMOS2's MSS aligned against its prestitched PAN2, and
the two aligned rasters stitched at the seam (:func:`stitch_mss_seam`).

The estimate is written once, for every route: :func:`register_rows` and
:func:`stt_rows` take their rows from a row source -- the resident strip
(:class:`StripRows`, views), the strip file (``models/scene_stream``,
uploads of the sampled rows) or the line-sharded strip
(``parallel/sharded_scene``, ``LineSharded.fetch``) -- and split the tiles
and windows over the sources' device slots, so every route cuts the same
tiles and gets the resident route's estimates bit for bit.

:class:`ParityScenePipeline` runs the same sample task in the reference
binary's own semantics, those of the file commands' parity route
(``prestitch``, the default action with ``--do-rrc4pan``, ``stitch``), on
resident strips: the same two drivers with the reference's tile grid
(:func:`reference_geometry`), full-surface ``cv::phaseCorrelate`` of the
x4 ``cv::resize``'d band tiles (:func:`correlate_surfaces`) and of the
stt windows, the file routes' float64 fit and average on the host, then
``cv::remap`` INTER_CUBIC (kernel (f)) over the reference's two section
loops and the seam concat.

The JAX package's TPU workarounds are not ported: cuFFT replaces the DFT
done as matrix multiplies (``ops/fft_mxu``) and float64 the double-word
float32 fit (``ops/ddf32``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..constants import (
    CORRELATION_LINES,
    IBCV_DEF_THRESHOLD,
    IBCV_MIN_COUNT,
    IBCV_MIN_SLICES,
    IBPA_DEFAULT_BATCHLINES,
    IBPA_DEFAULT_LINEOVERLAP,
    IBPA_MAX_LINEOVERLAP,
    IBPA_MIN_PROCESSLINES,
    MSS_BANDS,
    REMAP_SECTION_ROWS,
    STT_DEF_SECLINES,
)

from ..ops import phasecorr, polyfit, row_fft
from ..ops.phasecorr_cuda import windowed_crosspower_fused_tiles
from ..ops.resample import (
    SectionCut,
    ibpa_plan,
    plan_for_band_alignment,
    plan_for_constant_shift,
    prepare_remap_section,
    remap_bands_interleaved,
    remap_const_stitch_chunked,
    remap_section_u16,
    resize_cubic_f32,
    sectionary_plan,
    upsample4_f32,
)
from ..ops.rrc import rrc_apply
from ..ops.tile_stack import write_tiles
from ..utils.logging import SCENE_SPAN, count, olog, rlog, span, to_host

RRCParams = tuple[torch.Tensor, torch.Tensor]


def _fit_poly(cx: torch.Tensor, y: torch.Tensor, deg: int,
              w: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted least-squares polynomial fit in float64 (ascending
    coefficients, returned as float32).

    ``cx``/``y``/``w``: (..., T); the weighted normal equations are solved
    on x normalised by an exact power of two, batched over the leading
    dims.  A singular system (too few valid samples) yields non-finite
    coefficients rather than an error: the caller's count check reports
    it the reference's way."""
    f64 = torch.float64
    scale = 1.0 / 4096.0
    xn = cx.to(f64) * scale
    y = y.to(f64)
    w = torch.ones_like(xn) if w is None else w.to(f64)
    xn, y = torch.broadcast_tensors(xn, y)
    w = w.expand_as(xn)
    powers = [torch.ones_like(xn)]
    for _ in range(deg):
        powers.append(powers[-1] * xn)
    v = torch.stack(powers, dim=-1)                       # (..., T, d+1)
    vw = v * w[..., None]
    a = vw.transpose(-1, -2) @ v                          # (..., d+1, d+1)
    r = (vw.transpose(-1, -2) @ y[..., None])[..., 0]     # (..., d+1)
    c, _info = torch.linalg.solve_ex(a, r)
    k = torch.arange(deg + 1, dtype=f64, device=c.device)
    return (c * scale ** k).to(torch.float32)


def _cols(params, c0: int, c1: int):
    """Columns ``[c0, c1)`` of RRC parameters ``(k, b)`` (None stays
    None)."""
    return None if params is None else tuple(v[..., c0:c1] for v in params)


@dataclass(frozen=True)
class RegGeometry:
    """Where registration samples a (lines, width) PAN strip: ``n_sections``
    row blocks of ``corr_rows`` lines, ``sec_stride`` apart from line
    ``first_row``, each cut into ``slices`` tiles of ``cols`` columns; the
    band tiles are ``brows`` x ``bcols`` at the same place in band pixels
    (the PAN line over 4), or, with ``band_stride``, ``band_stride`` apart
    from band line ``band_first_row`` (the reference's own bookkeeping,
    :func:`reference_geometry`)."""

    slices: int
    n_sections: int
    corr_rows: int
    sec_stride: int
    cols: int
    bcols: int
    brows: int
    first_row: int = 0
    band_first_row: int = 0
    band_stride: int | None = None

    def row0(self, sec: int) -> int:
        """First PAN line of section ``sec``'s row block."""
        return self.first_row + sec * self.sec_stride

    def band_row0(self, sec: int) -> int:
        """First band line of section ``sec``'s row block."""
        if self.band_stride is None:
            return self.row0(sec) // MSS_BANDS
        return self.band_first_row + sec * self.band_stride


def register_geometry(lines_pan: int, width: int, slices: int = 10,
                      n_sections: int | None = None) -> RegGeometry:
    """The sampling geometry of :func:`register_fast` on a (lines_pan,
    width) PAN strip."""
    corr_rows = min(lines_pan, CORRELATION_LINES)
    corr_rows = max(64, corr_rows - corr_rows % 64)
    if n_sections is None:
        n_sections = max(1, min(5, lines_pan // CORRELATION_LINES))
    cols = width // slices
    if cols % MSS_BANDS:
        raise ValueError(
            f"slice width {cols} (= {width} // {slices}) is not a multiple "
            f"of {MSS_BANDS}"
        )
    sec_stride = (
        (lines_pan - corr_rows) // max(1, n_sections - 1)
        if n_sections > 1 else 0
    )
    return RegGeometry(slices, n_sections, corr_rows, sec_stride, cols,
                       cols // MSS_BANDS, corr_rows // MSS_BANDS)


def ibc_geometry(lines_pan: int, width: int, slices: int, sections: int):
    """The reference's sections x slices tile grid and its argument checks
    (CalcInterBandCorrelation, preproc.h:224-259): ``min(lines, 16000)``-line
    windows spaced by equal gaps along the strip, each cut into ``slices``
    column slices; the MSS window offsets use the same integer-divided-by-4
    bookkeeping.  -> (r0s, br0s, base_rows, band_rows, cols, band_cols,
    centers), ``centers[t]`` the slice-centre x of tile ``t``
    (section-major, slice-minor: the reference's sample order)."""
    if slices < IBCV_MIN_SLICES:
        raise ValueError(
            f"CalcInterBandCorrelation: at lease {IBCV_MIN_SLICES} "
            "slice needed"
        )
    if sections <= 0:
        raise ValueError(
            "CalcInterBandCorrelation: section count should be a "
            "positive integer"
        )
    if sections > 1 and sections * CORRELATION_LINES > lines_pan:
        raise ValueError(
            "CalcInterBandCorrelation: too many sections "
            f"({CORRELATION_LINES} lines per section), not enough total "
            "PAN data lines"
        )
    base_rows = min(lines_pan, CORRELATION_LINES)
    base_gap = (lines_pan - base_rows * sections) // (sections + 1)
    cols = width // slices
    band_rows = base_rows // MSS_BANDS
    band_gap = base_gap // MSS_BANDS
    band_cols = cols // MSS_BANDS
    r0s = [base_gap + sec * (base_rows + base_gap) for sec in range(sections)]
    br0s = [band_gap + sec * (band_rows + band_gap) for sec in range(sections)]
    centers = [i * cols + cols // 2 for i in range(slices)] * sections
    return r0s, br0s, base_rows, band_rows, cols, band_cols, centers


def reference_geometry(lines_pan: int, width: int, slices: int,
                       sections: int) -> RegGeometry:
    """The reference's tile grid (:func:`ibc_geometry`, with its argument
    checks) as a :class:`RegGeometry`: ``min(lines, 16000)``-line row
    blocks, unrounded, spaced by equal gaps from the first gap on, the
    band blocks at the reference's own integer-divided gaps."""
    r0s, br0s, base_rows, band_rows, cols, band_cols, _ = ibc_geometry(
        lines_pan, width, slices, sections)
    return RegGeometry(slices, sections, base_rows, base_rows + r0s[0],
                       cols, band_cols, band_rows, first_row=r0s[0],
                       band_first_row=br0s[0],
                       band_stride=band_rows + br0s[0])


def tile_blocks(n_tiles: int, n_slots: int) -> list[tuple[int, int]]:
    """Contiguous blocks of a tile axis, one a device slot, ``ceil(n_tiles /
    n_slots)`` tiles each, the last ones shorter or empty: JAX rounds the
    axis up to a multiple of the device count (``_pad_tile_axis``) and
    gives device ``d`` tiles ``[d * per, (d + 1) * per)``; the padded tiles
    are not computed here, so none can enter a fit."""
    per = -(-n_tiles // n_slots)
    return [(min(d * per, n_tiles), min((d + 1) * per, n_tiles))
            for d in range(n_slots)]


def tile_runs(blocks, slices):
    """``(slot, section, first slice, end slice)`` of each run of tiles of
    one section in the contiguous tile blocks (``blocks[d]``: slot ``d``'s
    ``[t0, t1)``), in block order.  One slot gets one run a section, over
    every slice, in section order."""
    runs = []
    for d, (t0, t1) in enumerate(blocks):
        for sec in range(t0 // slices, -(-t1 // slices)):
            runs.append((d, sec, max(t0 - sec * slices, 0),
                         min(t1 - sec * slices, slices)))
    return runs


class StripRows:
    """A strip as a row source, the contract of ``parallel.mesh.
    LineSharded.fetch``: ``fetch(plan)`` yields, for each ``(slot, a, b,
    (c0, c1))`` entry in plan order, rows ``[a, b)`` (the second-to-last
    axis) and columns ``[c0, c1)`` of ``strip``; of a tensor these are
    views, no copy."""

    def __init__(self, strip):
        self.strip = strip
        self.shape = tuple(strip.shape)

    def fetch(self, plan):
        return (self.strip[..., a:b, c0:c1]
                for _slot, a, b, (c0, c1) in plan)


def _one_block(outs):
    """The statistics of the only block of a one-slot plan, as they are."""
    (stats,) = outs
    return stats


def _first(devices):
    return next(d for d in devices if d is not None)


def correlate_tiles(geom: RegGeometry, stacks,
                    win: tuple[int, int] = (64, 64)):
    """The correlation of one slot's block of tiles: ``stacks``, the list
    of its float32 PAN tile stack (n, corr_rows, cols) and band tile stack
    (n, 4, brows, bcols), emptied as it is taken so that each stack is
    freed once its row DFTs are taken; the PAN tiles' rfft2 (the tile is
    the padded size: no pad) and the band tiles' fft2 (on the card kernel
    (i)'s row DFTs and cuFFT's column transforms, ``ops/row_fft``) and one
    kernel-(b) launch.  -> ``(dx, dy, rs)``, each (T, 4) float32."""
    pad = (geom.corr_rows, geom.cols)
    win = phasecorr.clamp_win(win, pad)
    if tuple(stacks[0].shape[-2:]) != pad:
        raise ValueError(f"PAN tiles {tuple(stacks[0].shape[-2:])} are not "
                         f"the correlation's {pad}")
    dev = stacks[0].device
    with span("oip.register.spectra", dev):
        fpan, fband = row_fft.take_spectra(stacks)
    with span("oip.register.correlate", dev):
        return windowed_crosspower_fused_tiles(
            fpan, fband, pad, geom.brows, win[0], win[1]
        )


def fit_tiles(geom: RegGeometry, dx, dy, rs,
              threshold: float = IBCV_DEF_THRESHOLD):
    """The fit of the registration: the (T, 4) statistics of
    every (section, slice) tile in section order -> ``(coeffs,
    n_valid)``."""
    with span("oip.register.fit", dx.device):
        cx = (
            torch.arange(geom.slices, device=dx.device) * geom.cols
            + geom.cols // 2
        ).to(torch.float32).repeat(geom.n_sections)
        w = (rs.T >= threshold).to(torch.float32)             # (4, T)
        n_valid = w.sum(dim=1).to(torch.int32)
        coeff_x = _fit_poly(cx, dx.T, 1, w)
        coeff_y = _fit_poly(cx, dy.T, 2, w)
    return [(coeff_x[b], coeff_y[b]) for b in range(MSS_BANDS)], n_valid


def correlate_surfaces(geom: RegGeometry, stacks, win=None):
    """The reference's correlation of one slot's block of tiles
    (CalcInterBandCorrelation, preproc.h:260-347): ``stacks`` as
    :func:`correlate_tiles` takes them, one tile at a time (its 4 band
    tiles brought up x4 by ``cv::resize`` INTER_CUBIC,
    :func:`~..ops.resample.upsample4_f32`, or to the PAN tile's size where
    that is not 4 times theirs, in an ``oip.upsample`` span), then the
    full-surface ``cv::phaseCorrelate`` of the PAN tile against each
    (:func:`~..ops.phasecorr.phase_correlate_tiles`): the file route's
    one tile a group, so the bits match it wherever an FFT's do not depend
    on its batch.  ``win`` is unused (the whole surface is searched).  ->
    ``(dx, dy, rs)``, each (T, 4) float32."""
    pan, bands = stacks
    stacks.clear()
    h, w = pan.shape[-2:]
    outs = []
    for t in range(pan.shape[0]):
        with span("oip.upsample", pan.device):
            band = bands[t:t + 1]
            if band.shape[-2] * MSS_BANDS == h and \
                    band.shape[-1] * MSS_BANDS == w:
                up = upsample4_f32(band)
            else:
                up = resize_cubic_f32(band, h, w)
        outs.append(phasecorr.phase_correlate_tiles(pan[t:t + 1], up))
        del up
    return tuple(torch.cat([o[k] for o in outs]) for k in range(3))


def fit_tiles_host(geom: RegGeometry, dx, dy, rs,
                   threshold: float = IBCV_DEF_THRESHOLD):
    """The file route's filter and fit of the registration
    (``PreProcessor._fit``, preproc.h:492-550): the (T, 4) statistics read
    back to the host, each band's samples with response >= ``threshold``
    fitted in float64 by ``ops/polyfit`` (the reference's error where
    fewer than IBCV_MIN_COUNT pass).  -> ``(coeffs, n_valid)`` as
    :func:`fit_tiles` gives them, float64 on the CPU."""
    with span("oip.register.fit", dx.device):
        stats = to_host(torch.stack([dx, dy, rs])).numpy().astype(np.float64)
        centers = np.array([i * geom.cols + geom.cols // 2
                            for i in range(geom.slices)] * geom.n_sections,
                           np.float64)
        coeffs = [tuple(torch.from_numpy(c) for c in
                        polyfit.fit_shift_models_filtered(
                            centers, stats[0][:, b], stats[1][:, b],
                            stats[2][:, b], threshold, b + 1))
                  for b in range(MSS_BANDS)]
        n_valid = torch.from_numpy((stats[2] >= threshold).sum(axis=0)).to(
            torch.int32)
    return coeffs, n_valid


def register_rows(geom: RegGeometry, pan, bands, devices,
                  rrc: dict | None = None, gather=_one_block,
                  win: tuple[int, int] = (64, 64),
                  threshold: float = IBCV_DEF_THRESHOLD,
                  correlate=None, fit=None):
    """The registration on row sources (:class:`StripRows`, a strip file's
    uploads, a ``parallel.mesh.LineSharded``): ``pan`` (L, W) and ``bands``
    (4, L/4, W/4) uint16, RAW where ``rrc[device]`` gives their ``(k, b)``
    (``(pan params | None, band params | None)``) -- each tile is then RRC'd
    as it is cut -- or already corrected.

    The (section, slice) tiles are split over the ``devices`` slots in
    contiguous blocks (:func:`tile_blocks`; a slot of None is another
    process's and is skipped).  Each block is cut from the rows its slot
    fetches, a run of tiles a section, straight into one float32 stack of
    its PAN tiles and one of its band tiles (:func:`write_tiles`), and
    correlated on its device by ``correlate`` (by default
    :func:`correlate_tiles`; the reference's :func:`correlate_surfaces`)
    before the next block's rows are taken, so one block's tiles are alive
    at a time.  ``gather`` takes the blocks' (dx, dy, rs) to one (T, 4)
    each in tile order, and ``fit`` (by default :func:`fit_tiles`;
    :func:`fit_tiles_host`) fits them.  -> ``(cx (4, 2), cy (4, 3),
    n_valid (4,))``.  Plans that cut the same tiles give bit-identical
    estimates wherever the FFTs' bits do not depend on their batch."""
    # the defaults are looked up at call time, where a caller may have
    # replaced them
    correlate = correlate or correlate_tiles
    fit = fit or fit_tiles
    runs = tile_runs(tile_blocks(geom.n_sections * geom.slices,
                                 len(devices)), geom.slices)
    pan_blks = pan.fetch([
        (d, geom.row0(sec), geom.row0(sec) + geom.corr_rows,
         (i0 * geom.cols, i1 * geom.cols)) for d, sec, i0, i1 in runs])
    band_blks = bands.fetch([
        (d, geom.band_row0(sec), geom.band_row0(sec) + geom.brows,
         (i0 * geom.bcols, i1 * geom.bcols)) for d, sec, i0, i1 in runs])
    stats = []
    for d, block in itertools.groupby(runs, key=lambda r: r[0]):
        dev = devices[d]
        if dev is None:
            for _run in block:
                next(pan_blks), next(band_blks)
            continue
        block = list(block)
        pp, bp = rrc[dev] if rrc else (None, None)
        n = sum(i1 - i0 for _d, _sec, i0, i1 in block)
        with span("oip.register.tiles", dev):
            stacks = [
                torch.empty((n, geom.corr_rows, geom.cols),
                            dtype=torch.float32, device=dev),
                torch.empty((n, *bands.shape[:-2], geom.brows, geom.bcols),
                            dtype=torch.float32, device=dev)]
            t0 = 0
            for _d, _sec, i0, i1 in block:
                write_tiles(stacks[0], t0, next(pan_blks),
                            _cols(pp, i0 * geom.cols, i1 * geom.cols),
                            geom.cols)
                write_tiles(stacks[1], t0, next(band_blks),
                            _cols(bp, i0 * geom.bcols, i1 * geom.bcols),
                            geom.bcols)
                t0 += i1 - i0
        stats.append(correlate(geom, stacks, win))
    coeffs, n_valid = fit(geom, *gather(stats), threshold)
    return (torch.stack([c[0] for c in coeffs]),
            torch.stack([c[1] for c in coeffs]), n_valid)


def register_fast(
    pan: torch.Tensor,
    mss: torch.Tensor,
    slices: int = 10,
    n_sections: int | None = None,
    win: tuple[int, int] = (64, 64),
    threshold: float = IBCV_DEF_THRESHOLD,
    pan_params: RRCParams | None = None,
    mss_params: RRCParams | None = None,
):
    """Fast registration: per-(section, slice) windowed phase correlation
    of PAN against the 4 bands, then the thresholded polynomial fit.

    ``pan``: (L, W) uint16 and ``mss``: (4, L/4, W/4) uint16 -- RAW strips
    when ``pan_params``/``mss_params`` ((W,) and (4, W/4) float64 ``(k,
    b)``) are given, in which case each sampled tile is RRC'd inline.
    Returns ``(coeffs, n_valid)``: per band ``(coeff_x (2,), coeff_y (3,))``
    float32 fitted over samples with response >= ``threshold``, and the
    (4,) valid counts (check with :func:`check_registration_valid`).

    The geometry is :func:`register_geometry`; the tiles go through
    :func:`register_rows` on one device.
    """
    geom = register_geometry(pan.shape[0], pan.shape[1], slices, n_sections)
    cx, cy, n_valid = register_rows(
        geom, StripRows(pan), StripRows(mss), [pan.device],
        {pan.device: (pan_params, mss_params)}, win=win, threshold=threshold)
    return list(zip(cx, cy)), n_valid


def check_registration_valid(n_valid) -> None:
    """Host-side min-count check on :func:`register_fast`'s valid counts
    (the reference's FilterInterBandShiftValues failure,
    preproc.h:505-510)."""
    counts = [int(v) for v in to_host(n_valid)]
    for b, n in enumerate(counts):
        if n < IBCV_MIN_COUNT:
            raise RuntimeError(
                f"Not enough valid correlation values for band#{b + 1}: "
                f"{n} valid values found, {IBCV_MIN_COUNT} expected at least"
            )


def stt_offsets(lines: int, sections: int, line_per_section: int):
    """First line of each of the stt estimate's ``sections`` windows of
    ``line_per_section`` rows, spaced by equal gaps along a ``lines``-line
    strip (CalcSttParameters, stitcher.h:151-160)."""
    gap = (lines - sections * line_per_section) // (sections + 1)
    return [gap + i * (gap + line_per_section) for i in range(sections)]


def stt_geometry(lines: int, sections: int,
                 line_per_section: int | None = None):
    """Where the stt estimate samples a ``lines``-line strip: ->
    ``(lps, offs)``, the window rows and each section's first line."""
    lps = line_per_section or max(64, min(16000, lines // sections))
    lps = max(64, lps - lps % 64)
    if sections * lps > lines:
        raise ValueError(
            "PAN line count less than sections times line-per-section, "
            "use smaller -s and/or -l value(s)"
        )
    return lps, stt_offsets(lines, sections, lps)


def stt_peaks(t1, t2, win: tuple[int, int] = (64, 64)):
    """Windowed correlation peaks of stacked float32 overlap windows ``t1``
    / ``t2`` (n, lps, ow) -> ``(dx, dy, rs)``, each (n,)."""
    shape = tuple(t1.shape[1:])
    win = phasecorr.clamp_win(win, shape)
    return phasecorr.peak_from_spectra_windowed(
        phasecorr.rfft2_padded(t1, shape), phasecorr.rfft2_padded(t2, shape),
        shape, win[0], win[1],
    )


def stt_average(dx, dy, rs, threshold: float = IBCV_DEF_THRESHOLD,
                max_delta_y: float = 0.0):
    """The deltas averaged over valid sections (response >= ``threshold``;
    |dy| <= ``max_delta_y`` when positive) -> ``(delta_x, delta_y,
    response, n_valid)`` 0-d tensors."""
    ok = rs >= threshold
    if max_delta_y > 0.0:
        ok = ok & (dy.abs() <= max_delta_y)
    w = ok.to(torch.float32)
    n = w.sum()
    denom = torch.clamp(n, min=1.0)
    return (
        (dx * w).sum() / denom,
        (dy * w).sum() / denom,
        (rs * w).sum() / denom,
        n.to(torch.int32),
    )


def _delta_ok(dy: float, r: float, threshold: float,
              max_delta_y: float) -> bool:
    return r >= threshold and (max_delta_y <= 0.0 or abs(dy) <= max_delta_y)


def valid_delta_mean(dxs, dys, rss, threshold: float, max_delta_y: float):
    """The per-section deltas' filter and float64 mean (stitcher.h:163-200):
    valid = response >= ``threshold`` and, when ``max_delta_y`` > 0,
    |dy| <= ``max_delta_y``; the valid ones summed in section order.  ->
    (the count of valid sections, (mean dx, mean dy, mean response)); the
    reference's "No valid delta value found" error when none survive."""
    sx = sy = sr = 0.0
    valid = 0
    for dx, dy, r in zip(dxs, dys, rss):
        if _delta_ok(float(dy), float(r), threshold, max_delta_y):
            sx += float(dx)
            sy += float(dy)
            sr += float(r)
            valid += 1
    if valid == 0:
        raise RuntimeError(
            "No valid delta value found for stitching parameter calculating"
        )
    return valid, (sx / valid, sy / valid, sr / valid)


def average_valid_deltas(
    dxs, dys, rss, offs, threshold: float, max_delta_y: float
) -> tuple[float, float, float]:
    """:func:`valid_delta_mean`, after the reference's QA table, and its
    summary logged, as the JAX package's ``models/stitcher.py`` does."""
    olog("Calculating stitching delta values ...")
    rlog("| offset |  delta x |  delta y | response | r |")
    for o, dx, dy, r in zip(offs, dxs, dys, rss):
        dx, dy, r = float(dx), float(dy), float(r)
        rlog("|%7d |%10.4f|%10.4f|%10.4f|%s|", o, dx, dy, r,
             " ok " if _delta_ok(dy, r, threshold, max_delta_y) else " x ")
    valid, mean = valid_delta_mean(dxs, dys, rss, threshold, max_delta_y)
    olog(
        "Total %d valid delta value pairs found, everage value: "
        "dx: %.5f, dy: %.5f, r: %.5f",
        valid, *mean,
    )
    return mean


def stt_average_host(dx, dy, rs, threshold: float = IBCV_DEF_THRESHOLD,
                     max_delta_y: float = 0.0):
    """The file route's average (``Stitcher.calc_stt_parameters``): the
    (n,) statistics read back to the host and averaged in float64
    (:func:`valid_delta_mean`: the reference's error where none is
    valid).  -> ``(delta_x, delta_y, response, n_valid)``, host
    numbers."""
    valid, mean = valid_delta_mean(
        *to_host(torch.stack([dx, dy, rs])).numpy(), threshold, max_delta_y)
    return (*mean, valid)


def stt_rows(pan1, pan2, devices, sections: int = 10,
             line_per_section: int | None = None, overlap_cols: int = 200,
             edge_cols: int = 0, threshold: float = IBCV_DEF_THRESHOLD,
             max_delta_y: float = 0.0, win: tuple[int, int] = (64, 64),
             gather=_one_block, geometry=None, peaks=None, average=None):
    """The stt estimate on row sources (as :func:`register_rows` takes
    them): ``sections`` windows (``geometry``, :func:`stt_geometry`) of
    PAN1's right overlap strip and PAN2's left one, a contiguous block of
    sections on each of the ``devices`` slots, each window cast to float32
    and the block's windows stacked; their peaks (``peaks``,
    :func:`stt_peaks`), gathered in section order by ``gather``, averaged
    (``average``, :func:`stt_average`); each default is looked up at call
    time.  -> as :func:`stt_estimate_fast`."""
    geometry = geometry or stt_geometry
    peaks = peaks or stt_peaks
    average = average or stt_average
    lines, width = pan1.shape[-2:]
    lps, offs = geometry(lines, sections, line_per_section)
    plan = [(d, o, o + lps)
            for d, (s0, s1) in enumerate(tile_blocks(sections, len(devices)))
            for o in offs[s0:s1]]
    with span("oip.stt", _first(devices)):
        win1, win2 = (strip.fetch([(d, a, b, cols) for d, a, b in plan])
                      for strip, cols in (
                          (pan1, (width - overlap_cols, width - edge_cols)),
                          (pan2, (edge_cols, overlap_cols))))
        outs = []
        for d, group in itertools.groupby(zip(plan, win1, win2),
                                          key=lambda g: g[0][0]):
            group = list(group)
            if devices[d] is None:
                continue
            t1, t2 = (torch.stack([g[k].to(torch.float32) for g in group])
                      for k in (1, 2))
            outs.append(peaks(t1, t2, win))
        return average(*gather(outs), threshold, max_delta_y)


def stt_estimate_fast(
    pan1: torch.Tensor,
    pan2: torch.Tensor,
    sections: int = 10,
    line_per_section: int | None = None,
    overlap_cols: int = 200,
    edge_cols: int = 0,
    threshold: float = IBCV_DEF_THRESHOLD,
    max_delta_y: float = 0.0,
    win: tuple[int, int] = (64, 64),
):
    """Stitching-parameter estimation (CalcSttParameters,
    stitcher.h:148-201): phase-correlate ``sections`` sampled windows of
    PAN1's right overlap strip against PAN2's left overlap strip
    (:func:`stt_rows` on one device), and average the deltas over valid
    samples (:func:`stt_average`).

    Returns (delta_x, delta_y, response, n_valid) as 0-d tensors;
    ``n_valid == 0`` is the reference's "No valid delta value found"
    error (:func:`check_stt_valid`)."""
    return stt_rows(StripRows(pan1), StripRows(pan2), [pan1.device],
                    sections, line_per_section, overlap_cols, edge_cols,
                    threshold, max_delta_y, win)


def check_stt_valid(n_valid) -> None:
    """Host-side check of :func:`stt_estimate_fast`'s valid count
    (stitcher.h:187-190)."""
    if int(to_host(n_valid)) == 0:
        raise RuntimeError(
            "No valid delta value found for stitching parameter calculating"
        )


class ScenePipeline(nn.Module):
    """The scene pipeline as one module: the RRC parameters are its
    buffers (the pipeline's only "weights"; nothing takes a gradient),
    :meth:`estimate` fits the registration and stt parameters,
    :meth:`transform` resamples and stitches, :meth:`forward` runs both.

    Inputs: ``pan1``/``pan2`` (L, W) and ``mss`` (4, L/4, W/4) uint16 RAW
    strips on the module's device.  ``col_halo`` bounds the supported
    horizontal shift (|dx| <= col_halo - 2) and ``prestt_row_bound`` the
    prestitch |dy|; the stt estimate is clamped to them, as in the JAX
    package (device_pipeline.py:638-641).
    """

    def __init__(
        self,
        pan1_params: RRCParams,
        pan2_params: RRCParams,
        mss_params: RRCParams,
        slices: int = 10,
        n_sections: int | None = None,
        fold: int = 200,
        row_bound: int = 3,
        stt_sections: int = 10,
        stt_lines: int | None = None,
        overlap_cols: int = 200,
        col_block: int = 128,
        col_halo: int = 16,
        stt_threshold: float = IBCV_DEF_THRESHOLD,
        stt_max_delta_y: float = 0.0,
        threshold: float = IBCV_DEF_THRESHOLD,
        prestt_row_bound: int = 8,
        return_prestt: bool = False,
    ):
        super().__init__()
        f64 = torch.float64
        for name, (k, b) in (
            ("pan1", pan1_params), ("pan2", pan2_params), ("mss", mss_params)
        ):
            self.register_buffer(f"{name}_k", torch.as_tensor(k, dtype=f64))
            self.register_buffer(f"{name}_b", torch.as_tensor(b, dtype=f64))
        self.fold = fold
        self.row_bound = row_bound
        self.overlap_cols = overlap_cols
        self.col_block = col_block
        self.col_halo = col_halo
        self.prestt_row_bound = prestt_row_bound
        self.return_prestt = return_prestt
        self.slices = slices
        self.n_sections = n_sections
        self.threshold = threshold
        self.stt_sections = stt_sections
        self.stt_lines = stt_lines
        self.stt_threshold = stt_threshold
        self.stt_max_delta_y = stt_max_delta_y

    def estimate(self, pan1, pan2, mss):
        """-> (cx (4, 2), cy (4, 3), n_valid (4,), raw_dx, raw_dy, n_stt)."""
        return self.estimate_rows(StripRows(pan1), StripRows(pan2),
                                  StripRows(mss), [pan1.device])

    def estimate_rows(self, pan1, pan2, mss, devices, gather=_one_block,
                      copies=None):
        """:meth:`estimate` on row sources of the RAW strips, over the
        ``devices`` slots (:func:`register_rows`' contract): the
        registration, its tiles RRC'd as they are cut with the buffers of
        ``copies[device]`` (this module's copy on each device; by default
        this module), then the stt estimate on the overlap windows, both
        gathered by ``gather``."""
        copies = copies or {d: self for d in devices}
        rrc = {d: ((m.pan1_k, m.pan1_b), (m.mss_k, m.mss_b))
               for d, m in copies.items()}
        with span("oip.estimate", _first(devices)):
            geom = register_geometry(*pan1.shape[-2:], self.slices,
                                     self.n_sections)
            cx, cy, n_valid = register_rows(
                geom, pan1, mss, devices, rrc, gather,
                threshold=self.threshold)
            raw_dx, raw_dy, _resp, n_stt = stt_rows(
                pan1, pan2, devices, self.stt_sections, self.stt_lines,
                self.overlap_cols, threshold=self.stt_threshold,
                max_delta_y=self.stt_max_delta_y, gather=gather)
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt

    def clamp_stt(self, raw_dx, raw_dy) -> tuple[float, float]:
        """The stt deltas clamped to the resample's supported band (each
        delta read back to the host: a wait for the device)."""
        hx = self.col_halo - 2.0
        hy = self.prestt_row_bound - 2.0
        return (min(max(float(to_host(raw_dx)), -hx), hx),
                min(max(float(to_host(raw_dy)), -hy), hy))

    def transform(self, pan1, pan2, mss, cx, cy, raw_dx, raw_dy):
        """-> (aligned (L/4, W/4, 4), stitched (L, 2*(W - fold))[, prestt
        (L, W)]) uint16."""
        with span("oip.transform", pan1.device):
            mss_c = rrc_apply(mss, self.mss_k, self.mss_b)
            aligned = remap_bands_interleaved(
                mss_c, cx, cy, row_bound=self.row_bound,
                col_block=self.col_block, col_halo=self.col_halo,
            )
            del mss_c
            dxs, dys = self.clamp_stt(raw_dx, raw_dy)
            out = remap_const_stitch_chunked(
                pan1, pan2, self.pan1_k, self.pan1_b, self.pan2_k,
                self.pan2_b, dxs, dys, self.fold,
                row_bound=self.prestt_row_bound, col_block=self.col_block,
                col_halo=self.col_halo, want_prestt=self.return_prestt,
            )
        if self.return_prestt:
            return aligned, out[0], out[1]
        return aligned, out

    def forward(self, pan1, pan2, mss):
        """Estimate then transform: -> (aligned, stitched[, prestt],
        n_valid, n_stt, params) with params = (cx, cy, stt_dx, stt_dy,
        raw_dx, raw_dy), stt_dx/dy the clamped values the resample used."""
        with span(SCENE_SPAN, pan1.device):
            cx, cy, n_valid, raw_dx, raw_dy, n_stt = self.estimate(
                pan1, pan2, mss
            )
            outs = self.transform(pan1, pan2, mss, cx, cy, raw_dx, raw_dy)
            dxs, dys = self.clamp_stt(raw_dx, raw_dy)
        return (*outs, n_valid, n_stt, (cx, cy, dxs, dys, raw_dx, raw_dy))


class MssAlign(nn.Module):
    """CMOS2's MSS aligned against the prestitched PAN2 (the second half of
    the reference's sample-task workflow, which registers against
    ``*.RRC.PRESTT.RAW``): RRC of the 4 bands (kernel (a)), registration
    against the already-corrected PAN, and the 4 alignment resamples into
    the interleaved raster (one kernel-(c) launch).  The MSS2 RRC
    parameters are its buffers.

    ``row_bound`` is 6, wider than the CMOS1 pipeline's 3: MSS2's fitted
    vertical offset holds the band misregistration plus the band-scale
    residue of the prestitch translation.  Kernel (c) takes it (rb <= 6),
    so no row bound here reaches the staged route."""

    def __init__(
        self,
        mss_params: RRCParams,
        slices: int = 10,
        n_sections: int | None = None,
        threshold: float = IBCV_DEF_THRESHOLD,
        row_bound: int = 6,
        col_block: int = 128,
        col_halo: int = 16,
    ):
        super().__init__()
        k, b = mss_params
        self.register_buffer("mss_k", torch.as_tensor(k, dtype=torch.float64))
        self.register_buffer("mss_b", torch.as_tensor(b, dtype=torch.float64))
        self.slices = slices
        self.n_sections = n_sections
        self.threshold = threshold
        self.row_bound = row_bound
        self.col_block = col_block
        self.col_halo = col_halo

    def remap(self, mss_c, cx, cy):
        """The alignment resample of RRC'd (4, rows, W/4) bands: -> (rows,
        W/4, 4) uint16."""
        return remap_bands_interleaved(
            mss_c, cx, cy, row_bound=self.row_bound,
            col_block=self.col_block, col_halo=self.col_halo,
        )

    def transform(self, mss, cx, cy):
        """RRC then :meth:`remap` of RAW (4, rows, W/4) bands."""
        return self.remap(rrc_apply(mss, self.mss_k, self.mss_b), cx, cy)

    def forward(self, pan_c, mss):
        """``pan_c`` (L, W) corrected PAN, ``mss`` (4, L/4, W/4) RAW bands
        -> (aligned (L/4, W/4, 4), n_valid (4,), (cx (4, 2), cy (4, 3)))."""
        mss_c = rrc_apply(mss, self.mss_k, self.mss_b)
        cx, cy, n_valid = self.register(StripRows(pan_c), StripRows(mss_c),
                                        [pan_c.device])
        return self.remap(mss_c, cx, cy), n_valid, (cx, cy)

    def register(self, pan_c, mss, devices, gather=_one_block,
                 raw: bool = False):
        """The registration of the bands against the corrected PAN, row
        sources over the ``devices`` slots (:func:`register_rows`); with
        ``raw`` the bands are RAW and each band tile is RRC'd as it is
        cut.  -> (cx (4, 2), cy (4, 3), n_valid (4,))."""
        geom = register_geometry(*pan_c.shape[-2:], self.slices,
                                 self.n_sections)
        rrc = ({d: (None, (self.mss_k, self.mss_b)) for d in devices}
               if raw else None)
        return register_rows(geom, pan_c, mss, devices, rrc, gather,
                             threshold=self.threshold)


def mss_fold_half(fold_cols: int) -> int:
    """Fold columns each aligned MSS raster loses at the seam: the MSS
    folds PAN's ``fold_cols / 4`` (sample-task.sh FOLDCOL_MSS), half a
    side."""
    return max(1, fold_cols // MSS_BANDS // 2)


def stitch_mss_seam(aligned, aligned2, fold_cols: int):
    """The two aligned MSS rasters (rows, W/4, 4) stitched at the seam
    (sample-task.sh step 4): CMOS1's without its right ``mss_fold_half``
    columns ++ CMOS2's without its left ones -> (rows, 2 * (W/4 - fold
    half), 4)."""
    fh = mss_fold_half(fold_cols)
    with span("oip.seam", aligned.device):
        return torch.cat([aligned[:, :aligned.shape[1] - fh],
                          aligned2[:, fh:]], dim=1)


class DualScenePipeline(nn.Module):
    """The reference's whole sample task (``DOC/sample-task.sh`` steps 2-4)
    on one device, as one module: the scene (:class:`ScenePipeline`,
    which must return the prestitched PAN2), CMOS2's MSS aligned against
    that prestitched PAN2 (:class:`MssAlign`, step 3.2), and the two
    aligned MSS rasters stitched at the seam (:func:`stitch_mss_seam`,
    step 4).  ``fold_cols`` is the scene's ``-c``: PAN's fold columns,
    whose quarter the MSS folds."""

    def __init__(self, pipe: ScenePipeline, align: MssAlign, fold_cols: int):
        super().__init__()
        if not pipe.return_prestt:
            raise ValueError("the dual scene aligns CMOS2's MSS against the "
                             "prestitched PAN2: needs return_prestt=True")
        self.pipe = pipe
        self.align = align
        self.fold_cols = fold_cols

    def forward(self, pan1, pan2, mss, mss2):
        """``pan1``/``pan2`` (L, W), ``mss``/``mss2`` (4, L/4, W/4) uint16
        RAW strips -> (aligned, stitched, aligned2, stitched_mss, n_valid,
        n_stt, n_valid2, params, (cx2 (4, 2), cy2 (4, 3))), the first five
        and params as :meth:`ScenePipeline.forward` gives them."""
        pipe = self.pipe
        dev = pan1.device
        with span(SCENE_SPAN, dev):
            cx, cy, n_valid, raw_dx, raw_dy, n_stt = pipe.estimate(
                pan1, pan2, mss)
            aligned, stitched, prestt = pipe.transform(
                pan1, pan2, mss, cx, cy, raw_dx, raw_dy)
            with span("oip.align2", dev):
                aligned2, n_valid2, fit2 = self.align(prestt, mss2)
            del prestt
            stitched_mss = stitch_mss_seam(aligned, aligned2, self.fold_cols)
            dxs, dys = pipe.clamp_stt(raw_dx, raw_dy)
        return (aligned, stitched, aligned2, stitched_mss, n_valid, n_stt,
                n_valid2, (cx, cy, dxs, dys, raw_dx, raw_dy), fit2)


def parity_stt_windows(lines: int, sections: int,
                       line_per_section: int | None = None):
    """The file route's stt windows (``Stitcher``): ``line_per_section``
    lines (None: ``min(STT_DEF_SECLINES, lines // sections)``), unrounded,
    at :func:`stt_offsets`; the reference's error where they do not fit
    the strip.  -> ``(lps, offs)``, as :func:`stt_geometry` gives them."""
    lps = line_per_section or min(STT_DEF_SECLINES, lines // sections)
    if lps <= 0 or sections * lps > lines:
        raise ValueError(
            "PAN line count less than sections times line-per-section, "
            "use smaller -s and/or -l value(s)"
        )
    return lps, stt_offsets(lines, sections, lps)


def stt_surface_peaks(t1, t2, win=None):
    """The stt windows' full-surface ``cv::phaseCorrelate``
    (CalcSttParameters, :func:`~..ops.phasecorr.phase_correlate_batch`);
    ``win`` is unused."""
    return phasecorr.phase_correlate_batch(t1, t2)


STITCH_ROWS = 8192   # PAN1 rows a step of the parity stitch


class ParityScenePipeline(nn.Module):
    """The reference's own sample task (``DOC/sample-task.sh`` steps 2-4 in
    the binary's default semantics) on device-resident strips, as one
    module: the file commands' parity route -- ``prestitch``, the default
    action with ``--do-rrc4pan`` and ``stitch -c`` -- with the strips and
    every product on the device.  The RRC parameters are its buffers.

    :meth:`estimate`: the registration through :func:`register_rows` on
    the reference's tile grid (:func:`reference_geometry`), the PAN and
    band tiles RRC'd as they are cut (kernel (h)), each band tile brought
    up x4 by ``cv::resize`` and correlated against its PAN tile over the
    whole surface (:func:`correlate_surfaces`), the file route's float64
    fit (:func:`fit_tiles_host`); the stt through :func:`stt_rows` on the
    uncorrected overlap strips, full-surface (:func:`stt_surface_peaks`)
    and averaged as ``Stitcher.calc_stt_parameters`` averages it.  The stt
    is not clamped.  Both read their statistics back to the host, where
    the fits and the remap plans are made.

    :meth:`transform`: RRC (kernel (a)) of the bands and both PANs; the
    bands' alignment sections (:func:`~..ops.resample.ibpa_plan`) and
    PAN2's SectionaryRemap with its rolling-buffer bottom cut
    (:func:`~..ops.resample.sectionary_plan`), each section a
    ``cv::remap`` INTER_CUBIC call (kernel (f)) on views of the RRC'd
    strips, in ``quantized_coords`` (OpenCV <= 4.x's 1/32-px grid) or
    continuous coordinates; the stitch's seam concat of RRC'd PAN1 and the
    prestitched PAN2, ``fold`` columns off each.

    :meth:`forward` raises the reference's errors where a band has too few
    valid tiles or no stt window is valid; :meth:`check` raises its
    argument errors for a strip's sizes (the ``scene --parity`` command
    calls it before any device work).  A band strip too short for one
    alignment section gives rows of 0, as the reference's loop would."""

    def __init__(
        self,
        pan1_params: RRCParams,
        pan2_params: RRCParams,
        mss_params: RRCParams,
        slices: int = 10,
        n_sections: int | None = None,
        threshold: float = IBCV_DEF_THRESHOLD,
        stt_sections: int = 10,
        stt_lines: int | None = None,
        overlap_cols: int = 200,
        edge_cols: int = 0,
        stt_threshold: float = IBCV_DEF_THRESHOLD,
        stt_max_delta_y: float = 0.0,
        fold: int = 100,
        remap_section_rows: int = REMAP_SECTION_ROWS,
        line_per_section: int = IBPA_DEFAULT_BATCHLINES,
        section_overlap: int = IBPA_DEFAULT_LINEOVERLAP,
        quantized_coords: bool = False,
    ):
        super().__init__()
        f64 = torch.float64
        for name, (k, b) in (
            ("pan1", pan1_params), ("pan2", pan2_params), ("mss", mss_params)
        ):
            self.register_buffer(f"{name}_k", torch.as_tensor(k, dtype=f64))
            self.register_buffer(f"{name}_b", torch.as_tensor(b, dtype=f64))
        self.slices = slices
        self.n_sections = n_sections
        self.threshold = threshold
        self.stt_sections = stt_sections
        self.stt_lines = stt_lines
        self.overlap_cols = overlap_cols
        self.edge_cols = edge_cols
        self.stt_threshold = stt_threshold
        self.stt_max_delta_y = stt_max_delta_y
        self.fold = fold
        self.remap_section_rows = remap_section_rows
        self.line_per_section = line_per_section
        self.section_overlap = section_overlap
        self.quantized_coords = quantized_coords

    def geometry(self, lines: int, width: int) -> RegGeometry:
        """The registration's tile grid on a (lines, width) PAN strip
        (``n_sections`` None: as many as the strip holds, at most 5)."""
        sections = self.n_sections or max(
            1, min(5, lines // CORRELATION_LINES))
        return reference_geometry(lines, width, self.slices, sections)

    def check(self, lines_pan: int, width: int, lines_mss: int) -> None:
        """The reference's argument errors for strips of these sizes: the
        tile grid's, the stt windows', the alignment sections'
        (DoInterBandAlignment, preproc.h:351-372)."""
        self.geometry(lines_pan, width)
        parity_stt_windows(lines_pan, self.stt_sections, self.stt_lines)
        if self.section_overlap > IBPA_MAX_LINEOVERLAP:
            raise ValueError(
                f"Overlap value {self.section_overlap} exceeds maximum "
                f"allowed value({IBPA_MAX_LINEOVERLAP})")
        if self.line_per_section < self.section_overlap * 2:
            raise ValueError(
                "Lines per section too small or section overlapped lines "
                "too large")
        if lines_mss < IBPA_MIN_PROCESSLINES:
            raise ValueError("Too few image lines left to process")

    def estimate(self, pan1, pan2, mss):
        """-> (cx (4, 2), cy (4, 3) float64 and n_valid (4,) int32 on the
        host, raw_dx, raw_dy, n_stt host numbers)."""
        dev = pan1.device
        lines, width = pan1.shape
        with span("oip.estimate", dev):
            cx, cy, n_valid = register_rows(
                self.geometry(lines, width), StripRows(pan1), StripRows(mss),
                [dev], {dev: ((self.pan1_k, self.pan1_b),
                              (self.mss_k, self.mss_b))},
                threshold=self.threshold, correlate=correlate_surfaces,
                fit=fit_tiles_host)
            raw_dx, raw_dy, _resp, n_stt = stt_rows(
                StripRows(pan1), StripRows(pan2), [dev], self.stt_sections,
                self.stt_lines, self.overlap_cols, self.edge_cols,
                self.stt_threshold, self.stt_max_delta_y,
                geometry=parity_stt_windows, peaks=stt_surface_peaks,
                average=stt_average_host)
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt

    def _remap(self, src, plan, cut, out=None):
        """One section's ``cv::remap`` (kernel (f)): output rows ``[cut.
        first, cut.first + cut.count)`` of the section ``src``."""
        with span("oip.remap.sections", src.device):
            out = remap_section_u16(src, plan, cut.first, cut.count, out=out)
        count("remap_sections")
        return out

    def align(self, mss_c, cx, cy):
        """The alignment of RRC'd (4, rows, W/4) bands in the reference's
        overlapping sections (:func:`~..ops.resample.ibpa_plan`, the first
        ``section_overlap`` rows trimmed) -> (rows - section_overlap, W/4,
        4) uint16, rows past the last section 0.  Every call's plan is
        uploaded before the first launch (here and in :meth:`prestitch`),
        so the card does not wait on the host between sections."""
        bands, lines, bw = mss_c.shape
        plans = [plan_for_band_alignment(cx[b], cy[b], bw,
                                         self.quantized_coords)
                 for b in range(bands)]
        # zeros through int16: torch has few uint16 kernels on CUDA
        aligned = torch.zeros((max(0, lines - self.section_overlap), bw,
                               bands), dtype=torch.int16,
                              device=mss_c.device).view(torch.uint16)
        calls = [(mss_c[b, c.offset:c.offset + c.rows], plans[b], c, b)
                 for c in ibpa_plan(lines, self.line_per_section, 0,
                                    self.section_overlap)
                 for b in range(bands)]
        for src, plan, c, _b in calls:
            prepare_remap_section(src, plan, c.first, c.count)
        for src, plan, c, b in calls:
            aligned[c.dst:c.dst + c.count, :, b] = self._remap(src, plan, c)
        return aligned

    def prestitch(self, pan2_c, dx: float, dy: float):
        """PreStitch's SectionaryRemap of the RRC'd (rows, W) PAN2 by the
        stt deltas (:func:`~..ops.resample.sectionary_plan`), each
        section's kept rows written in place -> (rows, W) uint16."""
        lines, width = pan2_c.shape
        plan = plan_for_constant_shift(dx, dy, width, self.quantized_coords)
        sp = sectionary_plan(lines, self.remap_section_rows, dy)
        calls = [(pan2_c[c.offset:c.offset + c.rows], c) for c in sp.cuts]
        if sp.window:
            window = torch.cat([pan2_c[a:a + n] for a, n in sp.window])
            calls.append((window, SectionCut(0, window.shape[0],
                                             sp.window_first, sp.bcut,
                                             sp.window_dst)))
        for src, c in calls:
            prepare_remap_section(src, plan, c.first, c.count)
        out = torch.empty((sp.rows, width), dtype=torch.uint16,
                          device=pan2_c.device)
        for src, c in calls:
            self._remap(src, plan, c, out[c.dst:c.dst + c.count])
        return out

    def transform(self, pan1, pan2, mss, cx, cy, raw_dx, raw_dy):
        """-> (aligned (L/4 - section_overlap, W/4, 4), prestt (L, W),
        stitched (L, 2 * (W - fold))) uint16."""
        with span("oip.transform", pan1.device):
            # both corrections queued first: the card runs them while the
            # host makes the remap plans
            mss_c = rrc_apply(mss, self.mss_k, self.mss_b)
            pan2_c = rrc_apply(pan2, self.pan2_k, self.pan2_b)
            aligned = self.align(mss_c, cx, cy)
            del mss_c
            prestt = self.prestitch(pan2_c, raw_dx, raw_dy)
            del pan2_c
            stitched = self.stitch(pan1, prestt)
        return aligned, prestt, stitched

    def stitch(self, pan1, prestt):
        """StitchBigRaw's seam concat: RRC(PAN1)'s left ``W - fold``
        columns beside the prestitched PAN2's from ``fold`` on, PAN1 RRC'd
        (kernel (a)) :data:`STITCH_ROWS` rows at a time, so no corrected
        copy of the whole strip is made beside the stitched one."""
        lines, width = pan1.shape
        keep = width - self.fold
        out = torch.empty((lines, 2 * keep), dtype=torch.uint16,
                          device=pan1.device)
        out[:, keep:] = prestt[:, self.fold:]
        for r0 in range(0, lines, STITCH_ROWS):
            out[r0:r0 + STITCH_ROWS, :keep] = rrc_apply(
                pan1[r0:r0 + STITCH_ROWS], self.pan1_k, self.pan1_b)[:, :keep]
        return out

    def forward(self, pan1, pan2, mss):
        """Estimate then transform: -> (aligned, prestt, stitched, n_valid,
        n_stt, (cx, cy, raw_dx, raw_dy))."""
        with span(SCENE_SPAN, pan1.device):
            cx, cy, n_valid, raw_dx, raw_dy, n_stt = self.estimate(
                pan1, pan2, mss)
            outs = self.transform(pan1, pan2, mss, cx, cy, raw_dx, raw_dy)
        return (*outs, n_valid, n_stt, (cx, cy, raw_dx, raw_dy))


def make_device_pipeline(pan1_params, pan2_params, mss_params, **cfg):
    """The whole scene as one :class:`ScenePipeline` (``forward``)."""
    return ScenePipeline(pan1_params, pan2_params, mss_params, **cfg)


def make_device_pipeline_staged(pan1_params, pan2_params, mss_params, **cfg):
    """The scene split at the parameter boundary: ``(estimate,
    transform)`` bound methods of one :class:`ScenePipeline`."""
    pipe = ScenePipeline(pan1_params, pan2_params, mss_params, **cfg)
    return pipe.estimate, pipe.transform
