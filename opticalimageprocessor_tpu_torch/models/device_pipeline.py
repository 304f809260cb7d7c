"""The single-device scene pipeline (the port's main path).

Counterpart of ``opticalimageprocessor_tpu/models/device_pipeline.py``.
Per scene:

  estimate:  registration -- (section, slice) tiles of PAN1 and the 4 MSS
             bands, RRC'd inline (kernel (a)), one batched rfft2 of the
             PAN tiles and one fft2 of the band tiles (cuFFT), the fused
             windowed cross-power of every (tile, band) (kernel (b)), the
             5x5 centroid, the 0.4 response filter and a float64 weighted
             polynomial fit; then the stt estimate on the uncorrected CMOS
             overlap strips
  transform: RRC of the 4 bands (kernel (a)), the 4 alignment resamples
             into the interleaved raster (one kernel-(c) launch), and the
             stitch tail: RRC of both PANs, the prestitch translation of
             PAN2 and the seam concat (kernel (d))

:class:`MssAlign` aligns CMOS2's MSS against the prestitched PAN2 the same
way (RRC, registration, one kernel-(c) launch at row bound 6).  The
registration is split into its sampling geometry (:func:`register_geometry`)
and a core on gathered tiles (:func:`register_tiles`), so the streamed scene
(``models/scene_stream``) uploads only the sampled rows and still gets the
resident route's estimates bit for bit.

The JAX package's TPU workarounds are not ported: cuFFT replaces the DFT
done as matrix multiplies (``ops/fft_mxu``) and float64 the double-word
float32 fit (``ops/ddf32``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..constants import (
    CORRELATION_LINES,
    IBCV_DEF_THRESHOLD,
    IBCV_MIN_COUNT,
    MSS_BANDS,
)

from ..ops import phasecorr
from ..ops.phasecorr_cuda import windowed_crosspower_fused_tiles
from ..ops.resample import remap_bands_interleaved, remap_const_stitch_chunked
from ..ops.rrc import rrc_apply
from ..utils.logging import SCENE_SPAN, span, to_host

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


def _section_tiles(strip, params, row0, rows, cols, slices):
    """The ``slices`` (rows, cols) tiles of one section's row block of a
    (..., L, W) strip, RRC'd when ``params`` is given, as float32
    (slices, ..., rows, cols)."""
    blk = strip[..., row0:row0 + rows, :slices * cols]
    if params is not None:
        k, b = params
        blk = rrc_apply(blk, k[..., :slices * cols], b[..., :slices * cols])
    t = blk.to(torch.float32).reshape(*blk.shape[:-1], slices, cols)
    return t.movedim(-2, 0)


@dataclass(frozen=True)
class RegGeometry:
    """Where registration samples a (lines, width) PAN strip: ``n_sections``
    row blocks of ``corr_rows`` lines, ``sec_stride`` apart, each cut into
    ``slices`` tiles of ``cols`` columns; the band tiles are ``brows`` x
    ``bcols`` at the same place in band pixels."""

    slices: int
    n_sections: int
    corr_rows: int
    sec_stride: int
    cols: int
    bcols: int
    brows: int

    def row0(self, sec: int) -> int:
        """First PAN line of section ``sec``'s row block."""
        return sec * self.sec_stride


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


def section_tiles(geom: RegGeometry, pan_blk, band_blk,
                  pan_params: RRCParams | None = None,
                  mss_params: RRCParams | None = None):
    """One section's tiles from its row blocks: ``pan_blk`` (>= corr_rows,
    >= slices * cols) and ``band_blk`` (4, >= brows, >= slices * bcols)
    uint16, starting at the section's first row, RRC'd when the params are
    given.  Returns float32 (slices, corr_rows, cols) and (slices, 4,
    brows, bcols)."""
    return (
        _section_tiles(pan_blk, pan_params, 0, geom.corr_rows, geom.cols,
                       geom.slices),
        _section_tiles(band_blk, mss_params, 0, geom.brows, geom.bcols,
                       geom.slices),
    )


def correlate_tiles(geom: RegGeometry, pan_tiles, band_tiles,
                    win: tuple[int, int] = (64, 64)):
    """The correlation half of :func:`register_tiles`: lists of tile
    blocks (float32 (n, corr_rows, cols) and (n, 4, brows, bcols) each),
    emptied as they are consumed so the tiles' memory is freed before
    kernel (b) runs; one batched rfft2 of the PAN tiles, one fft2 of the
    band tiles and one kernel-(b) launch.  -> ``(dx, dy, rs)``, each (T,
    4) float32.  The line mesh runs it on each device's block of tiles."""
    pad = (geom.corr_rows, geom.cols)
    win = phasecorr.clamp_win(win, pad)
    dev = pan_tiles[0].device
    with span("oip.register.spectra", dev):
        fpan = phasecorr.rfft2_padded(torch.cat(pan_tiles), pad)
        pan_tiles.clear()
        fband = phasecorr.band_full_spectrum_small(torch.cat(band_tiles))
        band_tiles.clear()
    with span("oip.register.correlate", dev):
        return windowed_crosspower_fused_tiles(
            fpan, fband, pad, geom.brows, win[0], win[1]
        )


def fit_tiles(geom: RegGeometry, dx, dy, rs,
              threshold: float = IBCV_DEF_THRESHOLD):
    """The fit half of :func:`register_tiles`: the (T, 4) statistics of
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


def register_tiles(geom: RegGeometry, pan_tiles, band_tiles,
                   win: tuple[int, int] = (64, 64),
                   threshold: float = IBCV_DEF_THRESHOLD):
    """The core of :func:`register_fast` on already gathered tiles: lists
    of every section's :func:`section_tiles`, in section order (float32
    (slices, corr_rows, cols) and (slices, 4, brows, bcols) each), through
    :func:`correlate_tiles` and :func:`fit_tiles`; returns ``(coeffs,
    n_valid)`` as :func:`register_fast`.  Callers that gather the same
    tiles in the same order get bit-identical estimates."""
    dx, dy, rs = correlate_tiles(geom, pan_tiles, band_tiles, win)
    return fit_tiles(geom, dx, dy, rs, threshold)


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

    The geometry is :func:`register_geometry`; all n_sections x slices
    tiles go through :func:`register_tiles`.
    """
    geom = register_geometry(pan.shape[0], pan.shape[1], slices, n_sections)
    pan_tiles, band_tiles = [], []
    with span("oip.register.tiles", pan.device):
        for sec in range(geom.n_sections):
            row0 = geom.row0(sec)
            p, b = section_tiles(geom, pan[row0:],
                                 mss[:, row0 // MSS_BANDS:], pan_params,
                                 mss_params)
            pan_tiles.append(p)
            band_tiles.append(b)
    return register_tiles(geom, pan_tiles, band_tiles, win, threshold)


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
    (:func:`stt_geometry`, :func:`stt_peaks`), and average the deltas over
    valid samples (:func:`stt_average`).

    Returns (delta_x, delta_y, response, n_valid) as 0-d tensors;
    ``n_valid == 0`` is the reference's "No valid delta value found"
    error (:func:`check_stt_valid`)."""
    lines, width = pan1.shape
    lps, offs = stt_geometry(lines, sections, line_per_section)
    ow = overlap_cols - edge_cols
    c1 = width - overlap_cols
    with span("oip.stt", pan1.device):
        t1 = torch.stack(
            [pan1[o:o + lps, c1:c1 + ow].to(torch.float32) for o in offs]
        )
        t2 = torch.stack(
            [pan2[o:o + lps, edge_cols:edge_cols + ow].to(torch.float32)
             for o in offs]
        )
        return stt_average(*stt_peaks(t1, t2, win), threshold, max_delta_y)


def check_stt_valid(n_valid) -> None:
    """Host-side check of :func:`stt_estimate_fast`'s valid count
    (stitcher.h:187-190)."""
    if int(to_host(n_valid)) == 0:
        raise RuntimeError(
            "No valid delta value found for stitching parameter calculating"
        )


def make_scene_estimate(
    slices: int = 10,
    n_sections: int | None = None,
    stt_sections: int = 10,
    stt_lines: int | None = None,
    overlap_cols: int = 200,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    threshold: float = IBCV_DEF_THRESHOLD,
):
    """The scene's parameter estimation over its minimal inputs:
    ``estimate(pan1, pan2_left, mss, pan1_params, mss_params)`` where
    ``pan2_left`` is PAN2's left ``overlap_cols`` columns (all the stt
    sampling reads) and both strips stay RAW (registration RRCs only its
    sampled tiles).  Returns ``(cx (4, 2), cy (4, 3), n_valid (4,),
    raw_dx, raw_dy, n_stt)``."""

    def estimate(pan1, pan2_left, mss, pan1_params, mss_params):
        coeffs, n_valid = register_fast(
            pan1, mss, slices, n_sections, threshold=threshold,
            pan_params=pan1_params, mss_params=mss_params,
        )
        raw_dx, raw_dy, _resp, n_stt = stt_estimate_fast(
            pan1, pan2_left, stt_sections, stt_lines, overlap_cols,
            threshold=stt_threshold, max_delta_y=stt_max_delta_y,
        )
        cx = torch.stack([c[0] for c in coeffs])
        cy = torch.stack([c[1] for c in coeffs])
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt

    return estimate


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
        # stt_estimate_fast's settings after the strips and overlap_cols
        self.stt_kw = dict(
            sections=stt_sections, line_per_section=stt_lines,
            threshold=stt_threshold, max_delta_y=stt_max_delta_y,
        )
        self._estimate = make_scene_estimate(
            slices=slices, n_sections=n_sections, stt_sections=stt_sections,
            stt_lines=stt_lines, overlap_cols=overlap_cols,
            stt_threshold=stt_threshold, stt_max_delta_y=stt_max_delta_y,
            threshold=threshold,
        )

    def estimate(self, pan1, pan2, mss):
        """-> (cx (4, 2), cy (4, 3), n_valid (4,), raw_dx, raw_dy, n_stt)."""
        with span("oip.estimate", pan1.device):
            return self._estimate(
                pan1, pan2[:, :self.overlap_cols], mss,
                (self.pan1_k, self.pan1_b), (self.mss_k, self.mss_b),
            )

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
        coeffs, n_valid = register_fast(
            pan_c, mss_c, self.slices, self.n_sections,
            threshold=self.threshold,
        )
        cx = torch.stack([c[0] for c in coeffs])
        cy = torch.stack([c[1] for c in coeffs])
        return self.remap(mss_c, cx, cy), n_valid, (cx, cy)


def make_mss_align(mss_params, **cfg) -> MssAlign:
    """The CMOS2 MSS align step as one :class:`MssAlign`."""
    return MssAlign(mss_params, **cfg)


def make_device_pipeline(pan1_params, pan2_params, mss_params, **cfg):
    """The whole scene as one :class:`ScenePipeline` (``forward``)."""
    return ScenePipeline(pan1_params, pan2_params, mss_params, **cfg)


def make_device_pipeline_staged(pan1_params, pan2_params, mss_params, **cfg):
    """The scene split at the parameter boundary: ``(estimate,
    transform)`` bound methods of one :class:`ScenePipeline`."""
    pipe = ScenePipeline(pan1_params, pan2_params, mss_params, **cfg)
    return pipe.estimate, pipe.transform
