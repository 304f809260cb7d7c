"""Inter-band registration + alignment (the default command) in PyTorch.

Counterpart of ``opticalimageprocessor_tpu/models/preprocessor.py``
(reference ``PreProcessor``, preproc.h:30-599), with the same stages:

1. geometry checks (CheckFilesAttributes);
2. PAN/MSS rows read on demand from the memory-mapped strips, RRC'd on
   the device by kernel (a) (:meth:`PreProcessor.pan_rows`,
   :meth:`PreProcessor.band_rows`);
3. inter-band correlation: slices x sections tiles, the x4 cubic
   upsample of the band tiles, full-surface ``cv::phaseCorrelate`` of each
   (tile, band) pair on ``torch.fft``;
4. response filter + float64 polynomial fit on the host;
5. the alignment remap: the parity route (``fast=False``, the default)
   remaps the reference's bordered sections of ``line_per_section`` lines
   with section-local maps (:func:`~..ops.resample.remap_section_u16`,
   bit for bit ``cv::remap``); fast mode remaps each whole band (kernel
   (c), or the staged remap beyond its row bound); the leading overlap
   rows are trimmed;
6. the ALIGNED.TIFF, channels [2, 1, 0, 3] (cv::imwrite's BGRA order).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..constants import (
    IBCV_DEF_SECTIONS,
    IBCV_DEF_SLICES,
    IBCV_DEF_THRESHOLD,
    IBPA_DEFAULT_LINEOVERLAP,
    IBPA_MAX_LINEOVERLAP,
    IBPA_MIN_PROCESSLINES,
    IBPA_STEM_EXT,
    MSS_BANDS,
    PIXELS_PER_LINE,
    RRC_STEM_EXT,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..utils.logging import olog, rlog, stage

from ..io import raw as raw_io
from ..io import tiff as tiff_io
from ..ops import phasecorr, polyfit, resample, rrc
from .device_pipeline import ibc_geometry
from .scene import load_rrc, resolve_device

_WRITE_CHUNK_ROWS = 4096   # PAN rows per RRC TIFF write


@dataclass
class InterBandShift:
    """Per-tile shift sample (reference InterBandShift, preproc.h:23-28)."""

    dx: float
    dy: float
    rs: float
    cx: int


@dataclass
class PreProcessor:
    pan_file: str
    mss_file: str
    rrc_pan_file: str = ""
    rrc_mss_files: tuple[str, str, str, str] | None = None
    out_dir: str | None = None
    # the parity route's coordinate convention: True = OpenCV <= 4.x's
    # 1/32-px grid, False = OpenCV 5.x's continuous coordinates
    quantized_coords: bool = False
    pixels_per_line: int = PIXELS_PER_LINE   # test hook; camera default 12288
    # fast=True: whole-band remap (the JAX package's fast mode, within 1 DN
    # of the parity route); False: the reference's bordered sections
    fast: bool = False
    device: str | torch.device = "cuda"

    # populated by stages
    band_shifts: list[list[InterBandShift]] = field(default_factory=list)
    coeff_x: np.ndarray | None = None   # (4, 2) ascending
    coeff_y: np.ndarray | None = None   # (4, 3) ascending

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.band_px = self.pixels_per_line // MSS_BANDS
        self.pan = raw_io.RawStrip(self.pan_file, self.pixels_per_line)
        self.mss = raw_io.RawStrip(self.mss_file, self.pixels_per_line)
        raw_io.check_pan_mss_sizes(self.pan, self.mss)
        self.lines_pan = self.pan.lines
        self.lines_mss = self.mss.lines
        olog("PAN: %d lines, MSS: %d lines.", self.lines_pan, self.lines_mss)
        self._pan_params = None       # float64 (k, b) on the device, or None
        self._mss_params = None       # 4 of them, or None
        self._loaded = False

    # -- load + RRC -----------------------------------------------------------
    def load_and_rrc(self, do_rrc_pan: bool = False, do_rrc_mss: bool = True):
        """Load the float64 RRC parameters onto the device; the strips stay
        memory-mapped and are corrected row range by row range."""

        def params(path, cols):
            return tuple(torch.from_numpy(v).to(self.device)
                         for v in load_rrc(path, cols))

        if do_rrc_pan:
            if not self.rrc_pan_file:
                raise ValueError("RRC parameter file of PAN needed")
            self._pan_params = params(self.rrc_pan_file, self.pixels_per_line)
        if do_rrc_mss:
            if not self.rrc_mss_files or any(
                not f for f in self.rrc_mss_files
            ):
                raise ValueError("RRC parameter file of all MSS Bands needed")
            self._mss_params = [params(f, self.band_px)
                                for f in self.rrc_mss_files]
        self._loaded = True

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)

    def pan_rows(self, a: int, b: int) -> torch.Tensor:
        """(RRC-corrected) PAN rows [a, b), (b - a, W) uint16 on the
        device."""
        rows = self._to_device(np.array(self.pan.section(a, b - a)))
        if self._pan_params is not None:
            rows = rrc.rrc_apply(rows, *self._pan_params)
        return rows

    def band_rows(self, band: int, a: int, b: int) -> torch.Tensor:
        """(RRC-corrected) MSS band-``band`` rows [a, b) on the device: the
        raw MSS line is 4 contiguous band segments (preproc.h:62-75)."""
        seg = self._to_device(
            self.mss.section(a, b - a).reshape(-1, MSS_BANDS,
                                               self.band_px)[:, band]
        )
        if self._mss_params is not None:
            seg = rrc.rrc_apply(seg, *self._mss_params[band])
        return seg

    def write_rrc_pan_tiff(self, line_offset: int = 0):
        path = build_output_file_path(
            self.pan_file, RRC_STEM_EXT, TIFF_FILE_EXT, out_dir=self.out_dir
        )
        rows = self.lines_pan - line_offset
        with stage("write_rrc_pan", rows * self.pixels_per_line * 2):
            w = tiff_io.TiffStripWriter(path, self.pixels_per_line, rows)
            for a in range(line_offset, self.lines_pan, _WRITE_CHUNK_ROWS):
                b = min(a + _WRITE_CHUNK_ROWS, self.lines_pan)
                w.write_rows(self.pan_rows(a, b).cpu().numpy())
            w.close()
        return path

    # -- inter-band correlation -----------------------------------------------
    def calc_inter_band_correlation(
        self,
        slices: int = IBCV_DEF_SLICES,
        sections: int = IBCV_DEF_SECTIONS,
        threshold: float = IBCV_DEF_THRESHOLD,
    ):
        """Tile extraction + upsample + batched phase correlation
        (preproc.h:224-347, same sampling geometry)."""
        r0s, br0s, base_rows, band_rows, cols, band_cols, centers = (
            ibc_geometry(self.lines_pan, self.pixels_per_line, slices,
                         sections))
        if not self._loaded:
            raise RuntimeError("call load_and_rrc() first")

        olog(
            "Calculating inter-band correlation with %d slices in %d "
            "section(s) ...", slices, sections,
        )
        sec_stats = []
        with stage("ibc_correlate"):
            for r0, br0 in zip(r0s, br0s):
                pan_block = self.pan_rows(r0, r0 + base_rows)
                band_blocks = [
                    self.band_rows(b, br0, br0 + band_rows)
                    for b in range(MSS_BANDS)
                ]
                pan_tiles = torch.stack([
                    pan_block[:, i * cols:(i + 1) * cols]
                    for i in range(slices)
                ])
                band_tiles = torch.stack([
                    band_blocks[b][:, i * band_cols:(i + 1) * band_cols]
                    for i in range(slices) for b in range(MSS_BANDS)
                ])
                del pan_block, band_blocks
                sec_stats.append(
                    _correlate_tiles(pan_tiles, band_tiles, MSS_BANDS))
        dxs, dys, rss = (
            np.concatenate([s[k] for s in sec_stats]) for k in range(3)
        )

        self.band_shifts = [[] for _ in range(MSS_BANDS)]
        for t in range(sections * slices):
            for b in range(MSS_BANDS):
                k = t * MSS_BANDS + b
                self.band_shifts[b].append(
                    InterBandShift(
                        dx=float(dxs[k]), dy=float(dys[k]), rs=float(rss[k]),
                        cx=centers[t],
                    )
                )
        self._dump_shift_table(slices, sections)
        self._fit(threshold)

    def _dump_shift_table(self, slices, sections):
        """The reference's QA table (DumpInterBandShiftValues,
        preproc.h:470-490)."""
        rlog(
            "|#SLC|Start|Center| End |   B1.x   |   B2.x   |   B3.x   |"
            "   B4.x   |   B1.y   |   B2.y   |   B3.y   |   B4.y   |"
            "   B1.r   |   B2.r   |   B3.r   |   B4.r   |"
        )
        cols = self.pixels_per_line // slices
        for s in range(sections):
            for i in range(slices):
                ii = i + s * slices
                sh = [self.band_shifts[b][ii] for b in range(MSS_BANDS)]
                rlog(
                    "|%4d|%5d|%6d|%5d|" % (i, i * cols, sh[0].cx, (i + 1) * cols)
                    + "".join(f"{x.dx:10.4f}|" for x in sh)
                    + "".join(f"{x.dy:10.4f}|" for x in sh)
                    + "".join(f"{x.rs:10.4f}|" for x in sh)
                )

    def _fit(self, threshold: float):
        """Filter + fit (preproc.h:492-550), float64 on the host."""
        self.coeff_x = np.zeros((MSS_BANDS, 2))
        self.coeff_y = np.zeros((MSS_BANDS, 3))
        for b in range(MSS_BANDS):
            shifts = self.band_shifts[b]
            cxc, cyc = polyfit.fit_shift_models_filtered(
                np.array([s.cx for s in shifts], np.float64),
                np.array([s.dx for s in shifts]),
                np.array([s.dy for s in shifts]),
                np.array([s.rs for s in shifts]),
                threshold, b + 1,
            )
            self.coeff_x[b] = cxc
            self.coeff_y[b] = cyc
            olog(
                "\tdeltaX coeff: [1] %.15f, [0] %.9f", cxc[1], cxc[0]
            )
            olog(
                "\tdeltaY coeff: [2] %.15f, [1] %.15f, [0] %.9f",
                cyc[2], cyc[1], cyc[0],
            )

    # -- alignment ------------------------------------------------------------
    def do_inter_band_alignment(
        self,
        line_per_section: int,
        line_offset: int = 0,
        section_overlap: int = IBPA_DEFAULT_LINEOVERLAP,
        keep_leading_lines: bool = False,
        write_tiff: bool = True,
    ) -> np.ndarray | str:
        """The alignment remap (preproc.h:351-425), then the first
        ``section_overlap`` rows trimmed unless ``keep_leading_lines``.

        The parity route reproduces the reference's section geometry:
        ``line_per_section`` batches advancing by ``line_per_section -
        section_overlap`` until fewer than IBPA_MIN_PROCESSLINES lines are
        left, each remapped with section-local maps (border value 0 at the
        section's edges) and its first ``section_overlap`` rows trimmed.
        Fast mode remaps each whole band in one pass
        (:func:`~..ops.resample.remap_band_fast_chunked`) and checks
        ``line_per_section`` only as the reference does.  Returns the
        ALIGNED.TIFF path, or the (rows, band_px, 4) array when
        ``write_tiff`` is False."""
        if section_overlap > IBPA_MAX_LINEOVERLAP:
            raise ValueError(
                f"Overlap value {section_overlap} exceeds maximum allowed "
                f"value({IBPA_MAX_LINEOVERLAP})"
            )
        if line_per_section < section_overlap * 2:
            raise ValueError(
                "Lines per section too small or section overlapped lines too "
                "large"
            )
        if self.lines_mss - line_offset < IBPA_MIN_PROCESSLINES:
            raise ValueError("Too few image lines left to process")
        if self.coeff_x is None:
            raise RuntimeError("run calc_inter_band_correlation first")

        skip = 0 if keep_leading_lines else section_overlap
        total_out = self.lines_mss - line_offset - skip
        aligned = np.zeros((total_out, self.band_px, MSS_BANDS), np.uint16)
        if self.fast:
            with stage("alignment_fast", self.mss.nbytes):
                # one band in flight at a time (bounded device and host
                # memory)
                for b in range(MSS_BANDS):
                    whole = resample.remap_band_fast_chunked(
                        self.band_rows(b, line_offset, self.lines_mss),
                        self.coeff_x[b].astype(np.float32),
                        self.coeff_y[b].astype(np.float32),
                    )
                    aligned[..., b] = \
                        whole[skip:skip + total_out].cpu().numpy()
        else:
            with stage("alignment", self.mss.nbytes):
                self._align_sections(aligned, line_per_section, line_offset,
                                     section_overlap, keep_leading_lines)
        if not write_tiff:
            return aligned
        path = build_output_file_path(
            self.mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=self.out_dir
        )
        tiff_io.write_tiff(path, aligned[..., [2, 1, 0, 3]])
        olog("Aligned MSS written to %s", path)
        return path

    def _align_sections(self, aligned: np.ndarray, line_per_section: int,
                        line_offset: int, section_overlap: int,
                        keep_leading_lines: bool) -> None:
        """The parity route's sections into ``aligned`` (as the JAX
        package's ``do_inter_band_alignment``): rows beyond the last
        section that was processed stay 0, as in the reference."""
        plans = [
            resample.plan_for_band_alignment(
                self.coeff_x[b], self.coeff_y[b], self.band_px,
                self.quantized_coords)
            for b in range(MSS_BANDS)
        ]
        for i, c in enumerate(resample.ibpa_plan(
                self.lines_mss, line_per_section, line_offset,
                section_overlap, keep_leading_lines)):
            olog("[SEC%d] %d lines for processing [offset=%d].",
                 i + 1, c.rows, c.offset)
            merged = np.empty((c.rows, self.band_px, MSS_BANDS), np.uint16)
            for b in range(MSS_BANDS):
                merged[:, :, b] = resample.remap_section_u16(
                    self.band_rows(b, c.offset, c.offset + c.rows), plans[b]
                ).cpu().numpy()
            aligned[c.dst:c.dst + c.count] = merged[c.first:c.first + c.count]


def _correlate_tiles(pan_tiles: torch.Tensor, band_tiles: torch.Tensor,
                     bands: int):
    """Upsample band tiles x4 and phase-correlate against their PAN tiles.

    ``pan_tiles``: (T, H, W) uint16; ``band_tiles``: (T*bands, H/4, W/4)
    uint16 ordered tile-major then band.  Returns per-(tile, band)
    dx/dy/response as numpy arrays."""
    h, w = pan_tiles.shape[1:]
    band_f = band_tiles.to(torch.float32)
    if band_tiles.shape[1] * MSS_BANDS == h and \
            band_tiles.shape[2] * MSS_BANDS == w:
        up = resample.upsample4_f32(band_f)
    else:
        up = resample.resize_cubic_f32(band_f, h, w)
    del band_f
    pan_rep = torch.repeat_interleave(pan_tiles.to(torch.float32), bands,
                                      dim=0)
    return tuple(t.cpu().numpy()
                 for t in phasecorr.phase_correlate_batch(pan_rep, up))
