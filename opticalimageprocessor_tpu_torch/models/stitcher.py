"""Dual-CMOS stitching (the ``prestitch`` and ``stitch`` commands) in
PyTorch.

Counterpart of ``opticalimageprocessor_tpu/models/stitcher.py``:

* :class:`Stitcher` -- ``prestitch``: the CMOS1<->CMOS2 overlap
  translation by full-surface phase correlation over sampled sections
  (CalcSttParameters), the RRC of both PANs streamed in 30000-row sections
  through kernel (a) (DoRRC), then PAN2's constant-shift resample
  (PreStitch).  The parity route (``fast=False``, the default) streams the
  reference's 30000-row sections through
  :func:`~..ops.resample.remap_section_u16` (bit for bit ``cv::remap``)
  with SectionaryRemap's upper/bottom cuts and rolling-buffer bottom cut;
  fast mode remaps the whole strip (kernel (c) for |dy| <= 5 px, the staged
  remap with kernel (e) beyond) and keeps the same line count.
* :func:`stitch` -- concatenate the two CMOS halves: the RAW or TIFF host
  writers, copied from the JAX module (they do no device work; importing
  that module would load jax).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (
    BYTES_PER_PIXEL,
    IBPA_DEFAULT_BATCHLINES,
    PIXELS_PER_LINE,
    PRESTT_STEM_EXT,
    RAW_FILE_EXT,
    REMAP_SECTION_ROWS,
    RRC_STEM_EXT,
    STT_DEF_EDGECOLS,
    STT_DEF_MAXDELTAY,
    STT_DEF_OVERLAPPX,
    STT_DEF_PHCTHRHLD,
    STT_DEF_SECLINES,
    STT_DEF_SECTIONS,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..utils.logging import olog, stage

from ..io import raw as raw_io
from ..io import tiff as tiff_io
from ..io.streaming import stream_process
from ..ops import phasecorr, resample, rrc
from .device_pipeline import average_valid_deltas, stt_offsets  # noqa: F401
from .scene import _host_rows, load_rrc, resolve_device


@dataclass
class Stitcher:
    pan1: str
    pan2: str
    rrc1: str = ""
    rrc2: str = ""
    sections: int = STT_DEF_SECTIONS
    line_per_section: int = STT_DEF_SECLINES
    overlap_cols: int = STT_DEF_OVERLAPPX
    out_dir: str | None = None
    # the parity route's coordinate convention: True = OpenCV <= 4.x's
    # 1/32-px grid, False = OpenCV 5.x's continuous coordinates
    quantized_coords: bool = False
    pixels_per_line: int = PIXELS_PER_LINE   # test hook; camera default 12288
    # fast=True: whole-strip constant-shift resample (the JAX package's
    # fast mode, within 1 DN of the parity route); False: the reference's
    # 30000-row sections
    fast: bool = False
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        s1 = raw_io.file_size(self.pan1)
        s2 = raw_io.file_size(self.pan2)
        if self.sections * self.line_per_section * BYTES_PER_PIXEL > s1:
            raise ValueError(
                "PAN1 size too small for SECTION & LINE_PER_SECTION argument"
            )
        if self.sections * self.line_per_section * BYTES_PER_PIXEL > s2:
            raise ValueError(
                "PAN2 size too small for SECTION & LINE_PER_SECTION argument"
            )
        if s1 != s2:
            raise ValueError("PAN1 size doesn't match PAN2 size")
        self.size_pan = s1
        self.lines_pan = s1 // (self.pixels_per_line * BYTES_PER_PIXEL)
        if self.lines_pan < self.sections * self.line_per_section:
            raise ValueError(
                "PAN line count less than sections times line-per-section, "
                "use smaller -s and/or -l value(s)"
            )
        olog("PAN: %d lines total.", self.lines_pan)
        # like the reference (stitcher.h:79-80): when RRC is skipped the
        # "RRC'd" path is the input path
        self.rrc_file_pan1 = self.pan1
        self.rrc_file_pan2 = self.pan2
        self.delta_x = 0.0
        self.delta_y = 0.0
        self.response = 0.0

    # -- CalcSttParameters (stitcher.h:148-201) -----------------------------
    def calc_stt_parameters(
        self,
        threshold: float = STT_DEF_PHCTHRHLD,
        max_delta_y: float = STT_DEF_MAXDELTAY,
        edge_cols: int = STT_DEF_EDGECOLS,
    ):
        p1 = raw_io.RawStrip(self.rrc_file_pan1, self.pixels_per_line)
        p2 = raw_io.RawStrip(self.rrc_file_pan2, self.pixels_per_line)
        ppl = self.pixels_per_line
        offs = stt_offsets(self.lines_pan, self.sections,
                           self.line_per_section)
        s1 = np.stack([
            p1.section(o, self.line_per_section)[
                :, ppl - self.overlap_cols:ppl - edge_cols]
            for o in offs
        ])
        s2 = np.stack([
            p2.section(o, self.line_per_section)[:, edge_cols:self.overlap_cols]
            for o in offs
        ])
        with stage("stt_correlate"):
            dxs, dys, rss = (
                t.cpu().numpy() for t in phasecorr.phase_correlate_batch(
                    *(torch.from_numpy(s).to(self.device, torch.float32)
                      for s in (s1, s2))
                )
            )
        self.delta_x, self.delta_y, self.response = average_valid_deltas(
            dxs, dys, rss, offs, threshold, max_delta_y
        )

    # -- DoRRC (stitcher.h:141-146) -----------------------------------------
    def do_rrc(self):
        self.rrc_file_pan1 = build_output_file_path(
            self.pan1, RRC_STEM_EXT, out_dir=self.out_dir
        )
        self.rrc_file_pan2 = build_output_file_path(
            self.pan2, RRC_STEM_EXT, out_dir=self.out_dir
        )
        for src, par, dst in (
            (self.pan1, self.rrc1, self.rrc_file_pan1),
            (self.pan2, self.rrc2, self.rrc_file_pan2),
        ):
            if not par:
                # the reference fails loudly here (LoadRRCParamFile fopen
                # throws); never silently write uncorrected .RRC.RAW
                raise ValueError("RRC parameter file needed")
            k, b = (torch.from_numpy(v).to(self.device)
                    for v in load_rrc(par, self.pixels_per_line))
            strip = raw_io.RawStrip(src, self.pixels_per_line)
            writer = raw_io.RawStripWriter(dst, self.pixels_per_line)
            with stage(f"rrc:{os.path.basename(src)}", strip.nbytes):
                stream_process(
                    strip, lambda sec: rrc.rrc_apply(sec.data, k, b),
                    writer.write_lines, REMAP_SECTION_ROWS, self.device,
                )
            writer.close()

    # -- PreStitch (stitcher.h:83-139 + SectionaryRemap) --------------------
    def pre_stitch(self) -> int:
        """Constant-shift resample of the (RRC'd) PAN2 into
        ``<PAN2>.PRESTT.RAW``; returns SectionaryRemap's line count.

        The upper cut ``ucut`` (dy < 0) and bottom cut ``bcut`` (dy >= 0)
        are the rows a section's shifted support leaves the section by
        (:func:`~..ops.resample.sectionary_cuts`)."""
        out_path = build_output_file_path(
            self.rrc_file_pan2, PRESTT_STEM_EXT, out_dir=self.out_dir
        )
        src = raw_io.RawStrip(self.rrc_file_pan2, self.pixels_per_line)
        writer = raw_io.RawStripWriter(out_path, self.pixels_per_line)
        if self.fast:
            n = self._pre_stitch_fast(src, writer)
        else:
            n = self._pre_stitch_sections(src, writer)
        writer.close()
        self.prestt_file_pan2 = out_path
        olog("Pre-stitched PAN2%s written to file '%s'.",
             " (fast)" if self.fast else "", out_path)
        return n

    def _pre_stitch_fast(self, src, writer) -> int:
        """Fast mode over the whole strip: the translation in the
        alignment-polynomial form (mapx = x + dx <=> cX = [4dx, 0]; G = dy
        <=> cY = [4dy, 0, 0]) through
        :func:`~..ops.resample.remap_band_fast_chunked` with row bound
        max(3, ceil|dy| + 1), as the JAX package's ``_pre_stitch_fast``;
        writes every row and returns the strip minus the ucut/bcut rows."""
        cx = np.asarray([4.0 * self.delta_x, 0.0], np.float32)
        cy = np.asarray([4.0 * self.delta_y, 0.0, 0.0], np.float32)
        row_bound = max(3, int(math.ceil(abs(self.delta_y))) + 1)
        with stage("prestitch_fast", self.size_pan):
            data = torch.from_numpy(np.array(src._mm)).to(self.device)
            mapped = resample.remap_band_fast_chunked(
                data, cx, cy, row_bound=row_bound
            )
            del data
            for blk in _host_rows(mapped):
                writer.write_lines(blk)
        return self.lines_pan - sum(resample.sectionary_cuts(self.delta_y))

    def _remap_section(self, rows: np.ndarray, plan) -> np.ndarray:
        return resample.remap_section_u16(
            torch.from_numpy(np.array(rows)).to(self.device), plan
        ).cpu().numpy()

    def _pre_stitch_sections(self, src, writer) -> int:
        """The parity route (the JAX package's ``pre_stitch``): the
        sections of :func:`~..ops.resample.sectionary_plan` at
        REMAP_SECTION_ROWS rows (read from this module at call time), each
        remapped whole and its kept rows written, then the bottom cut from
        the rebuilt rolling-buffer window.  Returns the final row offset,
        SectionaryRemap's return."""
        plan = resample.plan_for_constant_shift(
            self.delta_x, self.delta_y, self.pixels_per_line,
            self.quantized_coords,
        )
        sp = resample.sectionary_plan(self.lines_pan, REMAP_SECTION_ROWS,
                                      self.delta_y)
        with stage("prestitch", self.size_pan):
            for c in sp.cuts:
                mapped = self._remap_section(src.section(c.offset, c.rows),
                                             plan)
                writer.write_lines(mapped[c.first:c.first + c.count])
                del mapped
            if sp.window:
                window = np.concatenate([src.section(a, n)
                                         for a, n in sp.window])
                writer.write_lines(self._remap_section(window, plan)[
                    sp.window_first:sp.window_first + sp.bcut])
        return sp.end


# ---------------------------------------------------------------------------
# stitch writers (imageop.h:277-567), copied from the JAX package's
# models/stitcher.py: host IO only
# ---------------------------------------------------------------------------

def stitch(
    image1: str,
    image2: str,
    output: str = "",
    fold_cols_half: int = 0,
    use_gdal_style: bool = False,
    band_map: list[int] | None = None,
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
    band_interp: bool = False,
) -> str:
    """Static dispatch (Stitcher::Stitch, stitcher.h:21-46): RAW or TIFF."""
    e1 = os.path.splitext(image1)[1].lower()
    e2 = os.path.splitext(image2)[1].lower()
    if e1 != e2:
        raise ValueError("Stitch(): two images should be same type")
    if e1 not in (RAW_FILE_EXT.lower(), TIFF_FILE_EXT.lower(), ".tif"):
        raise ValueError("Stitch(): only RAW and TIFF image supported")
    if e1 == RAW_FILE_EXT.lower():
        return stitch_big_raw(
            image1, image2, output, pixels_per_line, fold_cols_half, out_dir
        )
    return stitch_tiff(
        image1, image2, output, fold_cols_half, use_gdal_style, band_map,
        out_dir, band_interp,
    )


def stitch_big_raw(
    left_path: str,
    right_path: str,
    out_path: str,
    pixels_per_line: int,
    fold_col_pixels: int,
    out_dir: str | None = None,
    block_lines: int = 4096,
) -> str:
    """StitchBigRaw (imageop.h:277-363): per-line ``left[:W-fold]`` then
    ``right[fold:]``; RAW output, or single-band TIFF when the output name
    ends .TIFF.  Streams in multi-line blocks instead of per-line fread."""
    left = raw_io.RawStrip(left_path, pixels_per_line)
    right = raw_io.RawStrip(right_path, pixels_per_line)
    if left.nbytes != right.nbytes:
        raise ValueError(
            f"RAW image sizes not match: left = {left.nbytes} bytes, right = "
            f"{right.nbytes} bytes"
        )
    half = pixels_per_line - fold_col_pixels
    out_px = half * 2
    output_is_tiff = True
    if not out_path:
        out_path = os.path.join(
            out_dir or os.getcwd(),
            f"stitched_{out_px}n{BYTES_PER_PIXEL * 8}b{TIFF_FILE_EXT}",
        )
    else:
        output_is_tiff = os.path.splitext(out_path)[1].lower() in (
            ".tiff", ".tif",
        )

    writer = (
        tiff_io.TiffStripWriter(out_path, out_px, left.lines, samples=1)
        if output_is_tiff
        else raw_io.RawStripWriter(out_path, out_px)
    )
    with stage("stitch_raw", left.nbytes * 2):
        for off in range(0, left.lines, block_lines):
            lb = left.section(off, block_lines)
            rb = right.section(off, block_lines)
            block = np.concatenate(
                [lb[:, :half], rb[:, fold_col_pixels:]], axis=1
            )
            if output_is_tiff:
                writer.write_rows(block)
            else:
                writer.write_lines(block)
    writer.close()
    return out_path


def stitch_tiff(
    left_path: str,
    right_path: str,
    out_path: str,
    fold_col_pixels: int,
    use_gdal_style: bool = False,
    band_map: list[int] | None = None,
    out_dir: str | None = None,
    band_interp: bool = False,
) -> str:
    """StitchTiff / StitchTiffGDAL (imageop.h:365-567): concatenate two
    multi-band TIFFs minus the fold columns; the GDAL-style path streams
    20000-line sections and writes LZW + predictor-2 (BigTIFF when large),
    with the optional 1-based band remap ('-m 3,2,1,4').

    ``band_interp`` tags the 4-band output's color interpretation the way
    StitchTiffGDAL's ``setBandInterpretion`` does (R/G/B/Alpha,
    imageop.h:508-530): PHOTOMETRIC=RGB plus EXTRASAMPLES=2 (unassociated
    alpha) — the tag GDAL emits for a GCI_AlphaBand fourth band."""
    if not out_path:
        out_path = os.path.join(out_dir or os.getcwd(), f"stitched{TIFF_FILE_EXT}")
    elif os.path.splitext(out_path)[1].lower() not in (".tiff", ".tif"):
        raise ValueError("Output file should be a tiff image")

    li = tiff_io.read_tiff_info(left_path)
    ri = tiff_io.read_tiff_info(right_path)
    if (li.height, li.width) != (ri.height, ri.width):
        raise RuntimeError("images have different sizes")
    if li.samples != ri.samples:
        raise RuntimeError("images have different sizes")
    half = li.width - fold_col_pixels
    out_px = half * 2
    samples = li.samples
    big_input = li.height * out_px * samples * 2 >= 4_000_000_000

    use_gdal_style = use_gdal_style or big_input
    writer = tiff_io.TiffStripWriter(
        out_path,
        out_px,
        li.height,
        samples=samples,
        compression="lzw" if use_gdal_style else "none",
        predictor=use_gdal_style,
        rows_per_strip=512,
        extrasamples=2 if (band_interp and samples == 4) else None,
    )
    # stream both inputs section-by-section (never materialising either,
    # like StitchTiffGDAL's per-band RasterIO loop, imageop.h:489-558);
    # memory is bounded by one section regardless of raster size
    section = min(IBPA_DEFAULT_BATCHLINES, 2048)
    with stage("stitch_tiff", li.height * out_px * samples * 2):
        for bl, br in zip(
            tiff_io.iter_tiff_rows(left_path, section),
            tiff_io.iter_tiff_rows(right_path, section),
        ):
            block = np.concatenate(
                [bl[:, :half], br[:, fold_col_pixels:]], axis=1
            )
            if band_map is not None:
                block = block[:, :, [m - 1 for m in band_map]]
            writer.write_rows(block)
    writer.close()
    return out_path
