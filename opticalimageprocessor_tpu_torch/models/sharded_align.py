"""Inter-band registration + alignment over the line mesh (the CLI's
default action with ``--mesh N``).

Counterpart of ``opticalimageprocessor_tpu/models/sharded_align.py``: the
user contract of :class:`~.preprocessor.PreProcessor` in fast mode -- the
same float64-fitted coefficients (the same tiles and fit) and an aligned
raster of the fast route's semantics -- run over an N-device line mesh
(``parallel/sharded.make_align_step``):

* the strips go shard by shard from the memory-mapped RAW files to the
  devices, so the host holds one shard at a time;
* the ALIGNED.TIFF (and with ``write_rrcpan`` the RRC TIFF of the PAN) is
  drained shard by shard at the rows' offsets;
* under several processes (``parallel/distributed``) each process ingests
  and drains its own shards, and ``write_tiff=False`` all-gathers the
  raster, so every process returns the same array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    IBPA_MAX_LINEOVERLAP,
    IBPA_MIN_PROCESSLINES,
    IBPA_STEM_EXT,
    MSS_BANDS,
    PIXELS_PER_LINE,
    RRC_STEM_EXT,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..io import raw as raw_io
from ..parallel.distributed import drain_line_sharded_to_tiff
from ..parallel.mesh import LINE_AXIS, LineMesh, resolve_mesh
from ..parallel.sharded import ingest_line_sharded, make_align_step
from ..utils.logging import olog, stage
from .scene import load_band_rrc, load_rrc


def run_sharded_align(
    pan_file: str,
    mss_file: str,
    rrc_pan_file: str = "",
    rrc_mss_files: tuple[str, str, str, str] | None = None,
    n_devices: int | LineMesh = 1,
    do_rrc_pan: bool = False,
    do_rrc_mss: bool = True,
    slices: int = 10,
    sections: int | None = None,
    threshold: float = 0.4,
    line_offset: int = 0,
    section_overlap: int = 520,
    keep_leading_lines: bool = False,
    out_dir: str | None = None,
    bgr_tiff_order: bool = True,
    pixels_per_line: int = PIXELS_PER_LINE,
    write_tiff: bool = True,
    quantized_coords: bool = False,
    write_rrcpan: bool = False,
    device: str | torch.device = "cuda",
):
    """Run the sharded align; returns the ALIGNED.TIFF path (or the aligned
    (rows, W/4, 4) array when ``write_tiff=False``).

    ``n_devices``: the mesh, a device count (``line_mesh(n, device)``) or
    an explicit :class:`~..parallel.mesh.LineMesh`.  RRC flags follow the
    CLI: the identity parameters stand in for a correction that is off
    (an exact no-op through the RRC).
    """
    band_px = pixels_per_line // MSS_BANDS
    pan = raw_io.RawStrip(pan_file, pixels_per_line)
    mss = raw_io.RawStrip(mss_file, pixels_per_line)
    # geometry invariants (CheckFilesAttributes, preproc.h:552-572)
    raw_io.check_pan_mss_sizes(pan, mss)
    if mss.lines - line_offset < IBPA_MIN_PROCESSLINES:
        raise ValueError("Too few image lines left to process")
    if section_overlap > IBPA_MAX_LINEOVERLAP:
        raise ValueError(
            f"Overlap value {section_overlap} exceeds maximum allowed "
            f"value({IBPA_MAX_LINEOVERLAP})"
        )
    if not keep_leading_lines and mss.lines - line_offset - section_overlap <= 0:
        raise ValueError("Too few image lines left to process")
    olog("PAN: %d lines, MSS: %d lines.", pan.lines, mss.lines)

    if do_rrc_pan and not rrc_pan_file:
        raise ValueError("RRC parameter file of PAN needed")
    pan_params = load_rrc(rrc_pan_file if do_rrc_pan else "", pixels_per_line)
    if do_rrc_mss and (
        not rrc_mss_files or any(not f for f in rrc_mss_files)
    ):
        raise ValueError("RRC parameter file of all MSS Bands needed")
    mss_params = load_band_rrc(rrc_mss_files if do_rrc_mss else None, band_px)

    mesh = resolve_mesh(n_devices, device)
    olog("Sharded align over %d-device '%s' mesh.", len(mesh), LINE_AXIS)

    with stage("shard_ingest", pan.nbytes + mss.nbytes):
        pan_arr = ingest_line_sharded(mesh, pan._mm, 0, MSS_BANDS)
        mss_view = mss._mm.reshape(mss.lines, MSS_BANDS, band_px).transpose(
            1, 0, 2)
        mss_arr = ingest_line_sharded(mesh, mss_view, 1)

    step = make_align_step(mesh, slices, sections, threshold,
                           quantized=quantized_coords,
                           want_pan_c=write_rrcpan)
    with stage("sharded_align", pan.nbytes + mss.nbytes):
        outs = step(pan_arr, mss_arr, pan_params, mss_params, line_offset,
                    real_lines_pan=pan.lines)
        aligned, coeff_x, coeff_y = outs[:3]
        for dev in mesh.distinct():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    del pan_arr, mss_arr
    if write_rrcpan:
        # WriteRRCedPAN_TIFF(lineOffset) parity (preproc.h:107,
        # main.cpp:310): the corrected PAN from line_offset on
        rrc_path = build_output_file_path(
            pan_file, RRC_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir)
        with stage("write_rrcpan",
                   (pan.lines - line_offset) * pixels_per_line * 2):
            drain_line_sharded_to_tiff(outs[3], rrc_path, total=pan.lines,
                                       row0=line_offset)
        olog("RRC'ed PAN written to %s", rrc_path)
    for b in range(MSS_BANDS):
        olog("\tdeltaX coeff: [1] %.15f, [0] %.9f",
             coeff_x[b, 1], coeff_x[b, 0])
        olog("\tdeltaY coeff: [2] %.15f, [1] %.15f, [0] %.9f",
             coeff_y[b, 2], coeff_y[b, 1], coeff_y[b, 0])

    total_rows = mss.lines - line_offset
    start = 0 if keep_leading_lines else section_overlap
    if not write_tiff:
        # on a mesh spanning processes an all-gather: every process
        # returns the whole raster (JAX replicates it over the mesh)
        return np.asarray(aligned.gather("cpu").numpy())[start:total_rows]

    path = build_output_file_path(
        mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir)
    order = [2, 1, 0, 3] if bgr_tiff_order else [0, 1, 2, 3]
    with stage("write_aligned",
               (total_rows - start) * band_px * MSS_BANDS * 2):
        drain_line_sharded_to_tiff(aligned, path, total=total_rows,
                                   row0=start, order=order)
    olog("Aligned MSS written to %s", path)
    return path
